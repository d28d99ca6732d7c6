// Fused alignment scan with per-song reduce, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_align_reduce_kernel` / `pallas_alignment_reduce`
// (pfann_tpu/index/pallas_align.py:45-129), which the exhaustive engine
// reaches through `alignment_core(impl="pallas")` (pfann_tpu/index/align.py)
// and the screened engine's coarse stage through the same call on its
// pooled int8 copy (pfann_tpu/index/screen.py:255-265).
//
// What it computes.  `db` is the uniform layout [N, d]: song s owns rows
// [s*R, s*R + R) = pad leading zeros, the song's embeddings, zero slack.
// For every query b (`q` is [B, S, d]) and every offset o in [0, R):
//
//     align[s*R + o, b] = sum_{i < S} dot(db[s*R + o + i], q[b, i])
//
// with rows >= N read as zero.  Only the per-song reduction leaves the chip:
//
//     best[b, s]   = max_o align[s*R + o, b]                  (f32)
//     argoff[b, s] = the LARGEST o reaching that max          (int32)
//
// written straight in [B, n_songs] order.  The score tensor never exists.
//
// What bounds it.  2*N*d*S*B operations against ~N*d bytes of db: at the
// serving shapes that is thousands of operations per byte, so the
// arithmetic units are the bound.  Phase 4 of chip_smoke.py (10k songs,
// R = 152, N = 1.52M, d = 128, S = 19, B = 1024, bf16) is 7.57e12 FLOP,
// 7.65 ms at 989 TFLOP/s on the tensor cores (its 476 MB of inputs and
// outputs take 0.14 ms at 3.35 TB/s); the screened engine's int8 stage 1
// at 100k songs (Rc = 40, Sc = 5, B = 1024) is 5.24e12 operations, 2.65 ms
// at 1,979 TOP/s.  In f32 the same phase-4 work is 113 ms at the CUDA
// cores' 67 TFLOP/s.
//
// Design, all three dtypes: a GEMM over global rows.  M = layout rows,
// N = queries, K = S*d.  Row g of the A operand is db rows g .. g+S-1 laid
// end to end: a row stride of d against a row length of S*d, so there is
// no im2col copy.  A block owns G whole songs and walks their G*R rows in
// M-subtiles of TM rows; for each it stages TM + S - 1 db rows in shared
// memory once, row-major, and the K-step for window row i reads rows
// i .. i+TM-1 of that one stage, so the shift by i is a row offset.  The
// B operand of step i is window row i of a tile of TN queries (TN x d, as
// stored), staged with cp.async in a ring of 2 stages, so that row i+1
// loads while row i multiplies: one barrier per window row.  The A stage
// is double-buffered the same way (the next subtile's rows load during
// this one's S steps) where shared memory allows it.  Staged rows are
// zero-filled past d up to the K-step and padded by 16 bytes, so the rows
// a phase of loads reads fall in distinct banks.  When S*d outgrows shared
// memory the window rows are split into chunks, each restaging A, so no S
// is refused.  The grid is 1-D with the song group fastest: the blocks
// in flight share one query tile's rows in L2.  (The query tile fastest,
// where they share a song group's rows, ran within 1.5% of it either way
// at every serving shape, tools/torch_kernel_sweep.py.)  The plan (TN, row sums, G, window rows per A stage, A stages, copy
// width, shared memory) is worked out in Python
// (index/align_kernel.py:tile_plan) and checked here.
//
// One kernel body, align_reduce_gemm<Core>, holds this pipeline and the
// epilogue for every dtype.  A Core supplies what differs: the warp's
// register tile, its product over one window row, and which rows and
// queries each lane holds (mma::Core on the tensor cores, f32k::Core on
// the CUDA cores).  The kernels align_reduce_mma and align_reduce_f32 are
// that body under each route's launch bounds.
//
// Epilogue, all three dtypes: the accumulator is align itself.  Each
// subtile folds it into two 32-bit words per (song of the group, query) in
// shared memory, in two passes: the max of the order-preserving value bits
// (atomicMax), a barrier, then the largest offset whose value equals that
// max (atomicMax).  A song's rows in a later subtile have later offsets, so
// pass 2 replaces an earlier subtile's offset exactly when this subtile
// raised the max or tied it: ties go to the later offset by construction.
// (One packed 64-bit key would take one pass, but a 64-bit shared
// atomicMax compiles to a compare-and-swap loop; the two passes made the
// int8 stage 1 1.2x faster, tools/torch_kernel_sweep.py.)  Where all of a
// warp's rows lie in one song, pass 1's lanes that hold a query reduce it
// with shuffles and one lane applies the atomic; else each thread applies
// one per run of its rows in one song, as in pass 2, where only the rows
// that reach the max apply one.  f32 values map -0.0 to +0.0 first (a
// plain >= treats them as equal, and all-zero regions tie on every
// offset).  best and argoff are written once per block, in [B, n_songs]
// order.
//
// bf16 and int8 (namespace mma): the tensor cores.
//   * mma.sync m16n8k16 bf16 x bf16 -> f32, m16n8k32 s8 x s8 -> s32.  In
//     bytes both fragments are the same 16 x 32-byte A tile and 32-byte x 8
//     B tile, so one kernel body serves both; a K-step is 32 bytes of a
//     row (rows zero-filled up to a multiple of 32 bytes).  A fragments
//     come from the shifted stage through ldmatrix, which takes one row
//     address per lane, so the shift by i costs nothing.  A stays
//     double-buffered unless that would leave one block per SM where one
//     A stage leaves two (at the serving shapes, bf16 at TN >= 32).
//   * Exactness: int8 sums are exact in s32, so best and argoff equal the
//     float64 plain version bit for bit (past 2^24 too).  bf16 products
//     are exact in f32, but the tensor cores' f32 accumulation rounds
//     toward zero: one chain of all S*d/16 MMAs into a sum near S drifts
//     (2.3e-3 at S = 119, d = 128).  Up to S*d = 4096 (S = 32 at d = 128;
//     ~1e-4 at the serving S = 19) the MMAs chain into align; past it (RS)
//     each window row's K-sum starts from zero in the MMAs and is added
//     with round-to-nearest adds, at twice the accumulator registers.
//   * Tiles: TN is the smallest of 8, 16, 32, 64 that holds B, so small
//     batches pay for few query slots; larger batches run in blocks of 64
//     queries and 256-row subtiles, which read half the query rows from L2
//     per output that 128 x 128 tiles do: bf16 ran 1.1x and int8 1.01-1.05x
//     faster that way (tools/torch_kernel_sweep.py).
//   Left on the table: wgmma (its A operand from registers filled by the
//   same shifted ldmatrix loads, B from shared memory; a version that
//   awaited each window row's products before the next barrier ran 1.4x
//   slower at phase 4, so it needs rows in flight), TMA for the stages,
//   warp specialisation, and a persistent grid.
//
// float32 (namespace f32k, only for the non-default `db_dtype: float32`):
// the CUDA cores, every product and sum an FFMA in round-to-nearest f32.
// The tensor cores would compute it in TF32 (or 3xTF32), a different
// result, and their f32 accumulation rounds toward zero; so the bound is
// the FMA peak.
//   * Register tile: each lane holds RM = 8 layout rows 8 apart and RN (up
//     to 8) queries 4 apart; a warp is 8 row lanes x 4 query lanes, so the
//     8 rows a load instruction reads are consecutive (distinct banks, each
//     row broadcast to 4 lanes) and so are its 4 queries.  A K-step of 4
//     floats is RM + RN 16-byte shared loads for 4*RM*RN FMAs (16 loads per
//     256 FMAs at 8 x 8).  256 threads, 256-row subtiles; TN below 64 takes
//     fewer queries a lane.  (128 queries in 128-row subtiles ran 3% slower,
//     and d = 128 fixed at compile time no faster, tools/torch_kernel_sweep.py.)
//   * One block per SM (254 registers at TN = 64, and 212-232 KB of shared
//     memory), so at d = 128 A has one stage, restaged per subtile.  (Copying
//     the next subtile's rows during this one's epilogue ran 1-1.5% slower,
//     tools/torch_kernel_sweep.py.)
//   * Exactness: the same f32 products summed in another order than the
//     plain version's cuBLAS product: |best - plain| <= 7e-5 at S <= 32 and
//     2.7e-4 at S = 119 (chip_smoke.py), against BEST_ATOL = 2e-3.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>


namespace {

// ------------------------------------------------ shared by both routes
struct Plan {
  long long N;  // db rows
  int rb;       // bytes of a db / query row: d * itemsize
  int kb;       // rb rounded up to the K-step: 32 bytes (mma) or 16 (f32)
  int lds;      // staged row stride in bytes: kb + 16
  int R, S, B, n_songs;
  int tm;       // layout rows per M-subtile (of the instantiation)
  int G;        // songs per block
  int sc;       // window rows per A stage (S unless S*d outgrows shared memory)
  int abuf;     // A stages: 2 (the next one loads during this one) or 1
  int ch;       // bytes per cp.async: 16, 8 or 4
};

constexpr int NST = 2;  // query-row stages: a ring of 2

template <int TM, int TN>
size_t smem_bytes(const Plan& p) {
  return (size_t)p.abuf * (TM + p.sc - 1) * p.lds + (size_t)NST * TN * p.lds +
         (size_t)p.G * TN * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// n < CH zero-fills the rest (n = 0: all zeros, nothing read)
template <int CH>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int n) {
  if constexpr (CH == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n) : "memory");
  else if constexpr (CH == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `rows` rows of p.rb bytes into shared rows p.lds apart, zero-filling
// bytes [rb, kb) and every row whose source is null.
template <int CH, class Src>
__device__ __forceinline__ void stage_rows(uint32_t dst, int rows, const Plan& p,
                                           const unsigned char* base, Src src, int tid,
                                           int nthr) {
  const int cpr = p.kb / CH;
  for (int e = tid; e < rows * cpr; e += nthr) {
    const int r = e / cpr, off = (e - r * cpr) * CH;
    const unsigned char* s = src(r);
    const bool ok = s != nullptr && off < p.rb;
    cp_async<CH>(dst + r * p.lds + off, ok ? s + off : base, ok ? CH : 0);
  }
}

template <class Src>
__device__ __forceinline__ void stage(uint32_t dst, int rows, const Plan& p,
                                      const unsigned char* base, Src src, int tid, int nthr) {
  if (p.ch == 16)
    stage_rows<16>(dst, rows, p, base, src, tid, nthr);
  else if (p.ch == 8)
    stage_rows<8>(dst, rows, p, base, src, tid, nthr);
  else
    stage_rows<4>(dst, rows, p, base, src, tid, nthr);
}

// order-preserving bits of an f32 value; -0.0 ranks as +0.0
__device__ __forceinline__ uint32_t float_order(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float order_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Opt in to `smem` bytes of dynamic shared memory for `kernel`.
cudaError_t allow_smem(const void* kernel, long long smem) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A core is what differs between the routes: a warp's register tile and its
// product over one window row, and which rows and queries each lane holds.
// It supplies
//   threads, WARPS_M, WM, WN, TM, TN   block and warp tiles (warp w sits at
//                                      row tile w % WARPS_M, query tile
//                                      w / WARPS_M);
//   NR, NC                             the rows and queries of a lane;
//   XOR0                               the lanes holding one query differ
//                                      in lane bits XOR0, 2*XOR0, 4*XOR0;
//   ONE_BLOCK                          one block per SM (the launch bounds);
//   clear(), row(a, b, p)              zero the tile; add one window row's
//                                      K-sum, A rows from `a` (the A stage
//                                      shifted by the window row), queries
//                                      from `b` (the query stage);
//   row_of(r), col_of(c)               the lane's r-th row (ascending in r)
//                                      within the warp's WM, c-th query
//                                      within its WN;
//   key(r, c), value(k)                the order-preserving 32-bit key of
//                                      that sum, and back to f32.

// ------------------------------------------------- bf16 and int8: mma.sync
namespace mma {

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

struct Bf16Op {
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t order(float v) { return float_order(v); }
  static __device__ __forceinline__ float value(uint32_t k) { return order_float(k); }
};

struct Int8Op {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t order(int v) {
    return static_cast<uint32_t>(v) ^ 0x80000000u;
  }
  static __device__ __forceinline__ float value(uint32_t k) {  // exact int, rounded once
    return __int2float_rn(static_cast<int>(k ^ 0x80000000u));
  }
};

// WARPS_M x WARPS_N warps, each MT m16 x NT n8 MMA tiles.  RS: the per-row
// partial sums (bf16 at large S*d).
template <class Op, bool RS, int WARPS_M_, int WARPS_N, int MT, int NT>
struct Core {
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load two n8 tiles at a time");
  static constexpr int threads = WARPS_M_ * WARPS_N * 32, WARPS_M = WARPS_M_;
  static constexpr int WM = MT * 16, WN = NT * 8;
  static constexpr int TM = WARPS_M * WM, TN = WARPS_N * WN;
  // a lane holds rows 16 mt + 8 h + gid and queries 8 nt + 2 tig + e
  static constexpr int NR = 2 * MT, NC = 2 * NT, XOR0 = 4;
  static constexpr bool ONE_BLOCK = false;  // two blocks per SM where they fit
  using Acc = typename Op::Acc;

  Acc acc[MT][NT][4];
  int a_lane, b_lane, gid, tig;

  // per-lane ldmatrix rows: A lanes 0-15 rows 0-15 bytes 0-15, lanes 16-31
  // the same rows at bytes 16-31; B lanes give query rows (lane & 7) + 8 *
  // (lane >> 4) at bytes 16 * ((lane >> 3) & 1) (x2 reads lanes 0-15 only)
  __device__ __forceinline__ Core(int lane, int warp_m, int warp_n, const Plan& p)
      : a_lane((warp_m * WM + (lane & 15)) * p.lds + (lane >> 4) * 16),
        b_lane((warp_n * WN + (lane & 7) + (NT > 1 ? (lane >> 4) << 3 : 0)) * p.lds +
               ((lane >> 3) & 1) * 16),
        gid(lane >> 2),
        tig(lane & 3) {}

  static __device__ __forceinline__ void zero(Acc (&c)[MT][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[mt][nt][j] = Acc(0);
  }
  __device__ __forceinline__ void clear() { zero(acc); }

  __device__ __forceinline__ void row(const unsigned char* a, const unsigned char* b,
                                      const Plan& p) {
    const uint32_t a_addr = smem_u32(a) + a_lane, b_addr = smem_u32(b) + b_lane;
    Acc part[MT][NT][4];
    if constexpr (RS) zero(part);
#pragma unroll 2
    for (int kk = 0; kk < p.kb; kk += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(af[mt], a_addr + mt * 16 * p.lds + kk);
      if constexpr (NT == 1) {
        ldsm_x2(bf[0][0], bf[0][1], b_addr + kk);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, b_addr + np * 16 * p.lds + kk);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          Op::mma((RS ? part : acc)[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    if constexpr (RS) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[mt][nt][j];
    }
  }

  __device__ __forceinline__ int row_of(int r) const { return (r >> 1) * 16 + (r & 1) * 8 + gid; }
  __device__ __forceinline__ int col_of(int c) const { return (c >> 1) * 8 + 2 * tig + (c & 1); }
  __device__ __forceinline__ uint32_t key(int r, int c) const {
    return Op::order(acc[r >> 1][c >> 1][2 * (r & 1) + (c & 1)]);
  }
  static __device__ __forceinline__ float value(uint32_t k) { return Op::value(k); }
};

}  // namespace mma

// ------------------------------------------------------ f32: CUDA cores
namespace f32k {

// WARPS_M x WARPS_N warps of 8 row lanes x 4 query lanes; a lane holds RM
// rows 8 apart and RN queries 4 apart, so a warp covers WM = 8*RM
// consecutive rows and WN = 4*RN queries.
template <int WARPS_M_, int WARPS_N, int RM, int RN>
struct Core {
  static constexpr int threads = WARPS_M_ * WARPS_N * 32, WARPS_M = WARPS_M_;
  static constexpr int WM = 8 * RM, WN = 4 * RN;
  static constexpr int TM = WARPS_M * WM, TN = WARPS_N * WN;
  static constexpr int NR = RM, NC = RN, XOR0 = 1;  // row lanes: lane bits 0-2
  static constexpr bool ONE_BLOCK = true;

  float acc[RM][RN];
  int a_lane, b_lane, lm, ln;  // a_lane, b_lane: the lane's first row, query (floats)

  __device__ __forceinline__ Core(int lane, int warp_m, int warp_n, const Plan& p)
      : a_lane((warp_m * WM + (lane & 7)) * (p.lds / 4)),
        b_lane((warp_n * WN + (lane >> 3)) * (p.lds / 4)),
        lm(lane & 7),
        ln(lane >> 3) {}

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < RM; ++j)
#pragma unroll
      for (int n = 0; n < RN; ++n) acc[j][n] = 0.f;
  }

  // A K-step of 4 floats: RM + RN 16-byte shared loads for 4*RM*RN FFMAs
  __device__ __forceinline__ void row(const unsigned char* a_stage, const unsigned char* b_stage,
                                      const Plan& p) {
    const int ld = p.lds / 4, kf = p.kb / 4;  // row stride, floats per K-step row
    const float* a = reinterpret_cast<const float*>(a_stage) + a_lane;
    const float* b = reinterpret_cast<const float*>(b_stage) + b_lane;
#pragma unroll 2
    for (int k = 0; k < kf; k += 4) {
      float4 av[RM], bv[RN];
#pragma unroll
      for (int j = 0; j < RM; ++j) av[j] = *reinterpret_cast<const float4*>(a + j * 8 * ld + k);
#pragma unroll
      for (int n = 0; n < RN; ++n) bv[n] = *reinterpret_cast<const float4*>(b + n * 4 * ld + k);
#pragma unroll
      for (int j = 0; j < RM; ++j)
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          float c = acc[j][n];
          c = fmaf(av[j].x, bv[n].x, c);
          c = fmaf(av[j].y, bv[n].y, c);
          c = fmaf(av[j].z, bv[n].z, c);
          acc[j][n] = fmaf(av[j].w, bv[n].w, c);
        }
    }
  }

  __device__ __forceinline__ int row_of(int r) const { return lm + 8 * r; }
  __device__ __forceinline__ int col_of(int c) const { return ln + 4 * c; }
  __device__ __forceinline__ uint32_t key(int r, int c) const { return float_order(acc[r][c]); }
  static __device__ __forceinline__ float value(uint32_t k) { return order_float(k); }
};

}  // namespace f32k

// -------------------------------------------------- the one kernel body
template <class Core>
__device__ __forceinline__ void align_reduce_gemm(const unsigned char* __restrict__ db,
                                                  const unsigned char* __restrict__ q,
                                                  float* __restrict__ best_out,
                                                  int* __restrict__ arg_out, const Plan& p) {
  constexpr int NTHR = Core::threads, WM = Core::WM, WN = Core::WN, TM = Core::TM,
                TN = Core::TN, NR = Core::NR, NC = Core::NC, X0 = Core::XOR0;

  extern __shared__ __align__(16) unsigned char smem[];
  const int a_bytes = (TM + p.sc - 1) * p.lds;
  unsigned char* sA = smem;                        // [abuf][TM + sc - 1][lds]
  unsigned char* sB = smem + p.abuf * a_bytes;     // [NST][TN][lds]
  uint32_t* vals = reinterpret_cast<uint32_t*>(sB + NST * TN * p.lds);  // [G][TN]
  uint32_t* offs = vals + p.G * TN;                                         // [G][TN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % Core::WARPS_M, warp_n = warp / Core::WARPS_M;
  // 1-D grid, song group fastest (see the header)
  const unsigned n_grp = (unsigned)((p.n_songs + p.G - 1) / p.G);
  const int qt = (int)(blockIdx.x / n_grp);
  const int s0 = (int)(blockIdx.x % n_grp) * p.G;
  const int gsongs = min(p.G, p.n_songs - s0);
  const long long row0 = (long long)s0 * p.R;     // the group's first layout row
  const long long grows = (long long)gsongs * p.R;
  const int n_sub = (int)((grows + TM - 1) / TM);
  const int n_chunk = (p.S + p.sc - 1) / p.sc;
  const int n_tiles = n_sub * n_chunk;  // A stages: (subtile, window-row chunk)
  const int n_steps = n_sub * p.S;
  const int b0 = qt * TN;

  auto stage_a = [&](int tile) {
    const int sub = tile / n_chunk, i0 = (tile - sub * n_chunk) * p.sc;
    const long long g0 = row0 + (long long)sub * TM + i0;
    stage(smem_u32(sA + (tile % p.abuf) * a_bytes), TM + min(p.sc, p.S - i0) - 1, p, db,
          [&](int r) -> const unsigned char* {
            const long long g = g0 + r;
            return g < p.N ? db + g * p.rb : nullptr;
          },
          tid, NTHR);
  };
  auto stage_b = [&](int u) {  // window row u % S of the query tile, into stage u % NST
    const int i = u % p.S;
    stage(smem_u32(sB + (u % NST) * TN * p.lds), TN, p, q,
          [&](int r) -> const unsigned char* {
            const int b = b0 + r;
            return b < p.B ? q + ((long long)b * p.S + i) * p.rb : nullptr;
          },
          tid, NTHR);
  };

  for (int e = tid; e < 2 * p.G * TN; e += NTHR) vals[e] = 0u;  // vals and offs
  if (p.abuf == 2) stage_a(0);
  stage_b(0);
  cp_async_commit();

  Core core(lane, warp_m, warp_n, p);
  core.clear();

  int t = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int sub = tile / n_chunk, i0 = (tile - sub * n_chunk) * p.sc;
    const int i1 = min(i0 + p.sc, p.S);
    const unsigned char* a_stage = sA + (tile % p.abuf) * a_bytes;
    for (int i = i0; i < i1; ++i, ++t) {
      if (i == i0) {
        if (p.abuf == 2) {
          cp_async_wait<0>();
          __syncthreads();  // A(tile) landed; A(tile - 1) read by all
          if (tile + 1 < n_tiles) stage_a(tile + 1);
        } else {
          __syncthreads();  // the previous A stage read by all
          stage_a(tile);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
      } else {
        cp_async_wait<0>();
        __syncthreads();  // query row t landed; row t - 1's stage read by all
      }
      if (t + 1 < n_steps) stage_b(t + 1);
      cp_async_commit();
      // window row i reads staged rows i - i0 .. : the shift is a row offset
      core.row(a_stage + (i - i0) * p.lds, sB + (t % NST) * TN * p.lds, p);
    }
    if (i1 < p.S) continue;

    // ---- epilogue of subtile `sub`: the segmented max, in two passes over
    // 32-bit words (see the header).  Group-local rows in 32 bits (G * R <
    // 2^31, checked at launch): a 64-bit division costs a call per row.
    const unsigned w0 = (unsigned)(sub * TM + warp_m * WM), R = (unsigned)p.R;
    const unsigned nrows = (unsigned)grows;
    int sl[NR], off[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const unsigned gr = w0 + core.row_of(r);
      const unsigned s = gr / R;
      sl[r] = gr < nrows ? (int)s : -1;
      off[r] = gr < nrows ? (int)(gr - s * R) : 0;
    }
    const unsigned w1 = w0 + WM - 1;
    const bool one_song = w1 < nrows && w0 / R == w1 / R;  // the same in every lane
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = warp_n * WN + core.col_of(c);
      if (one_song) {  // the 8 row lanes of this query reduce with shuffles
        uint32_t v = 0;
#pragma unroll
        for (int r = 0; r < NR; ++r) v = max(v, core.key(r, c));
#pragma unroll
        for (int x = X0; x < 8 * X0; x <<= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, x));
        if ((lane & (7 * X0)) == 0) atomicMax(&vals[sl[0] * TN + col], v);
      } else {  // one atomic per run of this lane's rows in one song
        int cur = -1;
        uint32_t cv = 0;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if (sl[r] < 0) continue;
          const uint32_t v = core.key(r, c);
          if (sl[r] != cur) {
            if (cur >= 0) atomicMax(&vals[cur * TN + col], cv);
            cur = sl[r];
            cv = v;
          } else {
            cv = max(cv, v);
          }
        }
        if (cur >= 0) atomicMax(&vals[cur * TN + col], cv);
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // an atomic per run only where a row hits
      const int col = warp_n * WN + core.col_of(c);
      int cur = -1, hit = -1;
      uint32_t top = 0;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (sl[r] < 0) continue;
        if (sl[r] != cur) {
          if (hit >= 0) atomicMax(&offs[cur * TN + col], (uint32_t)hit);
          cur = sl[r];
          hit = -1;
          top = vals[cur * TN + col];
        }
        // rows ascend with r: the last hit is the largest offset
        if (core.key(r, c) == top) hit = off[r];
      }
      if (hit >= 0) atomicMax(&offs[cur * TN + col], (uint32_t)hit);
    }
    core.clear();
  }

  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < gsongs * TN; e += NTHR) {
    const int col = e / gsongs, s = e - col * gsongs, b = b0 + col;
    if (b < p.B) {
      const long long o = (long long)b * p.n_songs + s0 + s;
      best_out[o] = Core::value(vals[s * TN + col]);
      arg_out[o] = (int)offs[s * TN + col];
    }
  }
}

// The kernels of the two routes: the one body, under their launch bounds.
// f32 states its one block per SM (shared memory allows no more); left to
// choose, ptxas cut its TN = 32 form from 168 to 122 registers to make
// room for a second block, and it ran 5% slower.  The MMA forms leave
// ptxas to choose: at up to 128 registers two blocks fit.
template <class Core>
__global__ void __launch_bounds__(Core::threads)
align_reduce_mma(const unsigned char* __restrict__ db, const unsigned char* __restrict__ q,
                 float* __restrict__ best_out, int* __restrict__ arg_out, const Plan p) {
  align_reduce_gemm<Core>(db, q, best_out, arg_out, p);
}
template <class Core>
__global__ void __launch_bounds__(Core::threads, 1)
align_reduce_f32(const unsigned char* __restrict__ db, const unsigned char* __restrict__ q,
                 float* __restrict__ best_out, int* __restrict__ arg_out, const Plan p) {
  align_reduce_gemm<Core>(db, q, best_out, arg_out, p);
}

template <class Core>
cudaError_t launch(const void* db, const void* q, void* best, void* argoff, const Plan& p,
                   long long smem, cudaStream_t stream) {
  if (p.tm != Core::TM || (long long)smem_bytes<Core::TM, Core::TN>(p) != smem)
    return cudaErrorInvalidValue;
  const long long blocks =
      (long long)((p.n_songs + p.G - 1) / p.G) * ((p.B + Core::TN - 1) / Core::TN);
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  void (*kernel)(const unsigned char*, const unsigned char*, float*, int*, const Plan);
  if constexpr (Core::ONE_BLOCK)
    kernel = align_reduce_f32<Core>;
  else
    kernel = align_reduce_mma<Core>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)blocks, Core::threads, smem, stream>>>(
      static_cast<const unsigned char*>(db), static_cast<const unsigned char*>(q),
      static_cast<float*>(best), static_cast<int*>(argoff), p);
  return cudaGetLastError();
}

// query tile TN -> warps (M x N) and warp tile (MT m16 x NT n8); the
// (TM, threads) of each must match align_kernel.py's TILE_CONFIGS.
template <class Op, bool RS>
cudaError_t launch_mma(const void* db, const void* q, void* best, void* argoff, const Plan& p,
                       int tn, long long smem, cudaStream_t s) {
  switch (tn) {
    case 64: return launch<mma::Core<Op, RS, 8, 1, 2, 8>>(db, q, best, argoff, p, smem, s);  // TM 256
    case 32: return launch<mma::Core<Op, RS, 8, 1, 2, 4>>(db, q, best, argoff, p, smem, s);  // TM 256
    case 16: return launch<mma::Core<Op, RS, 8, 1, 1, 2>>(db, q, best, argoff, p, smem, s);  // TM 128
    case 8: return launch<mma::Core<Op, RS, 4, 1, 1, 1>>(db, q, best, argoff, p, smem, s);   // TM 64
    default: return cudaErrorInvalidValue;
  }
}

// query tile TN -> lane tile (8 rows x RN queries) of 4 x 2 warps: TM 256,
// 256 threads (align_kernel.py's F32_TILE).
cudaError_t launch_f32(const void* db, const void* q, void* best, void* argoff, const Plan& p,
                       int tn, long long smem, cudaStream_t s) {
  switch (tn) {
    case 64: return launch<f32k::Core<4, 2, 8, 8>>(db, q, best, argoff, p, smem, s);
    case 32: return launch<f32k::Core<4, 2, 8, 4>>(db, q, best, argoff, p, smem, s);
    case 16: return launch<f32k::Core<4, 2, 8, 2>>(db, q, best, argoff, p, smem, s);
    case 8: return launch<f32k::Core<4, 2, 8, 1>>(db, q, best, argoff, p, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16, 2 = int8 (int32 sums).
// tn, tm, rowsum, G, sc, abuf, ch and smem are the tile plan of
// index/align_kernel.py:tile_plan.  Returns a cudaError_t (0 = launched).
int align_reduce_launch(const void* db, const void* q, void* best, void* argoff,
                        long long N, int d, int R, int S, int B, int n_songs, int dtype,
                        int tn, int tm, int rowsum, int G, int sc, int abuf, int ch,
                        long long smem, void* stream) {
  if (B <= 0 || n_songs <= 0) return cudaSuccess;
  if (d <= 0 || d % 4 || R <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  p.N = N;
  p.rb = dtype == 0 ? 4 * d : dtype == 1 ? 2 * d : d;
  const int step = dtype == 0 ? 16 : 32;  // K-step bytes: float4, or one MMA's K
  p.kb = (p.rb + step - 1) / step * step;
  p.lds = p.kb + 16;
  p.R = R;
  p.S = S;
  p.B = B;
  p.n_songs = n_songs;
  p.tm = tm;
  p.G = G;
  p.sc = sc;
  p.abuf = abuf;
  p.ch = ch;
  if (G <= 0 || (long long)G * R + 512 > INT_MAX || sc <= 0 || sc > S ||
      (abuf != 1 && abuf != 2) ||
      (ch != 4 && ch != 8 && ch != 16) || p.rb % ch || (rowsum != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(db) % ch || reinterpret_cast<uintptr_t>(q) % ch)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(db, q, best, argoff, p, tn, smem, s);
  if (dtype == 2) return launch_mma<mma::Int8Op, false>(db, q, best, argoff, p, tn, smem, s);
  if (rowsum) return launch_mma<mma::Bf16Op, true>(db, q, best, argoff, p, tn, smem, s);
  return launch_mma<mma::Bf16Op, false>(db, q, best, argoff, p, tn, smem, s);
}

const char* align_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
