// Fused alignment scan with per-song reduce, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_align_reduce_kernel` / `pallas_alignment_reduce`
// (pfann_tpu/index/pallas_align.py:45-129, pl.pallas_call at :106; int32
// sums for int8 at :49-52), which the exhaustive engine reaches through
// `alignment_core(impl="pallas")` (pfann_tpu/index/align.py) and the
// screened engine's coarse stage through the same call on its pooled int8
// copy (pfann_tpu/index/screen.py:255-265).
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
// serving shapes thousands of operations per byte, so the arithmetic units
// are the bound.  Phase 4 of chip_smoke.py (10k songs, R = 152, d = 128,
// S = 19, B = 1024, bf16) is 7.57e12 FLOP, 7.65 ms at 989 TFLOP/s on the
// tensor cores; the screened engine's int8 stage 1 at 100k songs (Rc = 40,
// Sc = 5, B = 1024) is 5.24e12 operations, 2.65 ms at 1,979 TOP/s.  In f32
// the phase-4 work is 113 ms at the CUDA cores' 67 TFLOP/s.
//
// All three dtypes are one GEMM over layout rows: M = layout rows, N =
// queries, K = S*d.  Row g of the A operand is db rows g .. g+S-1 laid end
// to end (a row stride of d against a row length of S*d: no im2col copy).
// A block stages TM + S - 1 db rows of an M-subtile once, and window row i
// reads rows i .. i+TM-1 of that one stage: the shift by i is a row offset.
// The B operand of window row i is row i of a tile of TN queries.  The
// per-song reduce is shared (seg_max, seg_argmax): each subtile folds its
// tile of align into two 32-bit words per (song of the block's group,
// query) in shared memory, in two passes between barriers: the max of the
// sums (atomicMax on order-preserving keys, -0.0 mapped to +0.0, so that
// all-zero regions tie on every offset), then the largest offset whose sum
// equals it.  A song's rows in a later subtile have later offsets, so pass
// 2 replaces an earlier subtile's offset exactly when this subtile raised
// the max or tied it: ties go to the later offset by construction.  (One
// packed 64-bit key would take one pass, but a 64-bit shared atomicMax is
// a compare-and-swap loop; two passes ran 1.2x faster, PR 3.)  A warp's
// rows in at most two songs reduce a query over its 8 row lanes in a
// butterfly that halves the columns a level (NC/2 + NC/4 + NC/8 shuffles
// for NC columns, one atomic a column); rows in more songs apply one atomic
// per run of a lane's rows.
//
// bf16 and int8 (namespace wg): wgmma, TMA and mbarriers.
//   * Operands.  wgmma with A from registers: m64nNk16 bf16 -> f32 and
//     m64nNk32 s8 -> s32 (the register-A form of s8 exists: CUTLASS's
//     SM90 ..._S32S8S8_RS_TN atoms).  In bytes both take the same A
//     fragment, the mma.sync 16 x 32-byte tile a warp loads with one
//     ldmatrix.x4, a row address a lane, so the window shift stays free;
//     an smem descriptor could not take it (its start keeps the 8-row
//     phase of the swizzle atom, and i is seldom a multiple of 8).  B, the
//     query rows, comes from shared memory by descriptor, K-major in
//     128-byte swizzled panels (8-row groups 1,024 bytes apart).
//   * Rows in flight.  A window row's K-steps (up to 256 bytes: a d = 128
//     row; wider rows go in groups of 256 bytes) are one wgmma group; the
//     next group is issued before `wgmma.wait_group 1` retires the one
//     before, so two rows are on the tensor cores while the next A
//     fragments load into the second of two register sets.  Past S*d =
//     4096, bf16 sums each row apart (the tensor cores' f32 accumulation
//     rounds toward zero: one chain over S = 119 drifted 2.3e-3): the
//     row's first K-step has scale-d 0, the row retires into one of two
//     partial accumulators, and is added to the total with round-to-nearest
//     f32 adds while the next row runs.  ptxas keeps the groups in flight
//     only where the warpgroup's branch is provably uniform: the role comes
//     from a __shfl_sync of threadIdx / 128 and the mbarrier spin loop is
//     inside one asm (chip_smoke.py fails on a serialisation advisory).
//   * Loads.  TMA with mbarriers: one thread of a loading warpgroup issues
//     every load; the consumers wait on "full" barriers and release stages
//     through "empty" ones; setmaxnreg gives the loader 40 (or 24) registers
//     and the consumers 232 (or 136, at three blocks an SM).  An A stage is
//     a 2-D tensor map over db [N, d] in boxes of at most 256 rows by one
//     128-byte panel; TMA zero-fills rows past N and columns past d (the
//     wrapper pads d to a 16-byte row).  The ldmatrix lane address applies
//     the swizzle (16-byte chunk XOR row mod 8); a shifted row keeps its own
//     phase.  The query rows are a 3-D map over q [B, S, d], queries past B
//     zero.  The A stages run a tile ahead of the query rows, across work
//     items: from device memory, they are asked for first.
//   * L2 and shared memory.  Each staged query row feeds TM layout rows, so
//     the query rows cost TN*d*S bytes of L2 per 2*TM*TN*S*d operations.
//     The binding limit was shared memory, though: the A fragments cost 2
//     KB of ldmatrix per m64 K-step whatever N, and wgmma reads B (N x 32
//     bytes) per m64 K-step, so a K-step moves 2048 + 32 N bytes per 2048 N
//     operations.  At N = 64 that is the SM's 128 bytes a clock at the bf16
//     peak; at N = 128, 96.  So bf16 from 64 queries takes 128-query tiles
//     in 128-row subtiles (one m64 tile a warpgroup, two warpgroups; ~4 TB/s
//     of L2 for the query rows at phase 4's measured rate), which ran 1.3x
//     faster than 64 queries in 256-row subtiles, and below 64 queries
//     256-row subtiles (two m64 tiles a warpgroup).  No TMA multicast.  A
//     ring of 4 query-row stages: 2 ran 1.3-1.5x slower.  int8 keeps its query
//     tile resident for the whole work item where its S rows fit (stage
//     1's Sc = 5: 40 KB at 64 queries), so only db rows stream.
//   * Epilogue.  The accumulator fragment is the mma.sync C layout (rows gid
//     and gid + 8 of a warp's 16, queries 2 tig + {0, 1} of each n8), so
//     the shared reduce takes it.  Its barriers are the consumers' own
//     (bar.sync 1), two a subtile.  It overlaps the products of the other
//     blocks on the SM: int8 runs three blocks an SM of one consumer
//     warpgroup each (64-row subtiles; its epilogue is long beside stage
//     1's 20 K-steps a subtile; 1.3x faster than two blocks an SM).  Two
//     accumulators a warpgroup, so that a subtile's epilogue overlaps the
//     next subtile's first row, ran 1.03-1.09x slower than the ordered
//     epilogue, and stay a variant.
//   * A persistent grid of one block per SM (bf16; three for int8) walks
//     the (song group, query tile) work items, song group fastest.
//   * Exactness: int8 sums are exact in s32, so best and argoff equal the
//     float64 plain version bit for bit; bf16 products are exact in f32 and
//     the sums differ from the plain version's by rounding order.
//   Measured and left on the table (PERF.md, tools/torch_kernel_sweep.py):
//   with no epilogue, phase 4 took 13.6 of 19.1 ms and int8 stage 1 7.1 of
//   16.2 (an early form of this kernel), and with no products 15.6 and 14.7:
//   the consumer warps' own instructions (ldmatrix, the epilogue) bound the
//   kernel, not the tensor cores.  Not built: an epilogue warpgroup fed
//   through shared memory, TMA multicast of the query rows, and the A
//   fragments shared between window rows.
//
// float32 (namespace f32k, only for the non-default `db_dtype: float32`):
// the CUDA cores, every product and sum an FFMA in round-to-nearest f32
// (TF32 would change the result, and the tensor cores' f32 accumulation
// rounds toward zero), so the bound is the FMA peak.  One kernel body,
// align_reduce_gemm<f32k::Core>: 256-row subtiles staged with cp.async,
// the query rows in a ring of 2 stages, one barrier per window row.
//   * Register tile: each lane holds RM = 8 layout rows 8 apart and RN (up
//     to 8) queries 4 apart; a warp is 8 row lanes x 4 query lanes, so the
//     8 rows a load instruction reads are consecutive (distinct banks, each
//     row broadcast to 4 lanes) and so are its 4 queries.  A K-step of 4
//     floats is RM + RN 16-byte shared loads for 4*RM*RN FMAs (16 loads per
//     256 FMAs at 8 x 8).  256 threads; TN below 64 takes fewer queries a
//     lane.  (128 queries in 128-row subtiles ran 3% slower, and d = 128
//     fixed at compile time no faster, tools/torch_kernel_sweep.py.)
//   * One block per SM (254 registers at TN = 64, and 212-232 KB of shared
//     memory), so at d = 128 A has one stage, restaged per subtile.  (Copying
//     the next subtile's rows during this one's epilogue ran 1-1.5% slower,
//     tools/torch_kernel_sweep.py.)  Songs per block count the last partial
//     wave.  When S*d outgrows shared memory the window rows are split into
//     chunks, each restaging A, so no S is refused.
//   * Exactness: the same f32 products summed in another order than the
//     plain version's cuBLAS product: |best - plain| <= 7e-5 at S <= 32 and
//     2.7e-4 at S = 119 (chip_smoke.py), against BEST_ATOL = 2e-3.
//
// The plans (query tile, instantiation, songs per group, stages, shared
// memory, grid) are worked out in Python (index/align_kernel.py:tile_plan)
// and checked here.  The source builds in four parts (ALIGN_REDUCE_PART:
// the f32 entry, bf16 chained, bf16 with row sums, int8), one nvcc each.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>


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
inline cudaError_t allow_smem(const void* kernel, long long smem) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// f32's core (f32k::Core) supplies to the body align_reduce_gemm<Core>
//   threads, WARPS_M, WM, WN, TM, TN   block and warp tiles (warp w sits at
//                                      row tile w % WARPS_M, query tile
//                                      w / WARPS_M);
//   NR, NC, XOR0                       the rows and queries of a lane, and
//                                      the lane bits of its row lanes;
//   clear(), row(a, b, p)              zero the tile; add one window row's
//                                      K-sum, A rows from `a` (the A stage
//                                      shifted by the window row), queries
//                                      from `b` (the query stage);
//   row_of, col_of, val, order, unorder  the tile as the per-song reduce
//                                      below takes it.

// ------------------------------------------ the per-song reduce, both routes
// A warp folds its tile of align into the per-song tables vals and offs
// [G][TN] (32-bit words in shared memory) in two passes, with a barrier of
// every thread that writes them in between (see the header).  A tile T
// supplies NR rows and NC queries a lane: row_of(r) (ascending in r, within
// the warp's WM consecutive rows), col_of(c) and val(r, c), the sum (Acc:
// float or int); order(v) and unorder(k) map a sum to its order-preserving
// 32-bit key and back.  The lanes holding one query differ in lane bits X0,
// 2*X0, 4*X0.  Maxima and ties are taken on the sums and only the results
// keyed, which is exact: max and == agree with the keys (-0.0 == +0.0).
template <int NR, int WM>
struct SegRows {
  int sl[NR], off[NR];  // group-local song (-1 past the group) and offset of each row
  int first, songs;     // the song of the warp's first row, and how many its rows
                        // inside the group reach (0 past the group; the same in
                        // every lane)

  // w0: the group-local row of the warp's first row.  Rows in 32 bits (G * R
  // < 2^31, checked at launch): a 64-bit division costs a call per row.
  template <class T>
  __device__ __forceinline__ SegRows(const T& t, unsigned w0, unsigned R, unsigned nrows) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const unsigned gr = w0 + t.row_of(r);
      const unsigned s = gr / R;
      sl[r] = gr < nrows ? (int)s : -1;
      off[r] = gr < nrows ? (int)(gr - s * R) : 0;
    }
    const unsigned w1 = min(w0 + WM, nrows) - 1;
    first = (int)(w0 / R);
    songs = w0 < nrows ? (int)(w1 / R) - first + 1 : 0;
  }
};

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ float vlowest(float) { return __int_as_float(0xff800000); }  // -inf
__device__ __forceinline__ int vlowest(int) { return INT_MIN; }

// One level of seg_max's butterfly over lane bit x, with N columns live:
// keep the half the lane bit selects, the max of both lanes' copies of it.
template <int N, class V, int NC>
__device__ __forceinline__ void fold(V (&v)[NC], int x, int lane, int& base, int& apply) {
  const bool hi = lane & x;
  if constexpr (N > 1) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const V got = __shfl_xor_sync(0xffffffffu, hi ? v[j] : v[j + N / 2], x);
      v[j] = vmax(hi ? v[j + N / 2] : v[j], got);
    }
    base += hi ? N / 2 : 0;
  } else {
    v[0] = vmax(v[0], __shfl_xor_sync(0xffffffffu, v[0], x));
    apply &= !hi;
  }
}

// pass 1: the max of each (song, query)
template <int NR, int NC, int X0, int WM, class T>
__device__ __forceinline__ void seg_max(const T& t, const SegRows<NR, WM>& g, int col0, int tn,
                                        uint32_t* vals, int lane) {
  if (g.songs <= 2) {
    // Per song of the warp's rows (at most two), the 8 row lanes of a query
    // reduce its NC column maxima in a butterfly that halves the columns at
    // each level (a level with one column left reduces it whole): NC/2 +
    // NC/4 + NC/8 shuffles in place of 3 NC.  A lane ends with column j +
    // NC/2 b0 + NC/4 b1 + NC/8 b2 of the halving levels' lane bits b, and
    // applies its atomics where the other bits are 0.  Rows off the song
    // enter as the identity of max.
    using V = decltype(t.val(0, 0));
    const V none = vlowest(V());
    for (int k = 0; k < g.songs; ++k) {
      const int song = g.first + k;
      V v[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        v[c] = g.sl[0] == song ? t.val(0, c) : none;
#pragma unroll
        for (int r = 1; r < NR; ++r) v[c] = vmax(v[c], g.sl[r] == song ? t.val(r, c) : none);
      }
      int base = 0, apply = 1;  // the lane's first column; whether it applies atomics
      fold<NC>(v, X0, lane, base, apply);
      fold<(NC > 1 ? NC / 2 : 1)>(v, 2 * X0, lane, base, apply);
      fold<(NC > 3 ? NC / 4 : 1)>(v, 4 * X0, lane, base, apply);
      if (apply) {
#pragma unroll
        for (int j = 0; j < (NC >= 8 ? NC / 8 : 1); ++j)
          atomicMax(&vals[song * tn + col0 + t.col_of(base + j)], T::order(v[j]));
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {  // one atomic per run of this lane's rows in one song
    const int col = col0 + t.col_of(c);
    int cur = -1;
    auto cv = t.val(0, c);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (g.sl[r] < 0) continue;
      const auto v = t.val(r, c);
      if (g.sl[r] != cur) {
        if (cur >= 0) atomicMax(&vals[cur * tn + col], T::order(cv));
        cur = g.sl[r];
        cv = v;
      } else {
        cv = vmax(cv, v);
      }
    }
    if (cur >= 0) atomicMax(&vals[cur * tn + col], T::order(cv));
  }
}

// pass 2: the largest offset whose sum equals the max, an atomic per run
// only where a row hits
template <int NR, int NC, int WM, class T>
__device__ __forceinline__ void seg_argmax(const T& t, const SegRows<NR, WM>& g, int col0, int tn,
                                           const uint32_t* vals, uint32_t* offs) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = col0 + t.col_of(c);
    int cur = -1, hit = -1;
    auto top = t.val(0, c);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (g.sl[r] < 0) continue;
      if (g.sl[r] != cur) {
        if (hit >= 0) atomicMax(&offs[cur * tn + col], (uint32_t)hit);
        cur = g.sl[r];
        hit = -1;
        top = T::unorder(vals[cur * tn + col]);
      }
      // rows ascend with r: the last hit is the largest offset
      if (t.val(r, c) == top) hit = g.off[r];
    }
    if (hit >= 0) atomicMax(&offs[cur * tn + col], (uint32_t)hit);
  }
}

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
  __device__ __forceinline__ float val(int r, int c) const { return acc[r][c]; }
  static __device__ __forceinline__ uint32_t order(float v) { return float_order(v); }
  static __device__ __forceinline__ float unorder(uint32_t k) { return order_float(k); }
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

    // ---- epilogue of subtile `sub`: the segmented max (see the header)
    const SegRows<NR, WM> rows(core, (unsigned)(sub * TM + warp_m * WM), (unsigned)p.R,
                               (unsigned)grows);
    seg_max<NR, NC, X0>(core, rows, warp_n * WN, TN, vals, lane);
    __syncthreads();
    seg_argmax<NR, NC>(core, rows, warp_n * WN, TN, vals, offs);
    core.clear();
  }

  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < gsongs * TN; e += NTHR) {
    const int col = e / gsongs, s = e - col * gsongs, b = b0 + col;
    if (b < p.B) {
      const long long o = (long long)b * p.n_songs + s0 + s;
      best_out[o] = Core::unorder(vals[s * TN + col]);
      arg_out[o] = (int)offs[s * TN + col];
    }
  }
}

// The f32 kernel: the body under its launch bounds.  It states its one
// block per SM (shared memory allows no more); left to choose, ptxas cut its
// TN = 32 form from 168 to 122 registers to make room for a second block,
// and it ran 5% slower.
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
  auto kernel = align_reduce_f32<Core>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)blocks, Core::threads, smem, stream>>>(
      static_cast<const unsigned char*>(db), static_cast<const unsigned char*>(q),
      static_cast<float*>(best), static_cast<int*>(argoff), p);
  return cudaGetLastError();
}

#if !defined(ALIGN_REDUCE_PART) || ALIGN_REDUCE_PART == 0  // (the f32 entry's part)
// query tile TN -> lane tile (8 rows x RN queries) of 4 x 2 warps: TM 256,
// 256 threads (align_kernel.py's F32_TILE).
inline cudaError_t launch_f32(const void* db, const void* q, void* best, void* argoff,
                              const Plan& p, int tn, long long smem, cudaStream_t s) {
  switch (tn) {
    case 64: return launch<f32k::Core<4, 2, 8, 8>>(db, q, best, argoff, p, smem, s);
    case 32: return launch<f32k::Core<4, 2, 8, 4>>(db, q, best, argoff, p, smem, s);
    case 16: return launch<f32k::Core<4, 2, 8, 2>>(db, q, best, argoff, p, smem, s);
    case 8: return launch<f32k::Core<4, 2, 8, 1>>(db, q, best, argoff, p, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif

// --------------------------------- bf16 and int8: wgmma, TMA and mbarriers
namespace wg {

constexpr int PANEL = 128;  // bytes of a row of one swizzled column panel
constexpr int BOX_MAX = 256;  // rows of a TMA box at most

struct Plan {
  int N, R, S, B, n_songs;
  int G;         // songs per work item
  int sc;        // window rows per A stage (S unless S*d outgrows shared memory)
  int abuf;      // A stages in the ring
  int qs;        // query-row stages in the ring
  int resident;  // the ring holds the query tile's S rows for a whole work item
  int kb;        // bytes of a row rounded up to the K-step (32)
  int panels;    // 128-byte column panels of a row
  int box_rows;  // rows of one db TMA box; n_box of them make an A stage
  int n_box;
  int n_grp;    // song groups
  int n_items;  // work items: song groups x query tiles, song group fastest
};

__host__ __device__ inline long long a_stage_bytes(const Plan& p) {
  return (long long)p.panels * p.n_box * p.box_rows * PANEL;
}
__host__ __device__ inline long long q_stage_bytes(const Plan& p, int tn) {
  return (long long)p.panels * tn * PANEL;
}
// 1 KB to align the stages to the 128-byte swizzle's 1,024-byte atom, the
// A and query rings, vals and offs, and a full and an empty mbarrier a stage
inline long long smem_bytes(const Plan& p, int tn) {
  return 1024 + p.abuf * a_stage_bytes(p) + p.qs * q_stage_bytes(p, tn) + 8LL * p.G * tn +
         16LL * (p.abuf + p.qs);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Spin until the phase of parity `parity` has completed.  The loop is
// inside the asm, so the code after it stays uniform for ptxas.  A wait that
// outlasts 2^24 polls is a deadlock: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "add.u32 n, n, 1;\nsetp.eq.u32 p, n, 0x1000000;\n@p trap;\nbra WAIT;\nDONE:\n}\n"
      ::"r"(bar), "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int x, int y, int z,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}
// the consumer warpgroups' own barrier (0 is __syncthreads')
template <int NCT>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of accumulators across the
// asynchronous products that write them
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// Descriptor of a K-major operand in 128-byte swizzled rows, 8-row groups
// 1,024 bytes apart (stride 64 x 16 bytes), layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// The two element types.  A K-step is 32 bytes of a row in both (k16 bf16,
// k32 int8), and the A fragment of one is the same 16 x 32-byte tile that
// ldmatrix.x4 loads; KC K-steps (a d = 128 row) make one wgmma group.
struct Bf16Op {
  using Acc = float;
  static constexpr int ITEM = 2, KC = 8;
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    if constexpr (N == 8) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
    else if constexpr (N == 16) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7}, "
          "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
            "+f"(d[6]), "+f"(d[7])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
    else if constexpr (N == 32) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
          "%12, %13, %14, %15}, "
          "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
    else if constexpr (N == 64) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
          "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31}, "
          "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
            "+f"(d[30]), "+f"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
    else if constexpr (N == 128) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
          "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
          "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
          "%60, %61, %62, %63}, "
          "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
            "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
            "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
            "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
            "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
  }
  static __device__ __forceinline__ uint32_t order(float v) { return float_order(v); }
  static __device__ __forceinline__ float unorder(uint32_t k) { return order_float(k); }
  static __device__ __forceinline__ float value(uint32_t k) { return order_float(k); }
};

struct Int8Op {
  using Acc = int;
  static constexpr int ITEM = 1, KC = 4;
  template <int N>
  static __device__ __forceinline__ void mma(int (&d)[N / 2], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    if constexpr (N == 8) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
          "{%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, %8, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
    else if constexpr (N == 16) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7}, "
          "{%8, %9, %10, %11}, %12, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
            "+r"(d[6]), "+r"(d[7])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
    else if constexpr (N == 32) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
          "%12, %13, %14, %15}, "
          "{%16, %17, %18, %19}, %20, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
            "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
            "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
    else if constexpr (N == 64) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
          "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31}, "
          "{%32, %33, %34, %35}, %36, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
            "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
            "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
            "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
            "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
            "+r"(d[30]), "+r"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
    else if constexpr (N == 128) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
          "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
          "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
          "%60, %61, %62, %63}, "
          "{%64, %65, %66, %67}, %68, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
            "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
            "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
            "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
            "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
            "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
            "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
            "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
            "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
            "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
            "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
    }
  }
  static __device__ __forceinline__ uint32_t order(int v) {
    return static_cast<uint32_t>(v) ^ 0x80000000u;
  }
  static __device__ __forceinline__ int unorder(uint32_t k) {
    return static_cast<int>(k ^ 0x80000000u);
  }
  static __device__ __forceinline__ float value(uint32_t k) {  // exact int, rounded once
    return __int2float_rn(static_cast<int>(k ^ 0x80000000u));
  }
};

// One warp's 16-row slice of an m64 accumulator: lanes hold rows gid and
// gid + 8 and queries 8 j + 2 tig + {0, 1} of each n8 block j, the
// mma.sync C layout, so the segmented max takes it as it takes f32's tile.
template <class Op, int TN>
struct Frag {
  using Acc = typename Op::Acc;
  const Acc (&d)[TN / 2];
  int gid, tig;
  __device__ __forceinline__ int row_of(int r) const { return 8 * r + gid; }
  __device__ __forceinline__ int col_of(int c) const { return (c >> 1) * 8 + 2 * tig + (c & 1); }
  __device__ __forceinline__ Acc val(int r, int c) const {
    return d[(c >> 1) * 4 + 2 * r + (c & 1)];
  }
  static __device__ __forceinline__ uint32_t order(Acc v) { return Op::order(v); }
  static __device__ __forceinline__ Acc unorder(uint32_t k) { return Op::unorder(k); }
};

template <int V>
using Int = std::integral_constant<int, V>;

// The kernel: a persistent grid of one block per SM walks the work items
// (song group, query tile), song group fastest.  NWG warpgroups consume, one
// more loads (one thread).  Each consumer warpgroup owns MT m64 tiles of an
// M-subtile of TM = 64 MT NWG layout rows and all TN queries.  RS: the
// per-row partial sums (bf16 past S*d = CHAIN_MAX_SD).  PP: two
// accumulators, so a subtile's epilogue runs while the next one's first
// window row is on the tensor cores.  BPS blocks per SM: with two, one
// block's epilogue runs while the other's products do.
template <class Op, int NWG, int BPS, bool RS, int MT, int TN, bool PP>
__global__ void __launch_bounds__((NWG + 1) * 128, BPS)
align_reduce_wgmma(const __grid_constant__ CUtensorMap tm_db,
                   const __grid_constant__ CUtensorMap tm_q, float* __restrict__ best_out,
                   int* __restrict__ arg_out, const Plan p) {
  static_assert(!(RS && PP), "row sums keep one total");
  using Acc = typename Op::Acc;
  constexpr int TM = 64 * MT * NWG, NCT = NWG * 128, KC = Op::KC, NREG = TN / 2;
  constexpr int NACC = PP ? 2 : 1;
  // consumer registers after setmaxnreg: what the launch gives the block
  // (65,536 / threads / BPS a thread, rounded down to 8: 168 at 384 threads
  // and one block an SM, 128 or 80 at 256 threads and two or three; at 256
  // threads and one block, ptxas takes 232), less the loading warpgroup's
  // 40 or 24
  constexpr int REGS = BPS == 3 ? 136 : 232;
  constexpr int PW = PANEL / Op::ITEM;  // elements of a panel row

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a_bytes = (uint32_t)a_stage_bytes(p), q_bytes = (uint32_t)q_stage_bytes(p, TN);
  const uint32_t sA = smem_u32(smem);                   // [abuf][panels][n_box * box_rows][128]
  const uint32_t sQ = sA + p.abuf * a_bytes;            // [qs][panels][TN][128]
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem + p.abuf * a_bytes + p.qs * q_bytes);
  uint32_t* offs = vals + p.G * TN;                     // vals, offs: [G][TN]
  const uint32_t full_a = smem_u32(offs + p.G * TN);    // mbarriers, 8 bytes each
  const uint32_t empty_a = full_a + 8 * p.abuf, full_q = empty_a + 8 * p.abuf,
                 empty_q = full_q + 8 * p.qs;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int j = 0; j < p.abuf; ++j) {
      mbar_init(full_a + 8 * j, 1);
      mbar_init(empty_a + 8 * j, NCT);
    }
    for (int j = 0; j < p.qs; ++j) {
      mbar_init(full_q + 8 * j, 1);
      mbar_init(empty_q + 8 * j, NCT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < 2 * p.G * TN; e += blockDim.x) vals[e] = 0u;  // vals and offs
  __syncthreads();
  const int n_chunk = (p.S + p.sc - 1) / p.sc;
  const int nk = p.kb / 32, nkc = (nk + KC - 1) / KC;  // K-steps a row, groups a row
  const uint32_t panel_a = (uint32_t)p.n_box * p.box_rows * PANEL;

  // the warpgroup, warp-uniform as ptxas sees it (a branch on threadIdx
  // would leave the products on a divergent path, and ptxas serialises them)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == NWG) {
    // ------------------------------------------------------- the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BPS == 1 ? 40 : 24) : "memory");
    if (tid == NCT) {
      int ai = 0, aph = 0, qi = 0, qph = 0, prev_qt = -1;
      auto load_q = [&](int i, int b0) {  // window row i of the query tile
        mbar_wait(empty_q + 8 * qi, qph ^ 1);
        mbar_expect(full_q + 8 * qi, q_bytes);
        for (int c = 0; c < p.panels; ++c)
          tma_3d(sQ + qi * q_bytes + c * TN * PANEL, &tm_q, c * PW, i, b0, full_q + 8 * qi);
        if (++qi == p.qs) qi = 0, qph ^= 1;
      };
      // The A stages run abuf - 1 tiles (subtile, window-row chunk) ahead of
      // the query rows, across work items: a stage's rows come from device
      // memory, so it is asked for before the rows of the tile before it.
      int a_item = blockIdx.x, a_sub = 0, a_ch = 0;  // the next A stage to load
      long long a_next = 0, t = 0;                   // its tile, and this one
      auto load_a = [&]() {
        const int qt = a_item / p.n_grp, s0 = (a_item - qt * p.n_grp) * p.G;
        const int g0 = s0 * p.R + a_sub * TM + a_ch * p.sc;
        mbar_wait(empty_a + 8 * ai, aph ^ 1);
        mbar_expect(full_a + 8 * ai, a_bytes);
        for (int c = 0; c < p.panels; ++c)
          for (int x = 0; x < p.n_box; ++x)
            tma_2d(sA + ai * a_bytes + c * panel_a + x * p.box_rows * PANEL, &tm_db, c * PW,
                   g0 + x * p.box_rows, full_a + 8 * ai);
        if (++ai == p.abuf) ai = 0, aph ^= 1;
        if (++a_ch == n_chunk) {
          a_ch = 0;
          if (++a_sub * TM >= min(p.G, p.n_songs - s0) * p.R) a_sub = 0, a_item += gridDim.x;
        }
        ++a_next;
      };
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
        const int qt = item / p.n_grp, s0 = (item - qt * p.n_grp) * p.G;
        const int n_sub = (min(p.G, p.n_songs - s0) * p.R + TM - 1) / TM;
        if (p.resident && qt != prev_qt)
          for (int i = 0; i < p.S; ++i) load_q(i, qt * TN);
        prev_qt = qt;
        for (int sub = 0; sub < n_sub; ++sub)
          for (int ch = 0; ch < n_chunk; ++ch, ++t) {
            while (a_next < t + p.abuf && a_item < p.n_items) load_a();
            if (!p.resident)
              for (int i = ch * p.sc; i < min((ch + 1) * p.sc, p.S); ++i) load_q(i, qt * TN);
          }
      }
    }
  } else {
    // ------------------------------------------------------ the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS) : "memory");
    const int wgi = role, wl = (tid >> 5) & 3, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    Acc acc[NACC][MT][NREG];
    Acc part[RS ? 2 : 1][MT][NREG];  // RS: window row i's K-sum, in part[i & 1]
    uint32_t a[2][MT][KC][4];        // the A fragments of two groups
    if constexpr (RS) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NREG; ++j) acc[0][mt][j] = Acc(0);
    }
    // this lane's ldmatrix row within an A stage, before the window shift:
    // lanes 0-15 give rows 0-15 of the warp's slice at K bytes 0-15, lanes
    // 16-31 the same rows at bytes 16-31
    const int lrow = (wgi * MT) * 64 + 16 * wl + (lane & 15), lhalf = lane >> 4;

    struct Done {  // what retiring a group leaves to do, in two registers
      int bits, sub;  // row_end | sub_end << 1 | rpar << 2 | apar << 3 | qslot << 4
      __device__ __forceinline__ int row_end() const { return bits & 1; }
      __device__ __forceinline__ int sub_end() const { return bits & 2; }
      __device__ __forceinline__ int rpar() const { return bits & 4; }
      __device__ __forceinline__ int apar() const { return bits & 8; }
      __device__ __forceinline__ int qslot() const { return bits >> 4; }
    };
    int ai = 0, aph = 0, qi = 0, qph = 0, prev_qt = -1, res_ph = 1;

    // the epilogue of subtile `sub` of accumulator A: the two-pass segmented
    // max of every warp's slices, between barriers of the consumers
    auto epilogue = [&](Acc (&A)[MT][NREG], int sub, int grows) {
      consumers_sync<NCT>();  // the previous subtile's pass 2 and the tables' reset done
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const Frag<Op, TN> t{A[mt], gid, tig};
        const SegRows<2, 16> rows(t, (unsigned)(sub * TM + lrow - (lane & 15) + mt * 64),
                                  (unsigned)p.R, (unsigned)grows);
        seg_max<2, TN / 4, 4>(t, rows, 0, TN, vals, lane);
      }
      consumers_sync<NCT>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const Frag<Op, TN> t{A[mt], gid, tig};
        const SegRows<2, 16> rows(t, (unsigned)(sub * TM + lrow - (lane & 15) + mt * 64),
                                  (unsigned)p.R, (unsigned)grows);
        seg_argmax<2, TN / 4>(t, rows, 0, TN, vals, offs);
      }
    };
    auto retire = [&](const Done& dn, int grows) {
      if (dn.row_end()) {
        if constexpr (RS) {  // add the row's K-sum, rounding to nearest
          auto add = [&](auto R) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              pin(part[decltype(R)::value][mt]);
#pragma unroll
              for (int j = 0; j < NREG; ++j) acc[0][mt][j] += part[decltype(R)::value][mt][j];
            }
          };
          if (dn.rpar()) add(Int<1>{}); else add(Int<0>{});
        }
        if (!p.resident) mbar_arrive(empty_q + 8 * dn.qslot());
      }
      if (dn.sub_end()) {
        if (NACC == 2 && dn.apar()) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) pin(acc[NACC - 1][mt]);
          epilogue(acc[NACC - 1], dn.sub, grows);
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) pin(acc[0][mt]);
          epilogue(acc[0], dn.sub, grows);
        }
        if constexpr (RS) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < NREG; ++j) acc[0][mt][j] = Acc(0);
        }
      }
    };

    for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
      const int qt = item / p.n_grp, s0 = (item - qt * p.n_grp) * p.G;
      const int gsongs = min(p.G, p.n_songs - s0), grows = gsongs * p.R;
      const int n_sub = (grows + TM - 1) / TM;
      if (p.resident && qt != prev_qt) res_ph ^= 1;
      prev_qt = qt;
      int g = 0;  // groups issued in this item
      Done pend{};
      bool pending = false;
      for (int sub = 0; sub < n_sub; ++sub)
        for (int ch = 0; ch < n_chunk; ++ch) {
          const int i0 = ch * p.sc, i1 = min(i0 + p.sc, p.S);
          const uint32_t stage = sA + ai * a_bytes;
          mbar_wait(full_a + 8 * ai, aph);
          for (int i = i0; i < i1; ++i) {
            const int qslot = p.resident ? i : qi;
            mbar_wait(full_q + 8 * qslot, p.resident ? res_ph : qph);
            const uint32_t qbase = sQ + qslot * q_bytes;
            const int r = i - i0 + lrow;  // the window shift is a row offset
            for (int kc = 0; kc < nkc; ++kc) {
              const Done cur{(kc == nkc - 1) | (kc == nkc - 1 && i == p.S - 1) << 1 |
                                 (i & 1) << 2 | (sub & 1) << 3 | qslot << 4,
                             sub};
              // one group: KC K-steps of window row i into the accumulator
              auto group = [&](auto SET, auto AP, auto RP) {
                constexpr int set = decltype(SET)::value, ap = decltype(AP)::value,
                              rp = decltype(RP)::value;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                  const int rr = r + mt * 64;
                  const uint32_t row = stage + rr * PANEL;
#pragma unroll
                  for (int k = 0; k < KC; ++k) {
                    const int kk = (kc * KC + k) * 32;
                    if (kk < p.kb)
                      ldsm_x4(a[set][mt][k], row + (kk >> 7) * panel_a +
                                                 (((((kk & 127) >> 4) + lhalf) ^ (rr & 7)) << 4));
                  }
                }
                if (i == i1 - 1 && kc == nkc - 1) mbar_arrive(empty_a + 8 * ai);
                auto& D = RS ? part[rp] : acc[ap];
                uint64_t desc[KC];  // B: the query stage's K-steps, set before the fence
#pragma unroll
                for (int k = 0; k < KC; ++k) {
                  const int kk = (kc * KC + k) * 32;
                  desc[k] = desc_sw128(qbase + (kk >> 7) * TN * PANEL + (kk & 127));
                }
                const int first = kc > 0 || (!RS && i > 0);  // 0: the sum starts here
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) pin(D[mt]);
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < KC; ++k) {
                  if ((kc * KC + k) * 32 < p.kb) {
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                      Op::template mma<TN>(D[mt], a[set][mt][k], desc[k], k > 0 || first);
                  }
                }
                wgmma_commit();
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) pin(D[mt]);
              };
              const int apar = PP ? (sub & 1) : 0, rpar = RS ? (i & 1) : 0;
              if (g & 1) {
                if (apar) group(Int<1>{}, Int<NACC - 1>{}, Int<0>{});
                else if (rpar) group(Int<1>{}, Int<0>{}, Int<RS ? 1 : 0>{});
                else group(Int<1>{}, Int<0>{}, Int<0>{});
              } else {
                if (apar) group(Int<0>{}, Int<NACC - 1>{}, Int<0>{});
                else if (rpar) group(Int<0>{}, Int<0>{}, Int<RS ? 1 : 0>{});
                else group(Int<0>{}, Int<0>{}, Int<0>{});
              }
              ++g;
              if (pending) {  // two groups in flight: retire the older
                wgmma_wait<1>();
                retire(pend, grows);
              }
              pend = cur;
              pending = true;
              if (!PP && cur.sub_end()) {  // the next group writes this accumulator
                wgmma_wait<0>();
                retire(cur, grows);
                pending = false;
              }
            }
            if (!p.resident && ++qi == p.qs) qi = 0, qph ^= 1;
          }
          if (++ai == p.abuf) ai = 0, aph ^= 1;
        }
      if (pending) {
        wgmma_wait<0>();
        retire(pend, grows);
      }
      // write the item's best and argoff in [B, n_songs] order; reset the tables
      consumers_sync<NCT>();
      const int b0 = qt * TN;
      for (int e = tid; e < gsongs * TN; e += NCT) {
        const int col = e / gsongs, s = e - col * gsongs, b = b0 + col;
        if (b < p.B) {
          const long long o = (long long)b * p.n_songs + s0 + s;
          best_out[o] = Op::value(vals[s * TN + col]);
          arg_out[o] = (int)offs[s * TN + col];
        }
        vals[s * TN + col] = 0u;
        offs[s * TN + col] = 0u;
      }
      // a resident query tile is released when the next item takes another
      const int next = item + gridDim.x;
      if (p.resident && next < p.n_items && next / p.n_grp != qt)
        for (int j = 0; j < p.S; ++j) mbar_arrive(empty_q + 8 * j);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library links cudart alone.  A missing entry point is an error.
inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (!found) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = found;
  return cudaSuccess;
}

// A tensor map of `rank` dims (innermost first) read in 128-byte swizzled
// boxes; out-of-bounds elements read as zero.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int item, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled encode;
  cudaError_t e = encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(
      map, item == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Op, int NWG, int BPS, bool RS, int MT, int TN, bool PP>
cudaError_t launch(const void* db, const void* q, void* best, void* argoff, int d,
                   const Plan& p, int blocks, long long smem, cudaStream_t stream) {
  constexpr int TM = 64 * MT * NWG;
  const int rows = TM + p.sc - 1;  // an A stage: the subtile and its window
  if (p.n_box != (rows + BOX_MAX - 1) / BOX_MAX ||
      p.box_rows != ((rows + p.n_box - 1) / p.n_box + 7) / 8 * 8 || smem_bytes(p, TN) != smem)
    return cudaErrorInvalidValue;
  const int item = Op::ITEM;
  CUtensorMap map_db, map_q;
  const cuuint64_t db_dims[2] = {(cuuint64_t)d, (cuuint64_t)p.N};
  const cuuint64_t db_strides[1] = {(cuuint64_t)d * item};
  const cuuint32_t db_box[2] = {(cuuint32_t)(PANEL / item), (cuuint32_t)p.box_rows};
  cudaError_t e = tensor_map(&map_db, db, item, 2, db_dims, db_strides, db_box);
  if (e != cudaSuccess) return e;
  const cuuint64_t q_dims[3] = {(cuuint64_t)d, (cuuint64_t)p.S, (cuuint64_t)p.B};
  const cuuint64_t q_strides[2] = {(cuuint64_t)d * item, (cuuint64_t)d * item * p.S};
  const cuuint32_t q_box[3] = {(cuuint32_t)(PANEL / item), 1, (cuuint32_t)TN};
  e = tensor_map(&map_q, q, item, 3, q_dims, q_strides, q_box);
  if (e != cudaSuccess) return e;
  auto kernel = align_reduce_wgmma<Op, NWG, BPS, RS, MT, TN, PP>;
  e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, (NWG + 1) * 128, smem, stream>>>(map_db, map_q, static_cast<float*>(best),
                                                    static_cast<int*>(argoff), p);
  return cudaGetLastError();
}

// The instantiations, (dtype, row sums, m64 tiles a warpgroup, ping-pong
// accumulators, query tile): align_kernel.py's TILE_CONFIGS (the plans) and
// WGMMA_VARIANTS (more for tools/torch_kernel_sweep.py) name the same set.
template <class Op, int NWG, int BPS, bool RS, int MT, bool PP, int TN>
constexpr bool built() {
  if (NWG == 1)  // int8: 64-row subtiles at three (or two) blocks an SM; d > 1536
    return Op::ITEM == 1 && MT == 1 && !PP &&
           ((BPS == 3 && TN <= 64) || (BPS == 2 && TN == 64) || (BPS == 1 && TN == 8));
  if (Op::ITEM == 2 && RS) return BPS == 1 && MT == 1 && !PP && TN <= 64;
  if (Op::ITEM == 2)
    return BPS == 1 && ((MT == 2 && !PP && TN <= 32) || (MT == 1 && PP && TN == 64) ||
                        (MT == 1 && !PP && TN >= 64));
  return BPS == 1 && MT == 1 && ((PP && TN == 64) || (!PP && TN == 128));
}

template <class Op, int NWG, int BPS, bool RS, int MT, bool PP>
cudaError_t launch_tn(const void* db, const void* q, void* best, void* argoff, int d,
                      const Plan& p, int tn, int blocks, long long smem, cudaStream_t s) {
  auto go = [&](auto TN) -> cudaError_t {
    constexpr int n = decltype(TN)::value;
    if constexpr (built<Op, NWG, BPS, RS, MT, PP, n>())
      return launch<Op, NWG, BPS, RS, MT, n, PP>(db, q, best, argoff, d, p, blocks, smem, s);
    return cudaErrorInvalidValue;
  };
  switch (tn) {
    case 128: return go(Int<128>{});
    case 64: return go(Int<64>{});
    case 32: return go(Int<32>{});
    case 16: return go(Int<16>{});
    case 8: return go(Int<8>{});
    default: return cudaErrorInvalidValue;
  }
}

// The plan of a bf16/int8 launch, checked; 0 or a cudaError_t.  db and q
// 16-byte aligned, rows of d * item bytes a multiple of 16 (the wrapper pads
// d).  tn, nwg, mt, G, sc, abuf, qs, resident and blocks are the tile plan
// of index/align_kernel.py:tile_plan.
inline int make_plan(Plan& p, const void* db, const void* q, long long N, int d, int R, int S,
                     int B, int n_songs, int item, int tn, int nwg, int mt, int G, int sc,
                     int abuf, int qs, int resident, int blocks) {
  if (d <= 0 || (d * item) % 16 || R <= 0 || S <= 0 || reinterpret_cast<uintptr_t>(db) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return cudaErrorInvalidValue;
  const int tm = 64 * mt * nwg;
  // TMA coordinates are 32-bit: every row an A stage reads, below 2^31
  if (N > INT_MAX || (long long)n_songs * R + tm + S > INT_MAX || G <= 0 ||
      (long long)G * R + 512 > INT_MAX || sc <= 0 || sc > S || abuf < 1 ||
      qs < (resident ? 1 : 2) || (resident && qs != S))
    return cudaErrorInvalidValue;
  p.N = (int)N;
  p.R = R;
  p.S = S;
  p.B = B;
  p.n_songs = n_songs;
  p.G = G;
  p.sc = sc;
  p.abuf = abuf;
  p.qs = qs;
  p.resident = resident;
  p.kb = (d * item + 31) / 32 * 32;
  p.panels = (p.kb + PANEL - 1) / PANEL;
  const int rows = tm + sc - 1;
  p.n_box = (rows + BOX_MAX - 1) / BOX_MAX;
  p.box_rows = ((rows + p.n_box - 1) / p.n_box + 7) / 8 * 8;
  p.n_grp = (n_songs + G - 1) / G;
  const long long items = (long long)p.n_grp * ((B + tn - 1) / tn);
  if (items > INT_MAX || blocks < 1 || blocks > items) return cudaErrorInvalidValue;
  p.n_items = (int)items;
  return cudaSuccess;
}

}  // namespace wg

}  // namespace

extern "C" {

// bf16 (chained sums, or row sums) and int8 (int32 sums) on the tensor
// cores: one entry each, built apart (ALIGN_REDUCE_PART 1-3, with the f32
// entry 0) so that nvcc compiles them in parallel.  Arguments: see
// wg::make_plan; bps and pp pick the instantiation with nwg and mt.
#define WG_ARGS                                                                             \
  const void *db, const void *q, void *best, void *argoff, long long N, int d, int R, int S, \
      int B, int n_songs, int tn, int nwg, int bps, int mt, int pp, int G, int sc, int abuf,  \
      int qs, int resident, int blocks, long long smem, void *stream
#define WG_PLAN(ITEM)                                                                     \
  if (B <= 0 || n_songs <= 0) return cudaSuccess;                                         \
  wg::Plan p;                                                                             \
  const int e = wg::make_plan(p, db, q, N, d, R, S, B, n_songs, ITEM, tn, nwg, mt, G, sc,  \
                              abuf, qs, resident, blocks);                                \
  if (e != cudaSuccess) return e;                                                         \
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_LAUNCH(OP, NWG, BPS, RS, MT, PP)                                                \
  if (nwg == NWG && bps == BPS && mt == MT && !!pp == PP)                                  \
    return wg::launch_tn<OP, NWG, BPS, RS, MT, PP>(db, q, best, argoff, d, p, tn, blocks, \
                                                   smem, s);

#if !defined(ALIGN_REDUCE_PART) || ALIGN_REDUCE_PART == 1
int align_reduce_bf16_launch(WG_ARGS) {
  WG_PLAN(2)
  WG_LAUNCH(wg::Bf16Op, 2, 1, false, 2, false)
  WG_LAUNCH(wg::Bf16Op, 2, 1, false, 1, true)
  WG_LAUNCH(wg::Bf16Op, 2, 1, false, 1, false)
  return cudaErrorInvalidValue;
}
#endif

#if !defined(ALIGN_REDUCE_PART) || ALIGN_REDUCE_PART == 2
int align_reduce_bf16_rowsum_launch(WG_ARGS) {
  WG_PLAN(2)
  WG_LAUNCH(wg::Bf16Op, 2, 1, true, 1, false)
  return cudaErrorInvalidValue;
}
#endif

#if !defined(ALIGN_REDUCE_PART) || ALIGN_REDUCE_PART == 3
int align_reduce_int8_launch(WG_ARGS) {
  WG_PLAN(1)
  WG_LAUNCH(wg::Int8Op, 1, 3, false, 1, false)
  WG_LAUNCH(wg::Int8Op, 1, 2, false, 1, false)
  WG_LAUNCH(wg::Int8Op, 1, 1, false, 1, false)
  WG_LAUNCH(wg::Int8Op, 2, 1, false, 1, true)
  WG_LAUNCH(wg::Int8Op, 2, 1, false, 1, false)
  return cudaErrorInvalidValue;
}
#endif
#undef WG_ARGS
#undef WG_PLAN
#undef WG_LAUNCH

#if !defined(ALIGN_REDUCE_PART) || ALIGN_REDUCE_PART == 0
// f32 on the CUDA cores.  tn, tm, G, sc, abuf, ch and smem are the tile plan
// of index/align_kernel.py:tile_plan.  Returns a cudaError_t (0 = launched).
int align_reduce_f32_launch(const void* db, const void* q, void* best, void* argoff,
                            long long N, int d, int R, int S, int B, int n_songs, int tn, int tm,
                            int G, int sc, int abuf, int ch, long long smem, void* stream) {
  if (B <= 0 || n_songs <= 0) return cudaSuccess;
  if (d <= 0 || d % 4 || R <= 0 || S <= 0) return cudaErrorInvalidValue;
  Plan p;
  p.N = N;
  p.rb = 4 * d;
  p.kb = (p.rb + 15) / 16 * 16;  // K-step: a float4
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
      (abuf != 1 && abuf != 2) || (ch != 4 && ch != 8 && ch != 16) || p.rb % ch ||
      reinterpret_cast<uintptr_t>(db) % ch || reinterpret_cast<uintptr_t>(q) % ch)
    return cudaErrorInvalidValue;
  return launch_f32(db, q, best, argoff, p, tn, smem, static_cast<cudaStream_t>(stream));
}

const char* align_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif

}  // extern "C"
