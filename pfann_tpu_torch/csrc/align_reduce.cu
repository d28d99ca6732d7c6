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
// serving shapes that is thousands of operations per byte, so the tensor
// cores are the bound.  Phase 4 of chip_smoke.py (10k songs, R = 152,
// N = 1.52M, d = 128, S = 19, B = 1024, bf16) is 7.57e12 FLOP, 7.65 ms at
// 989 TFLOP/s (its 476 MB of inputs and outputs take 0.14 ms at 3.35 TB/s);
// the screened engine's int8 stage 1 at 100k songs (Rc = 40, Sc = 5,
// B = 1024) is 5.24e12 operations, 2.65 ms at 1,979 TOP/s.
//
// Design: a GEMM over global rows.  M = layout rows, N = queries, K = S*d.
// Row g of the A operand is db rows g .. g+S-1 laid end to end: a row
// stride of d against a row length of S*d, so there is no im2col copy.  A
// block owns G whole songs and walks their G*R rows in M-subtiles of TM
// rows; for each it stages TM + S - 1 db rows in shared memory once, and
// the K-step for window row i reads its A fragments (ldmatrix) from rows
// i .. i+TM-1 of that one stage: ldmatrix takes one row address per lane,
// so the shift by i costs nothing.  The B operand of step i is window row
// i of a tile of TN queries (TN x d, K-major as stored), staged with
// cp.async in a ring of 2 stages, so that row i+1 loads while row i
// multiplies.  The A stage is double-buffered the same way (the next
// subtile's rows load during this one's S steps) unless that would leave
// one block per SM where one A stage leaves two (at the serving shapes,
// bf16 at TN >= 32).
//   * Tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32, m16n8k32
//     s8 x s8 -> s32.  In bytes both fragments are the same 16 x 32-byte A
//     tile and 32-byte x 8 B tile, so one kernel body serves both; a K-step
//     is 32 bytes of a row, and rows are zero-filled up to a multiple of 32
//     bytes while staging (any d that is a multiple of 4).  Staged rows are
//     32k + 16 bytes apart, so the 8 rows an ldmatrix phase reads fall in
//     distinct banks.
//   * The accumulator is align itself.  The epilogue of each subtile folds
//     it into two 32-bit words per (song of the group, query) in shared
//     memory, in two passes: the max of the order-preserving value bits
//     (atomicMax), a barrier, then the largest offset whose value equals
//     that max (atomicMax).  A song's rows in a later subtile have later
//     offsets, so pass 2 replaces an earlier subtile's offset exactly when
//     this subtile raised the max or tied it: ties go to the later offset
//     by construction.  (One packed 64-bit key would take one pass, but a
//     64-bit shared atomicMax compiles to a compare-and-swap loop; the two
//     passes made the int8 stage 1 1.2x faster,
//     tools/torch_kernel_sweep.py.)  Where all of a warp's rows lie in one
//     song, the 8 lanes that hold a column reduce it with shuffles and one
//     lane applies the atomic; else each thread applies one per run of its
//     rows in one song.  f32 values map -0.0 to +0.0 first (a plain >=
//     treats them as equal, and all-zero regions tie on every offset).
//     best and argoff are written once per block, in [B, n_songs] order.
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
//     faster that way (tools/torch_kernel_sweep.py).  A group of G songs
//     wastes only the rows rounding its G*R up to TM.  The plan (TN, row
//     sums, G, window rows per A stage, A stages, copy width, shared
//     memory) is worked out in Python (index/align_kernel.py:tile_plan)
//     and checked here.  When S*d outgrows shared memory the window rows
//     are split into chunks, each restaging A, so no S is refused.
// Left on the table: wgmma (its A operand from registers filled by the
// same shifted ldmatrix loads, B from shared memory; a version that awaited
// each window row's products before the next barrier ran 1.4x slower at
// phase 4, so it needs rows in flight), TMA for the stages, warp
// specialisation, and a persistent grid.
//
// float32 (dtype code 0, only for the non-default `db_dtype: float32`)
// keeps the CUDA-core kernel of the first port: the tensor cores would
// compute it in TF32, which is a different result.  One block of 256
// threads per (song, 64-query tile) walks the song's offsets in tiles of
// 64 with f32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>


namespace {

// ------------------------------------------------------------------ f32
namespace f32k {

constexpr int TO = 64;   // offsets per tile
constexpr int TB = 64;   // queries per block
constexpr int NT = 256;  // threads: 16 offset groups x 16 query groups
constexpr int RT = 4;    // offsets per thread: o0 + ty*RT + r
constexpr int CT = 4;    // queries per thread: b0 + tx + 16*c

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

size_t smem_bytes(int d, int S) {
  size_t tiles = ((size_t)(TO + S - 1) + TB) * (round4(d) + 4) * 4;
  size_t reduce = (size_t)16 * TB * 8;
  return tiles > reduce ? tiles : reduce;
}

__device__ __forceinline__ float mac4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

__global__ void __launch_bounds__(NT)
align_reduce_f32(const float* __restrict__ db, const float* __restrict__ q,
                 float* __restrict__ best_out, int* __restrict__ arg_out,
                 long long N, int d, int R, int S, int B, int n_songs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int dp = round4(d);  // staged floats per row; zeros past d
  const int ld = dp + 4;     // keeps rows 16-byte aligned, shifts banks
  const int rows = TO + S - 1;
  float* sdb = smem;             // [rows][ld]
  float* sq = smem + rows * ld;  // [TB][ld]

  const int song = blockIdx.x;
  const int b0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long base = (long long)song * R;

  float run_best[CT];
  int run_arg[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    run_best[c] = -INFINITY;
    run_arg[c] = -1;
  }

  for (int o0 = 0; o0 < R; o0 += TO) {
    __syncthreads();  // the previous tile's readers are done with sdb
    for (int e = tid; e < rows * dp; e += NT) {
      const int r = e / dp, k = e - r * dp;
      const long long g = base + o0 + r;
      sdb[r * ld + k] = (g < N && k < d) ? db[g * d + k] : 0.f;
    }

    float acc[RT][CT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;

    for (int i = 0; i < S; ++i) {
      __syncthreads();  // sdb staged; the previous sq consumed
      for (int e = tid; e < TB * dp; e += NT) {
        const int b = e / dp, k = e - b * dp;
        const int gb = b0 + b;
        sq[b * ld + k] = (gb < B && k < d) ? q[((long long)gb * S + i) * d + k] : 0.f;
      }
      __syncthreads();
      const float* arow = sdb + (ty * RT + i) * ld;
      const float* qrow = sq + tx * ld;
#pragma unroll 2
      for (int k = 0; k < dp; k += 4) {
        float4 a[RT], bq[CT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          a[r] = *reinterpret_cast<const float4*>(arow + r * ld + k);
#pragma unroll
        for (int c = 0; c < CT; ++c)
          bq[c] = *reinterpret_cast<const float4*>(qrow + 16 * c * ld + k);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[r][c] = mac4(a[r], bq[c], acc[r][c]);
      }
    }

    // offsets grow with r and with o0, so >= keeps the later one on ties
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int o = o0 + ty * RT + r;
      if (o < R) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          if (acc[r][c] >= run_best[c]) {
            run_best[c] = acc[r][c];
            run_arg[c] = o;
          }
        }
      }
    }
  }

  __syncthreads();
  float* red_v = smem;                                    // [16][TB]
  int* red_o = reinterpret_cast<int*>(smem + 16 * TB);  // [16][TB]
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    red_v[ty * TB + tx + 16 * c] = run_best[c];
    red_o[ty * TB + tx + 16 * c] = run_arg[c];
  }
  __syncthreads();
  if (tid < TB) {
    float bv = red_v[tid];
    int bo = red_o[tid];
    for (int y = 1; y < 16; ++y) {
      const float v = red_v[y * TB + tid];
      const int o = red_o[y * TB + tid];
      if (v > bv || (v == bv && o > bo)) {
        bv = v;
        bo = o;
      }
    }
    const int gb = b0 + tid;
    if (gb < B) {
      best_out[(long long)gb * n_songs + song] = bv;
      arg_out[(long long)gb * n_songs + song] = bo;
    }
  }
}

cudaError_t launch(const void* db, const void* q, void* best, void* argoff, long long N,
                   int d, int R, int S, int B, int n_songs, cudaStream_t stream) {
  if ((B + TB - 1) / TB > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(d, S);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(align_reduce_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_songs, (B + TB - 1) / TB);
  align_reduce_f32<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(db), static_cast<const float*>(q),
      static_cast<float*>(best), static_cast<int*>(argoff), N, d, R, S, B, n_songs);
  return cudaGetLastError();
}

}  // namespace f32k

// ------------------------------------------------- bf16 and int8: mma.sync
namespace mma {

struct Plan {
  long long N;  // db rows
  int rb;       // bytes of a db / query row: d * itemsize
  int kb;       // rb rounded up to 32: the K bytes of one window row
  int lds;      // staged row stride in bytes: kb + 16
  int R, S, B, n_songs;
  int tm;       // layout rows per M-subtile (of the instantiation)
  int G;        // songs per block
  int sc;       // window rows per A stage (S unless S*d outgrows shared memory)
  int abuf;     // A stages: 2 (the next one loads during this one) or 1
  int ch;       // bytes per cp.async: 16, 8 or 4
};

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
  // order-preserving bits; -0.0 ranks as +0.0
  static __device__ __forceinline__ uint32_t order(float v) {
    uint32_t u = __float_as_uint(v);
    if ((u << 1) == 0) u = 0;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  static __device__ __forceinline__ float value(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
  }
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

template <int WARPS_M, int WARPS_N, int MT, int NT>
struct Tile {
  static constexpr int threads = WARPS_M * WARPS_N * 32;
  static constexpr int WM = MT * 16, WN = NT * 8;
  static constexpr int TM = WARPS_M * WM, TN = WARPS_N * WN;
};

constexpr int NST = 2;  // query-row stages: a ring of 2

template <int TM, int TN>
size_t smem_bytes(const Plan& p) {
  return (size_t)p.abuf * (TM + p.sc - 1) * p.lds + (size_t)NST * TN * p.lds +
         (size_t)p.G * TN * 8;
}

template <class Op, bool RS, int WARPS_M, int WARPS_N, int MT, int NT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
align_reduce_mma(const unsigned char* __restrict__ db, const unsigned char* __restrict__ q,
                 float* __restrict__ best_out, int* __restrict__ arg_out, const Plan p) {
  using Acc = typename Op::Acc;
  using T = Tile<WARPS_M, WARPS_N, MT, NT>;
  constexpr int NTHR = T::threads, WM = T::WM, WN = T::WN, TM = T::TM, TN = T::TN;
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load two n8 tiles at a time");

  extern __shared__ __align__(16) unsigned char smem[];
  const int a_bytes = (TM + p.sc - 1) * p.lds;
  unsigned char* sA = smem;                        // [abuf][TM + sc - 1][lds]
  unsigned char* sB = smem + p.abuf * a_bytes;     // [NST][TN][lds]
  uint32_t* vals = reinterpret_cast<uint32_t*>(sB + NST * TN * p.lds);  // [G][TN]
  uint32_t* offs = vals + p.G * TN;                                         // [G][TN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  const int gid = lane >> 2, tig = lane & 3;
  const int s0 = blockIdx.x * p.G;
  const int gsongs = min(p.G, p.n_songs - s0);
  const long long row0 = (long long)s0 * p.R;     // the group's first layout row
  const long long grows = (long long)gsongs * p.R;
  const int n_sub = (int)((grows + TM - 1) / TM);
  const int n_chunk = (p.S + p.sc - 1) / p.sc;
  const int n_tiles = n_sub * n_chunk;  // A stages: (subtile, window-row chunk)
  const int n_steps = n_sub * p.S;
  const int b0 = blockIdx.y * TN;

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

  Acc acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = Acc(0);

  // per-lane ldmatrix rows: A lanes 0-15 rows 0-15 bytes 0-15, lanes 16-31
  // the same rows at bytes 16-31; B lanes give query rows (lane & 7) + 8 *
  // (lane >> 4) at bytes 16 * ((lane >> 3) & 1) (x2 reads lanes 0-15 only)
  const int a_lane = (warp_m * WM + (lane & 15)) * p.lds + (lane >> 4) * 16;
  const int b_lane = (warp_n * WN + (lane & 7) + (NT > 1 ? (lane >> 4) << 3 : 0)) * p.lds +
                     ((lane >> 3) & 1) * 16;

  int t = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int sub = tile / n_chunk, i0 = (tile - sub * n_chunk) * p.sc;
    const int i1 = min(i0 + p.sc, p.S);
    const uint32_t a_stage = smem_u32(sA + (tile % p.abuf) * a_bytes);
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

      const uint32_t a_addr = a_stage + a_lane + (i - i0) * p.lds;
      const uint32_t b_addr = smem_u32(sB) + (t % NST) * TN * p.lds + b_lane;
      Acc part[MT][NT][4];
      if constexpr (RS) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) part[mt][nt][j] = Acc(0);
      }
#pragma unroll 2
      for (int kk = 0; kk < p.kb; kk += 32) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], a_addr + mt * 16 * p.lds + kk);
        if constexpr (NT == 1) {
          ldsm_x2(b[0][0], b[0][1], b_addr + kk);
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r[4];
            ldsm_x4(r, b_addr + np * 16 * p.lds + kk);
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            Op::mma((RS ? part : acc)[mt][nt], a[mt], b[nt][0], b[nt][1]);
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
    if (i1 < p.S) continue;

    // ---- epilogue of subtile `sub`: the segmented max, in two passes over
    // 32-bit words.  Pass 1 takes the max of the order-preserving value
    // bits per (song, column); pass 2, after a barrier, the largest offset
    // whose value equals it.  A song's rows in a later subtile have later
    // offsets, so pass 2 replaces an earlier subtile's offset exactly when
    // this subtile raised the max or tied it.
    // group-local rows in 32 bits (G * R < 2^31, checked at launch): a
    // 64-bit division costs a call per row
    const unsigned w0 = (unsigned)(sub * TM + warp_m * WM), R = (unsigned)p.R;
    const unsigned nrows = (unsigned)grows;
    int sl[MT][2], off[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned gr = w0 + mt * 16 + h * 8 + gid;
        const unsigned s = gr / R;
        sl[mt][h] = gr < nrows ? (int)s : -1;
        off[mt][h] = gr < nrows ? (int)(gr - s * R) : 0;
      }
    const unsigned w1 = w0 + WM - 1;
    const bool one_song = w1 < nrows && w0 / R == w1 / R;  // the same in every lane
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = warp_n * WN + nt * 8 + 2 * tig + e;
        if (one_song) {  // the 8 lanes holding this column reduce with shuffles
          uint32_t v = 0;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) v = max(v, Op::order(acc[mt][nt][2 * h + e]));
#pragma unroll
          for (int x = 4; x < 32; x <<= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, x));
          if (gid == 0) atomicMax(&vals[sl[0][0] * TN + col], v);
        } else {  // one atomic per run of this thread's rows in one song
          int cur = -1;
          uint32_t cv = 0;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (sl[mt][h] < 0) continue;
              const uint32_t v = Op::order(acc[mt][nt][2 * h + e]);
              if (sl[mt][h] != cur) {
                if (cur >= 0) atomicMax(&vals[cur * TN + col], cv);
                cur = sl[mt][h];
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
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = warp_n * WN + nt * 8 + 2 * tig + e;
        int cur = -1, hit = -1;
        uint32_t top = 0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (sl[mt][h] < 0) continue;
            if (sl[mt][h] != cur) {
              if (hit >= 0) atomicMax(&offs[cur * TN + col], (uint32_t)hit);
              cur = sl[mt][h];
              hit = -1;
              top = vals[cur * TN + col];
            }
            // rows ascend with (mt, h): the last hit is the largest offset
            if (Op::order(acc[mt][nt][2 * h + e]) == top) hit = off[mt][h];
          }
        if (hit >= 0) atomicMax(&offs[cur * TN + col], (uint32_t)hit);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = Acc(0);
  }

  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < gsongs * TN; e += NTHR) {
    const int col = e / gsongs, s = e - col * gsongs, b = b0 + col;
    if (b < p.B) {
      const long long o = (long long)b * p.n_songs + s0 + s;
      best_out[o] = Op::value(vals[s * TN + col]);
      arg_out[o] = (int)offs[s * TN + col];
    }
  }
}

template <class Op, bool RS, int WARPS_M, int WARPS_N, int MT, int NT>
cudaError_t launch(const void* db, const void* q, void* best, void* argoff, const Plan& p,
                   long long smem, cudaStream_t stream) {
  using T = Tile<WARPS_M, WARPS_N, MT, NT>;
  if (p.tm != T::TM || (long long)smem_bytes<T::TM, T::TN>(p) != smem)
    return cudaErrorInvalidValue;
  if ((p.B + T::TN - 1) / T::TN > 65535) return cudaErrorInvalidConfiguration;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > optin) return cudaErrorInvalidConfiguration;
  auto kernel = align_reduce_mma<Op, RS, WARPS_M, WARPS_N, MT, NT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n_songs + p.G - 1) / p.G, (p.B + T::TN - 1) / T::TN);
  kernel<<<grid, T::threads, smem, stream>>>(static_cast<const unsigned char*>(db),
                                             static_cast<const unsigned char*>(q),
                                             static_cast<float*>(best),
                                             static_cast<int*>(argoff), p);
  return cudaGetLastError();
}

// query tile TN -> warps (M x N) and warp tile (MT m16 x NT n8); the
// (TM, threads) of each must match align_kernel.py's TILE_CONFIGS.  RS: the
// per-row partial sums (bf16 at large S*d).
template <class Op, bool RS>
cudaError_t launch_tile(const void* db, const void* q, void* best, void* argoff,
                        const Plan& p, int tn, long long smem, cudaStream_t s) {
  switch (tn) {
    case 64: return launch<Op, RS, 8, 1, 2, 8>(db, q, best, argoff, p, smem, s);  // TM 256
    case 32: return launch<Op, RS, 8, 1, 2, 4>(db, q, best, argoff, p, smem, s);  // TM 256
    case 16: return launch<Op, RS, 8, 1, 1, 2>(db, q, best, argoff, p, smem, s);  // TM 128
    case 8: return launch<Op, RS, 4, 1, 1, 1>(db, q, best, argoff, p, smem, s);   // TM 64
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mma

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores; the plan arguments are ignored),
// 1 = bfloat16, 2 = int8 (int32 sums).  tn, tm, rowsum, G, sc, abuf, ch
// and smem are the tile plan of index/align_kernel.py:tile_plan.
// Returns a cudaError_t (0 = launched).
int align_reduce_launch(const void* db, const void* q, void* best, void* argoff,
                        long long N, int d, int R, int S, int B, int n_songs, int dtype,
                        int tn, int tm, int rowsum, int G, int sc, int abuf, int ch,
                        long long smem, void* stream) {
  if (B <= 0 || n_songs <= 0) return cudaSuccess;
  if (d <= 0 || d % 4 || R <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return f32k::launch(db, q, best, argoff, N, d, R, S, B, n_songs, s);
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  mma::Plan p;
  p.N = N;
  p.rb = dtype == 1 ? 2 * d : d;
  p.kb = (p.rb + 31) / 32 * 32;
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
  if (dtype == 2) return mma::launch_tile<mma::Int8Op, false>(db, q, best, argoff, p, tn, smem, s);
  if (rowsum) return mma::launch_tile<mma::Bf16Op, true>(db, q, best, argoff, p, tn, smem, s);
  return mma::launch_tile<mma::Bf16Op, false>(db, q, best, argoff, p, tn, smem, s);
}

const char* align_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
