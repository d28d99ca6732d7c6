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
//     align[s, o, b] = sum_{i < S} dot(db[s*R + o + i], q[b, i])
//
// with rows >= N read as zero.  Only the per-song reduction leaves the chip:
//
//     best[b, s]   = max_o align[s, o, b]                     (f32)
//     argoff[b, s] = the LARGEST o reaching that max          (int32)
//
// written straight in [B, n_songs] order.  The [N, S, B] score tensor never
// exists.  Three input types:
//   * f32 and bf16: products and sums in f32 (a bf16 x bf16 product is exact
//     in f32);
//   * int8 (pallas_align.py:49-52): products and sums in int32 with __dp4a
//     over 4-byte packs of d, the running max and argmax compared in int32,
//     and best converted to f32 only when written (pallas_align.py:77-80).
//     An f32 sum would stop being exact past 2^24 (a coarse row sum reaches
//     ~6e7 at S = 30) and would break ties differently.
//
// Design (simple and right first).  One block of 256 threads per (song,
// tile of TB = 64 queries).  The block walks the song's offsets in tiles of
// TO = 64: it stages the TO + S - 1 db rows the tile needs in shared memory
// as 4-byte units (f32 values, or int8 packed four to a 32-bit word), then
// for each window row i stages row i of the query tile, and every thread
// accumulates a 4-offset x 4-query register tile over d.  Both tiles are
// row-major with a row stride of (row units rounded up to 4) + 4: stores
// from consecutive threads land in consecutive banks, and the inner loop
// reads 16-byte vectors (float4 / int4) whose rows a quarter-warp reads in
// different banks.  Each thread keeps a running max/argmax over the offsets
// it owned (ties to the later offset), and the block reduces the 16 offset
// groups at the end.  A region of any length is served (a 10-minute track
// at 0.5 s hop is ~1,200 rows, more than shared memory holds), and any S
// and B: none of the TPU kernel's limits (B % 128, the 32-row zero halo,
// G = 8 songs per step) carry over.  d must be a multiple of 4.
//
// What bounds it.  2*N*d*S*B operations against ~N*d*itemsize bytes of db
// read: at the serving shapes (S = 19, B = 1024) that is thousands of
// operations per byte, so the card's arithmetic is the bound, not its
// memory.  This version runs on the CUDA cores (f32 FMA, or int8 __dp4a at
// 4 MACs an instruction).  It leaves on the table: the tensor cores (wgmma
// on bf16 or int8 tiles, the main gain), TMA / double-buffered staging of
// the query rows (each window row waits on its loads), the queries of a
// tile wasted when B is not a multiple of 64 (all 63 of them at B = 1), and
// the offsets wasted past each region's end (R rounded up to TO).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int TO = 64;   // offsets per tile
constexpr int TB = 64;   // queries per block
constexpr int NT = 256;  // threads: 16 offset groups x 16 query groups
constexpr int RT = 4;    // offsets per thread: o0 + ty*RT + r
constexpr int CT = 4;    // queries per thread: b0 + tx + 16*c

// Staged units: a float (from f32 or bf16) or an int (four packed int8).
template <typename U> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

__device__ __forceinline__ float to_unit(float x) { return x; }
__device__ __forceinline__ float to_unit(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_unit(int x) { return x; }

__device__ __forceinline__ float mac4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}
__device__ __forceinline__ int mac4(int4 a, int4 b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

__device__ __forceinline__ float lowest(float) { return -INFINITY; }
__device__ __forceinline__ int lowest(int) { return INT_MIN; }

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// du: 4-byte units per db / query row (d for f32 and bf16, d/4 for int8)
size_t smem_bytes(int du, int S) {
  size_t tiles = ((size_t)(TO + S - 1) + TB) * (round4(du) + 4) * 4;
  size_t reduce = (size_t)16 * TB * 8;
  return tiles > reduce ? tiles : reduce;
}

// T: the global unit (float, __nv_bfloat16, or int = four int8); U: the
// staged unit and accumulator (float or int).
template <typename T, typename U>
__global__ void __launch_bounds__(NT)
align_reduce_kernel(const T* __restrict__ db, const T* __restrict__ q,
                    float* __restrict__ best_out, int* __restrict__ arg_out,
                    long long N, int du, int R, int S, int B, int n_songs) {
  using V = typename Vec4<U>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* smem = reinterpret_cast<U*>(smem_raw);
  const int dp = round4(du);  // staged units per row; zeros past du
  const int ld = dp + 4;      // keeps rows 16-byte aligned, shifts banks
  const int rows = TO + S - 1;
  U* sdb = smem;              // [rows][ld]
  U* sq = smem + rows * ld;   // [TB][ld]

  const int song = blockIdx.x;
  const int b0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long base = (long long)song * R;

  U run_best[CT];
  int run_arg[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    run_best[c] = lowest(U());
    run_arg[c] = -1;
  }

  for (int o0 = 0; o0 < R; o0 += TO) {
    __syncthreads();  // the previous tile's readers are done with sdb
    for (int e = tid; e < rows * dp; e += NT) {
      const int r = e / dp, k = e - r * dp;
      const long long g = base + o0 + r;
      sdb[r * ld + k] = (g < N && k < du) ? to_unit(db[g * du + k]) : U(0);
    }

    U acc[RT][CT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] = U(0);

    for (int i = 0; i < S; ++i) {
      __syncthreads();  // sdb staged; the previous sq consumed
      for (int e = tid; e < TB * dp; e += NT) {
        const int b = e / dp, k = e - b * dp;
        const int gb = b0 + b;
        sq[b * ld + k] = (gb < B && k < du)
                             ? to_unit(q[((long long)gb * S + i) * du + k]) : U(0);
      }
      __syncthreads();
      const U* arow = sdb + (ty * RT + i) * ld;
      const U* qrow = sq + tx * ld;
#pragma unroll 2
      for (int k = 0; k < dp; k += 4) {
        V a[RT], bq[CT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          a[r] = *reinterpret_cast<const V*>(arow + r * ld + k);
#pragma unroll
        for (int c = 0; c < CT; ++c)
          bq[c] = *reinterpret_cast<const V*>(qrow + 16 * c * ld + k);
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
  U* red_v = smem;                                    // [16][TB]
  int* red_o = reinterpret_cast<int*>(smem + 16 * TB);  // [16][TB]
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    red_v[ty * TB + tx + 16 * c] = run_best[c];
    red_o[ty * TB + tx + 16 * c] = run_arg[c];
  }
  __syncthreads();
  if (tid < TB) {
    U bv = red_v[tid];
    int bo = red_o[tid];
    for (int y = 1; y < 16; ++y) {
      const U v = red_v[y * TB + tid];
      const int o = red_o[y * TB + tid];
      if (v > bv || (v == bv && o > bo)) {
        bv = v;
        bo = o;
      }
    }
    const int gb = b0 + tid;
    if (gb < B) {
      best_out[(long long)gb * n_songs + song] = static_cast<float>(bv);  // int: round to nearest
      arg_out[(long long)gb * n_songs + song] = bo;
    }
  }
}

template <typename T, typename U>
cudaError_t launch(const void* db, const void* q, void* best, void* argoff,
                   long long N, int du, int R, int S, int B, int n_songs,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(du, S);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(align_reduce_kernel<T, U>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_songs, (B + TB - 1) / TB);
  align_reduce_kernel<T, U><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(db), static_cast<const T*>(q),
      static_cast<float*>(best), static_cast<int*>(argoff), N, du, R, S, B, n_songs);
  return cudaGetLastError();
}

int units_per_row(int d, int dtype) { return dtype == 2 ? d / 4 : d; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (int32 sums).  Returns a
// cudaError_t (0 = launched).  int8 rows are read as 32-bit words, so db
// and q must be 4-byte aligned.
int align_reduce_launch(const void* db, const void* q, void* best, void* argoff,
                        long long N, int d, int R, int S, int B, int n_songs,
                        int dtype, void* stream) {
  if (B <= 0 || n_songs <= 0) return cudaSuccess;
  if (d <= 0 || d % 4 || R <= 0 || S <= 0) return cudaErrorInvalidValue;
  if ((B + TB - 1) / TB > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int du = units_per_row(d, dtype);
  if (dtype == 0) return launch<float, float>(db, q, best, argoff, N, du, R, S, B, n_songs, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, float>(db, q, best, argoff, N, du, R, S, B, n_songs, s);
  if (dtype == 2) return launch<int, int>(db, q, best, argoff, N, du, R, S, B, n_songs, s);
  return cudaErrorInvalidValue;
}

long long align_reduce_smem_bytes(int d, int S, int dtype) {
  return (long long)smem_bytes(units_per_row(d, dtype), S);
}

const char* align_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
