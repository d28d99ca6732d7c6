// Fused alignment scan with per-song reduce, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_align_reduce_kernel` / `pallas_alignment_reduce`
// (pfann_tpu/index/pallas_align.py:45-129), which the exhaustive engine
// reaches through `alignment_core(impl="pallas")` (pfann_tpu/index/align.py).
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
// exists.  Inputs are f32 or bf16; products and sums are f32 (a bf16 x bf16
// product is exact in f32).
//
// Design (simple and right first).  One block of 256 threads per (song,
// tile of TB = 64 queries).  The block walks the song's offsets in tiles of
// TO = 64: it stages the TO + S - 1 db rows the tile needs in shared memory
// as f32, then for each window row i stages row i of the query tile, and
// every thread accumulates a 4-offset x 4-query register tile over d.  Both
// tiles are row-major with a row stride of d + 4 floats: stores from
// consecutive threads land in consecutive banks, and the inner loop reads
// float4s over d (4 + 4 of them feed 64 FMAs; the stride puts the rows a
// warp reads in different banks).  Each thread keeps a running max/argmax
// over the offsets it owned (ties to the later offset), and the block
// reduces the 16 offset groups at the end.  A region of any length is
// served (a 10-minute track at 0.5 s hop is ~1,200 rows, more than shared
// memory holds), and any S and B: none of the TPU kernel's limits (B % 128,
// the 32-row zero halo, G = 8 songs per step) carry over.  d must be a
// multiple of 4.
//
// What bounds it.  2*N*d*S*B FLOPs against ~N*d*2 bytes of db read: at the
// serving shapes (S = 19, B = 1024) that is thousands of FLOPs per byte, so
// the card's arithmetic is the bound, not its memory.  This version runs on
// the CUDA cores in f32 FMA.  It leaves on the table: the tensor cores
// (wgmma on bf16 tiles, the main gain), TMA / double-buffered staging of the
// query rows (each window row waits on its loads), the queries of a tile
// wasted when B is not a multiple of 64 (all 63 of them at B = 1), and the
// offsets wasted past each region's end (R rounded up to TO).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TO = 64;   // offsets per tile
constexpr int TB = 64;   // queries per block
constexpr int NT = 256;  // threads: 16 offset groups x 16 query groups
constexpr int RT = 4;    // offsets per thread: o0 + ty*RT + r
constexpr int CT = 4;    // queries per thread: b0 + tx + 16*c

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_bytes(int d, int S) {
  size_t tiles = ((size_t)(TO + S - 1) + TB) * (d + 4) * sizeof(float);
  size_t reduce = (size_t)16 * TB * (sizeof(float) + sizeof(int));
  return tiles > reduce ? tiles : reduce;
}

template <typename T>
__global__ void __launch_bounds__(NT)
align_reduce_kernel(const T* __restrict__ db, const T* __restrict__ q,
                    float* __restrict__ best_out, int* __restrict__ arg_out,
                    long long N, int d, int R, int S, int B, int n_songs) {
  extern __shared__ float smem[];
  const int ld = d + 4;  // keeps rows 16-byte aligned
  const int rows = TO + S - 1;
  float* sdb = smem;              // [rows][ld]
  float* sq = smem + rows * ld;   // [TB][ld]

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
    for (int e = tid; e < rows * d; e += NT) {
      const int r = e / d, k = e - r * d;
      const long long g = base + o0 + r;
      sdb[r * ld + k] = g < N ? to_f32(db[g * d + k]) : 0.f;
    }

    float acc[RT][CT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;

    for (int i = 0; i < S; ++i) {
      __syncthreads();  // sdb staged; the previous sq consumed
      for (int e = tid; e < TB * d; e += NT) {
        const int b = e / d, k = e - b * d;
        const int gb = b0 + b;
        sq[b * ld + k] = gb < B ? to_f32(q[((long long)gb * S + i) * d + k]) : 0.f;
      }
      __syncthreads();
      const float* arow = sdb + (ty * RT + i) * ld;
      const float* qrow = sq + tx * ld;
#pragma unroll 2
      for (int k = 0; k < d; k += 4) {
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
          for (int c = 0; c < CT; ++c) {
            acc[r][c] = fmaf(a[r].x, bq[c].x, acc[r][c]);
            acc[r][c] = fmaf(a[r].y, bq[c].y, acc[r][c]);
            acc[r][c] = fmaf(a[r].z, bq[c].z, acc[r][c]);
            acc[r][c] = fmaf(a[r].w, bq[c].w, acc[r][c]);
          }
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
  float* red_v = smem;                                   // [16][TB]
  int* red_o = reinterpret_cast<int*>(smem + 16 * TB);   // [16][TB]
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

template <typename T>
cudaError_t launch(const void* db, const void* q, void* best, void* argoff,
                   long long N, int d, int R, int S, int B, int n_songs,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(d, S);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(align_reduce_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_songs, (B + TB - 1) / TB);
  align_reduce_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(db), static_cast<const T*>(q),
      static_cast<float*>(best), static_cast<int*>(argoff), N, d, R, S, B, n_songs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int align_reduce_launch(const void* db, const void* q, void* best, void* argoff,
                        long long N, int d, int R, int S, int B, int n_songs,
                        int dtype, void* stream) {
  if (B <= 0 || n_songs <= 0) return cudaSuccess;
  if (d <= 0 || d % 4 || R <= 0 || S <= 0) return cudaErrorInvalidValue;
  if ((B + TB - 1) / TB > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(db, q, best, argoff, N, d, R, S, B, n_songs, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(db, q, best, argoff, N, d, R, S, B, n_songs, s);
  return cudaErrorInvalidValue;
}

long long align_reduce_smem_bytes(int d, int S) { return (long long)smem_bytes(d, S); }

const char* align_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
