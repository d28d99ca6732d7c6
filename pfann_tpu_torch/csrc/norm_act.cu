// norm_act: FpNetwork's whole-volume LayerNorm and its activation in one
// kernel, on the inference path (models/norm_act.py binds it with ctypes).
//
// What it computes, per segment n of x [N, V] (V = C*F*T, one conv output):
//   a    = x, or round(act(x)) where the activation comes first
//          (relu_after_bn false: the statistics are of act(x));
//   mean = sum(a) / V, var = sum((a - mean)^2) / V, both in f32;
//   y    = round((a - mean) * rsqrt(var + eps) * weight + bias), the affine
//          f32 over the whole volume, rounded to x's dtype;
//   out  = y, or round(act(y)) where the activation comes after.
// These are the arithmetic and the rounding points of the port's torch path
// (F.layer_norm of the f32 copy, cast back, then the activation in the
// input's dtype) and of the JAX package's _FullLayerNorm
// (pfann_tpu/models/fp_network.py:47-63).
//
// It replaces no TPU kernel: the JAX package writes the norm and the
// activation as plain ops, which XLA fuses on the TPU.  The port ran them
// as four passes (the f32 copy, F.layer_norm, the cast back, the
// activation), some 24-28 bytes an element of bf16.  Its bound on this
// card is bytes: a few operations an element against reading the conv's
// output and writing the activation, 4 bytes an element in bf16.  Two
// forms, chosen by norm_act.plan in Python from the volume alone:
//   rows:  a segment of up to 4,096 16-byte vectors (64 KB) is staged in
//          one block's shared memory by cp.async (every load in flight at
//          once, no registers held), S segments a group of G threads, so
//          x is read once and written once; the sums are trees (a thread's
//          elements, warp shuffles, shared memory across the group's
//          warps), so the variance is the exact two-pass form; each
//          vector's weight and bias are loaded once for the S segments.
//   split: larger segments: a stats kernel writes each chunk's (mean, M2)
//          from registers, and an apply kernel merges them by Chan's
//          formula and applies the affine to SPB segments a block with the
//          weight and bias of its element range loaded once (6 bytes an
//          element of bf16).  A cluster of blocks holding a whole segment
//          in distributed shared memory (4 bytes an element) measured
//          slower at these volumes (PERF.md), and is not built.
//
// The output may be x itself: every element is read before it is written,
// by the thread that writes it, and the caller (the inference path)
// passes the conv's output, which nothing else reads.  Offsets are 64-bit:
// N*V may pass 2^32.  Every load and store is a 16-byte vector: V is a
// multiple of 16 bytes' elements and x, y, weight and bias are 16-byte
// aligned (FpNetwork's channel counts are multiples of 8; the wrapper
// raises otherwise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace na {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STATS_VPT = 4;  // split: vectors a thread of a stats chunk
constexpr int SG = 4;         // split: segments whose loads are in flight at once
constexpr int SPB = 16;       // split: segments an apply block, one merging warp each
constexpr int ELU = 1;        // act: 0 ReLU, 1 ELU

template <typename T>
struct Tr;
template <>
struct Tr<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float t(float v) { return v; }
};
template <>
struct Tr<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 t(float v) { return __float2bfloat16_rn(v); }
};

// 16 bytes of T
template <typename T, int VEC>
struct alignas(16) Pack {
  static_assert(sizeof(T) * VEC == 16, "one 16-byte vector");
  T v[VEC];
};

// torch's activations in the input's dtype: computed in f32, rounded once
// (relu: clamp_min, NaN passes; elu with alpha 1: expm1 below 0)
__device__ __forceinline__ float act_f(float v, int act) {
  if (act == ELU) return v > 0.f ? v : expm1f(v);
  return v < 0.f ? 0.f : v;
}

template <typename T, int VEC>
__device__ __forceinline__ float pack_sum(const Pack<T, VEC>& p) {
  float s[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = Tr<T>::f(p.v[e]);
#pragma unroll
  for (int h = VEC / 2; h; h >>= 1)
#pragma unroll
    for (int e = 0; e < h; ++e) s[e] += s[e + h];
  return s[0];
}

template <typename T, int VEC>
__device__ __forceinline__ float pack_sq(const Pack<T, VEC>& p, float mean) {
  float s[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float d = Tr<T>::f(p.v[e]) - mean;
    s[e] = d * d;
  }
#pragma unroll
  for (int h = VEC / 2; h; h >>= 1)
#pragma unroll
    for (int e = 0; e < h; ++e) s[e] += s[e + h];
  return s[0];
}

// VEC (4 or 8) floats of the affine from p, 16-byte aligned
template <int VEC>
__device__ __forceinline__ void load_affine(const float* __restrict__ p, float (&o)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
    o[4 * q] = t.x;
    o[4 * q + 1] = t.y;
    o[4 * q + 2] = t.z;
    o[4 * q + 3] = t.w;
  }
}

// one vector of the output from one of a (already activated where the
// activation comes first), the statistics and the affine
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> norm_pack(const Pack<T, VEC>& v, float mean, float rstd,
                                                  const float (&w)[VEC], const float (&b)[VEC],
                                                  int act, int act_first) {
  Pack<T, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float t = Tr<T>::f(Tr<T>::t(((Tr<T>::f(v.v[e]) - mean) * rstd) * w[e] + b[e]));
    if (!act_first) t = Tr<T>::f(Tr<T>::t(act_f(t, act)));
    o.v[e] = Tr<T>::t(t);
  }
  return o;
}

template <typename T, int VEC>
__device__ __forceinline__ void act_pack(Pack<T, VEC>& v, int act) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) v.v[e] = Tr<T>::t(act_f(Tr<T>::f(v.v[e]), act));
}

template <int N>
__device__ __forceinline__ float tree(float (&s)[N]) {
#pragma unroll
  for (int h = N / 2; h; h >>= 1)
#pragma unroll
    for (int j = 0; j < h; ++j) s[j] += s[j + h];
  return s[0];
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane adds the same pairs, so all hold the same bits
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sums over a group of G threads (G a power of two, 32 to THREADS) of
// S values at once, the same bits in every thread.  red: [S][WARPS] floats
// of shared memory, used by one call.
template <int S>
__device__ void group_sum(float (&v)[S], int G, float* red) {
#pragma unroll
  for (int k = 0; k < S; ++k) v[k] = warp_sum(v[k]);
  if (G <= 32) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = G / 32;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) red[k * WARPS + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < S; ++k)
    v[k] = warp_sum(lane < nw ? red[k * WARPS + warp / nw * nw + lane] : 0.f);
}

// rows: S segments per group of G threads, VPT vectors of VEC elements a
// thread in each, staged in shared memory; each thread reads back only the
// vectors it staged, so the passes need no barrier of their own
template <typename T, int VEC, int VPT, int S>
__global__ void __launch_bounds__(THREADS, 2)
    rows_kernel(const T* x, T* y, const float* __restrict__ w, const float* __restrict__ b,
                float* __restrict__ stats, long long N, long long V, int G, float eps, int act,
                int act_first) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* buf = reinterpret_cast<P*>(smem_raw);  // [S][VPT][THREADS]
  __shared__ float red[2][S * WARPS];
  const long long n0 = ((long long)blockIdx.x * (THREADS / G) + threadIdx.x / G) * S;
  const int r = threadIdx.x % G;
  const long long nv = V / VEC;
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const long long i = (long long)j * G + r;
      const bool ok = n0 + k < N && i < nv;
      const T* src = ok ? x + (n0 + k) * V + i * VEC : x;
      P* dst = buf + (k * VPT + j) * THREADS + threadIdx.x;
      // a source size of 0 fills the vector with zeros
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                   "l"(src), "r"(ok ? 16 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  float mean[S], rstd[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    float s[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      P v = buf[(k * VPT + j) * THREADS + threadIdx.x];
      if (act_first) {
        act_pack<T, VEC>(v, act);
        buf[(k * VPT + j) * THREADS + threadIdx.x] = v;
      }
      s[j] = pack_sum<T, VEC>(v);
    }
    mean[k] = tree(s);
  }
  group_sum<S>(mean, G, red[0]);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    mean[k] /= (float)V;
    float s[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const long long i = (long long)j * G + r;
      s[j] = (n0 + k < N && i < nv)
                 ? pack_sq<T, VEC>(buf[(k * VPT + j) * THREADS + threadIdx.x], mean[k])
                 : 0.f;
    }
    rstd[k] = tree(s);
  }
  group_sum<S>(rstd, G, red[1]);
#pragma unroll
  for (int k = 0; k < S; ++k) rstd[k] = rsqrtf(rstd[k] / (float)V + eps);
  if (stats != nullptr && r == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (n0 + k < N) {
        stats[2 * (n0 + k)] = mean[k];
        stats[2 * (n0 + k) + 1] = rstd[k];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const long long i = (long long)j * G + r;
    if (n0 < N && i < nv) {
      float wv[VEC], bv[VEC];
      load_affine<VEC>(w + i * VEC, wv);
      load_affine<VEC>(b + i * VEC, bv);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (n0 + k < N) {
          *reinterpret_cast<P*>(y + (n0 + k) * V + i * VEC) = norm_pack<T, VEC>(
              buf[(k * VPT + j) * THREADS + threadIdx.x], mean[k], rstd[k], wv, bv, act,
              act_first);
        }
      }
    }
  }
}

// split, pass 1: chunk k of segment n (THREADS * STATS_VPT vectors) ->
// part[n, k] = (its mean, its sum of squared deviations from that mean)
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    stats_kernel(const T* __restrict__ x, float* __restrict__ part, long long V, int K, int act,
                 int act_first) {
  using P = Pack<T, VEC>;
  __shared__ float red[2][WARPS];
  const long long n = blockIdx.x / K;
  const int k = blockIdx.x % K;
  const long long nv = V / VEC;
  const long long chunk = (long long)THREADS * STATS_VPT;  // vectors
  const long long i0 = k * chunk;
  const long long cnt = (nv - i0 < chunk ? nv - i0 : chunk) * VEC;
  P v[STATS_VPT];
  float s[STATS_VPT];
#pragma unroll
  for (int j = 0; j < STATS_VPT; ++j) {
    const long long i = i0 + (long long)j * THREADS + threadIdx.x;
    if (i < nv) {
      v[j] = *reinterpret_cast<const P*>(x + n * V + i * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[j].v[e] = Tr<T>::t(0.f);
    }
    if (act_first) act_pack<T, VEC>(v[j], act);
    s[j] = pack_sum<T, VEC>(v[j]);
  }
  float sum[1] = {tree(s)};
  group_sum<1>(sum, THREADS, red[0]);
  const float mean = sum[0] / (float)cnt;
#pragma unroll
  for (int j = 0; j < STATS_VPT; ++j) {
    const long long i = i0 + (long long)j * THREADS + threadIdx.x;
    s[j] = i < nv ? pack_sq<T, VEC>(v[j], mean) : 0.f;
  }
  float m2[1] = {tree(s)};
  group_sum<1>(m2, THREADS, red[1]);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = mean;
    part[2 * blockIdx.x + 1] = m2[0];
  }
}

// Chan's merge of (count, mean, M2) with (nb, mb, m2b)
__device__ __forceinline__ void chan(float& n, float& m, float& m2, float nb, float mb,
                                     float m2b) {
  if (nb == 0.f) return;
  const float t = n + nb, d = mb - m;
  m += d * (nb / t);
  m2 += m2b + d * d * (n * (nb / t));
  n = t;
}

// split, pass 2: block (e, g) applies vectors [e * THREADS, (e + 1) *
// THREADS) of the affine to segments [g * spb, g * spb + spb), after
// merging each one's K chunks.  spb is always SPB, passed as an argument:
// compiled in as a constant, this kernel ran 8% slower at the largest
// volumes with the same registers (PERF.md)
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    apply_kernel(const T* x, T* y, const float* __restrict__ w, const float* __restrict__ b,
                 const float* __restrict__ part, float* __restrict__ stats, long long N,
                 long long V, int K, int chunk, int spb, long long n0, float eps, int act,
                 int act_first) {
  static_assert(SPB <= WARPS, "one merging warp a segment");
  static_assert(SPB % SG == 0, "whole groups of in-flight loads");
  using P = Pack<T, VEC>;
  __shared__ float st[WARPS][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g0 = n0 + (long long)blockIdx.y * spb;
  // warp s merges segment g0 + s: lanes take chunks lane, lane + 32, ...
  // in turn, then a tree to lane 0 (shfl_down keeps one order of merges)
  if (warp < spb && g0 + warp < N) {
    const long long n = g0 + warp;
    float c = 0.f, m = 0.f, m2 = 0.f;
    for (int k = lane; k < K; k += 32) {
      const long long left = V - (long long)k * chunk;
      chan(c, m, m2, (float)(left < chunk ? left : chunk), part[2 * (n * K + k)],
           part[2 * (n * K + k) + 1]);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float cb = __shfl_down_sync(0xffffffffu, c, o);
      const float mb = __shfl_down_sync(0xffffffffu, m, o);
      const float m2b = __shfl_down_sync(0xffffffffu, m2, o);
      if (lane + o < 32) chan(c, m, m2, cb, mb, m2b);
    }
    if (lane == 0) {
      const float rstd = rsqrtf(m2 / (float)V + eps);
      st[warp][0] = m;
      st[warp][1] = rstd;
      if (stats != nullptr && blockIdx.x == 0) {
        stats[2 * n] = m;
        stats[2 * n + 1] = rstd;
      }
    }
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= V / VEC) return;
  float wr[VEC], br[VEC];
  load_affine<VEC>(w + i * VEC, wr);
  load_affine<VEC>(b + i * VEC, br);
  // SG segments' loads in flight before their stores (x and y may be one)
  for (int s0 = 0; s0 < spb; s0 += SG) {
    P v[SG];
#pragma unroll
    for (int q = 0; q < SG; ++q) {
      if (s0 + q < spb && g0 + s0 + q < N)
        v[q] = *reinterpret_cast<const P*>(x + (g0 + s0 + q) * V + i * VEC);
    }
#pragma unroll
    for (int q = 0; q < SG; ++q) {
      const long long n = g0 + s0 + q;
      if (s0 + q >= spb || n >= N) break;
      if (act_first) act_pack<T, VEC>(v[q], act);
      *reinterpret_cast<P*>(y + n * V + i * VEC) =
          norm_pack<T, VEC>(v[q], st[s0 + q][0], st[s0 + q][1], wr, br, act, act_first);
    }
  }
}

template <typename T, int VEC, int VPT, int S>
cudaError_t launch_rows(const void* x, void* y, const float* w, const float* b, float* stats,
                        long long N, long long V, int G, float eps, int act, int act_first,
                        cudaStream_t stream) {
  auto kernel = rows_kernel<T, VEC, VPT, S>;
  const long long groups = (N + S - 1) / S;
  const long long blocks = (groups + THREADS / G - 1) / (THREADS / G);
  const size_t smem = (size_t)THREADS * VPT * S * sizeof(Pack<T, VEC>);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(reinterpret_cast<const T*>(x),
                                                      reinterpret_cast<T*>(y), w, b, stats, N,
                                                      V, G, eps, act, act_first);
  return cudaGetLastError();
}

// the (VPT, S) tiles the source builds, as norm_act.ROWS_TILES lists them:
// 64 KB of staging a block each
#define NA_ROWS_TILES(X) X(2, 4) X(4, 2) X(8, 1)

template <typename T, int VEC = int(16 / sizeof(T))>
cudaError_t rows_tile(int vpt, int segs, const void* x, void* y, const float* w, const float* b,
                      float* stats, long long N, long long V, int G, float eps, int act,
                      int act_first, cudaStream_t s) {
#define NA_CASE(P, Q)                                                                       \
  if (vpt == P && segs == Q)                                                                \
    return launch_rows<T, VEC, P, Q>(x, y, w, b, stats, N, V, G, eps, act, act_first, s);
  NA_ROWS_TILES(NA_CASE)
#undef NA_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int VEC = int(16 / sizeof(T))>
cudaError_t launch_split(const void* x, void* y, const float* w, const float* b, float* part,
                         float* stats, long long N, long long V, float eps, int act,
                         int act_first, cudaStream_t stream) {
  const long long nv = V / VEC;
  const long long chunk_v = (long long)THREADS * STATS_VPT;
  const int K = (int)((nv + chunk_v - 1) / chunk_v);
  const unsigned eb = (unsigned)((nv + THREADS - 1) / THREADS);
  stats_kernel<T, VEC><<<(unsigned)(N * K), THREADS, 0, stream>>>(
      reinterpret_cast<const T*>(x), part, V, K, act, act_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_launch = 65535LL * SPB;  // gridDim.y
  for (long long n0 = 0; n0 < N; n0 += per_launch) {
    const long long n = N - n0 < per_launch ? N - n0 : per_launch;
    apply_kernel<T, VEC><<<dim3(eb, (unsigned)((n + SPB - 1) / SPB)), THREADS, 0, stream>>>(
        reinterpret_cast<const T*>(x), reinterpret_cast<T*>(y), w, b, part, stats, N, V, K,
        (int)(chunk_v * VEC), SPB, n0, eps, act, act_first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace na

// dtype: 0 float32, 1 bfloat16 (V a multiple of 4 or 8 elements: whole
// 16-byte vectors; x, y, weight and bias 16-byte aligned); G threads a
// segment (a power of two, 32 to 512) holding vpt vectors each of segs
// segments
extern "C" int norm_act_rows_launch(int dtype, int vpt, int segs, const void* x, void* y,
                                    const float* w, const float* b, float* stats, long long N,
                                    long long V, int G, float eps, int act, int act_first,
                                    void* stream) {
  const long long vec = dtype ? 8 : 4;
  if (N < 1 || V < 1 || V % vec || G < 32 || (G & (G - 1)) || G > na::THREADS ||
      (long long)G * vpt < V / vec || (act != 0 && act != na::ELU))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? na::rows_tile<__nv_bfloat16>(vpt, segs, x, y, w, b, stats, N, V, G,
                                                         eps, act, act_first, s)
                          : na::rows_tile<float>(vpt, segs, x, y, w, b, stats, N, V, G, eps,
                                                 act, act_first, s));
}

// part: N * K * 2 floats of scratch, K = ceil(vectors / (512 * 4)) chunks
// a segment; SPB segments an apply block
extern "C" int norm_act_split_launch(int dtype, const void* x, void* y, const float* w,
                                     const float* b, float* part, float* stats, long long N,
                                     long long V, float eps, int act, int act_first,
                                     void* stream) {
  if (N < 1 || V < 1 || V % (dtype ? 8 : 4) || (act != 0 && act != na::ELU))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? na::launch_split<__nv_bfloat16>(x, y, w, b, part, stats, N, V, eps,
                                                            act, act_first, s)
                          : na::launch_split<float>(x, y, w, b, part, stats, N, V, eps, act,
                                                    act_first, s));
}

extern "C" const char* norm_act_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
