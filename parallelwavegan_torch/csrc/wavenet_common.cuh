// Shared pieces of the fused WaveNet stack kernels (forward, backward and the
// experiment's variant forward): the compiled channel widths, the thread-tile
// layout and the typed 2- and 4-wide loads and stores. wavenet_variant.cu
// runs 256-thread blocks over tiles of TT = 64 time rows and does its
// products as register-blocked SIMT GEMMs whose thread tile is 4 rows x 8
// columns (columns cg*4..+3 and 64 + cg*4..+3 of a 128-column panel); the
// tensor-core bodies of wavenet_stack.cu and wavenet_stack_bwd.cu take only
// the constants and the small loads and stores from here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pwg {

constexpr int R = 64;        // residual channels
constexpr int G = 128;       // gate channels (2 R)
constexpr int S = 64;        // skip channels
constexpr int SR = S + R;    // fused skip|out width
constexpr int TT = 64;       // time rows per block
constexpr int KC = 16;       // contraction rows per weight chunk
constexpr int THREADS = 256;
constexpr float kSqrtHalf = 0.70710678118654752f;

static_assert(G == 2 * R, "gate splits G into tanh and sigmoid halves of R");
static_assert(SR == G, "every GEMM shares one 128-column thread layout");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value to the matmul type, returned as f32
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4 consecutive elements (16-byte aligned for f32, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// 2 consecutive f32 (8-byte aligned)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// contraction length of the gate GEMM, padded to whole weight chunks
__host__ __device__ constexpr int padded_k(int A) {
  return (3 * R + A + KC - 1) / KC * KC;
}

// acc[r][0..3] += a[r] * w0[0..3], acc[r][4..7] += a[r] * w1[0..3]
__device__ __forceinline__ void fma_tile(float acc[4][8], const float4 a,
                                         const float4 w0, const float4 w1) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], wv[j], acc[r][j]);
}

__device__ __forceinline__ void zero_tile(float acc[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
}

// Stage the activation tile of one layer, transposed, into shared memory:
// a_s[tap * R + ch][r] = x(t0 + r + (tap - 1) d), a_s[3R + ch][r] = c(t0 + r),
// rows outside [0, T) and the padding rows up to padded_k(A) as zeros.
// x is rounded to the matmul type WT on the way (a no-op when XT == WT).
template <typename WT, typename XT>
__device__ __forceinline__ void stage_activations(
    float* a_s, const XT* __restrict__ x, const WT* __restrict__ c,
    size_t row0, int t0, int T, int A, int d, int tid) {
  const int K = 3 * R + A;
  const int KP = padded_k(A);
  for (int i = tid; i < 3 * TT * (R / 4); i += THREADS) {
    const int ch = (i % (R / 4)) * 4;
    const int r = (i / (R / 4)) % TT;
    const int tap = i / (TT * (R / 4));
    const int t = t0 + r + (tap - 1) * d;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t >= 0 && t < T) load4(x + (row0 + t) * R + ch, v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a_s[(tap * R + ch + j) * TT + r] = round_to<WT>(v[j]);
  }
  for (int i = tid; i < TT * (A / 4); i += THREADS) {
    const int ch = (i % (A / 4)) * 4;
    const int r = i / (A / 4);
    const int t = t0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < T) load4(c + (row0 + t) * A + ch, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) a_s[(3 * R + ch + j) * TT + r] = v[j];
  }
  for (int i = tid; i < (KP - K) * TT; i += THREADS) a_s[K * TT + i] = 0.f;
}

// acc += a_s[0:KP] (transposed, [k][TT]) . [w_tap; w_aux] for this thread's
// 4 x 8 tile; the weights stream through w_s in chunks of KC rows. Begins
// with a barrier, so a_s may have been written just before the call.
template <typename WT>
__device__ __forceinline__ void gate_gemm(
    float acc[4][8], const float* a_s, float* w_s,
    const WT* __restrict__ w_tap, const WT* __restrict__ w_aux, int A,
    int tid, int rg, int cg) {
  const int K = 3 * R + A;
  const int KP = padded_k(A);
  for (int k0 = 0; k0 < KP; k0 += KC) {
    __syncthreads();  // a_s is staged / the previous chunk is consumed
    for (int i = tid; i < KC * G / 4; i += THREADS) {
      const int col = (i % (G / 4)) * 4;
      const int k = k0 + i / (G / 4);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k < 3 * R)
        load4(w_tap + (size_t)k * G + col, v);
      else if (k < K)
        load4(w_aux + (size_t)(k - 3 * R) * G + col, v);
      store4(w_s + (i / (G / 4)) * G + col, v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          a_s + (k0 + kk) * TT + rg * 4);
      const float4 w0 = *reinterpret_cast<const float4*>(w_s + kk * G + cg * 4);
      const float4 w1 =
          *reinterpret_cast<const float4*>(w_s + kk * G + R + cg * 4);
      fma_tile(acc, a, w0, w1);
    }
  }
}

// acc += a_s[0:KP] (transposed, [k][TT]) . w[0:K] for this thread's 4 x 8
// tile, w row-major (K, 128) in global memory, streamed through w_s in
// chunks of KC rows; rows K..KP of w read as zeros. Begins with a barrier,
// so a_s may have been written just before the call (wavenet_variant.cu's
// aux and skip|out products).
template <typename WT>
__device__ __forceinline__ void panel_gemm(
    float acc[4][8], const float* a_s, float* w_s, const WT* __restrict__ w,
    int K, int KP, int tid, int rg, int cg) {
  for (int k0 = 0; k0 < KP; k0 += KC) {
    __syncthreads();  // a_s is complete / the previous chunk is consumed
    for (int i = tid; i < KC * G / 4; i += THREADS) {
      const int col = (i % (G / 4)) * 4;
      const int k = k0 + i / (G / 4);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k < K) load4(w + (size_t)k * G + col, v);
      store4(w_s + (i / (G / 4)) * G + col, v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          a_s + (k0 + kk) * TT + rg * 4);
      const float4 w0 = *reinterpret_cast<const float4*>(w_s + kk * G + cg * 4);
      const float4 w1 =
          *reinterpret_cast<const float4*>(w_s + kk * G + R + cg * 4);
      fma_tile(acc, a, w0, w1);
    }
  }
}

}  // namespace pwg
