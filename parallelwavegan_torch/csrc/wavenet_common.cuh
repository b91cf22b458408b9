// Shared pieces of the fused WaveNet stack kernels (forward, backward and the
// experiment's variant forward): the compiled channel widths, the tile and
// block sizes and the typed 2- and 4-wide loads and stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pwg {

constexpr int R = 64;        // residual channels
constexpr int G = 128;       // gate channels (2 R)
constexpr int S = 64;        // skip channels
constexpr int SR = S + R;    // fused skip|out width
constexpr int TT = 64;       // time rows per tile
constexpr int THREADS = 256;
constexpr float kSqrtHalf = 0.70710678118654752f;

static_assert(G == 2 * R, "gate splits G into tanh and sigmoid halves of R");
static_assert(SR == G, "[Ws | Wo] is as wide as [Wt; Wa]");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

}  // namespace pwg
