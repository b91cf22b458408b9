// Warp-level matrix-multiply pieces shared by mrf_stage.cu,
// matmul_bench.cu, wavenet_stack.cu and wavenet_stack_bwd.cu: one 16 x 8
// output tile per warp and call, in the three matmul types the HiFi-GAN
// serving kernels use,
//
//   int8  x int8  -> int32   mma.sync m16n8k32 (tensor cores)
//   bf16  x bf16  -> float32 mma.sync m16n8k16 (tensor cores)
//   float x float -> float32 the same tile from shuffles and FMAs (exact
//                            f32 products; the parity mode, not a fast one)
//
// All three use one fragment layout, so the code that gathers operands from
// shared memory is written once. With g = lane / 4, t = lane % 4, KS the
// contraction depth of one step and EPR the elements in a 32-bit register:
//   a[0] = A[g    ][t*EPR ..]      a[2] = A[g    ][KS/2 + t*EPR ..]
//   a[1] = A[g + 8][t*EPR ..]      a[3] = A[g + 8][KS/2 + t*EPR ..]
//   b[0] = B[t*EPR ..][g]          b[1] = B[KS/2 + t*EPR ..][g]
//   c[0], c[1] = C[g][2t], C[g][2t+1]   c[2], c[3] = C[g+8][2t], C[g+8][2t+1]
// A is read row-major (k contiguous) and B as [n][k] (k contiguous), so
// every register is one aligned 32-bit load; rows of both tiles in shared
// memory are padded by 16 bytes, which spreads the eight rows a load
// touches over distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pwgmma {

constexpr int ROW_PAD_BYTES = 16;  // per-row padding of shared-memory tiles

template <typename MT>
struct Traits;
template <>
struct Traits<int8_t> {
  using Acc = int;
  static constexpr int KS = 32;
  static constexpr int EPR = 4;
};
template <>
struct Traits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int KS = 16;
  static constexpr int EPR = 2;
};
template <>
struct Traits<float> {
  using Acc = float;
  static constexpr int KS = 8;
  static constexpr int EPR = 1;
};

template <typename MT>
__device__ __forceinline__ void mma_tile(typename Traits<MT>::Acc c[4],
                                         const uint32_t a[4],
                                         const uint32_t b[2]);

template <>
__device__ __forceinline__ void mma_tile<int8_t>(int c[4], const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma_tile<__nv_bfloat16>(float c[4],
                                                        const uint32_t a[4],
                                                        const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// f32: every lane fetches, for each of the 8 contraction indices, the two A
// rows and two B columns of its four outputs from the lanes that hold them.
template <>
__device__ __forceinline__ void mma_tile<float>(float c[4], const uint32_t a[4],
                                                const uint32_t b[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int from_a = (g << 2) | (k & 3);
    const int from_b = (t << 3) | (k & 3);  // the lane with g' = 2t
    const float a_lo =
        __uint_as_float(__shfl_sync(0xffffffffu, k < 4 ? a[0] : a[2], from_a));
    const float a_hi =
        __uint_as_float(__shfl_sync(0xffffffffu, k < 4 ? a[1] : a[3], from_a));
    const uint32_t bk = k < 4 ? b[0] : b[1];
    const float b_0 = __uint_as_float(__shfl_sync(0xffffffffu, bk, from_b));
    const float b_1 = __uint_as_float(__shfl_sync(0xffffffffu, bk, from_b + 4));
    c[0] = fmaf(a_lo, b_0, c[0]);
    c[1] = fmaf(a_lo, b_1, c[1]);
    c[2] = fmaf(a_hi, b_0, c[2]);
    c[3] = fmaf(a_hi, b_1, c[3]);
  }
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// clip(round_half_even(v), +-127) as the low byte of the result
__device__ __forceinline__ uint32_t quant_byte(float v) {
  const float q = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// f32 products on the TF32 tensor cores at f32 accuracy (the backward's f32
// body): mma.sync m16n8k8 tf32 -> f32 has the fragment layout above with
// KS = 8, EPR = 1, and reads only the sign, exponent and top 10 mantissa
// bits of each 32-bit operand (the low 13 are ignored: truncation). Each
// operand x splits as hi = x rounded to TF32 (to nearest, ties away, by
// integer arithmetic on its bits: cvt.rna.tf32.f32 gives the same bits but
// issues at a quarter of the rate) and lo = x - hi (exact in f32, truncated
// to TF32 by the tensor core); a . b is taken as lo_a . hi_b + hi_a . lo_b +
// hi_a . hi_b, the small terms first. The dropped lo_a . lo_b and the
// truncation of lo leave a relative error near 2^-21 per product, against
// about 2^-11 for one TF32 product. mma_tiles below issues the three
// products for a warp's tiles; the f32 bodies of wavenet_stack.cu and
// wavenet_stack_bwd.cu take their products from it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows row0..row0+15, k0..k0+7 from a row-major [row][k] tile,
// split into its TF32 hi and lo parts
__device__ __forceinline__ void load_a_split(uint32_t hi[4], uint32_t lo[4],
                                             const float* a, int lda, int gq,
                                             int tq) {
  const float v[4] = {a[gq * lda + tq], a[(gq + 8) * lda + tq],
                      a[gq * lda + tq + 4], a[(gq + 8) * lda + tq + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}

// c[i][j] += A_i . B_j for MT m-tiles i (the split A fragments) and NT
// n-tiles j < n_valid, B_j the [k][n] tile at b + col(j) (row k0, column
// n0). The three products are issued pass by pass (lo . hi, then hi . lo,
// then hi . hi), so MT x NT independent accumulator chains overlap in the
// tensor pipe. The tensor core truncates the low bits of what it adds into
// its accumulator, so a deep contraction summed in place drifts by about
// one unit in the last place of the running sum per call. With FRESH, the
// k-step's three products go to a zeroed tile that is then added to c in
// f32 (rounded to nearest): the truncation is taken against that k-step's
// own partial sum, and the running sum rounds as f32 FMAs would (the
// forward's 272-deep gate product needs it: summed in place, the stack's
// output lies 6 x further from float64; wavenet_stack.cu's head note).
template <int MT, int NT, bool FRESH = false, typename ColFn>
__device__ __forceinline__ void mma_tiles(float (*c)[NT][4],
                                          uint32_t (*a_hi)[4],
                                          uint32_t (*a_lo)[4],
                                          const float* b, int ldb, ColFn col,
                                          int gq, int tq, int n_valid = NT) {
  uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float* p = b + col(j);
    split_tf32(p[tq * ldb + gq], b_hi[j][0], b_lo[j][0]);
    split_tf32(p[(tq + 4) * ldb + gq], b_hi[j][1], b_lo[j][1]);
  }
  float fresh[FRESH ? MT : 1][NT][4] = {};
  auto acc = [&](int ij) -> float* {
    if constexpr (FRESH) return fresh[ij / NT][ij % NT];
    return c[ij / NT][ij % NT];
  };
  // the three products pass by pass over the MT x NT accumulators
#pragma unroll
  for (int ij = 0; ij < MT * NT; ++ij)
    if (ij % NT < n_valid) mma_tf32(acc(ij), a_lo[ij / NT], b_hi[ij % NT]);
#pragma unroll
  for (int ij = 0; ij < MT * NT; ++ij)
    if (ij % NT < n_valid) mma_tf32(acc(ij), a_hi[ij / NT], b_lo[ij % NT]);
#pragma unroll
  for (int ij = 0; ij < MT * NT; ++ij)
    if (ij % NT < n_valid) mma_tf32(acc(ij), a_hi[ij / NT], b_hi[ij % NT]);
  if constexpr (FRESH) {
#pragma unroll
    for (int ij = 0; ij < MT * NT; ++ij)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[ij / NT][ij % NT][e] += acc(ij)[e];
  }
}

}  // namespace pwgmma
