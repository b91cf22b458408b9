// Asynchronous staging and fragment loads for the tensor-core kernels on
// Hopper (sm_90a), shared by matmul_bench.cu and wavenet_stack.cu:
//
//   cp.async ring     16-byte global -> shared copies that bypass the
//                     registers (zero-filled where the source is out of
//                     range), committed in groups and waited for in order,
//                     so a block fills the next tile while it multiplies the
//                     current one;
//   ldmatrix          one instruction loads a warp's whole A fragment (x4)
//                     or the B fragments of two n-tiles (x4) from shared
//                     memory in the 32-bit register layout of mma_common.cuh.
//                     The int8 m16n8k32 fragment has the same word layout as
//                     the bf16 m16n8k16 one, so one load serves both; .trans
//                     reads a bf16 operand stored [k][n] as if it were
//                     stored [n][k];
//   shared addresses  the 32-bit shared-window address the two need.
//
// Rows of a tile are laid out so that the eight 16-byte rows one ldmatrix
// phase reads fall on distinct banks: an odd number of 16-byte chunks per
// row (padding), or chunk c of row r stored at c ^ (r & 7) (swizzle).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pwgpipe {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst[0:16] = src[0:16] if valid else zeros (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(valid ? 16 : 0));
}

// the same for 8 bytes (source and destination 8-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane i supplies the row address of row i % 8 of
// matrix i / 8 and receives r[m] = its fragment word of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile whose
// rows are `row_bytes` long (a multiple of 128)
__device__ __forceinline__ int swizzle(int row, int chunk, int row_bytes) {
  return row * row_bytes + ((chunk ^ (row & 7)) << 4);
}

}  // namespace pwgpipe
