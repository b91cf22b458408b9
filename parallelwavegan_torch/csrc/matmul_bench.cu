// Row-tiled matrix product at the MRF stage's contraction shapes, for
// Hopper (sm_90a): (M, K) . (K, N) with int8 -> int32 or bf16 -> f32.
//
// Replaces the Pallas TPU kernel `kernel` of `pallas_matmul_bench`
// (tools/int8_stage_roofline.py:150): the measurement of what the matrix
// unit delivers for tall products with a short contraction (K = k C, 96 to
// 384) and a narrow output (N = C, 32 to 128), which are the shapes of
// every conv in mrf_stage.cu.
//
// Design. The TPU kernel walks 512-row tiles in grid order with all of B
// resident in VMEM. Here a block of 4 warps stages B once, transposed to
// [n][k] so that the contraction index is contiguous, and then walks row
// tiles of 64 (blockIdx.x, blockIdx.x + gridDim.x, ...): it stages the A
// tile with 16-byte loads, each warp multiplies its 16 rows by all N
// columns with mma.sync (mma_common.cuh) and writes its outputs. M is
// ragged-safe, K is zero-padded to the mma depth in shared memory, N is a
// multiple of 8 up to 128.
//
// Bound: at these shapes the bytes bind, not the operations. M = 131072,
// K = 352, N = 32 in int8 reads 46 MB and writes 17 MB of int32 (19 us at
// 3.35 TB/s) for 3.0e9 operations (1.5 us at the int8 peak). The A tile is
// not double-buffered yet, so loads and mma's do not overlap within a block;
// several blocks per SM hide part of that.

#include "mma_common.cuh"

namespace {

using namespace pwgmma;

constexpr int TM = 64;  // rows per tile: 4 warps x 16 rows
constexpr int THREADS = 128;

// the bits of one element, for copies that do no arithmetic
template <typename MT>
struct Bits;
template <>
struct Bits<int8_t> { using type = uint8_t; };
template <>
struct Bits<__nv_bfloat16> { using type = uint16_t; };

template <typename MT, int NT>
__global__ void __launch_bounds__(THREADS) matmul_kernel(
    const MT* __restrict__ a, const MT* __restrict__ b,
    typename Traits<MT>::Acc* __restrict__ out, int M, int K, int N) {
  using Acc = typename Traits<MT>::Acc;
  constexpr int KS = Traits<MT>::KS;
  constexpr int EPR = Traits<MT>::EPR;
  constexpr int ES = (int)sizeof(MT);
  constexpr int NI = NT / 8;
  using Raw = typename Bits<MT>::type;
  const Raw* a_bits = reinterpret_cast<const Raw*>(a);
  const Raw* b_bits = reinterpret_cast<const Raw*>(b);

  extern __shared__ float4 smem4[];
  const int kp = (K + KS - 1) / KS * KS;
  const int stride = kp * ES + ROW_PAD_BYTES;
  unsigned char* b_s = reinterpret_cast<unsigned char*>(smem4);  // [NT][stride]
  unsigned char* a_s = b_s + NT * stride;                        // [TM][stride]
  const int tid = threadIdx.x;

  // B, transposed, zero beyond K and N
  for (int i = tid; i < NT * kp; i += THREADS) {
    const int n = i % NT, k = i / NT;
    Raw v = 0;
    if (k < K && n < N) v = b_bits[(size_t)k * N + n];
    *reinterpret_cast<Raw*>(b_s + n * stride + k * ES) = v;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool vector_rows = (K * ES) % 16 == 0;
  const int tiles = (M + TM - 1) / TM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * TM;
    __syncthreads();  // B is staged / the last tile's A is consumed
    if (vector_rows) {
      const int vecs = K * ES / 16;
      for (int i = tid; i < TM * vecs; i += THREADS) {
        const int r = i / vecs, v = i % vecs;
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M)
          q = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(a_bits) +
              (size_t)(m0 + r) * K * ES + v * 16);
        *reinterpret_cast<uint4*>(a_s + r * stride + v * 16) = q;
      }
      for (int i = tid; i < TM * (kp - K); i += THREADS) {
        const int r = i / (kp - K), k = K + i % (kp - K);
        *reinterpret_cast<Raw*>(a_s + r * stride + k * ES) = 0;
      }
    } else {
      for (int i = tid; i < TM * kp; i += THREADS) {
        const int r = i / kp, k = i % kp;
        Raw v = 0;
        if (k < K && m0 + r < M) v = a_bits[(size_t)(m0 + r) * K + k];
        *reinterpret_cast<Raw*>(a_s + r * stride + k * ES) = v;
      }
    }
    __syncthreads();

    Acc acc[NI][4];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[ni][j] = 0;
    for (int k0 = 0; k0 < kp; k0 += KS) {
      uint32_t af[4];
      const unsigned char* pa =
          a_s + (warp * 16 + g) * stride + (k0 + t4 * EPR) * ES;
      af[0] = lds32(pa);
      af[1] = lds32(pa + 8 * stride);
      af[2] = lds32(pa + (KS / 2) * ES);
      af[3] = lds32(pa + 8 * stride + (KS / 2) * ES);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const unsigned char* pb =
            b_s + (ni * 8 + g) * stride + (k0 + t4 * EPR) * ES;
        uint32_t bf[2];
        bf[0] = lds32(pb);
        bf[1] = lds32(pb + (KS / 2) * ES);
        mma_tile<MT>(acc[ni], af, bf);
      }
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = ni * 8 + 2 * t4;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp * 16 + g + 8 * h;
        if (row >= M) continue;
        Acc* p = out + (size_t)row * N + col;
        p[0] = acc[ni][2 * h];
        p[1] = acc[ni][2 * h + 1];
      }
    }
  }
}

template <typename MT, int NT>
cudaError_t launch(const void* a, const void* b, void* out, int M, int K,
                   int N, int blocks, cudaStream_t stream) {
  constexpr int KS = Traits<MT>::KS;
  const int kp = (K + KS - 1) / KS * KS;
  const size_t smem =
      (size_t)(NT + TM) * (kp * sizeof(MT) + ROW_PAD_BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  matmul_kernel<MT, NT><<<blocks, THREADS, smem, stream>>>(
      static_cast<const MT*>(a), static_cast<const MT*>(b),
      static_cast<typename Traits<MT>::Acc*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename MT>
cudaError_t dispatch(const void* a, const void* b, void* out, int M, int K,
                     int N, int blocks, cudaStream_t s) {
  if (N <= 8) return launch<MT, 8>(a, b, out, M, K, N, blocks, s);
  if (N <= 16) return launch<MT, 16>(a, b, out, M, K, N, blocks, s);
  if (N <= 32) return launch<MT, 32>(a, b, out, M, K, N, blocks, s);
  if (N <= 64) return launch<MT, 64>(a, b, out, M, K, N, blocks, s);
  return launch<MT, 128>(a, b, out, M, K, N, blocks, s);
}

}  // namespace

extern "C" {

// out (M, N) = a (M, K) . b (K, N) on `stream`, one launch of `blocks`
// blocks. is_int8: int8 inputs and int32 output, else bfloat16 inputs and
// float32 output. N is a multiple of 8, at most 128. Returns a cudaError_t.
int pwg_matmul_bench(int is_int8, const void* a, const void* b, void* out,
                     int M, int K, int N, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 8 || N > 128 || N % 8 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (is_int8) return (int)dispatch<int8_t>(a, b, out, M, K, N, blocks, s);
  return (int)dispatch<__nv_bfloat16>(a, b, out, M, K, N, blocks, s);
}

const char* pwg_matmul_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
