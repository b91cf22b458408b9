// Tall-skinny matrix product at the MRF stage's contraction shapes, for
// Hopper (sm_90a): (M, K) . (K, N) with int8 -> int32 or bf16 -> f32.
//
// Replaces the Pallas TPU kernel `kernel` of `pallas_matmul_bench`
// (tools/int8_stage_roofline.py:150): the measurement of what the matrix
// unit delivers for tall products with a short contraction (K = k C, 96 to
// 384) and a narrow output (N = C, 32 to 128), which are the shapes of
// every conv in mrf_stage.cu.
//
// Bound: the bytes, not the operations. M = 131072, K = 352, N = 32 in int8
// reads 46 MB of A and writes 17 MB of int32 (19 us at 3.35 TB/s) for
// 3.0e9 operations (1.5 us at the int8 peak); the five MRF shapes together
// move 172 MB in int8 (51 us) and 260 MB in bf16 (78 us). So the design
// keeps the memory system busy without a pause and touches each byte once:
//   - persistent blocks (the grid is the instantiation's occupancy times
//     the SMs, chosen by the wrapper) stage B once, transposed to [n][k], and
//     keep it resident while they walk row tiles blockIdx.x, + gridDim.x, ...;
//   - A tiles (TM = 128 rows where N <= 32, else 64) arrive through a ring
//     of STAGES (2 to 4, the most that fits 227 KB) shared-memory buffers
//     filled by cp.async (pipeline.cuh) while the warps multiply the tile
//     before: STAGES - 1 tiles are always in flight;
//   - each warp owns 16 rows x all N columns; ldmatrix loads its A fragment
//     and the B fragments of two n-tiles per instruction (rows padded to an
//     odd number of 16-byte chunks: no bank conflicts), mma.sync does the
//     products (mma_common.cuh);
//   - the epilogue goes through shared memory (the warp's own A rows of the
//     consumed stage where they are wide enough, else a scratch tile) and
//     leaves as whole 16-byte row pieces.
// M is ragged-safe, K is zero-padded to the mma depth (rows whose length is
// not a multiple of 16 bytes are staged synchronously), N is a multiple of 8
// up to 128.

#include "mma_common.cuh"
#include "pipeline.cuh"

namespace {

using namespace pwgmma;
using namespace pwgpipe;

// the bits of one element, for copies that do no arithmetic
template <typename MT>
struct Bits;
template <>
struct Bits<int8_t> { using type = uint8_t; };
template <>
struct Bits<__nv_bfloat16> { using type = uint16_t; };

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// shared-memory plan, mirrored by matmul_plan() in ops/cuda/matmul_bench.py
struct Plan {
  int kp;      // K padded to the mma depth
  int stride;  // bytes per staged row (A and B^T): an odd count of 16 B
  bool alias;  // the epilogue reuses the warp's own A rows
  size_t smem;
};

template <typename MT, int NT, int TM>
__host__ __device__ inline Plan make_plan(int K, int stages) {
  Plan p;
  p.kp = (K + Traits<MT>::KS - 1) / Traits<MT>::KS * Traits<MT>::KS;
  p.stride = p.kp * (int)sizeof(MT) + ROW_PAD_BYTES;
  p.alias = p.stride >= (NT + 8) * 4;
  p.smem = (size_t)(NT + stages * TM) * p.stride +
           (p.alias ? 0 : (size_t)(TM / 16) * 16 * (NT + 8) * 4);
  return p;
}

template <typename MT, int NT, int TM>
__global__ void __launch_bounds__(TM * 2) matmul_kernel(
    const MT* __restrict__ a, const MT* __restrict__ b,
    typename Traits<MT>::Acc* __restrict__ out, int M, int K, int N,
    int stages) {
  using Acc = typename Traits<MT>::Acc;
  using Raw = typename Bits<MT>::type;
  constexpr int KS = Traits<MT>::KS;
  constexpr int ES = (int)sizeof(MT);
  constexpr int NI = NT / 8;
  constexpr int THREADS = TM * 2;  // one warp per 16 rows
  const Plan plan = make_plan<MT, NT, TM>(K, stages);
  const int kp = plan.kp, st = plan.stride;

  extern __shared__ float4 smem4[];
  unsigned char* b_s = reinterpret_cast<unsigned char*>(smem4);  // [NT][st]
  unsigned char* a_s = b_s + NT * st;                  // [stages][TM][st]
  unsigned char* c_scratch = a_s + (size_t)stages * TM * st;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int tiles = (M + TM - 1) / TM;
  const bool vector_rows = (K * ES) % 16 == 0;
  const unsigned char* a_bytes = reinterpret_cast<const unsigned char*>(a);
  // fill ring slot `slot` with row tile `tile` (nothing past the last tile);
  // always one commit group, so group counts stay aligned with tiles
  auto fill = [&](int tile, int slot) {
    if (tile < tiles) {
      unsigned char* dst = a_s + (size_t)slot * TM * st;
      const int m0 = tile * TM;
      if (vector_rows) {
        const int chunks = kp * ES / 16, valid = K * ES / 16;
        for (int i = tid; i < TM * chunks; i += THREADS) {
          const int r = i / chunks, v = i % chunks;
          const bool ok = v < valid && m0 + r < M;
          cp_async16(dst + r * st + v * 16,
                     ok ? a_bytes + ((size_t)(m0 + r) * K * ES + v * 16)
                        : a_bytes,
                     ok);
        }
      } else {
        const Raw* a_bits = reinterpret_cast<const Raw*>(a);
        for (int i = tid; i < TM * kp; i += THREADS) {
          const int r = i / kp, k = i % kp;
          Raw v = 0;
          if (k < K && m0 + r < M) v = a_bits[(size_t)(m0 + r) * K + k];
          *reinterpret_cast<Raw*>(dst + r * st + k * ES) = v;
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < stages - 1; ++s)
    fill(blockIdx.x + s * gridDim.x, s);

  // B, transposed, zero beyond K and N, while the first tiles arrive: the
  // rows of b come in 8-byte pieces (N is a multiple of 8), a batch of
  // loads in flight before their elements are scattered into the columns
  for (int i = tid * 16; i < NT * st; i += THREADS * 16)
    *reinterpret_cast<uint4*>(b_s + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  {
    constexpr int EPP = 8 / ES;  // elements in one 8-byte piece
    constexpr int BATCH = 4;
    const int pieces = K * N / EPP;
    const uint2* b_pieces = reinterpret_cast<const uint2*>(b);
    for (int p0 = tid; p0 < pieces; p0 += BATCH * THREADS) {
      uint2 v[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int p = p0 + j * THREADS;
        v[j] = p < pieces ? b_pieces[p] : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int p = p0 + j * THREADS;
        if (p >= pieces) break;
        const int k = p * EPP / N, n0 = p * EPP % N;
        const Raw* e = reinterpret_cast<const Raw*>(&v[j]);
#pragma unroll
        for (int q = 0; q < EPP; ++q)
          *reinterpret_cast<Raw*>(b_s + (n0 + q) * st + k * ES) = e[q];
      }
    }
  }

  // ldmatrix row addresses of this lane (see pipeline.cuh): A matrix
  // lane / 8 covers rows +8 for odd matrices and bytes +16 for the upper
  // two; B matrix lane / 8 covers bytes +16 for odd and n +8 for the upper
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  int slot = 0;
  for (int it = 0;; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    if (tile >= tiles) break;
    fill(tile + (stages - 1) * gridDim.x, (slot + stages - 1) % stages);
    // all but the stages - 1 newest groups have landed: this tile
    if (stages == 2) cp_async_wait<1>();
    else if (stages == 3) cp_async_wait<2>();
    else cp_async_wait<3>();
    __syncthreads();

    unsigned char* tile_s = a_s + (size_t)slot * TM * st;
    Acc acc[NI][4];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[ni][j] = 0;
    for (int k0 = 0; k0 < kp * ES; k0 += KS * ES) {
      uint32_t af[4];
      ldmatrix_x4(af, tile_s + a_row * st + k0 + a_col);
      if constexpr (NI == 1) {
        uint32_t bf[2];
        ldmatrix_x2(bf, b_s + (lane & 7) * st + k0 + b_col);
        mma_tile<MT>(acc[0], af, bf);
      } else {
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_s + (np * 16 + b_row) * st + k0 + b_col);
          mma_tile<MT>(acc[2 * np], af, bf);
          mma_tile<MT>(acc[2 * np + 1], af, bf + 2);
        }
      }
    }

    // epilogue: fragments -> this warp's 16 x NT staging rows -> 16-byte
    // pieces of whole output rows
    __syncwarp();  // every lane is done reading its A rows
    unsigned char* c_s = plan.alias
                             ? tile_s + warp * 16 * st
                             : c_scratch + warp * 16 * (NT + 8) * 4;
    const int cst = plan.alias ? st : (NT + 8) * 4;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Acc* p = reinterpret_cast<Acc*>(c_s + (g + 8 * h) * cst) + ni * 8 +
                 2 * t4;
        p[0] = acc[ni][2 * h];
        p[1] = acc[ni][2 * h + 1];
      }
    __syncwarp();
    const int row0 = tile * TM + warp * 16;
    constexpr int PIECES = NT / 4;  // 16 bytes = 4 results
    for (int i = lane; i < 16 * PIECES; i += 32) {
      const int r = i / PIECES, v = i % PIECES;
      if (row0 + r < M && v * 4 < N)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + v * 4) =
            *reinterpret_cast<const uint4*>(c_s + r * cst + v * 16);
    }
    __syncthreads();  // the slot may be refilled by the next iteration
    slot = (slot + 1) % stages;
  }
  cp_async_wait<0>();
}

// allow the instantiation the most dynamic shared memory a block may use,
// once per process (the launch asks for what its plan needs)
template <typename MT, int NT, int TM>
cudaError_t prepare(int K, int stages, size_t* smem) {
  static cudaError_t allowed = cudaFuncSetAttribute(
      matmul_kernel<MT, NT, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  *smem = make_plan<MT, NT, TM>(K, stages).smem;
  if (allowed != cudaSuccess) return allowed;
  return *smem > (size_t)kMaxSmem ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename MT, int NT, int TM>
cudaError_t run(const void* a, const void* b, void* out, int M, int K, int N,
                int stages, int blocks, int* occupancy, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare<MT, NT, TM>(K, stages, &smem);
  if (err != cudaSuccess) return err;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, matmul_kernel<MT, NT, TM>, TM * 2, smem);
  matmul_kernel<MT, NT, TM><<<blocks, TM * 2, smem, stream>>>(
      static_cast<const MT*>(a), static_cast<const MT*>(b),
      static_cast<typename Traits<MT>::Acc*>(out), M, K, N, stages);
  return cudaGetLastError();
}

// NT: N rounded up to 8, 16, 32, 64 or 128; TM = 128 rows for NT <= 32
template <typename MT>
cudaError_t dispatch(const void* a, const void* b, void* out, int M, int K,
                     int N, int stages, int blocks, int* occ, cudaStream_t s) {
  if (N <= 8) return run<MT, 8, 128>(a, b, out, M, K, N, stages, blocks, occ, s);
  if (N <= 16)
    return run<MT, 16, 128>(a, b, out, M, K, N, stages, blocks, occ, s);
  if (N <= 32)
    return run<MT, 32, 128>(a, b, out, M, K, N, stages, blocks, occ, s);
  if (N <= 64) return run<MT, 64, 64>(a, b, out, M, K, N, stages, blocks, occ, s);
  return run<MT, 128, 64>(a, b, out, M, K, N, stages, blocks, occ, s);
}

}  // namespace

extern "C" {

// out (M, N) = a (M, K) . b (K, N) on `stream`, one launch of `blocks`
// persistent blocks with a ring of `stages` A tiles. is_int8: int8 inputs
// and int32 output, else bfloat16 inputs and float32 output. N is a
// multiple of 8, at most 128. Returns a cudaError_t.
int pwg_matmul_bench(int is_int8, const void* a, const void* b, void* out,
                     int M, int K, int N, int stages, int blocks,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 8 || N > 128 || N % 8 || blocks < 1 ||
      stages < 2 || stages > 4)
    return (int)cudaErrorInvalidValue;
  if (is_int8)
    return (int)dispatch<int8_t>(a, b, out, M, K, N, stages, blocks, nullptr,
                                 s);
  return (int)dispatch<__nv_bfloat16>(a, b, out, M, K, N, stages, blocks,
                                      nullptr, s);
}

// blocks of the instantiation for (is_int8, N, K, stages) that fit one SM
int pwg_matmul_bench_occupancy(int is_int8, int K, int N, int stages,
                               int* blocks_per_sm) {
  if (K < 1 || N < 8 || N > 128 || N % 8 || stages < 2 || stages > 4)
    return (int)cudaErrorInvalidValue;
  if (is_int8)
    return (int)dispatch<int8_t>(nullptr, nullptr, nullptr, 1, K, N, stages,
                                 1, blocks_per_sm, nullptr);
  return (int)dispatch<__nv_bfloat16>(nullptr, nullptr, nullptr, 1, K, N,
                                      stages, 1, blocks_per_sm, nullptr);
}

const char* pwg_matmul_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
