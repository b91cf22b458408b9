// One HiFi-GAN multi-receptive-field (MRF) stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mrf_kernel`
// (parallelwavegan_tpu/ops/pallas/mrf_stage.py:75). For x (B, T, C) and
// every branch b (kernel size k_b), layer by layer (dilation d):
//
//   y1 = conv_{k_b, d}(leaky(xb)) + bias       xb starts as x
//   y2 = conv_{k_b, 1}(leaky(y1)) + bias
//   xb = xb + y2
//   out = (xb_0 + xb_1 + ...) / n_branches     summed in f32, rounded once
//
// Every conv zero-pads at the *sequence* ends and is one contraction of
// depth k_b * C: int8 x int8 -> int32 with the activation quantised per
// input channel, q = clip(rint(v * (1/sx)), +-127), and the epilogue
// float(acc) * sw + bias as two roundings; or bf16 / f32 -> f32 + bias. The
// residual stream and y1 are f32 in every mode.
//
// Design. The TPU kernel keeps a halo'd window of the f32 residual, a
// second one, a LeakyReLU scratch and a (rows, 11 C) tap window in tens of
// MB of VMEM across nine sequential grid steps. A Hopper block has 227 KB
// and blocks do not run in order, so none of that carries over. Here one
// launch is one conv of the stage for all branches at once
// (grid = (ceil(T / 128), B, branches x column tiles), 128 threads), the
// residual xb and the intermediate y1 live in f32 global scratch, one
// buffer per branch, and a last small launch takes the branch mean:
// 2 * layers + 1 launches a stage (7 for HiFi-GAN v1). Because every launch
// works on whole-sequence buffers, rows outside [0, T) simply read as zero
// when a block stages its input: no tile ever feeds halo rows computed
// past the sequence end into the next conv. Per launch a block
//   1. stages its input window, TT + (k - 1) d rows x C channels, through
//      LeakyReLU and the rounding (or quantisation) to the matmul type into
//      shared memory;
//   2. streams the conv's weights, stored transposed as (C_out, K) so that
//      the contraction index is contiguous, through shared memory in
//      chunks of 128 bytes a row (they stay L2 resident: one conv's
//      weights are at most 0.7 MB);
//   3. multiplies with mma.sync on the tensor cores (int8, bf16) or with
//      the f32 tile of mma_common.cuh: each warp owns 32 rows x up to 64
//      columns; the A operand of tap j is the window shifted by j d rows,
//      so the tap gather costs nothing beyond an address;
//   4. adds the bias (and the residual for the second conv) and writes f32.
//
// Bound (HiFi-GAN v1, batch 32 x 512 frames): 2 * 2 * 3 * 21 * C^2 FLOP
// per row, 1.1e12 to 4.3e12 FLOP a stage, against one read and one write
// of (B, T, C): operations bound every stage. This first version pays
// about 12 bytes per element and conv of f32 scratch traffic on top
// (18 convs a stage) and does not overlap its loads with its mma's; fusing
// the conv pair over a 5-row halo, bf16 scratch, cp.async / TMA pipelines
// and wgmma are the next steps.

#include "mma_common.cuh"

namespace {

using namespace pwgmma;

constexpr int TT = 128;       // time rows per block: 4 warps x 32 rows
constexpr int THREADS = 128;
constexpr int MAX_BRANCHES = 4;
constexpr int CHUNK_BYTES = 128;  // weight bytes per output row and chunk
constexpr int W_STRIDE = CHUNK_BYTES + ROW_PAD_BYTES;

// where a conv reads its input or residual from
enum Kind { kScratch = 0, kInputF32 = 1, kInputBF16 = 2 };

struct ConvArgs {
  const void* wt[MAX_BRANCHES];   // (C, kpad) weights of this conv, transposed
  const float* sc[MAX_BRANCHES];  // (4, C) rows [1/sx, sw, bias, 0]
  int k[MAX_BRANCHES];            // kernel size per branch
  int kpad[MAX_BRANCHES];         // k * C rounded up to 32
  const void* src;                // conv input
  const void* res;                // residual (second conv only)
  float* dst;                     // f32 scratch, (branches, B, T, C)
  int src_kind, res_kind;
  int T, C, log2c, d, n_ct, second;
  float slope;
};

__device__ __forceinline__ void load4_kind(const void* p, int kind, size_t i,
                                           float v[4]) {
  if (kind == kInputBF16) {
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    const float2 a = __bfloat1622float2(q[0]);
    const float2 b = __bfloat1622float2(q[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const float4 q =
        *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
}

// four activations -> the matmul type, into the staged window
template <typename MT>
__device__ __forceinline__ void store_mm(unsigned char* p, const float v[4],
                                         const float* inv_sx);
template <>
__device__ __forceinline__ void store_mm<float>(unsigned char* p,
                                                const float v[4],
                                                const float*) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_mm<__nv_bfloat16>(unsigned char* p,
                                                        const float v[4],
                                                        const float*) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_mm<int8_t>(unsigned char* p,
                                                 const float v[4],
                                                 const float* inv_sx) {
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    packed |= quant_byte(__fmul_rn(v[j], inv_sx[j])) << (8 * j);
  *reinterpret_cast<uint32_t*>(p) = packed;
}

// MT: matmul type; NT: output columns per block (8, 16, 32 or 64)
template <typename MT, int NT>
__global__ void __launch_bounds__(THREADS) mrf_conv_kernel(const ConvArgs a) {
  using Acc = typename Traits<MT>::Acc;
  constexpr int KS = Traits<MT>::KS;
  constexpr int EPR = Traits<MT>::EPR;
  constexpr int ES = (int)sizeof(MT);
  constexpr int KC = CHUNK_BYTES / ES;  // contraction elements per chunk
  constexpr int NI = NT / 8;

  extern __shared__ float4 smem4[];
  unsigned char* w_s = reinterpret_cast<unsigned char*>(smem4);  // [NT][W_STRIDE]
  unsigned char* win = w_s + NT * W_STRIDE;                      // [rows][stride]

  const int tid = threadIdx.x;
  const int branch = blockIdx.z / a.n_ct;
  const int col0 = (blockIdx.z % a.n_ct) * NT;
  const int item = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int T = a.T, C = a.C, d = a.d;
  const int k = a.k[branch], kpad = a.kpad[branch];
  const int K = k * C;
  const int half = (k - 1) / 2;
  const int stride = C * ES + ROW_PAD_BYTES;
  const size_t plane = (size_t)gridDim.y * T * C;  // one branch of scratch
  const size_t item0 = (size_t)item * T * C;
  const float* sc = a.sc[branch];

  // 1. the input window: rows t0 - half d .. t0 + TT - 1 + half d
  {
    const size_t src0 = item0 + (a.src_kind == kScratch ? branch * plane : 0);
    const int c4 = C / 4;
    const int rows = TT + (k - 1) * d;
    for (int i = tid; i < rows * c4; i += THREADS) {
      const int ch = (i % c4) * 4;
      const int r = i / c4;
      const int t = t0 - half * d + r;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (t >= 0 && t < T)
        load4_kind(a.src, a.src_kind, src0 + (size_t)t * C + ch, v);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = v[j] >= 0.f ? v[j] : __fmul_rn(v[j], a.slope);
      store_mm<MT>(win + r * stride + ch * ES, v, sc + ch);
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 32;
  Acc acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const unsigned char* wt = static_cast<const unsigned char*>(a.wt[branch]);
  for (int k0 = 0; k0 < kpad; k0 += KC) {
    __syncthreads();  // the window is staged / the last chunk is consumed
    // 2. weights [col0 .. col0 + NT) x [k0 .. k0 + KC), 16 bytes a load
    for (int i = tid; i < NT * (CHUNK_BYTES / 16); i += THREADS) {
      const int n = i / (CHUNK_BYTES / 16);
      const int v = i % (CHUNK_BYTES / 16);
      const int kk = k0 + v * (16 / ES);
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (kk < kpad)
        q = *reinterpret_cast<const uint4*>(
            wt + ((size_t)(col0 + n) * kpad + kk) * ES);
      *reinterpret_cast<uint4*>(w_s + n * W_STRIDE + v * 16) = q;
    }
    __syncthreads();
    // 3. the k-steps of this chunk
    const int steps = min(KC, kpad - k0) / KS;
    for (int ks = 0; ks < steps; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kk = k0 + ks * KS + j * (KS / 2) + t4 * EPR;
        const int tap = kk >> a.log2c;
        const int ch = kk & (C - 1);
        const bool valid = kk < K;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const unsigned char* p =
              win + (wrow + mi * 16 + g + tap * d) * stride + ch * ES;
          af[mi][2 * j] = valid ? lds32(p) : 0u;
          af[mi][2 * j + 1] = valid ? lds32(p + 8 * stride) : 0u;
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const unsigned char* p =
            w_s + (ni * 8 + g) * W_STRIDE + (ks * KS + t4 * EPR) * ES;
        uint32_t bf[2];
        bf[0] = lds32(p);
        bf[1] = lds32(p + (KS / 2) * ES);
        mma_tile<MT>(acc[0][ni], af[0], bf);
        mma_tile<MT>(acc[1][ni], af[1], bf);
      }
    }
  }

  // 4. epilogue: rescale, bias, residual; two columns a store
  const size_t dst0 = branch * plane + item0;
  const size_t res0 = item0 + (a.res_kind == kScratch ? branch * plane : 0);
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = col0 + ni * 8 + 2 * t4;
    const float sw0 = sc[C + col], sw1 = sc[C + col + 1];
    const float b0 = sc[2 * C + col], b1 = sc[2 * C + col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wrow + mi * 16 + g + 8 * h;
        if (t >= T) continue;
        float y0 = (float)acc[mi][ni][2 * h];
        float y1 = (float)acc[mi][ni][2 * h + 1];
        if (sizeof(MT) == 1) {
          y0 = __fmul_rn(y0, sw0);
          y1 = __fmul_rn(y1, sw1);
        }
        y0 = __fadd_rn(y0, b0);
        y1 = __fadd_rn(y1, b1);
        const size_t at = (size_t)t * C + col;
        if (a.second) {
          float r0, r1;
          if (a.res_kind == kInputBF16) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const __nv_bfloat16*>(a.res) + res0 + at));
            r0 = r.x; r1 = r.y;
          } else {
            const float2 r = *reinterpret_cast<const float2*>(
                static_cast<const float*>(a.res) + res0 + at);
            r0 = r.x; r1 = r.y;
          }
          y0 = __fadd_rn(r0, y0);
          y1 = __fadd_rn(r1, y1);
        }
        *reinterpret_cast<float2*>(a.dst + dst0 + at) = make_float2(y0, y1);
      }
  }
}

// out = (xb_0 + xb_1 + ...) / n (an IEEE division, as the plain version
// takes it), four elements a thread
__global__ void mrf_mean_kernel(const float* __restrict__ xb, void* out,
                                int out_bf16, size_t n, int n_branches) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(xb + i);
  for (int b = 1; b < n_branches; ++b) {
    const float4 v = *reinterpret_cast<const float4*>(xb + b * n + i);
    s.x = __fadd_rn(s.x, v.x); s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z); s.w = __fadd_rn(s.w, v.w);
  }
  const float nb = (float)n_branches;
  s.x = __fdiv_rn(s.x, nb); s.y = __fdiv_rn(s.y, nb);
  s.z = __fdiv_rn(s.z, nb); s.w = __fdiv_rn(s.w, nb);
  if (out_bf16) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(
        static_cast<__nv_bfloat16*>(out) + i);
    q[0] = __floats2bfloat162_rn(s.x, s.y);
    q[1] = __floats2bfloat162_rn(s.z, s.w);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = s;
  }
}

template <typename MT, int NT>
cudaError_t run_conv(const ConvArgs& a, int B, int n_branches, size_t smem,
                     cudaStream_t stream) {
  const dim3 grid((a.T + TT - 1) / TT, B, n_branches * a.n_ct);
  mrf_conv_kernel<MT, NT><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename MT, int NT>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(mrf_conv_kernel<MT, NT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename MT>
cudaError_t run_stage(int x_bf16, const void* x, void* out,
                      const void* const* wt, const float* const* sc,
                      const int* kernels, const int* dils, int n_branches,
                      int n_layers, int B, int T, int C, float slope,
                      float* xb, float* y1, cudaStream_t stream) {
  const int NT = C < 64 ? C : 64;
  int log2c = 0;
  while ((1 << log2c) < C) ++log2c;
  int kmax = 0, dmax = 1;
  for (int b = 0; b < n_branches; ++b)
    if (kernels[b] > kmax) kmax = kernels[b];
  for (int l = 0; l < n_layers; ++l)
    if (dils[l] > dmax) dmax = dils[l];
  const size_t smem =
      (size_t)NT * W_STRIDE +
      (size_t)(TT + (kmax - 1) * dmax) * (C * sizeof(MT) + ROW_PAD_BYTES);
  cudaError_t err = NT == 8    ? allow_smem<MT, 8>(smem)
                    : NT == 16 ? allow_smem<MT, 16>(smem)
                    : NT == 32 ? allow_smem<MT, 32>(smem)
                               : allow_smem<MT, 64>(smem);
  if (err != cudaSuccess) return err;

  ConvArgs a;
  a.T = T; a.C = C; a.log2c = log2c; a.n_ct = C / NT; a.slope = slope;
  const int x_kind = x_bf16 ? kInputBF16 : kInputF32;
  for (int l = 0; l < n_layers; ++l)
    for (int ci = 0; ci < 2; ++ci) {
      for (int b = 0; b < n_branches; ++b) {
        a.k[b] = kernels[b];
        a.kpad[b] = (kernels[b] * C + 31) / 32 * 32;
        a.wt[b] = static_cast<const unsigned char*>(wt[b]) +
                  (size_t)(l * 2 + ci) * C * a.kpad[b] * sizeof(MT);
        a.sc[b] = sc[b] + (size_t)(l * 2 + ci) * 4 * C;
      }
      a.second = ci;
      a.d = ci == 0 ? dils[l] : 1;
      if (ci == 0) {  // y1 = conv(leaky(xb))
        a.src = l == 0 ? x : xb;
        a.src_kind = l == 0 ? x_kind : kScratch;
        a.res = nullptr; a.res_kind = kScratch;
        a.dst = y1;
      } else {        // xb = xb + conv(leaky(y1)), in place
        a.src = y1; a.src_kind = kScratch;
        a.res = l == 0 ? x : xb;
        a.res_kind = l == 0 ? x_kind : kScratch;
        a.dst = xb;
      }
      err = NT == 8    ? run_conv<MT, 8>(a, B, n_branches, smem, stream)
            : NT == 16 ? run_conv<MT, 16>(a, B, n_branches, smem, stream)
            : NT == 32 ? run_conv<MT, 32>(a, B, n_branches, smem, stream)
                       : run_conv<MT, 64>(a, B, n_branches, smem, stream);
      if (err != cudaSuccess) return err;
    }
  const size_t n = (size_t)B * T * C;
  const unsigned blocks = (unsigned)((n / 4 + 255) / 256);
  mrf_mean_kernel<<<blocks, 256, 0, stream>>>(xb, out, x_bf16, n, n_branches);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs one MRF stage on `stream`: 2 * n_layers conv launches and the mean.
// Returns a cudaError_t (0 on success). The Python wrapper checks shapes,
// types and alignment before the call.
// x_bf16: x and out are bfloat16 (else float32), both (B, T, C).
// mm_type: 0 = float32, 1 = bfloat16, 2 = int8 weights and products.
// wt[b]: (n_layers, 2, C, kpad_b) transposed weights, kpad_b = k_b C rounded
// up to 32, zero beyond k_b C; sc[b]: (n_layers, 2, 4, C) f32 rows
// [1/sx, sw, bias, 0]; kernels, dils on the host; xb, y1: f32 scratch of
// (n_branches, B, T, C) each. C is a power of two, 8 to 256.
int pwg_mrf_stage_forward(int x_bf16, int mm_type, const void* x, void* out,
                          const void* const* wt, const float* const* sc,
                          const int* kernels, const int* dils, int n_branches,
                          int n_layers, int B, int T, int C, float slope,
                          void* xb, void* y1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xbf = static_cast<float*>(xb);
  float* y1f = static_cast<float*>(y1);
  if (n_branches < 1 || n_branches > MAX_BRANCHES || C < 8 || C > 256 ||
      (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  if (mm_type == 0)
    return (int)run_stage<float>(x_bf16, x, out, wt, sc, kernels, dils,
                                 n_branches, n_layers, B, T, C, slope, xbf,
                                 y1f, s);
  if (mm_type == 1)
    return (int)run_stage<__nv_bfloat16>(x_bf16, x, out, wt, sc, kernels, dils,
                                         n_branches, n_layers, B, T, C, slope,
                                         xbf, y1f, s);
  if (mm_type == 2)
    return (int)run_stage<int8_t>(x_bf16, x, out, wt, sc, kernels, dils,
                                  n_branches, n_layers, B, T, C, slope, xbf,
                                  y1f, s);
  return (int)cudaErrorInvalidValue;
}

const char* pwg_mrf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
