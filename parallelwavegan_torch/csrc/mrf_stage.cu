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
// Two bodies, chosen by mrf_stage_plan() in ops/cuda/mrf_stage.py from the
// shape and the types alone (never on a failure):
//
// The fused-pair body (bf16 and int8 packs, C 32 to 256): one launch per
// layer for all branches, and one for the branch mean, n_layers + 1 launches
// a stage (4 for HiFi-GAN v1). A block owns one branch and one time tile of
// TT = M - (k - 1) output rows (the widest kernel's blocks first) and
// computes every output column:
//   1. the input window, M + (k - 1) d rows from t0 - half (d + 1), is read
//      once from x (layer 0) or the branch's f32 residual (8 loads of 16
//      bytes in flight a thread), passed through LeakyReLU and rounded
//      (bf16) or quantised with the first conv's 1/sx (int8) once, into
//      shared memory; rows outside [0, T) are zero;
//   2. the first conv is computed over M = TT + (k - 1) rows, the tile plus
//      the second conv's halo; its epilogue (float(acc) * sw, + bias, as two
//      roundings), LeakyReLU and the rounding or quantisation with the
//      *second* conv's 1/sx run in registers, and y1 goes to shared memory
//      in the matmul type, over the window (a block computes every column in
//      one pass). Rows of y1 outside [0, T) are stored as zeros: the second
//      conv zero-pads at the sequence end, not the tile end. y1 never
//      reaches global memory;
//   3. the second conv reads y1 from shared memory; its epilogue adds the
//      f32 residual and writes the branch's f32 residual (ping-pong buffers:
//      a neighbouring block may still read the old one as its halo);
//   4. the weights of both convs, transposed to (C_out, kpad), stream
//      through a three-slot cp.async ring (pipeline.cuh) of 128-byte chunks
//      of all C output rows, chunk i + 2 in flight while chunk i is
//      multiplied; one __syncthreads a chunk; every weight byte brought
//      from L2 feeds M = 128 (C 128, 256) or 256 (C 32, 64) rows;
//   5. fragments load by ldmatrix (A: the window shifted by tap * d rows,
//      so the tap gather is an address; B: the ring slot), mma.sync does
//      the products (m16n8k16 bf16 -> f32, m16n8k32 int8 -> int32); 8
//      warps (run_pair_c lists each width's tiling).
// The mean launch sums ((xb0 + xb1) + xb2) in f32, divides (IEEE) by the
// branch count and rounds once to x's type.
//
// The per-conv body (f32 packs, the parity mode, and C 8 and 16): one
// launch per conv for all branches over f32 global scratch for y1 and the
// residual, and the mean, 2 n_layers + 1 launches: per launch a block
// stages its window through LeakyReLU and the rounding, streams the conv's
// weights through shared memory in synchronous 128-byte chunks and
// multiplies with mma.sync (or mma_common.cuh's f32 tile).
//
// Bound (HiFi-GAN v1, batch 32 x 512 frames): 2 * 2 * 3 * 21 * C^2 FLOP
// per row, 1.1e12 to 4.3e12 FLOP a stage (9.74e12 for the four, 9.85 ms at
// the bf16 peak, 4.92 ms at the int8 one), against one read and one write
// of (B, T, C): operations bound every stage. The fused-pair body moves
// about 3 (2 + 4) + 3 (8 + 8) x 2 + 14 = 80 bytes an element and stage
// (bf16 x; the window halo is read again, mostly from L2), against the
// per-conv body's ~194: a floor of 3.2 ms at C 128-32, 0.8 ms at C 256.
// What the per-conv body loses and what the fused one does about it: (1)
// the f32 round trips of y1 and the residual between 7 launches -> y1 on
// chip, 4 launches; (2) synchronous weight staging, two barriers a chunk ->
// the ring, one barrier; (3) the window staged once per 64-column tile ->
// once per tile for all columns; (4) 32-bit fragment gathers -> ldmatrix;
// (5) two 4-warp blocks an SM at C 256 -> one 8-warp block with y1 over the
// window (two blocks an SM at C 128 and 64, three at C 32). Measured
// (tools/mrf_stage_ablation.py, PERF.md): at C 256 the products take under
// half of the time; the rest is the latency of the serial phases (window,
// epilogue residual loads, weight chunks) that one block an SM cannot
// overlap. wgmma (B straight from a swizzled ring slot) was tried: where
// ptxas had to insert warpgroup waits around it, it measured no faster
// than mma.sync, and it was taken out.

#include "mma_common.cuh"
#include "pipeline.cuh"

namespace {

using namespace pwgmma;
using namespace pwgpipe;

constexpr int TT = 128;       // time rows per block: 4 warps x 32 rows
constexpr int THREADS = 128;
constexpr int MAX_BRANCHES = 4;
constexpr int CHUNK_BYTES = 128;  // weight bytes per output row and chunk
constexpr int W_STRIDE = CHUNK_BYTES + ROW_PAD_BYTES;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

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

// ---------------------------------------------------------------------------
// The fused-pair body.

// weight ring slots: chunk i + 2 is filled while chunk i is multiplied
constexpr int F_STAGES = 3;
constexpr int F_WSTRIDE = CHUNK_BYTES + ROW_PAD_BYTES;  // 9 x 16 B: odd

struct PairArgs {
  const void* wt[MAX_BRANCHES][2];   // the layer's two convs, (C, kpad)
  const float* sc[MAX_BRANCHES][2];  // (4, C) rows [1/sx, sw, bias, 0]
  int k[MAX_BRANCHES];
  int kpad[MAX_BRANCHES];
  int tiles[MAX_BRANCHES];           // time tiles of each branch
  const void* src;                   // layer input and residual
  float* dst;                        // (branches, B, T, C) f32
  size_t src_branch_stride;          // 0 for x, B T C for a residual buffer
  int src_bf16;
  int T, C, log2c, d, kmax, n_branches;
  float slope;
};

// four activations of a read-only source (x or the residual being read),
// through the non-coherent path, so that loads may run ahead of stores
__device__ __forceinline__ void ldg4_kind(const void* p, int bf16, size_t i,
                                          float v[4]) {
  if (bf16) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const float4 q =
        __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) +
                                              i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
}

__device__ __forceinline__ float2 ldg2_kind(const void* p, int bf16,
                                            size_t i) {
  if (bf16) {
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(
        static_cast<const __nv_bfloat16*>(p) + i));
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q));
  }
  return __ldg(
      reinterpret_cast<const float2*>(static_cast<const float*>(p) + i));
}

// two activations -> the matmul type, into y1
template <typename MT>
__device__ __forceinline__ void store2_mm(unsigned char* p, float v0, float v1,
                                          float inv0, float inv1);
template <>
__device__ __forceinline__ void store2_mm<__nv_bfloat16>(unsigned char* p,
                                                         float v0, float v1,
                                                         float, float) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
template <>
__device__ __forceinline__ void store2_mm<int8_t>(unsigned char* p, float v0,
                                                  float v1, float inv0,
                                                  float inv1) {
  *reinterpret_cast<uint16_t*>(p) =
      (uint16_t)(quant_byte(__fmul_rn(v0, inv0)) |
                 (quant_byte(__fmul_rn(v1, inv1)) << 8));
}

// shared memory of one launch: the window, y1 over it (the window is dead
// once the first conv is done) and the ring (mirrored by fused_smem_bytes()
// in ops/cuda/mrf_stage.py)
__host__ __device__ inline size_t fused_y1_offset(int rows, int C, int es,
                                                  int kmax, int d) {
  // the window's rows; y1's M + kmax - 1 are no more
  return (size_t)(rows + (kmax - 1) * d) * ((size_t)C * es + ROW_PAD_BYTES);
}
__host__ __device__ inline size_t fused_smem(int rows, int C, int es, int kmax,
                                             int d) {
  return fused_y1_offset(rows, C, es, kmax, d) +
         (size_t)F_STAGES * C * F_WSTRIDE;
}

// MT: matmul type; NC: the channels C, every output column in one pass;
// WM x WN warps along the rows and the columns; MI: 16-row m-tiles per warp
// (M = WM 16 MI); MINB: blocks an SM should hold (caps the registers).
template <typename MT, int NC, int WM, int WN, int MI, int MINB>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
    mrf_pair_kernel(const PairArgs a) {
  using Acc = typename Traits<MT>::Acc;
  constexpr int KS = Traits<MT>::KS;
  constexpr int ES = (int)sizeof(MT);
  constexpr int KC = CHUNK_BYTES / ES;  // contraction elements per chunk
  constexpr int THREADS = WM * WN * 32;
  constexpr int NI = NC / (8 * WN);     // n-tiles per warp, even
  constexpr int M = WM * 16 * MI;
  static_assert(NI % 2 == 0, "two n-tiles per B ldmatrix");

  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;

  // this block's branch and time tile; the last branch (the widest kernel,
  // the longest blocks) first. Constant indices keep PairArgs in the
  // parameter space
  int tile = blockIdx.x, branch = -1, k = 0, kpad = 0;
  const void* w0v = nullptr;
  const void* w1v = nullptr;
  const float* sc0 = nullptr;
  const float* sc1 = nullptr;
#pragma unroll
  for (int b = MAX_BRANCHES - 1; b >= 0; --b) {
    if (branch < 0 && b < a.n_branches) {
      if (tile < a.tiles[b]) {
        branch = b;
        k = a.k[b];
        kpad = a.kpad[b];
        w0v = a.wt[b][0];
        w1v = a.wt[b][1];
        sc0 = a.sc[b][0];
        sc1 = a.sc[b][1];
      } else {
        tile -= a.tiles[b];
      }
    }
  }
  const int T = a.T, d = a.d;
  constexpr int C = NC;
  const int half = (k - 1) / 2;
  const int tt = M - (k - 1);  // output rows of the tile
  const int t0 = tile * tt;
  const int st = C * ES + ROW_PAD_BYTES;
  const unsigned char* wt0 = static_cast<const unsigned char*>(w0v);
  const unsigned char* wt1 = static_cast<const unsigned char*>(w1v);
  unsigned char* win = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* y1s = win;  // over the window
  unsigned char* ring = win + fused_y1_offset(M, C, ES, a.kmax, d);
  // the weight chunks of both convs, in the order they are consumed: conv,
  // contraction chunk
  const int n_kc = (kpad + KC - 1) / KC;
  const int total = 2 * n_kc;
  auto fill = [&](int i) {
    if (i < total) {
      const int conv = i / n_kc, kc = i % n_kc;
      const unsigned char* w = conv == 0 ? wt0 : wt1;
      unsigned char* dst = ring + (size_t)(i % F_STAGES) * NC * F_WSTRIDE;
      for (int q = tid; q < NC * (CHUNK_BYTES / 16); q += THREADS) {
        const int n = q / (CHUNK_BYTES / 16), v = q % (CHUNK_BYTES / 16);
        const int kk = kc * KC + v * (16 / ES);
        const bool ok = kk < kpad;
        cp_async16(dst + n * F_WSTRIDE + v * 16,
                   ok ? w + ((size_t)n * kpad + kk) * ES : w, ok);
      }
    }
    cp_async_commit();
  };
  fill(0);
  fill(1);

  // 1. the window, while the first weight chunks are in flight
  const size_t item0 = (size_t)blockIdx.y * T * C;
  const size_t src0 = item0 + branch * a.src_branch_stride;
  {
    // BATCH loads of 4 elements in flight per thread before any is stored
    constexpr int BATCH = 8;
    const int c4 = C / 4;
    const int n4 = (M + (k - 1) * d) * c4;
    const int w0 = t0 - half * (d + 1);
    for (int i0 = tid; i0 < n4; i0 += THREADS * BATCH) {
      float v[BATCH][4];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = i0 + j * THREADS;
        const int t = w0 + (i >> (a.log2c - 2));
        v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
        if (i < n4 && t >= 0 && t < T)
          ldg4_kind(a.src, a.src_bf16,
                    src0 + (size_t)t * C + (i & (c4 - 1)) * 4, v[j]);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = i0 + j * THREADS;
        if (i >= n4) break;
        const int ch = (i & (c4 - 1)) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[j][q] = v[j][q] >= 0.f ? v[j][q] : __fmul_rn(v[j][q], a.slope);
        store_mm<MT>(win + (i >> (a.log2c - 2)) * st + ch * ES, v[j],
                     sc0 + ch);
      }
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mrow = (warp % WM) * 16 * MI;   // the warp's first row
  const int ncol = (warp / WM) * (NC / WN);  // its first column
  // ldmatrix row addresses of this lane (pipeline.cuh, matmul_bench.cu)
  const int a_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * st + (lane >> 4) * 16;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * F_WSTRIDE +
                    ((lane >> 3) & 1) * 16;

  Acc acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  for (int i = 0; i < total; ++i) {
    cp_async_wait<1>();  // chunk i has landed (chunk i + 1 may not)
    __syncthreads();  // for every thread; the window / y1 are complete; the
                      // slot of chunk i + 2 (chunk i - 1's) is free
    const int conv = i / n_kc, kc = i % n_kc;
    const unsigned char* w_s = ring + (size_t)(i % F_STAGES) * NC * F_WSTRIDE;
    const unsigned char* A = conv == 0 ? win : y1s;
    const int dd = conv == 0 ? d : 1;
    const int k0 = kc * KC;
    const int steps = min(KC, kpad - k0) / KS;
#pragma unroll
    for (int ks = 0; ks < KC / KS; ++ks) {
      if (ks >= steps) break;
      const int kk = k0 + ks * KS;
      const int tap = kk >> a.log2c, ch = kk & (C - 1);
      const unsigned char* ab =
          A + (size_t)(mrow + tap * dd) * st + ch * ES + a_off;
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(af[mi], ab + mi * 16 * st);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, w_s + (ncol + np * 16) * F_WSTRIDE + ks * KS * ES +
                            b_off);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_tile<MT>(acc[mi][2 * np], af[mi], bf);
          mma_tile<MT>(acc[mi][2 * np + 1], af[mi], bf + 2);
        }
      }
      if (ks == 0) fill(i + 2);
    }
    if (kc != n_kc - 1) continue;
    if (conv == 0) {
      // every warp is done with the window: y1 may overwrite it; its rows
      // past the first conv's M feed only discarded outputs
      __syncthreads();
      for (int i = tid * 16; i < (k - 1) * st; i += THREADS * 16)
        *reinterpret_cast<uint4*>(y1s + (size_t)M * st + i) =
            make_uint4(0u, 0u, 0u, 0u);
    }

    // the conv's epilogue; the second conv's residuals of an n-tile are
    // loaded before any of its results is stored (more n-tiles at once
    // spill registers in every configuration)
    const float* sc = conv == 0 ? sc0 : sc1;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = ncol + ni * 8 + 2 * t4;
      const float sw0 = sc[C + col], sw1 = sc[C + col + 1];
      const float b0 = sc[2 * C + col], b1 = sc[2 * C + col + 1];
      // conv 2's 1/sx: y1 is its input
      const float inv0 = sc1[col], inv1 = sc1[col + 1];
      float2 res[MI][2];
      if (conv == 1) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mrow + mi * 16 + g + 8 * h;
            res[mi][h] = r < tt && t0 + r < T
                             ? ldg2_kind(a.src, a.src_bf16,
                                         src0 + (size_t)(t0 + r) * C + col)
                             : make_float2(0.f, 0.f);
          }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mrow + mi * 16 + g + 8 * h;
          float y0 = (float)acc[mi][ni][2 * h];
          float y1 = (float)acc[mi][ni][2 * h + 1];
          acc[mi][ni][2 * h] = 0;
          acc[mi][ni][2 * h + 1] = 0;
          if (sizeof(MT) == 1) {
            y0 = __fmul_rn(y0, sw0);
            y1 = __fmul_rn(y1, sw1);
          }
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
          if (conv == 0) {  // y1 row r is time t0 - half + r
            const int t = t0 - half + r;
            if (t < 0 || t >= T) {
              y0 = 0.f;
              y1 = 0.f;
            } else {
              y0 = y0 >= 0.f ? y0 : __fmul_rn(y0, a.slope);
              y1 = y1 >= 0.f ? y1 : __fmul_rn(y1, a.slope);
            }
            store2_mm<MT>(y1s + r * st + col * ES, y0, y1, inv0, inv1);
          } else {  // output row r is time t0 + r
            const int t = t0 + r;
            if (r >= tt || t >= T) continue;
            *reinterpret_cast<float2*>(a.dst +
                                       branch * (size_t)gridDim.y * T * C +
                                       item0 + (size_t)t * C + col) =
                make_float2(__fadd_rn(res[mi][h].x, y0),
                            __fadd_rn(res[mi][h].y, y1));
          }
        }
    }
  }
  cp_async_wait<0>();
}

template <typename MT, int NC, int WM, int WN, int MI, int MINB>
cudaError_t run_pair(PairArgs& a, int B, cudaStream_t stream) {
  static cudaError_t allowed = cudaFuncSetAttribute(
      mrf_pair_kernel<MT, NC, WM, WN, MI, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  constexpr int M = WM * 16 * MI;
  const size_t smem = fused_smem(M, NC, (int)sizeof(MT), a.kmax, a.d);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  int blocks = 0;
  for (int b = 0; b < a.n_branches; ++b) {
    const int tt = M - (a.k[b] - 1);
    if (tt < 16) return cudaErrorInvalidValue;
    a.tiles[b] = (a.T + tt - 1) / tt;
    blocks += a.tiles[b];
  }
  mrf_pair_kernel<MT, NC, WM, WN, MI, MINB>
      <<<dim3(blocks, B), WM * WN * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// the instantiation for C: (C, WM, WN, MI, MINB), mirrored by
// _FUSED_CONFIG in ops/cuda/mrf_stage.py
template <typename MT>
cudaError_t run_pair_c(PairArgs& a, int B, cudaStream_t stream) {
  switch (a.C) {
    case 32: return run_pair<MT, 32, 8, 1, 2, 3>(a, B, stream);
    case 64: return run_pair<MT, 64, 8, 1, 2, 2>(a, B, stream);
    case 128: return run_pair<MT, 128, 4, 2, 2, 2>(a, B, stream);
    case 256: return run_pair<MT, 256, 4, 2, 2, 1>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename MT>
cudaError_t run_stage_fused(int x_bf16, const void* x, void* out,
                            const void* const* wt, const float* const* sc,
                            const int* kernels, const int* dils,
                            int n_branches, int n_layers, int B, int T, int C,
                            float slope, float* buf0, float* buf1,
                            cudaStream_t stream) {
  PairArgs a;
  a.T = T; a.C = C; a.n_branches = n_branches; a.slope = slope;
  a.log2c = 0;
  while ((1 << a.log2c) < C) ++a.log2c;
  a.kmax = 0;
  for (int b = 0; b < n_branches; ++b) {
    a.k[b] = kernels[b];
    a.kpad[b] = (kernels[b] * C + 31) / 32 * 32;
    if (a.k[b] > a.kmax) a.kmax = a.k[b];
  }
  const size_t plane = (size_t)B * T * C;
  float* bufs[2] = {buf0, buf1};
  for (int l = 0; l < n_layers; ++l) {
    for (int b = 0; b < n_branches; ++b)
      for (int ci = 0; ci < 2; ++ci) {
        a.wt[b][ci] = static_cast<const unsigned char*>(wt[b]) +
                      (size_t)(l * 2 + ci) * C * a.kpad[b] * sizeof(MT);
        a.sc[b][ci] = sc[b] + (size_t)(l * 2 + ci) * 4 * C;
      }
    a.d = dils[l];
    a.src = l == 0 ? x : bufs[(l - 1) % 2];
    a.src_bf16 = l == 0 && x_bf16;
    a.src_branch_stride = l == 0 ? 0 : plane;
    a.dst = bufs[l % 2];
    cudaError_t err = run_pair_c<MT>(a, B, stream);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((plane / 4 + 255) / 256);
  mrf_mean_kernel<<<blocks, 256, 0, stream>>>(bufs[(n_layers - 1) % 2], out,
                                              x_bf16, plane, n_branches);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs one MRF stage on `stream` on the body that mrf_stage_plan() chose:
// body 0, the per-conv body (2 * n_layers conv launches and the mean);
// body 1, the fused-pair body (n_layers launches and the mean; bf16 or int8
// weights, C 32 to 256). Returns a cudaError_t (0 on success). The Python
// wrapper checks shapes, types and alignment before the call.
// x_bf16: x and out are bfloat16 (else float32), both (B, T, C).
// mm_type: 0 = float32, 1 = bfloat16, 2 = int8 weights and products.
// wt[b]: (n_layers, 2, C, kpad_b) transposed weights, kpad_b = k_b C rounded
// up to 32, zero beyond k_b C; sc[b]: (n_layers, 2, 4, C) f32 rows
// [1/sx, sw, bias, 0]; kernels, dils on the host; s0, s1: f32 scratch of
// (n_branches, B, T, C) each (body 0: the residual and y1; body 1: the
// residual's two ping-pong buffers). C is a power of two, 8 to 256.
int pwg_mrf_stage_forward(int body, int x_bf16, int mm_type, const void* x,
                          void* out, const void* const* wt,
                          const float* const* sc, const int* kernels,
                          const int* dils, int n_branches, int n_layers,
                          int B, int T, int C, float slope, void* s0,
                          void* s1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f0 = static_cast<float*>(s0);
  float* f1 = static_cast<float*>(s1);
  if (n_branches < 1 || n_branches > MAX_BRANCHES || C < 8 || C > 256 ||
      (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  if (body == 1) {
    if (C < 32) return (int)cudaErrorInvalidValue;
    if (mm_type == 1)
      return (int)run_stage_fused<__nv_bfloat16>(
          x_bf16, x, out, wt, sc, kernels, dils, n_branches, n_layers, B, T,
          C, slope, f0, f1, s);
    if (mm_type == 2)
      return (int)run_stage_fused<int8_t>(x_bf16, x, out, wt, sc, kernels,
                                          dils, n_branches, n_layers, B, T, C,
                                          slope, f0, f1, s);
    return (int)cudaErrorInvalidValue;
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (mm_type == 0)
    return (int)run_stage<float>(x_bf16, x, out, wt, sc, kernels, dils,
                                 n_branches, n_layers, B, T, C, slope, f0,
                                 f1, s);
  if (mm_type == 1)
    return (int)run_stage<__nv_bfloat16>(x_bf16, x, out, wt, sc, kernels, dils,
                                         n_branches, n_layers, B, T, C, slope,
                                         f0, f1, s);
  if (mm_type == 2)
    return (int)run_stage<int8_t>(x_bf16, x, out, wt, sc, kernels, dils,
                                  n_branches, n_layers, B, T, C, slope, f0,
                                  f1, s);
  return (int)cudaErrorInvalidValue;
}

const char* pwg_mrf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
