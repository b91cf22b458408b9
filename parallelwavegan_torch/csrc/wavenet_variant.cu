// Experiment variants of the fused WaveNet layer for Hopper (sm_90a), one
// launch per layer.
//
// Replaces the Pallas TPU kernel `_variant_kernel`
// (tools/int8_wavenet_experiment.py:53): the layer of wavenet_stack.cu with
// two knobs. Per layer with dilation d, for every time row t:
//
//   xcat = [x(t-d) | x(t) | x(t+d)]              f32 state, zeros outside [0, T)
//   int8 taps:  xq = clip(rint(xcat * s_tap[0]), +-127)  (from the f32 state)
//               z  = f32(xq . Wq) * s_tap[1]             (exact int32 sums)
//   else:       z  = bf16(xcat) . Wt                     (f32 accumulation)
//   z   += c(t) . Wa + bt
//   gate tanh:  g = tanh(z[:R]) * (0.5 * (1 + tanh(z[R:])))
//   gate mul:   g = z[:R] * z[R:]            (a timing bound, wrong on purpose)
//   so   = bf16(g) . [Ws | Wo] + bs;  skip += so[:S];  x = (so[S:] + x) sqrt(1/2)
//
// The 0.5 of sigmoid(u) = 0.5 (1 + tanh(u / 2)) is folded into the gate half
// of Wt, Wa and bt by the wrapper. x, c, Wa, Ws|Wo are bf16, Wt bf16 or
// int8, the biases and s_tap f32.
//
// Design. The kernel answers how much of the serving layer (wavenet_stack.cu)
// is the gate and what int8 tap products buy, so it keeps the shape that
// layer had when the tool was ported (a SIMT body, since replaced there by
// tensor-core bodies), to compare like with like: 64-row tiles, 256
// threads, the f32 residual in two global ping-pong buffers, every thread a
// 4 x 8 tile of a register-blocked SIMT GEMM, with staging, the gate GEMM
// and the thread tile taken from wavenet_common.cuh. The variants are
// template parameters of that one layer body.
//
// The int8 product uses __dp4a (four int8 MACs per lane at a time into an
// int32 accumulator) and not mma.sync.m16n8k32: dp4a drops into the same
// 4 x 8 thread tile as the f32 FMAs it replaces, so the measured difference
// is the arithmetic's alone; the tensor-core form needs another fragment
// layout, staging and epilogue and belongs to the redesign of the serving
// kernel. Integer sums are exact in either. For dp4a both operands are
// packed along the contraction: the activation tile is quantised while it
// is staged, from the f32 state (not via bf16), into words of four
// consecutive k (12 KB instead of the 48 KB of its f32 form), and the
// wrapper hands the weights over as (L, 48, 128) words of four k each. The
// quantiser's arithmetic is pinned (__fmul_rn, rintf, clip), so the plain
// version reproduces xq bit for bit; the tap sum (int32) and the aux sum
// (f32) are two accumulators joined before the gate.
//
// Bound (tool shape, batch 32 x 131072 samples, 10 layers): 86,016 FLOP per
// sample per layer, 3.6e12 in all, against 672 B per sample moved once:
// bound by operations, 3.65 ms at the bf16 tensor-core peak; with int8 taps
// 57 % of the MACs run at the int8 rate (2.6 ms). The arithmetic here is
// on the CUDA cores, so the kernel is no faster than
// about 54 ms, and the f32 state and skip round-trip device memory once per
// layer.

#include "mma_common.cuh"
#include "wavenet_common.cuh"

namespace {

using namespace pwg;
using bf16 = __nv_bfloat16;

constexpr int K4 = 3 * R / 4;  // packed tap contraction: words of 4 int8
constexpr int KC4 = KC;  // packed rows per weight chunk: KC4 * G words fill w_s

static_assert(K4 % KC4 == 0, "the packed taps split into whole chunks");

__host__ __device__ constexpr int padded_a(int A) {
  return (A + KC - 1) / KC * KC;
}

__host__ __device__ constexpr size_t smem_floats(int A, bool int8_taps) {
  return (int8_taps ? (size_t)K4 * TT + (size_t)padded_a(A) * TT
                    : (size_t)padded_k(A) * TT) +
         (size_t)KC * G + (size_t)R * TT;
}

// a_q[k4][r] = the quantised [x(t-d) | x(t) | x(t+d)] of row t0 + r, four
// consecutive channels a word (k = 4 k4 .. 4 k4 + 3 in the low .. high byte)
template <typename XT>
__device__ __forceinline__ void stage_quantized(
    uint32_t* a_q, const XT* __restrict__ x, size_t row0, int t0, int T, int d,
    float inv_s, int tid) {
  for (int i = tid; i < 3 * TT * (R / 4); i += THREADS) {
    const int ch = (i % (R / 4)) * 4;
    const int r = (i / (R / 4)) % TT;
    const int tap = i / (TT * (R / 4));
    const int t = t0 + r + (tap - 1) * d;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t >= 0 && t < T) load4(x + (row0 + t) * R + ch, v);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= pwgmma::quant_byte(__fmul_rn(v[j], inv_s)) << (8 * j);
    a_q[(tap * (R / 4) + ch / 4) * TT + r] = word;
  }
}

// c_s[ch][r] = c(t0 + r), rows past T and channels A..padded_a(A) as zeros
__device__ __forceinline__ void stage_aux(float* c_s,
                                          const bf16* __restrict__ c,
                                          size_t row0, int t0, int T, int A,
                                          int tid) {
  for (int i = tid; i < TT * (A / 4); i += THREADS) {
    const int ch = (i % (A / 4)) * 4;
    const int r = i / (A / 4);
    const int t = t0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < T) load4(c + (row0 + t) * A + ch, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) c_s[(ch + j) * TT + r] = v[j];
  }
  for (int i = tid; i < (padded_a(A) - A) * TT; i += THREADS)
    c_s[A * TT + i] = 0.f;
}

// iacc += a_q . w_q for this thread's 4 x 8 tile; w_q (K4, G) words stream
// through wq_s in chunks of KC4 packed rows. Begins with a barrier.
__device__ __forceinline__ void tap_gemm_int8(int iacc[4][8],
                                              const uint32_t* a_q,
                                              uint32_t* wq_s,
                                              const uint32_t* __restrict__ w_q,
                                              int tid, int rg, int cg) {
  for (int k0 = 0; k0 < K4; k0 += KC4) {
    __syncthreads();  // a_q is staged / the previous chunk is consumed
    for (int i = tid; i < KC4 * G / 4; i += THREADS)
      reinterpret_cast<uint4*>(wq_s)[i] =
          reinterpret_cast<const uint4*>(w_q + (size_t)k0 * G)[i];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC4; ++kk) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(a_q + (k0 + kk) * TT + rg * 4);
      const uint4 w0 =
          *reinterpret_cast<const uint4*>(wq_s + kk * G + cg * 4);
      const uint4 w1 =
          *reinterpret_cast<const uint4*>(wq_s + kk * G + R + cg * 4);
      const int av[4] = {(int)a.x, (int)a.y, (int)a.z, (int)a.w};
      const int wv[8] = {(int)w0.x, (int)w0.y, (int)w0.z, (int)w0.w,
                         (int)w1.x, (int)w1.y, (int)w1.z, (int)w1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          iacc[r][j] = __dp4a(av[r], wv[j], iacc[r][j]);
    }
  }
}

// MUL: the product gate; INT8: int8 tap products; XIN, XOUT: types of the
// residual read and written (bf16 at the ends of the stack, f32 between)
template <bool MUL, bool INT8, typename XIN, typename XOUT>
__global__ void __launch_bounds__(THREADS, 2) variant_layer_kernel(
    const XIN* __restrict__ x_in, const bf16* __restrict__ c,
    const void* __restrict__ w_tap, const float* __restrict__ b_tap,
    const bf16* __restrict__ w_aux, const bf16* __restrict__ w_so,
    const float* __restrict__ b_so, const float* __restrict__ s_tap,
    XOUT* __restrict__ x_out, float* __restrict__ skip, int T, int A, int d,
    int first_layer) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const size_t row0 = (size_t)blockIdx.y * T;  // first row of this item
  // thread tile: rows rg*4..rg*4+3; columns cg*4..+3 and R + cg*4..+3
  const int rg = tid / 16;
  const int cg = tid % 16;
  float acc[4][8];
  zero_tile(acc);
  float* w_s;  // [KC][G] weight chunk
  float* g_s;  // [R][TT] gate output, transposed

  // 1, 2. z = [taps | c] . [Wt; Wa]
  if constexpr (INT8) {
    uint32_t* a_q = reinterpret_cast<uint32_t*>(smem);  // [K4][TT]
    float* c_s = smem + K4 * TT;                        // [padded_a][TT]
    w_s = c_s + padded_a(A) * TT;
    g_s = w_s + KC * G;
    stage_quantized(a_q, x_in, row0, t0, T, d, s_tap[0], tid);
    stage_aux(c_s, c, row0, t0, T, A, tid);
    int iacc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) iacc[r][j] = 0;
    tap_gemm_int8(iacc, a_q, reinterpret_cast<uint32_t*>(w_s),
                  static_cast<const uint32_t*>(w_tap), tid, rg, cg);
    panel_gemm<bf16>(acc, c_s, w_s, w_aux, A, padded_a(A), tid, rg, cg);
    const float rescale = s_tap[1];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[r][j] = __fadd_rn(
            __fmul_rn(__int2float_rn(iacc[r][j]), rescale), acc[r][j]);
  } else {
    float* a_s = smem;  // [padded_k][TT] activation tile, transposed
    w_s = a_s + padded_k(A) * TT;
    g_s = w_s + KC * G;
    stage_activations<bf16>(a_s, x_in, c, row0, t0, T, A, d, tid);
    gate_gemm<bf16>(acc, a_s, w_s, static_cast<const bf16*>(w_tap), w_aux, A,
                    tid, rg, cg);
  }

  // gate, in registers: columns j (tanh half) and R + j (gate half)
  float bt[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bt[j] = b_tap[cg * 4 + j];
    bt[4 + j] = b_tap[R + cg * 4 + j];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float za = acc[r][j] + bt[j];
      const float zb = acc[r][4 + j] + bt[4 + j];
      const float gv =
          MUL ? za * zb : tanhf(za) * (0.5f * (1.f + tanhf(zb)));
      g_s[(cg * 4 + j) * TT + rg * 4 + r] = round_to<bf16>(gv);
    }

  // 3. so = g . [Ws | Wo]
  zero_tile(acc);
  panel_gemm<bf16>(acc, g_s, w_s, w_so, R, R, tid, rg, cg);

  float bs[4], bo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bs[j] = b_so[cg * 4 + j];
    bo[j] = b_so[S + cg * 4 + j];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + rg * 4 + r;
    if (t >= T) break;
    const size_t row = row0 + t;
    float xo[4], sv[4], xn[4];
    load4(x_in + row * R + cg * 4, xo);
    float* sp = skip + row * S + cg * 4;
    if (!first_layer) load4(sp, sv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = acc[r][j] + bs[j];
      sv[j] = first_layer ? s : sv[j] + s;
      xn[j] = (acc[r][4 + j] + bo[j] + xo[j]) * kSqrtHalf;
    }
    store4(sp, sv);
    store4(x_out + row * R + cg * 4, xn);
  }
}

struct LayerArgs {
  const void* x_in;
  const bf16* c;
  const void* w_tap;
  const float* b_tap;
  const bf16* w_aux;
  const bf16* w_so;
  const float* b_so;
  const float* s_tap;
  void* x_out;
  float* skip;
  int B, T, A, d, first;
  size_t smem;
  cudaStream_t stream;
};

template <bool MUL, bool INT8, typename XIN, typename XOUT>
cudaError_t launch_layer(const LayerArgs& a) {
  // opt the kernel into more than 48 KB of dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      variant_layer_kernel<MUL, INT8, XIN, XOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + TT - 1) / TT, a.B);
  variant_layer_kernel<MUL, INT8, XIN, XOUT>
      <<<grid, THREADS, a.smem, a.stream>>>(
          static_cast<const XIN*>(a.x_in), a.c, a.w_tap, a.b_tap, a.w_aux,
          a.w_so, a.b_so, a.s_tap, static_cast<XOUT*>(a.x_out), a.skip, a.T,
          a.A, a.d, a.first);
  return cudaGetLastError();
}

template <bool MUL, bool INT8>
cudaError_t launch_typed(const LayerArgs& a, bool first, bool last) {
  if (first && last) return launch_layer<MUL, INT8, bf16, bf16>(a);
  if (first) return launch_layer<MUL, INT8, bf16, float>(a);
  if (last) return launch_layer<MUL, INT8, float, bf16>(a);
  return launch_layer<MUL, INT8, float, float>(a);
}

}  // namespace

extern "C" {

// Runs L layers on `stream`; returns a cudaError_t (0 on success).
// The Python wrapper checks shapes, types and alignment before the call.
// x, x_out (B, T, 64) bf16; c (B, T, A) bf16; skip (B, T, 64) f32; buf0,
// buf1 (B, T, 64) f32 scratch (buf0 needed for L >= 2, buf1 for L >= 3);
// w_tap (L, 192, 128) bf16, or with int8_taps (L, 48, 128, 4) int8 (four
// consecutive contraction rows a word); b_tap (L, 128) f32; w_aux
// (L, A, 128) bf16; w_so (L, 64, 128) bf16; b_so (L, 128) f32; s_tap
// (L, 2) f32 on the device; dilations on the host.
int pwg_wavenet_variant_forward(int gate_mul, int int8_taps, const void* x,
                                const void* c, const void* w_tap,
                                const void* b_tap, const void* w_aux,
                                const void* w_so, const void* b_so,
                                const void* s_tap, const int* dilations,
                                int L, int B, int T, int A, void* x_out,
                                void* skip, void* buf0, void* buf1,
                                void* stream) {
  const size_t tap_bytes = int8_taps ? 1 : sizeof(bf16);
  LayerArgs a;
  a.c = static_cast<const bf16*>(c);
  a.skip = static_cast<float*>(skip);
  a.B = B;
  a.T = T;
  a.A = A;
  a.smem = smem_floats(A, int8_taps != 0) * sizeof(float);
  a.stream = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < L; ++l) {
    // layer l reads what layer l-1 wrote: x, then buf0, buf1, buf0, ...
    const bool first = l == 0, last = l == L - 1;
    a.x_in = first ? x : (l % 2 == 1 ? buf0 : buf1);
    a.x_out = last ? x_out : (l % 2 == 0 ? buf0 : buf1);
    a.w_tap = static_cast<const char*>(w_tap) +
              (size_t)l * 3 * R * G * tap_bytes;
    a.b_tap = static_cast<const float*>(b_tap) + (size_t)l * G;
    a.w_aux = static_cast<const bf16*>(w_aux) + (size_t)l * A * G;
    a.w_so = static_cast<const bf16*>(w_so) + (size_t)l * R * SR;
    a.b_so = static_cast<const float*>(b_so) + (size_t)l * SR;
    a.s_tap = static_cast<const float*>(s_tap) + (size_t)l * 2;
    a.d = dilations[l];
    a.first = first;
    cudaError_t err;
    if (gate_mul && int8_taps)
      err = launch_typed<true, true>(a, first, last);
    else if (gate_mul)
      err = launch_typed<true, false>(a, first, last);
    else if (int8_taps)
      err = launch_typed<false, true>(a, first, last);
    else
      err = launch_typed<false, false>(a, first, last);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* pwg_variant_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
