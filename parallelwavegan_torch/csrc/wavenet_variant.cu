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
// Two bodies, as variant_launch_plan() in ops/cuda/wavenet_variant.py names
// them:
//
//   tensor_cores_bf16 (bf16 taps, either gate): the serving layer's own
//     body, wavenet_layer_tc_kernel of wavenet_tc_layer.cuh, which
//     wavenet_stack.cu runs with the sigmoid gate and bf16 biases, here with
//     the tanh or the product gate and f32 biases (design in that file's
//     head note). The tool asks how much of the serving layer is the gate,
//     so the variant runs the serving layer itself. The tanh gate is taken
//     as tanh(a) sigmoid(2 b) on the special-function unit, the serving
//     kernel's arithmetic (relative error near 1e-6, under the bf16 rounding
//     of g that follows).
//   simt_int8_taps: 64-row tiles of 256 threads, a register-blocked SIMT
//     GEMM of 4 x 8 a thread, the f32 residual in two global ping-pong
//     buffers. The tap window is quantised while it is staged, from the f32
//     state (not via bf16), into words of four consecutive k, and multiplied
//     by __dp4a (four int8 MACs a lane) into an int32 sum; the wrapper hands
//     the weights over as (L, 48, 128) words of four k each. The quantiser's
//     arithmetic is pinned (__fmul_rn, rintf, clip), the tap sum (int32) and
//     the aux sum (f32) are two accumulators joined before the gate, the aux
//     and skip|out products are f32 FMAs in k order and the gate is tanhf:
//     the plain version's arithmetic, which it reproduces nearly bit for
//     bit. It has to: the int8 taps are held to 2e-3 (1 + max) of the plain
//     version, and a tensor-core body (the tap product on mma.sync m16n8k32,
//     its fragments quantised as they load, Wa and Ws|Wo on bf16 tensor
//     cores) missed that: its f32 sums, taken in the tensor core's order,
//     move some f32 state across a quantisation border of a later layer and
//     some x across a bf16 rounding border (one bf16 step of x, 3.9e-3,
//     against 3.1e-3 allowed at batch 2 x 4,133, 10 layers; PERF.md).
//
// Bound (tool shape, batch 32 x 131072 samples, 10 layers): 86,016 FLOP per
// sample per layer, 3.6e12 in all: 3.65 ms at the bf16 tensor-core peak,
// 2.61 ms with the tap product at the int8 rate. A per-layer launch must
// move 1,184 B per sample and layer (x in and out and skip read and written
// in f32, c in bf16): 14.82 ms at 3.35 TB/s, so the bytes bind the
// tensor-core body. The SIMT int8 body's arithmetic is on the CUDA cores,
// so it is no faster than about 23 ms (its 18,432 f32 FMAs a row and layer
// at 67 TFLOP/s).

#include "wavenet_tc_layer.cuh"

namespace {

using namespace pwg;
using pwgtc::bf16;

constexpr int KC = 16;         // contraction rows per weight chunk
constexpr int K4 = 3 * R / 4;  // packed tap contraction: words of 4 int8
constexpr int KC4 = KC;  // packed rows per weight chunk: KC4 * G words fill w_s

static_assert(K4 % KC4 == 0, "the packed taps split into whole chunks");

__host__ __device__ constexpr int padded_a(int A) {
  return (A + KC - 1) / KC * KC;
}

// shared memory of the SIMT int8 body, in floats: the quantised taps [K4][TT]
// words, c [padded_a][TT], a weight chunk [KC][G] and g [R][TT]; mirrored by
// variant_smem_bytes() in ops/cuda/wavenet_variant.py
__host__ __device__ constexpr size_t simt_smem_floats(int A) {
  return (size_t)K4 * TT + (size_t)padded_a(A) * TT + (size_t)KC * G +
         (size_t)R * TT;
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

// acc += a_s[0:KP] (transposed, [k][TT]) . w[0:K] for this thread's 4 x 8
// tile, w row-major (K, 128) bf16 in global memory, streamed through w_s in
// chunks of KC rows; rows K..KP of w read as zeros. Begins with a barrier,
// so a_s may have been written just before the call.
__device__ __forceinline__ void panel_gemm(float acc[4][8], const float* a_s,
                                           float* w_s,
                                           const bf16* __restrict__ w, int K,
                                           int KP, int tid, int rg, int cg) {
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

// clip(rint(v[j] * s), +-127) of four consecutive values at p (zeros where
// !valid), packed low byte first: the int8 body's quantiser
template <typename XT>
__device__ __forceinline__ uint32_t quant_word(const XT* p, bool valid,
                                               float s) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) load4(p, v);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    word |= pwgmma::quant_byte(__fmul_rn(v[j], s)) << (8 * j);
  return word;
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
    const bool valid = t >= 0 && t < T;
    a_q[(tap * (R / 4) + ch / 4) * TT + r] =
        quant_word(x + (valid ? (row0 + t) * R + ch : 0), valid, inv_s);
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

// The SIMT int8-taps layer. MUL: the product gate; XIN, XOUT: types of the
// residual read and written (bf16 at the ends of the stack, f32 between).
// A thread's tile: rows rg*4..rg*4+3, columns cg*4..+3 and R + cg*4..+3.
template <bool MUL, typename XIN, typename XOUT>
__global__ void __launch_bounds__(THREADS, 2) int8_taps_layer_kernel(
    const XIN* __restrict__ x_in, const bf16* __restrict__ c,
    const uint32_t* __restrict__ w_q, const float* __restrict__ b_tap,
    const bf16* __restrict__ w_aux, const bf16* __restrict__ w_so,
    const float* __restrict__ b_so, const float* __restrict__ s_tap,
    XOUT* __restrict__ x_out, float* __restrict__ skip, int T, int A, int d,
    int first_layer) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint32_t* a_q = reinterpret_cast<uint32_t*>(smem);  // [K4][TT]
  float* c_s = smem + K4 * TT;                        // [padded_a][TT]
  float* w_s = c_s + padded_a(A) * TT;                // [KC][G] weight chunk
  float* g_s = w_s + KC * G;                          // [R][TT] g, transposed

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const size_t row0 = (size_t)blockIdx.y * T;  // first row of this item
  const int rg = tid / 16;
  const int cg = tid % 16;
  float acc[4][8];
  zero_tile(acc);

  // z = f32(xq . Wq) s_tap[1] + c . Wa, the two sums apart until joined
  stage_quantized(a_q, x_in, row0, t0, T, d, s_tap[0], tid);
  stage_aux(c_s, c, row0, t0, T, A, tid);
  int iacc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) iacc[r][j] = 0;
  tap_gemm_int8(iacc, a_q, reinterpret_cast<uint32_t*>(w_s), w_q, tid, rg,
                cg);
  panel_gemm(acc, c_s, w_s, w_aux, A, padded_a(A), tid, rg, cg);
  const float rescale = s_tap[1];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[r][j] = __fadd_rn(
          __fmul_rn(__int2float_rn(iacc[r][j]), rescale), acc[r][j]);

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
      g_s[(cg * 4 + j) * TT + rg * 4 + r] =
          __bfloat162float(__float2bfloat16_rn(gv));
    }

  // so = g . [Ws | Wo]
  zero_tile(acc);
  panel_gemm(acc, g_s, w_s, w_so, R, R, tid, rg, cg);

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

struct Int8Args {
  const void* x_in;
  const bf16* c;
  const uint32_t* w_q;
  const float* b_tap;
  const bf16* w_aux;
  const bf16* w_so;
  const float* b_so;
  const float* s_tap;
  void* x_out;
  float* skip;
  int B, T, A, d, first;
  cudaStream_t stream;
};

template <bool MUL, typename XIN, typename XOUT>
cudaError_t launch_int8_layer(const Int8Args& a) {
  const size_t smem = simt_smem_floats(a.A) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      int8_taps_layer_kernel<MUL, XIN, XOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + TT - 1) / TT, a.B);
  int8_taps_layer_kernel<MUL, XIN, XOUT><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const XIN*>(a.x_in), a.c, a.w_q, a.b_tap, a.w_aux, a.w_so,
      a.b_so, a.s_tap, static_cast<XOUT*>(a.x_out), a.skip, a.T, a.A, a.d,
      a.first);
  return cudaGetLastError();
}

// layer l reads what layer l-1 wrote: x, then buf0, buf1, buf0, ...
template <bool MUL>
cudaError_t run_int8_stack(const pwgtc::TcStackArgs<float>& t,
                           const uint32_t* w_q, const float* s_tap) {
  Int8Args a;
  a.c = t.c;
  a.skip = t.skip;
  a.B = t.B;
  a.T = t.T;
  a.A = t.A;
  a.stream = t.stream;
  for (int l = 0; l < t.L; ++l) {
    const bool first = l == 0, last = l == t.L - 1;
    a.x_in = first ? t.x : (l % 2 == 1 ? t.buf0 : t.buf1);
    a.x_out = last ? t.x_out : (l % 2 == 0 ? t.buf0 : t.buf1);
    a.w_q = w_q + (size_t)l * K4 * G;
    a.b_tap = t.b_tap + (size_t)l * G;
    a.w_aux = t.w_aux + (size_t)l * t.A * G;
    a.w_so = t.w_so + (size_t)l * R * SR;
    a.b_so = t.b_so + (size_t)l * SR;
    a.s_tap = s_tap + (size_t)l * 2;
    a.d = t.dilations[l];
    a.first = first;
    cudaError_t err;
    if (first && last) err = launch_int8_layer<MUL, bf16, bf16>(a);
    else if (first) err = launch_int8_layer<MUL, bf16, float>(a);
    else if (last) err = launch_int8_layer<MUL, float, bf16>(a);
    else err = launch_int8_layer<MUL, float, float>(a);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// x (4 words) f32 or bf16 -> out (words): the int8 body's quantiser
template <typename XT>
__global__ void quantize_kernel(const XT* __restrict__ x, int words, float s,
                                uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < words) out[i] = quant_word(x + 4 * (size_t)i, true, s);
}

}  // namespace

extern "C" {

// Runs L layers on `stream`; returns a cudaError_t (0 on success). The
// Python wrapper checks shapes, types and alignment before the call.
// x, x_out (B, T, 64) bf16; c (B, T, A) bf16; skip (B, T, 64) f32; buf0,
// buf1 (B, T, 64) f32 scratch (buf0 needed for L >= 2, buf1 for L >= 3);
// w_tap (L, 192, 128) bf16, or with int8_taps (L, 48, 128, 4) int8 (four
// consecutive contraction rows a word); b_tap (L, 128) f32; w_aux
// (L, A, 128) bf16; w_so (L, 64, 128) bf16; b_so (L, 128) f32; s_tap
// (L, 2) f32 on the device (read with int8_taps); dilations on the host.
// bf16 taps run on `blocks` persistent blocks; int8 taps one block a tile.
int pwg_wavenet_variant_forward(int gate_mul, int int8_taps, const void* x,
                                const void* c, const void* w_tap,
                                const void* b_tap, const void* w_aux,
                                const void* w_so, const void* b_so,
                                const void* s_tap, const int* dilations,
                                int L, int B, int T, int A, void* x_out,
                                void* skip, void* buf0, void* buf1,
                                int blocks, void* stream) {
  const pwgtc::TcStackArgs<float> a = {
      x, static_cast<const bf16*>(c), static_cast<const bf16*>(w_tap),
      static_cast<const float*>(b_tap), static_cast<const bf16*>(w_aux),
      static_cast<const bf16*>(w_so), static_cast<const float*>(b_so),
      dilations, L, B, T, A, x_out, static_cast<float*>(skip), buf0, buf1,
      nullptr, blocks, static_cast<cudaStream_t>(stream)};
  const uint32_t* w_q = static_cast<const uint32_t*>(w_tap);
  const float* s = static_cast<const float*>(s_tap);
  cudaError_t err;
  if (int8_taps)
    err = gate_mul ? run_int8_stack<true>(a, w_q, s)
                   : run_int8_stack<false>(a, w_q, s);
  else if (blocks < 1)
    err = cudaErrorInvalidValue;
  else
    err = gate_mul ? pwgtc::run_tc_stack<pwgtc::kProductGate, float>(a)
                   : pwgtc::run_tc_stack<pwgtc::kTanhGate, float>(a);
  return (int)err;
}

// shared memory of one layer launch, by the type of the x it reads
// (0 = float32, 1 = bfloat16) and the tap type
size_t pwg_wavenet_variant_smem(int x_is_bf16, int int8_taps, int A) {
  if (int8_taps) return simt_smem_floats(A) * sizeof(float);
  return x_is_bf16 ? pwgtc::tc_smem_bytes<bf16>(A)
                   : pwgtc::tc_smem_bytes<float>(A);
}

// out[i] = the int8 body's quantised word of x[4 i .. 4 i + 3] with scale
// s, for `words` words; x f32 (x_is_bf16 = 0) or bf16, 16-byte aligned
int pwg_wavenet_variant_quantize(int x_is_bf16, const void* x, int words,
                                 float s, void* out, void* stream) {
  const int threads = 256, grid = (words + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (x_is_bf16)
    quantize_kernel<bf16><<<grid, threads, 0, st>>>(
        static_cast<const bf16*>(x), words, s, o);
  else
    quantize_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(x), words, s, o);
  return (int)cudaGetLastError();
}

const char* pwg_variant_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
