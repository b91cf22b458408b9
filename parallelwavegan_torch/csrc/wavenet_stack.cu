// Fused WaveNet gated residual layer for Hopper (sm_90a), one launch per layer.
//
// Replaces the Pallas TPU kernel `_stack_kernel`
// (parallelwavegan_tpu/ops/pallas/wavenet_stack.py:113). Per layer with
// dilation d, for every time row t of every batch item:
//
//   z    = [x(t-d) | x(t) | x(t+d)] . Wt + c(t) . Wa + bt        (G = 128)
//   g    = tanh(z[:R]) * sigmoid(z[R:])                          (R = 64)
//   skip += g . Ws + bs                                          (S = 64, f32)
//   x    = (g . Wo + bo + x) * sqrt(1/2)                         (f32 state)
//
// with zero padding at the *sequence* ends (rows outside [0, T) read as 0).
// Matmul inputs are rounded to the weight type (f32 or bf16) and every
// product accumulates in f32, as on the TPU (wavenet_stack.py:140,156,173).
//
// Two layer bodies, one launch per layer each. The residual state between
// layers stays f32 in two global ping-pong buffers that the wrapper
// allocates; the first layer reads x in its own type and the last writes
// x_out in that type. For training (save_inputs in the TPU kernel,
// wavenet_stack.py:144) each layer also writes its input, rounded to the
// matmul type, to xs (L, B, T, R): exactly the values its tap product
// consumed, which the backward kernel (wavenet_stack_bwd.cu) recomputes the
// gate from. The TPU kernel fuses a whole dilation cycle over halo'd windows
// whose f32 residual state (64 ch x (chunk + 2048) rows) does not fit the
// 227 KB of shared memory a Hopper block may use; that blocking is not
// carried over.
//
// Bound (PWG v1 serving: batch 32 x 131072 samples, 30 layers): 86,016 FLOP
// per sample and layer, 1.08e13 FLOP in all. bf16: 10.9 ms at the bf16
// tensor-core peak; a per-layer launch must move about 1,184 B per sample:
// x in and out in f32 (256 + 256), skip read and written in f32 (512), c in
// bf16 (160); 4.97 GB a layer, 44.5 ms for 30 layers at 3.35 TB/s. So on
// this card the bytes bind a bf16 per-layer launch, about 4 x above the
// operations. f32 (three TF32 products per product, 495 / 3 TFLOP/s):
// 65.6 ms, above the f32 per-layer byte floor of 1,344 B per sample (c in
// f32, 320 B), 50.5 ms: the operations bind. At the PWG v1 training shape
// (batch 6 x 25,600, 30 layers as three calls of 10, f32, with xs) 3.96e11
// FLOP, 2.40 ms, against a byte floor of 1,600 B per sample and layer
// (xs written too), 2.20 ms.
//
// bf16: the tensor-core body (wavenet_layer_tc_kernel in
// wavenet_tc_layer.cuh, with the sigmoid gate and bf16 biases; the
// experiment's variant kernel, wavenet_variant.cu, runs the same body with
// its own gate and f32 biases): persistent blocks with the
// layer's 86 KB of bf16 weights resident, a two-slot cp.async ring of x
// rows and c, mma.sync m16n8k16 with the gate formed in registers, and the
// skip and residual epilogue; the design is in that file's head note.
//   What still binds it is measured by tools/wavenet_stack_ablation.py
//   (variants without the transcendentals, without the ring's loads,
//   without the epilogue's traffic) and written in PERF.md. Fusing layers
//   to keep x and skip on chip would evict the resident weights (86 KB a
//   layer).
// f32: the split-TF32 tensor-core body (wavenet_layer_tf32_kernel), the
// body of f32 serving (decode's default dtype) and of the f32 training
// forward. Every product runs on mma.sync m16n8k8 TF32 in three terms
// (mma_common.cuh: x = hi + lo, a . b = lo_a hi_b + hi_a lo_b + hi_a hi_b),
// which keeps f32 accuracy: through 30 layers at full width, one TF32
// product per product misses the f32 tolerance of 1e-4 (1 + max) (2.7e-4
// on x, 4.3e-4 on skip against float64), the three-term split stays near
// 1e-7 (tests/test_torch_wavenet_stack.py emulates both). The tensor core
// truncates what it adds into its accumulator, so each k-step's three
// products are summed in a zeroed tile and added in f32 (mma_tiles with
// FRESH). Summed in place, x of the serving stack lies 9.8e-7 (1 + max)
// from float64 against 1.5e-7 this way (the in_place variant of
// tools/wavenet_stack_ablation.py, 9 % faster), and the generator's
// weight-norm gradients through the STFT loss leave their tolerance
// (chip_smoke.py, step 6); this way the training-shape stack lies 2.7e-7
// from float64, below the plain f32 version's 3.6e-7 (chip_smoke.py; both
// on an NVIDIA H100 80GB HBM3 at 700 W). Per layer:
//   - one block per 64-row tile of one item, 8 warps, two blocks of 112 KB
//     an SM. The f32 weights (172 KB a layer) do not fit beside a ring of
//     tiles, so they stream with the activations: one three-slot cp.async
//     ring (pipeline.cuh) of 32-row chunks, [Wt; Wa] with the matching 32
//     columns of [x(t-d) | x(t+d) | c], then [Ws | Wo], runs through both
//     products without draining (the layout of the backward's data launch
//     in wavenet_stack_bwd.cu). The weights come from L2, 2.7 KB a row and
//     layer, about 340 GB over the serving forward. 128-row tiles on 16
//     warps, which halve that, were slower at both shapes above (PERF.md);
//   - the centre rows x(t) arrive once, with the first chunk, and serve the
//     centre tap, the residual and xs (the layer input itself in f32);
//   - a warp holds the tanh and sigmoid columns of the same 16 channels for
//     32 rows, so the gate forms in registers; g passes to the second
//     product through a [64][64] f32 tile read back as 32-bit words;
//   - the epilogue adds skip in place (f32) and writes x and xs.

#include "mma_common.cuh"
#include "pipeline.cuh"
#include "wavenet_common.cuh"
#include "wavenet_tc_layer.cuh"

namespace {

using namespace pwg;

// bf16: the tensor-core layer body of wavenet_tc_layer.cuh with the
// sigmoid gate and bf16 biases; xs may be null.
cudaError_t run_stack_tc(const void* x, const void* c, const void* w_tap,
                         const void* b_tap, const void* w_aux,
                         const void* w_so, const void* b_so,
                         const int* dilations, int L, int B, int T, int A,
                         void* x_out, float* skip, void* buf0, void* buf1,
                         void* xs, int blocks, cudaStream_t stream) {
  using pwgtc::bf16;
  const pwgtc::TcStackArgs<bf16> a = {
      x, static_cast<const bf16*>(c), static_cast<const bf16*>(w_tap),
      static_cast<const bf16*>(b_tap), static_cast<const bf16*>(w_aux),
      static_cast<const bf16*>(w_so), static_cast<const bf16*>(b_so),
      dilations, L, B, T, A, x_out, skip, buf0, buf1, static_cast<bf16*>(xs),
      blocks, stream};
  return pwgtc::run_tc_stack<pwgtc::kSigmoidGate, bf16>(a);
}

// ---------------------------------------------------------------------------
// f32: the layer body on split-TF32 tensor cores.

namespace tf32 {

using pwgmma::load_a_split;
using pwgmma::mma_tiles;

constexpr int STAGES = 3;        // ring slots
constexpr int KCH = 32;          // contraction rows of one ring chunk
constexpr int WB_LD = G + 8;     // [k][128] weight chunk (= 8 mod 32)
constexpr int ACT_LD = KCH + 4;  // [row][k] activation chunk (= 4 mod 8)
constexpr int ROW_LD = R + 4;    // [row][64] centre rows and gate (= 4 mod 8)

// the ring, the centre rows x(t) and the gate g of one 64-row tile;
// mirrored by tf32_smem_bytes() in ops/cuda/wavenet_stack.py
constexpr int STAGE_FLOATS = KCH * WB_LD + TT * ACT_LD;
constexpr int SMEM = (STAGES * STAGE_FLOATS + 2 * TT * ROW_LD) * 4;

}  // namespace tf32

// One layer, one block per tile of 64 rows of one item, 8 warps; warp
// (wm, wq) = (warp % 2, warp / 2) owns rows 32 wm .. 32 wm + 31 (two
// m-tiles, so every split B fragment feeds two). One ring of chunks of 32
// contraction rows runs through both products without draining:
//   z  = [x(t-d) | x(t) | x(t+d) | c] . [Wt; Wa]   ceil((3R + A) / 32)
//        chunks, each 32 weight rows and the matching 32 activation columns
//        (the centre tap's columns come from the centre rows, staged once
//        with the first chunk); the warp takes the tanh columns 16 wq ..
//        +15 and the sigmoid columns 64 + 16 wq .. +15, so the gate of one
//        channel forms in one lane
//   so = g . [Ws | Wo]                             2 chunks; the warp takes
//        columns 32 wq .. +31: skip for wq < 2, the residual for wq >= 2
// Every product is three TF32 mma.sync products (mma_tiles), each k-step's
// summed apart and added to the accumulators in f32. g goes through
// a [64][64] f32 tile, read back as 32-bit words (ldmatrix cannot
// transpose 32-bit values; the row pad spreads a fragment's loads over the
// banks).
__global__ void __launch_bounds__(THREADS, 2) wavenet_layer_tf32_kernel(
    const float* __restrict__ x_in, const float* __restrict__ c,
    const float* __restrict__ w_tap, const float* __restrict__ b_tap,
    const float* __restrict__ w_aux, const float* __restrict__ w_so,
    const float* __restrict__ b_so, float* __restrict__ x_out,
    float* __restrict__ skip, float* __restrict__ xs, int T, int A, int d,
    int first_layer) {
  using namespace tf32;
  using pwgpipe::cp_async16;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* x_s = ring + STAGES * STAGE_FLOATS;  // [TT][ROW_LD] x(t)
  float* g_s = x_s + TT * ROW_LD;             // [TT][ROW_LD] g

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wq = warp >> 1;
  const int t0 = blockIdx.x * TT;
  const size_t row0 = (size_t)blockIdx.y * T;
  const int K = 3 * R + A;  // the gate contraction
  const int n_gate = (K + KCH - 1) / KCH;
  const int n_chunks = n_gate + R / KCH;

  // every thread copies its share of chunk ci into its ring slot: 32 rows
  // of [Wt; Wa] or of [Ws | Wo], and for the side taps and c the matching
  // activation columns, rows outside [0, T) and columns past K as zeros
  auto issue = [&](int ci) {
    float* st = ring + (ci % STAGES) * STAGE_FLOATS;
    const bool gate_chunk = ci < n_gate;
    const int k0 = (gate_chunk ? ci : ci - n_gate) * KCH;
    for (int i = tid; i < KCH * (G / 4); i += THREADS) {
      const int kk = i / (G / 4), col = (i % (G / 4)) * 4;
      const int k = k0 + kk;
      const float* src = w_tap;
      bool valid = true;
      if (!gate_chunk) src = w_so + (size_t)k * SR + col;
      else if (k < 3 * R) src = w_tap + (size_t)k * G + col;
      else if (k < K) src = w_aux + (size_t)(k - 3 * R) * G + col;
      else valid = false;
      cp_async16(st + kk * WB_LD + col, src, valid);
    }
    if (!gate_chunk || (k0 >= R && k0 < 2 * R)) return;
    for (int i = tid; i < TT * (KCH / 4); i += THREADS) {
      const int r = i / (KCH / 4), k = k0 + (i % (KCH / 4)) * 4;
      const float* src = x_in;
      bool valid;
      if (k < 3 * R) {
        const int t = t0 + r + (k / R - 1) * d;
        valid = t >= 0 && t < T;
        if (valid) src = x_in + (row0 + t) * R + k % R;
      } else {
        const int t = t0 + r;
        valid = t < T && k < K;
        if (valid) src = c + (row0 + t) * A + (k - 3 * R);
      }
      cp_async16(st + KCH * WB_LD + r * ACT_LD + (i % (KCH / 4)) * 4, src,
                 valid);
    }
  };

  // the centre rows, with the first chunk: the centre tap's activations,
  // the residual and xs
  for (int i = tid; i < TT * (R / 4); i += THREADS) {
    const int r = i / (R / 4), ch = (i % (R / 4)) * 4, t = t0 + r;
    cp_async16(x_s + r * ROW_LD + ch,
               t < T ? x_in + (row0 + t) * R + ch : x_in, t < T);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) issue(s);
    pwgpipe::cp_async_commit();
  }

  // the next chunk of the ring: wait for it, refill the slot freed by the
  // one before (every thread is past it after the barrier)
  int ci = 0;
  auto next_chunk = [&]() -> const float* {
    pwgpipe::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ci + STAGES - 1 < n_chunks) issue(ci + STAGES - 1);
    pwgpipe::cp_async_commit();
    return ring + (ci++ % STAGES) * STAGE_FLOATS;
  };

  float acc[2][4][4] = {};
  // 1. z, on this warp's tanh n-tiles (j = 0, 1) and their sigmoid
  // partners (j = 2, 3)
  for (int q = 0; q < n_gate; ++q) {
    const float* st = next_chunk();
    const int k0 = q * KCH;
    const bool centre = k0 >= R && k0 < 2 * R;
    const float* act = centre ? x_s + (k0 - R) : st + KCH * WB_LD;
    const int lda = centre ? ROW_LD : ACT_LD;
    const int k_left = K - k0;  // the last chunk of c may be partial
#pragma unroll
    for (int kk = 0; kk < KCH; kk += 8) {
      if (kk >= k_left) break;
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_a_split(a_hi[i], a_lo[i], act + (32 * wm + 16 * i) * lda + kk,
                     lda, gq, tq);
      mma_tiles<2, 4, true>(
          acc, a_hi, a_lo, st + kk * WB_LD + 16 * wq, WB_LD,
          [](int j) { return (j >> 1) * R + 8 * (j & 1); }, gq, tq);
    }
  }

  // the gate in registers, to g_s for the second product
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = 16 * wq + 8 * j + 2 * tq;
    const float bt[4] = {b_tap[col], b_tap[col + 1], b_tap[R + col],
                         b_tap[R + col + 1]};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float za = acc[i][j][2 * h + e] + bt[e];
          const float zb = acc[i][2 + j][2 * h + e] + bt[2 + e];
          gv[e] = tanhf(za) * (1.f / (1.f + expf(-zb)));
        }
        store2(g_s + (32 * wm + 16 * i + gq + 8 * h) * ROW_LD + col, gv[0],
               gv[1]);
      }
  }

  // 2. so = g . [Ws | Wo] on this warp's 32 output columns; the first
  // chunk's barrier also completes g_s
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int q = 0; q < R / KCH; ++q) {
    const float* st = next_chunk();
#pragma unroll
    for (int kk = 0; kk < KCH; kk += 8) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_a_split(a_hi[i], a_lo[i],
                     g_s + (32 * wm + 16 * i) * ROW_LD + q * KCH + kk, ROW_LD,
                     gq, tq);
      mma_tiles<2, 4, true>(acc, a_hi, a_lo, st + kk * WB_LD + 32 * wq,
                            WB_LD, [](int j) { return 8 * j; }, gq, tq);
    }
  }

  // wq < 2: skip += so[:, :S] + bs, in place. wq >= 2: x = (so[:, S:] + bo
  // + x) sqrt(1/2), x from the centre rows
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 32 * wq + 8 * j + 2 * tq;
    const float b0 = b_so[col], b1 = b_so[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * i + gq + 8 * h, t = t0 + r;
        if (t >= T) continue;
        const size_t row = row0 + t;
        const float v0 = acc[i][j][2 * h] + b0, v1 = acc[i][j][2 * h + 1] + b1;
        if (wq < 2) {
          float* p = skip + row * S + col;
          if (first_layer) {
            store2(p, v0, v1);
          } else {
            const float2 old = *reinterpret_cast<const float2*>(p);
            store2(p, old.x + v0, old.y + v1);
          }
        } else {
          const int ch = col - S;
          const float2 xo =
              *reinterpret_cast<const float2*>(x_s + r * ROW_LD + ch);
          store2(x_out + row * R + ch, (v0 + xo.x) * kSqrtHalf,
                 (v1 + xo.y) * kSqrtHalf);
        }
      }
  }
  // xs: the layer's input, as the taps read it
  if (xs != nullptr) {
    for (int i = tid; i < TT * (R / 4); i += THREADS) {
      const int r = i / (R / 4), ch = (i % (R / 4)) * 4, t = t0 + r;
      if (t < T)
        *reinterpret_cast<float4*>(xs + (row0 + t) * R + ch) =
            *reinterpret_cast<const float4*>(x_s + r * ROW_LD + ch);
    }
  }
  pwgpipe::cp_async_wait<0>();
}

// f32 all through: x, the residual and x_out are float, so every layer runs
// the one kernel over the ping-pong buffers
cudaError_t run_stack_tf32(const void* x, const void* c, const void* w_tap_,
                           const void* b_tap_, const void* w_aux_,
                           const void* w_so_, const void* b_so_,
                           const int* dilations, int L, int B, int T, int A,
                           void* x_out, float* skip, void* buf0, void* buf1,
                           void* xs_, cudaStream_t stream) {
  const float* w_tap = static_cast<const float*>(w_tap_);
  const float* b_tap = static_cast<const float*>(b_tap_);
  const float* w_aux = static_cast<const float*>(w_aux_);
  const float* w_so = static_cast<const float*>(w_so_);
  const float* b_so = static_cast<const float*>(b_so_);
  float* xs = static_cast<float*>(xs_);
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_layer_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tf32::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TT - 1) / TT, B);
  for (int l = 0; l < L; ++l) {
    // layer l reads what layer l-1 wrote: x, then buf0, buf1, buf0, ...
    const void* src = l == 0 ? x : (l % 2 == 1 ? buf0 : buf1);
    void* dst = l == L - 1 ? x_out : (l % 2 == 0 ? buf0 : buf1);
    wavenet_layer_tf32_kernel<<<grid, THREADS, tf32::SMEM, stream>>>(
        static_cast<const float*>(src), static_cast<const float*>(c),
        w_tap + (size_t)l * 3 * R * G, b_tap + (size_t)l * G,
        w_aux + (size_t)l * A * G, w_so + (size_t)l * R * SR,
        b_so + (size_t)l * SR, static_cast<float*>(dst), skip,
        xs == nullptr ? nullptr : xs + (size_t)l * B * T * R, T, A,
        dilations[l], l == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Runs L layers on `stream`; returns a cudaError_t (0 on success).
// The Python wrapper checks shapes, types and alignment before the call.
// dtype: 0 = float32, 1 = bfloat16, for x, c, x_out, xs and every weight.
// body, as the wrapper's launch plan names it: 1 = the split-TF32 body
// (one block per 64-row tile), the one float32 runs; 0 = the bf16
// tensor-core body (`blocks` persistent blocks), the one bfloat16 runs; any
// other pair is refused.
// x, x_out (B, T, 64); c (B, T, A); skip (B, T, 64) f32; buf0, buf1
// (B, T, 64) f32 scratch (buf0 needed for L >= 2, buf1 for L >= 3);
// xs (L, B, T, 64) receives every layer's input, or is null;
// weights as fuse_wavenet_stack_params lays them out; dilations on the host.
int pwg_wavenet_stack_forward(int dtype, int body, const void* x,
                              const void* c, const void* w_tap,
                              const void* b_tap, const void* w_aux,
                              const void* w_so, const void* b_so,
                              const int* dilations, int L, int B, int T,
                              int A, void* x_out, void* skip, void* buf0,
                              void* buf1, void* xs, int blocks,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sk = static_cast<float*>(skip);
  if (dtype == 0 && body == 1)
    return (int)run_stack_tf32(x, c, w_tap, b_tap, w_aux, w_so, b_so,
                               dilations, L, B, T, A, x_out, sk, buf0, buf1,
                               xs, s);
  if (dtype == 1 && body == 0 && blocks >= 1)
    return (int)run_stack_tc(x, c, w_tap, b_tap, w_aux, w_so, b_so, dilations,
                             L, B, T, A, x_out, sk, buf0, buf1, xs, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// shared memory of one tensor-core layer launch, by the type of the x it
// reads (0 = float32, 1 = bfloat16)
size_t pwg_wavenet_stack_tc_smem(int x_is_bf16, int A) {
  return x_is_bf16 ? pwgtc::tc_smem_bytes<__nv_bfloat16>(A)
                   : pwgtc::tc_smem_bytes<float>(A);
}

// shared memory of one split-TF32 layer launch
size_t pwg_wavenet_stack_tf32_smem() { return tf32::SMEM; }

const char* pwg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
