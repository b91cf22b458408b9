// Backward of the fused WaveNet gated residual stack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_stack_bwd_kernel`
// (parallelwavegan_tpu/ops/pallas/wavenet_stack_train.py:62). The forward
// (wavenet_stack.cu) saved every layer's input xs_l, rounded to the matmul
// type. Layers run last to first; with D = dL/dx_{l+1} and dskip = dL/dskip,
// for every time row t of every batch item:
//
//   z    = [xs(t-d) | xs(t) | xs(t+d)] . Wt + c(t) . Wa + bt     (recomputed)
//   ta   = tanh(z[:R]);  sig = sigmoid(z[R:]);  g = ta * sig
//   dso  = [dskip | D * sqrt(1/2)]
//   dg   = dso . Wso^T
//   dz   = [dg * sig * (1 - ta^2) | dg * ta * sig * (1 - sig)]
//   dWt += xcat^T . dz   dbt += sum dz   dWa += c^T . dz
//   dWso += g^T . dso    dbso += sum dso
//   dc  += dz . Wa^T
//   dL/dx_l(u) = D(u) * sqrt(1/2) + tap0(u+d) + tap1(u) + tap2(u-d),
//                [tap0 | tap1 | tap2] = dz . Wt^T, rows outside [0, T) zero.
//
// Every product accumulates in f32; the gate and dz through it are f32; D,
// the tap scratch and dc stay f32, and dx is rounded to the type of x once,
// at the end. What enters each product, per body:
//
//   product          float32 body          bfloat16 body (as the TPU kernel)
//   z                xs, c, [Wt; Wa]       the same, bf16
//   dg               dso, Wso^T            bf16(dso), Wso^T
//   [taps | dc]      dz, [Wt; Wa]^T        bf16(dz), [Wt; Wa]^T
//   dWt, dWa         xcat, c; dz           xcat, c; bf16(dz)
//   dWso             g; dso                bf16(g); bf16(dso)
//   dbt, dbso        sums of f32 dz, dso   sums of f32 dz, dso
//
// In f32 nothing is rounded; in bf16 the cotangents are rounded just before
// the products that take them, where the TPU kernel rounds them for its
// matrix unit (its dzm and dso.astype(mm)).
//
// Design. The TPU kernel walks halo'd windows, keeps the running cotangent
// and two zero-edged tap scratches in VMEM across its sequential layer grid
// steps, overlap-adds dx and dc outside and writes one weight-gradient block
// per (window, layer). None of that fits 227 KB of shared memory or Hopper's
// unordered blocks. Here every layer is two launches over global scratch
// buffers that the wrapper allocates, last layer first:
//
//   data launch   one 64-row tile of one item at a time: recompute ta and
//     sig from xs and c, then dg (K = 128) and [taps | dc] (K = 128,
//     N = 3R + A). No atomics and no overlap-add: the launch writes the
//     three tap products (B, T, 3R) to a scratch, and the next launch
//     (layer l-1) forms its incoming cotangent on read,
//     D(u) <- D(u) * sqrt(1/2) + tap0(u+d) + tap1(u) + tap2(u-d), in place
//     (each row of D is read and written by the one block that owns it;
//     the tap scratch ping-pongs). dc accumulates in place in f32. dz and
//     g go to global scratch for the second launch.
//   weight launch grid (slabs, tiles): the weight gradients are sums over
//     all B*T rows, so they are [xcat | c | g]^T . [dz | dso] GEMMs whose
//     contraction runs over rows. Each block takes one 64-row tile of the
//     output (a tap, 64 channels of c, or g) and one slab of rows,
//     accumulates 64 x 128 sums in registers and writes one f32 partial.
//     The wrapper adds the slabs with one torch.sum: deterministic, unlike
//     f32 atomicAdd. As many slabs as keep every block resident (two a SM):
//     the launch is one wave.
//
// A last small launch forms the cotangent of the stack input from D and the
// first layer's taps.
//
// Two bodies run that design; the wrapper's launch plan
// (backward_launch_plan in ops/cuda/wavenet_stack_train.py) picks one from
// the dtype, and the C entry point takes the one it names:
//
//   float32: tensor_cores_tf32x3 (bwd_data_tc_kernel, bwd_weight_tc_kernel).
//     Every product on mma.sync m16n8k8 TF32 tensor cores in three terms:
//     x = hi + lo with hi = x rounded to TF32, lo = x - hi (which the
//     tensor core truncates to TF32), a . b = lo_a hi_b + hi_a lo_b +
//     hi_a hi_b in f32 (mma_common.cuh). One TF32 product keeps 10 mantissa
//     bits and misses the card tests' 1e-4 (1 + max) at these shapes (2.4e-4
//     to 2.6e-4 in tests/test_torch_wavenet_stack_bwd.py's emulation); the
//     three-term split keeps 6e-8 to 9e-8 there; on an NVIDIA H100 (700 W)
//     the gradients stay within 3e-5 (1 + max) of the plain version. The
//     tensor core truncates what it adds into its accumulator, so, as in
//     the forward, each k-step's three products are summed in a zeroed
//     tile and added in f32 (mma_tiles with FRESH), and the bias column
//     sums are taken per 32-row chunk and then added: summed in place, the
//     weight gradients at the training shape lay up to 44 x further from
//     float64 than the plain version's f32 sums, dx 6 x (seeded weights;
//     chip_smoke.py holds all seven outputs to at most 2 x;
//     tools/backward_f32_sums.py measures the variants). The
//     data launch runs one block per tile and streams weights and
//     activation columns through a three-slot cp.async ring of 32-row
//     chunks (pipeline.cuh) that runs through its three products without
//     draining; ta, sig, dg and dz live in registers in the accumulators'
//     layout (a warp owns the tanh and sigmoid columns of the same
//     channels). The weight launch streams 32-row chunks of both sides
//     through a four-slot ring; row 64 of its partial holds the column sums
//     (the bias gradients).
//   bfloat16: tensor_cores_bf16 (bwd_data_bf16_kernel,
//     bwd_weight_bf16_kernel). Every product one mma.sync m16n8k16 bf16 ->
//     f32 product (mma_common.cuh) on the operands of the table above. The
//     data launch runs on persistent blocks, one an SM, in the manner of
//     the forward's bf16 body (wavenet_stack.cu): each block loads the
//     layer's weights once and keeps them while it walks tiles, and the next
//     tile's xs windows, c rows and bf16 dskip rows arrive by cp.async while
//     the warps work on this one. One copy of [Wt; Wa] serves two products:
//     z reads it [k][n] through ldmatrix.trans, [taps | dc] reads the same
//     rows as [n][k] through plain ldmatrix (so no transposed copy is read),
//     and dg reads Wso [n][k] the same way. The incoming cotangent's f32
//     loads are issued before the gate product and consumed after it. dz,
//     g and bf16(D_in sqrt(1/2)) go to global memory in bf16 (the weight
//     launch takes them only rounded), with the f32 column sums of dz and of
//     D_in sqrt(1/2) per block (the wrapper adds the blocks; the sums of
//     dskip are the same every layer and the wrapper takes them once). The
//     weight launch streams 64-row chunks of both sides, all bf16, through
//     a four-slot ring and reads both as fragments by ldmatrix.trans.
//     Shared memory of the data launch (A = 80; AP = A padded to 16):
//       [Wt; Wa; 0] (3R + AP) x 128 bf16, swizzled      69,632 B
//       Wso R x 128 bf16, swizzled                      16,384
//       bt f32                                             512
//       column sums of a tile [8][R] + [2][G] f32        3,072
//       bf16(D_in sqrt(1/2)) [64][R] (rows padded)       9,216
//       bf16(dz) [64][G] (rows padded)                  17,408
//       two ring slots: three xs windows (or one halo'd window) [192][R],
//       bf16 dskip [64][S], c [64][AP] (rows padded)   96,256
//     212,480 B in all, 512 B more for each 1 of AP: one block an SM, and
//     the plan refuses A above 112.
//
// Bound (PWG v1 training batch 6 x 25,600 samples, 30 layers): per row and
// layer 3 (3R + A) G + 2 R (S + R) = 120,832 MAC = 241,664 FLOP (the gate
// product recomputed and transposed twice, the skip/out 1x1 only transposed
// twice), 1.11e12 FLOP in all: 6.75 ms for the split-TF32 body (three TF32
// products each, 495 / 3 TFLOP/s), 1.13 ms at the bf16 tensor-core peak.
// The bytes that must move (xs, c, the cotangents, dx, dc; about 0.7 GB in
// bf16, 1.4 GB in f32) take under 0.5 ms, but the two-launch design moves
// more. Per row and layer in f32 the data launch moves 4,032 B (xs, c, D
// read and written, the three tap rows read, taps, dz and g written, dc
// read and written) and the weight launch 1,856 B (xs, c, g, dz, dskip, D),
// 27 GB in all, 8.10 ms at 3.35 TB/s. In bf16 the data launch moves 3,616 B
// (xs, c and dskip in bf16; D, the tap rows and dc as in f32; dz, g and
// bf16(D_in sqrt(1/2)) written in bf16) and the weight launch 928 B (xs, c,
// g, dz, dskip, bf16(D_in sqrt(1/2)), all bf16), 21 GB in all, 6.25 ms. So
// for both bodies the byte floor of this design binds before its
// operations; keeping D and the taps on chip (fusing the launches) is the
// next step.

#include "mma_common.cuh"
#include "pipeline.cuh"
#include "wavenet_common.cuh"

namespace {

using namespace pwg;
using pwgmma::load_a_split;
using pwgmma::mma_tf32;
using pwgmma::mma_tiles;
using pwgmma::split_tf32;

constexpr int KR = 32;  // rows per chunk of the f32 weight launch

// The cotangent of this layer's output for 4 channels of row t of one item:
// D itself for the last layer, else D * sqrt(1/2) plus the three tap
// transposes of the layer above (dilation dp) read from its tap scratch.
__device__ __forceinline__ void incoming_cotangent(
    float v[4], const float* __restrict__ D, const float* __restrict__ taps,
    size_t row0, int t, int T, int ch, int dp) {
  load4(D + (row0 + t) * R + ch, v);
  if (taps == nullptr) return;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4], e[4] = {0.f, 0.f, 0.f, 0.f};
  if (t + dp < T) load4(taps + (row0 + t + dp) * (3 * R) + ch, a);
  load4(taps + (row0 + t) * (3 * R) + R + ch, b);
  if (t - dp >= 0) load4(taps + (row0 + t - dp) * (3 * R) + 2 * R + ch, e);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] * kSqrtHalf + a[j] + b[j] + e[j];
}

// dx = D * sqrt(1/2) + the first layer's tap transposes, in the type of x
template <typename WT>
__global__ void bwd_finish_kernel(const float* __restrict__ D,
                                  const float* __restrict__ taps,
                                  WT* __restrict__ dx, int T, int d,
                                  long long groups) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const long long n = i / (R / 4);
  const int ch = (int)(i % (R / 4)) * 4;
  const long long b = n / T;
  const int t = (int)(n - b * T);
  float v[4];
  incoming_cotangent(v, D, taps, (size_t)(b * T), t, T, ch, d);
  store4(dx + n * R + ch, v);
}

// ---------------------------------------------------------------------------
// The f32 tensor-core body: the same two launches a layer, every product on
// mma.sync m16n8k8 TF32 in three terms (mma_common.cuh), the weights and row
// chunks through cp.async rings (pipeline.cuh).

namespace tc {

constexpr int STAGES = 3;         // data launch: ring slots
constexpr int KCH = 32;           // contraction rows of one ring chunk
constexpr int WB_LD = G + 8;      // [k][n] chunk of 128 columns (= 8 mod 32)
constexpr int WS_LD = R + 8;      // [k][n] chunk of Wso^T, 64 columns
constexpr int ACT_LD = KCH + 4;   // [row][k] activation chunk (= 4 mod 8)
constexpr int STAGE_FLOATS = KCH * WB_LD + TT * ACT_LD;
constexpr int ROW_LD = G + 4;     // [row][128] dso tile, then dz (= 4 mod 8)
constexpr int DATA_SMEM = (STAGES * STAGE_FLOATS + TT * ROW_LD) * 4;

constexpr int WSTAGES = 4;        // weight launch: ring slots
constexpr int LHS_LD = 64 + 8;    // [row][64] left-hand chunk (= 8 mod 32)
constexpr int RHS_LD = G + 8;     // [row][128] right-hand chunk
constexpr int WSTAGE_FLOATS = KR * (LHS_LD + RHS_LD);
constexpr int WEIGHT_SMEM = WSTAGES * WSTAGE_FLOATS * 4;

// load_a_split (mma_common.cuh) from a [k][row] tile: the transposed
// left-hand side
__device__ __forceinline__ void load_at_split(uint32_t hi[4], uint32_t lo[4],
                                              const float* a, int lda, int gq,
                                              int tq) {
  const float v[4] = {a[tq * lda + gq], a[tq * lda + gq + 8],
                      a[(tq + 4) * lda + gq], a[(tq + 4) * lda + gq + 8]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}

}  // namespace tc

// bwd_data_tc_kernel: one 64-row tile of one item per block, 8 warps; warp
// (wm, wq) = (warp % 2, warp / 2) owns rows 32 wm .. 32 wm + 31 (two
// m-tiles, so every B fragment it loads and splits feeds two). One ring of
// chunks of 32 contraction rows runs through the three products without
// draining between them:
//   z = [x(t-d) | x(t) | x(t+d) | c] . [Wt; Wa]   ceil(K / 32) chunks, each
//       32 weight rows and the matching 32 columns of the activation tile;
//       the warp takes the tanh columns 16 wq .. +15 and the sigmoid columns
//       64 + 16 wq .. +15, so ta and sig of one channel meet in one lane
//   dg = dso . Wso^T                              4 chunks of Wso^T (32 x 64);
//       the warp takes columns 16 wq .. +15, the channels it holds ta and
//       sig of, so dz forms in registers
//   [taps | dc] = dz . [Wt; Wa]^T                 panels of 128 columns x 4
//       chunks; the warp takes columns 32 wq .. +31 of a panel, n-tiles
//       past 3R + A skipped
// dso (dskip | D_in sqrt(1/2), D_in formed on read by incoming_cotangent)
// and then dz sit in one [64][128] tile beside the ring.
__global__ void __launch_bounds__(THREADS, 2) bwd_data_tc_kernel(
    const float* __restrict__ xs, const float* __restrict__ c,
    const float* __restrict__ w_tap, const float* __restrict__ b_tap,
    const float* __restrict__ w_aux, const float* __restrict__ w_so_t,
    const float* __restrict__ w_cat_t, const float* __restrict__ dskip,
    float* __restrict__ D, const float* __restrict__ taps_in,
    float* __restrict__ taps_out, float* __restrict__ dc,
    float* __restrict__ dz_out, float* __restrict__ g_out, int T, int A,
    int d, int d_prev, int first_launch) {
  using namespace tc;
  using pwgpipe::cp_async16;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* row_s = ring + STAGES * STAGE_FLOATS;  // [TT][ROW_LD] dso, then dz

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wq = warp >> 1;
  const int t0 = blockIdx.x * TT;
  const size_t row0 = (size_t)blockIdx.y * T;
  const int K = 3 * R + A;  // the gate contraction, and the taps' columns
  const int n_gate = (K + KCH - 1) / KCH;
  const int n_dg = SR / KCH;
  const int n_pan = (K + G - 1) / G;
  const int n_chunks = n_gate + n_dg + n_pan * (G / KCH);

  // every thread copies its share of chunk ci into its ring slot
  auto issue = [&](int ci) {
    float* st = ring + (ci % STAGES) * STAGE_FLOATS;
    if (ci < n_gate) {
      const int k0 = ci * KCH;
      for (int i = tid; i < KCH * (G / 4); i += THREADS) {
        const int kk = i / (G / 4), col = (i % (G / 4)) * 4;
        const int k = k0 + kk;
        const float* src = k < 3 * R ? w_tap + (size_t)k * G + col
                                     : w_aux + (size_t)(k - 3 * R) * G + col;
        cp_async16(st + kk * WB_LD + col, k < K ? src : w_tap, k < K);
      }
      for (int i = tid; i < TT * (KCH / 4); i += THREADS) {
        const int r = i / (KCH / 4), k = k0 + (i % (KCH / 4)) * 4;
        const float* src = xs;
        bool valid;
        if (k < 3 * R) {
          const int t = t0 + r + (k / R - 1) * d;
          valid = t >= 0 && t < T;
          if (valid) src = xs + (row0 + t) * R + k % R;
        } else {
          const int t = t0 + r;
          valid = t < T && k < K;
          if (valid) src = c + (row0 + t) * A + (k - 3 * R);
        }
        cp_async16(st + KCH * WB_LD + r * ACT_LD + (i % (KCH / 4)) * 4, src,
                   valid);
      }
    } else if (ci < n_gate + n_dg) {
      const int k0 = (ci - n_gate) * KCH;
      for (int i = tid; i < KCH * (R / 4); i += THREADS) {
        const int kk = i / (R / 4), col = (i % (R / 4)) * 4;
        cp_async16(st + kk * WS_LD + col,
                   w_so_t + (size_t)(k0 + kk) * R + col, true);
      }
    } else {
      const int j = ci - n_gate - n_dg;
      const int m0 = (j / (G / KCH)) * G, k0 = (j % (G / KCH)) * KCH;
      for (int i = tid; i < KCH * (G / 4); i += THREADS) {
        const int kk = i / (G / 4), col = (i % (G / 4)) * 4;
        const bool valid = m0 + col < K;
        cp_async16(st + kk * WB_LD + col,
                   valid ? w_cat_t + (size_t)(k0 + kk) * K + m0 + col
                         : w_cat_t,
                   valid);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) issue(s);
    pwgpipe::cp_async_commit();
  }

  // dso tile while the first chunks are in flight: [dskip | D_in sqrt(1/2)],
  // D_in written back in place for the weight launch and the next layer
  for (int i = tid; i < TT * (S / 4); i += THREADS) {
    const int ch = (i % (S / 4)) * 4, r = i / (S / 4), t = t0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < T) load4(dskip + (row0 + t) * S + ch, v);
    store4(row_s + r * ROW_LD + ch, v);
  }
  for (int i = tid; i < TT * (R / 4); i += THREADS) {
    const int ch = (i % (R / 4)) * 4, r = i / (R / 4), t = t0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < T) {
      incoming_cotangent(v, D, taps_in, row0, t, T, ch, d_prev);
      if (taps_in != nullptr) store4(D + (row0 + t) * R + ch, v);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] *= kSqrtHalf;
    store4(row_s + r * ROW_LD + S + ch, v);
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

  // 1. z, then the gate in registers; g to global memory for the weight
  // launch. One loop a product keeps each product's registers to itself.
  float ta[2][2][4], sig[2][2][4];
  {
    float acc[2][4][4] = {};
    for (int q = 0; q < n_gate; ++q) {
      const float* st = next_chunk();
#pragma unroll
      for (int kk = 0; kk < KCH; kk += 8) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a_split(a_hi[i], a_lo[i],
                       st + KCH * WB_LD + (32 * wm + 16 * i) * ACT_LD + kk,
                       ACT_LD, gq, tq);
        mma_tiles<2, 4, true>(
            acc, a_hi, a_lo, st + kk * WB_LD + 16 * wq, WB_LD,
            [](int j) { return (j >> 1) * R + 8 * (j & 1); }, gq, tq);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * wq + 8 * j + 2 * tq;
      const float bt[4] = {b_tap[col], b_tap[col + 1], b_tap[R + col],
                           b_tap[R + col + 1]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ta[i][j][e] = tanhf(acc[i][j][e] + bt[e & 1]);
          sig[i][j][e] =
              1.f / (1.f + expf(-(acc[i][2 + j][e] + bt[2 + (e & 1)])));
          gv[e] = ta[i][j][e] * sig[i][j][e];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + 32 * wm + 16 * i + gq + 8 * h;
          if (t < T)
            store2(g_out + (row0 + t) * R + col, gv[2 * h], gv[2 * h + 1]);
        }
      }
    }
  }

  // 2. dg = dso . Wso^T, then dz through the gate: over the dso tile once
  // every warp is done reading it, and to global memory for the weight
  // launch
  {
    float dg[2][2][4] = {};
    for (int q = 0; q < n_dg; ++q) {
      const float* st = next_chunk();
#pragma unroll
      for (int kk = 0; kk < KCH; kk += 8) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a_split(a_hi[i], a_lo[i],
                       row_s + (32 * wm + 16 * i) * ROW_LD + q * KCH + kk,
                       ROW_LD, gq, tq);
        mma_tiles<2, 2, true>(dg, a_hi, a_lo, st + kk * WS_LD + 16 * wq,
                              WS_LD, [](int j) { return 8 * j; }, gq, tq);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * wq + 8 * j + 2 * tq;
        float da[4], db[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = ta[i][j][e], sg = sig[i][j][e];
          da[e] = dg[i][j][e] * sg * (1.f - a * a);
          db[e] = dg[i][j][e] * a * sg * (1.f - sg);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 32 * wm + 16 * i + gq + 8 * h;
          store2(row_s + r * ROW_LD + col, da[2 * h], da[2 * h + 1]);
          store2(row_s + r * ROW_LD + R + col, db[2 * h], db[2 * h + 1]);
          const int t = t0 + r;
          if (t < T) {
            store2(dz_out + (row0 + t) * G + col, da[2 * h], da[2 * h + 1]);
            store2(dz_out + (row0 + t) * G + R + col, db[2 * h],
                   db[2 * h + 1]);
          }
        }
      }
  }

  // 3. [taps | dc] = dz . [Wt; Wa]^T, a panel of 128 columns at a time: tap
  // products to the scratch, dc in place
  for (int m0 = 0; m0 < K; m0 += G) {
    // n-tiles of this warp left of column K (warp-uniform)
    const int n_valid = min(4, max(0, (K - m0 - 32 * wq + 7) / 8));
    float acc[2][4][4] = {};
    for (int q = 0; q < G / KCH; ++q) {
      const float* st = next_chunk();
#pragma unroll
      for (int kk = 0; kk < KCH; kk += 8) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a_split(a_hi[i], a_lo[i],
                       row_s + (32 * wm + 16 * i) * ROW_LD + q * KCH + kk,
                       ROW_LD, gq, tq);
        mma_tiles<2, 4, true>(acc, a_hi, a_lo, st + kk * WB_LD + 32 * wq,
                              WB_LD, [](int j) { return 8 * j; }, gq, tq,
                              n_valid);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + 32 * wq + 8 * j + 2 * tq;  // even, as are 3R and K
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + 32 * wm + 16 * i + gq + 8 * h;
          if (t < T && m < K) {
            const size_t row = row0 + t;
            float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
            if (m < 3 * R) {
              store2(taps_out + row * (3 * R) + m, v0, v1);
            } else {
              float* p = dc + row * A + (m - 3 * R);
              if (!first_launch) {
                const float2 old = *reinterpret_cast<const float2*>(p);
                v0 += old.x;
                v1 += old.y;
              }
              store2(p, v0, v1);
            }
          }
        }
    }
  }
}

// bwd_weight_tc_kernel: one 64 x 128 block of [xcat | c | g]^T . [dz | dso]
// over one slab of rows. tile 0..2: tap (tile - 1) d of xs against dz; tile
// 3..3+NC-1: 64 channels of c against dz; the last tile: g against dso.
// Chunks of 32 rows of both sides arrive through a four-slot cp.async ring;
// warp (wm, wn) = (warp % 2, warp / 2) owns output rows 32 wm .. +31 and
// columns 32 wn .. +31.
// The g tile reads D itself; its dso columns are scaled by sqrt(1/2) at the
// end. Row 64 of the partial holds the column sums of the right-hand side
// (dbt from tile 0, dbso from the last tile; zeros in the other tiles).
__global__ void __launch_bounds__(THREADS, 2) bwd_weight_tc_kernel(
    const float* __restrict__ xs, const float* __restrict__ c,
    const float* __restrict__ dz, const float* __restrict__ g,
    const float* __restrict__ dskip, const float* __restrict__ D,
    float* __restrict__ partial, int B, int T, int A, int d,
    int rows_per_slab) {
  using namespace tc;
  using pwgpipe::cp_async16;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const bool g_tile = tile == n_tiles - 1;
  const bool sums = tile == 0 || g_tile;
  const long long N = (long long)B * T;
  const long long n_begin = (long long)blockIdx.x * rows_per_slab;
  const long long n_end = min(N, n_begin + rows_per_slab);
  const int n_chunks = n_end > n_begin ? (int)((n_end - n_begin + KR - 1) / KR)
                                       : 0;

  auto issue = [&](int ci) {
    float* lhs = ring + (ci % WSTAGES) * WSTAGE_FLOATS;
    float* rhs = lhs + KR * LHS_LD;
    const long long n0 = n_begin + (long long)ci * KR;
    for (int i = tid; i < KR * 16; i += THREADS) {
      const int kk = i / 16, ch = (i % 16) * 4;
      const long long n = n0 + kk;
      const float* src = xs;
      bool valid = false;
      if (n < n_end) {
        if (tile < 3) {
          const long long b = n / T;
          const int t = (int)(n - b * T) + (tile - 1) * d;
          valid = t >= 0 && t < T;
          if (valid) src = xs + (b * T + t) * R + ch;
        } else if (g_tile) {
          valid = true;
          src = g + n * R + ch;
        } else {
          const int ca = (tile - 3) * 64 + ch;
          valid = ca < A;
          if (valid) src = c + n * A + ca;
        }
      }
      cp_async16(lhs + kk * LHS_LD + ch, src, valid);
    }
    for (int i = tid; i < KR * 32; i += THREADS) {
      const int kk = i / 32, col = (i % 32) * 4;
      const long long n = n0 + kk;
      const float* src = !g_tile ? dz + n * G + col
                         : col < S ? dskip + n * S + col
                                   : D + n * R + (col - S);
      cp_async16(rhs + kk * RHS_LD + col, n < n_end ? src : dz, n < n_end);
    }
  };

#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < n_chunks) issue(s);
    pwgpipe::cp_async_commit();
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float colsum = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    pwgpipe::cp_async_wait<WSTAGES - 2>();
    __syncthreads();
    if (ci + WSTAGES - 1 < n_chunks) issue(ci + WSTAGES - 1);
    pwgpipe::cp_async_commit();
    const float* lhs = ring + (ci % WSTAGES) * WSTAGE_FLOATS;
    const float* rhs = lhs + KR * LHS_LD;
    if (sums && tid < G) {  // a chunk's rows summed apart, then added
      float part = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < KR; ++kk) part += rhs[kk * RHS_LD + tid];
      colsum += part;
    }
#pragma unroll
    for (int kk = 0; kk < KR; kk += 8) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_at_split(a_hi[i], a_lo[i], lhs + kk * LHS_LD + 32 * wm + 16 * i,
                      LHS_LD, gq, tq);
      mma_tiles<2, 4, true>(acc, a_hi, a_lo, rhs + kk * RHS_LD + 32 * wn,
                            RHS_LD, [](int j) { return 8 * j; }, gq, tq);
    }
  }

  float* out = partial + ((size_t)blockIdx.x * n_tiles + tile) * 65 * 128;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 32 * wn + 8 * j + 2 * tq;
    const float scale = g_tile && col >= S ? kSqrtHalf : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(out + (32 * wm + 16 * i + gq + 8 * h) * 128 + col,
               acc[i][j][2 * h] * scale, acc[i][j][2 * h + 1] * scale);
  }
  if (tid < G)
    out[64 * 128 + tid] = g_tile && tid >= S ? colsum * kSqrtHalf : colsum;
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core body: the same two launches a layer, every product
// one mma.sync m16n8k16 bf16 -> f32 product, the cotangents rounded to bf16
// where the TPU kernel rounds them.

namespace bf {

using bf16 = __nv_bfloat16;

constexpr int W_ROW = G * 2;         // bytes of a resident weight row (swizzled)
constexpr int X_ROW = R * 2 + 16;    // bytes of a staged row of 64 bf16
constexpr int Z_ROW = G * 2 + 16;    // bytes of a row of the dz tile
constexpr int STAGES = 2;            // data launch: ring slots
constexpr int SUMS = 8 * R + 2 * G;  // f32 column sums of one tile
constexpr int WCH = 64;              // weight launch: rows of a chunk
constexpr int WSTAGES = 4;           // weight launch: ring slots
constexpr int WSTAGE = WCH * (X_ROW + Z_ROW);
constexpr int WEIGHT_SMEM = WSTAGES * WSTAGE;

// aux channels padded to the mma depth, and a staged c row (an odd number
// of 16-byte chunks, like every staged row: ldmatrix conflict-free)
__host__ __device__ constexpr int padded_aux(int A) { return (A + 15) / 16 * 16; }
__host__ __device__ constexpr int c_row(int A) { return padded_aux(A) * 2 + 16; }

// a ring slot: three xs windows of TT rows (or one halo'd window of up to
// TT + 2 d rows), bf16 dskip [TT][S], c [TT][AP]
__host__ __device__ constexpr size_t stage_bytes(int A) {
  return (size_t)4 * TT * X_ROW + (size_t)TT * c_row(A);
}

// the data launch's shared memory (the layout in the head note); mirrored
// by backward_smem_bytes() in ops/cuda/wavenet_stack_train.py
__host__ __device__ constexpr size_t data_smem(int A) {
  return (size_t)(4 * R + padded_aux(A)) * W_ROW + G * 4 + SUMS * 4 +
         TT * X_ROW + TT * Z_ROW + STAGES * stage_bytes(A);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// tanh and sigmoid on the special-function unit (relative error near 1e-6,
// far below bf16's rounding; both saturate exactly), as the forward's bf16
// gate (wavenet_stack.cu)
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// A fragment of rows m0..m0+15, k0..k0+15 of a row-major bf16 tile whose
// rows are `row` bytes apart
__device__ __forceinline__ void a_frag(uint32_t a[4], const unsigned char* t,
                                       int row, int m0, int k0, int lane) {
  pwgpipe::ldmatrix_x4(a, t + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row +
                              k0 * 2 + (lane >> 4) * 16);
}

// B fragments of n-tiles n0, n0 + 8 over k0..k0+15 from a swizzled resident
// weight tile: stored [k][n] (b_kn, ldmatrix.trans) or [n][k] (b_nk)
__device__ __forceinline__ void b_kn(uint32_t b[4], const unsigned char* w,
                                     int k0, int n0, int lane) {
  pwgpipe::ldmatrix_x4_trans(
      b, w + pwgpipe::swizzle(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              n0 / 8 + (lane >> 4), W_ROW));
}
__device__ __forceinline__ void b_nk(uint32_t b[4], const unsigned char* w,
                                     int k0, int n0, int lane) {
  pwgpipe::ldmatrix_x4(
      b, w + pwgpipe::swizzle(n0 + (lane & 7) + (lane >> 4) * 8,
                              k0 / 8 + ((lane >> 3) & 1), W_ROW));
}

}  // namespace bf

// bwd_data_bf16_kernel: persistent blocks of 8 warps walk tiles tile =
// blockIdx.x, + gridDim.x, ... (B * ceil(T / 64) of them). Warp (wm, wq) =
// (warp % 2, warp / 2) owns rows 32 wm .. 32 wm + 31 of a tile (two
// m-tiles, so every B fragment feeds two products):
//   z = [x(t-d) | x(t) | x(t+d) | c] . [Wt; Wa]   3R / 16 + AP / 16 k-steps;
//       the warp takes the tanh columns 16 wq .. +15 and the sigmoid
//       columns 64 + 16 wq .. +15, so ta and sig of one channel meet in one
//       lane
//   dg = bf16(dso) . Wso^T                        8 k-steps; the warp takes
//       the channels it holds ta and sig of, so dz forms in registers
//   [taps | dc] = bf16(dz) . [Wt; Wa]^T           the warp keeps its rows'
//       A fragments (all 8 k-steps) in registers and takes column pairs
//       16 p .. 16 p + 15, p = wq, wq + 4, ... < (3R + AP) / 16
// Three barriers a tile: the slot has landed; bf16(D_in sqrt(1/2)) is
// complete; bf16(dz) and the tile's column sums are complete.
__global__ void __launch_bounds__(THREADS, 1) bwd_data_bf16_kernel(
    const bf::bf16* __restrict__ xs, const bf::bf16* __restrict__ c,
    const bf::bf16* __restrict__ w_tap, const bf::bf16* __restrict__ b_tap,
    const bf::bf16* __restrict__ w_aux, const bf::bf16* __restrict__ w_so,
    const bf::bf16* __restrict__ dskip, float* __restrict__ D,
    const float* __restrict__ taps_in, float* __restrict__ taps_out,
    float* __restrict__ dc, bf::bf16* __restrict__ dz_out,
    bf::bf16* __restrict__ g_out, bf::bf16* __restrict__ dres_out,
    float* __restrict__ colsum, int B, int T, int A, int d, int d_prev,
    int first_launch) {
  using namespace bf;
  using pwgpipe::cp_async16;
  const int AP = padded_aux(A);
  const int CS = c_row(A);
  const int K = 3 * R + A;    // the gate contraction; columns of [taps | dc]
  const int KP = 3 * R + AP;  // resident rows of [Wt; Wa], zero-padded
  extern __shared__ float4 smem4[];
  unsigned char* w_s = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* wso_s = w_s + (size_t)KP * W_ROW;
  float* bias_s = reinterpret_cast<float*>(wso_s + R * W_ROW);
  float* sums_s = bias_s + G;  // [8][R] of D_in sqrt(1/2), [2][G] of dz
  unsigned char* dres_s = reinterpret_cast<unsigned char*>(sums_s + SUMS);
  unsigned char* dz_s = dres_s + TT * X_ROW;
  unsigned char* ring = dz_s + TT * Z_ROW;
  const size_t sbytes = stage_bytes(A);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wq = warp >> 1;
  const int per_item = (T + TT - 1) / TT;
  const int tiles = B * per_item;

  // the layer's weights, once: rows [Wt (3R); Wa (A); zeros (AP - A); Wso
  // (R)] of 128 bf16, 16-byte chunks swizzled (KP is a multiple of 8, so
  // Wso's rows keep their swizzle key)
  for (int i = tid; i < (KP + R) * (W_ROW / 16); i += THREADS) {
    const int k = i / (W_ROW / 16), ch = i % (W_ROW / 16);
    const bf16* src = w_tap;
    bool ok = true;
    if (k < 3 * R) src = w_tap + (size_t)k * G;
    else if (k < K) src = w_aux + (size_t)(k - 3 * R) * G;
    else if (k < KP) ok = false;
    else src = w_so + (size_t)(k - KP) * SR;
    cp_async16(w_s + pwgpipe::swizzle(k, ch, W_ROW), ok ? src + ch * 8 : w_tap,
               ok);
  }
  for (int i = tid; i < G; i += THREADS) bias_s[i] = __bfloat162float(b_tap[i]);

  // stage tile `tile` into ring slot `slot`, rows outside [0, T) as zeros;
  // one commit group per call. For d < TT the taps overlap and one window
  // of rows t0 - d .. t0 + TT + d - 1 serves all three (tap k starts at
  // window row k d); otherwise each tap has its own TT rows.
  const bool halo = d < TT;
  const int x_rows = halo ? TT + 2 * d : 3 * TT;
  auto fill = [&](int tile, int slot) {
    if (tile < tiles) {
      unsigned char* st = ring + slot * sbytes;
      const int b = tile / per_item, t0 = (tile % per_item) * TT;
      const size_t row0 = (size_t)b * T;
      constexpr int XC = R * 2 / 16;  // 16-byte chunks of a row; S == R
      const int ch = tid % XC;
      for (int q = tid / XC; q < x_rows; q += THREADS / XC) {
        const int t = halo ? t0 - d + q : t0 + q % TT + (q / TT - 1) * d;
        const bool ok = t >= 0 && t < T;
        cp_async16(st + q * X_ROW + ch * 16,
                   ok ? xs + (row0 + t) * R + ch * 8 : xs, ok);
      }
      unsigned char* sk = st + 3 * TT * X_ROW;
      for (int q = tid / XC; q < TT; q += THREADS / XC) {
        const bool ok = t0 + q < T;
        cp_async16(sk + q * X_ROW + ch * 16,
                   ok ? dskip + (row0 + t0 + q) * S + ch * 8 : dskip, ok);
      }
      unsigned char* c_st = sk + TT * X_ROW;
      if (A % 8 == 0) {  // rows of whole 16-byte pieces
        for (int i = tid; i < TT * (AP / 8); i += THREADS) {
          const int v = i % (AP / 8), r = i / (AP / 8);
          const bool ok = t0 + r < T && v < A / 8;
          cp_async16(c_st + r * CS + v * 16,
                     ok ? c + (row0 + t0 + r) * A + v * 8 : c, ok);
        }
      } else {  // 8-byte pieces (A is a multiple of 4)
        for (int i = tid; i < TT * (AP / 4); i += THREADS) {
          const int v = i % (AP / 4), r = i / (AP / 4);
          const bool ok = t0 + r < T && v < A / 4;
          pwgpipe::cp_async8(c_st + r * CS + v * 8,
                             ok ? c + (row0 + t0 + r) * A + v * 4 : c, ok);
        }
      }
    }
    pwgpipe::cp_async_commit();
  };

  // this thread's share of the incoming cotangent: rows tid / 16 + 16 i,
  // channels 4 (tid % 16) .. + 3
  const int cg = (tid & 15) * 4;
  // the block's column sums over its tiles: dbt (tid < G), then the dso
  // half of dbso (G <= tid < G + R)
  float csum = 0.f;

  fill(blockIdx.x, 0);  // with the weights: one group
  int slot = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    fill(tile + gridDim.x, slot ^ 1);
    pwgpipe::cp_async_wait<1>();  // this tile (and the weights) landed
    __syncthreads();
    const unsigned char* st = ring + slot * sbytes;
    const int b = tile / per_item, t0 = (tile % per_item) * TT;
    const size_t row0 = (size_t)b * T;

    // 1. the incoming cotangent's loads, in flight during the gate product
    float4 dv[4], tp[4][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + (tid >> 4) + 16 * i;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      dv[i] = tp[i][0] = tp[i][1] = tp[i][2] = zero;
      if (t >= T) continue;
      dv[i] = *reinterpret_cast<const float4*>(D + (row0 + t) * R + cg);
      if (taps_in == nullptr) continue;
      const float* tr = taps_in + (row0 + t) * (3 * R) + cg;
      if (t + d_prev < T)
        tp[i][0] = *reinterpret_cast<const float4*>(tr + (size_t)d_prev * 3 * R);
      tp[i][1] = *reinterpret_cast<const float4*>(tr + R);
      if (t - d_prev >= 0)
        tp[i][2] = *reinterpret_cast<const float4*>(
            tr - (size_t)d_prev * 3 * R + 2 * R);
    }

    // 2. z on this warp's tanh n-tiles (j = 0, 1) and their sigmoid
    // partners (j = 2, 3), then the gate in registers; g to global memory
    float ta[2][2][4], sg[2][2][4];
    {
      float acc[2][4][4] = {};
      const int tap_rows = halo ? d : TT;  // window rows between taps
      auto step = [&](const unsigned char* act, int row, int k_act,
                      int k_w) {
        uint32_t a[2][4], bt[4], bs[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a_frag(a[i], act, row, 32 * wm + 16 * i, k_act, lane);
        b_kn(bt, w_s, k_w, 16 * wq, lane);
        b_kn(bs, w_s, k_w, R + 16 * wq, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pwgmma::mma_tile<bf16>(acc[i][0], a[i], bt);
          pwgmma::mma_tile<bf16>(acc[i][1], a[i], bt + 2);
          pwgmma::mma_tile<bf16>(acc[i][2], a[i], bs);
          pwgmma::mma_tile<bf16>(acc[i][3], a[i], bs + 2);
        }
      };
#pragma unroll
      for (int s = 0; s < 3 * R / 16; ++s)
        step(st + (s / 4) * tap_rows * X_ROW, X_ROW, (s % 4) * 16, s * 16);
      const unsigned char* c_st = st + 4 * TT * X_ROW;
#pragma unroll 5
      for (int s = 0; s < AP / 16; ++s) step(c_st, CS, s * 16, 3 * R + s * 16);

#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * wq + 8 * j + 2 * tq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ta[i][j][e] = tanh_fast(acc[i][j][e] + bias_s[col + (e & 1)]);
            sg[i][j][e] =
                sigmoid_fast(acc[i][2 + j][e] + bias_s[R + col + (e & 1)]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + 32 * wm + 16 * i + gq + 8 * h;
            if (t < T)
              *reinterpret_cast<uint32_t*>(g_out + (row0 + t) * R + col) =
                  pack_bf16(ta[i][j][2 * h] * sg[i][j][2 * h],
                            ta[i][j][2 * h + 1] * sg[i][j][2 * h + 1]);
          }
        }
      }
    }

    // 3. D_in = D sqrt(1/2) + the layer above's taps (D itself for the last
    // layer), written back in place; bf16(D_in sqrt(1/2)) to dres_s and to
    // global memory for the weight launch; its f32 column sums
    {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (tid >> 4) + 16 * i, t = t0 + r;
        float v[4] = {dv[i].x, dv[i].y, dv[i].z, dv[i].w};
        if (taps_in != nullptr) {
          const float a[4] = {tp[i][0].x, tp[i][0].y, tp[i][0].z, tp[i][0].w};
          const float bb[4] = {tp[i][1].x, tp[i][1].y, tp[i][1].z, tp[i][1].w};
          const float e[4] = {tp[i][2].x, tp[i][2].y, tp[i][2].z, tp[i][2].w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = v[j] * kSqrtHalf + a[j] + bb[j] + e[j];
          if (t < T) store4(D + (row0 + t) * R + cg, v);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] *= kSqrtHalf;
          s4[j] += v[j];
        }
        const uint2 packed = make_uint2(pack_bf16(v[0], v[1]),
                                        pack_bf16(v[2], v[3]));
        *reinterpret_cast<uint2*>(dres_s + r * X_ROW + cg * 2) = packed;
        if (t < T)
          *reinterpret_cast<uint2*>(dres_out + (row0 + t) * R + cg) = packed;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) s4[j] += __shfl_xor_sync(0xffffffffu, s4[j], 16);
      if (lane < 16) store4(sums_s + warp * R + cg, s4);
    }
    __syncthreads();

    // 4. dg = bf16(dso) . Wso^T (dskip's columns from the slot, the rest
    // from dres_s), then dz through the gate: bf16 to dz_s and to global
    // memory, f32 column sums
    {
      float dg[2][2][4] = {};
      const unsigned char* sk = st + 3 * TT * X_ROW;
#pragma unroll
      for (int kk = 0; kk < SR / 16; ++kk) {
        uint32_t a[2][4], bw[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a_frag(a[i], kk < S / 16 ? sk : dres_s, X_ROW, 32 * wm + 16 * i,
                 (kk % (S / 16)) * 16, lane);
        b_nk(bw, wso_s, kk * 16, 16 * wq, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pwgmma::mma_tile<bf16>(dg[i][0], a[i], bw);
          pwgmma::mma_tile<bf16>(dg[i][1], a[i], bw + 2);
        }
      }
      float sa[2][2] = {}, sb[2][2] = {};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * wq + 8 * j + 2 * tq;
          float da[4], db[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float a = ta[i][j][e], s = sg[i][j][e];
            da[e] = dg[i][j][e] * s * (1.f - a * a);
            db[e] = dg[i][j][e] * a * s * (1.f - s);
            sa[j][e & 1] += da[e];
            sb[j][e & 1] += db[e];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 32 * wm + 16 * i + gq + 8 * h, t = t0 + r;
            const uint32_t pa = pack_bf16(da[2 * h], da[2 * h + 1]);
            const uint32_t pb = pack_bf16(db[2 * h], db[2 * h + 1]);
            *reinterpret_cast<uint32_t*>(dz_s + r * Z_ROW + col * 2) = pa;
            *reinterpret_cast<uint32_t*>(dz_s + r * Z_ROW + (R + col) * 2) = pb;
            if (t < T) {
              *reinterpret_cast<uint32_t*>(dz_out + (row0 + t) * G + col) = pa;
              *reinterpret_cast<uint32_t*>(dz_out + (row0 + t) * G + R + col) =
                  pb;
            }
          }
        }
      // sum over the warp's 32 rows (the lanes of one tq), then lanes 0..3
      // hold the warp's column sums
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            sa[j][e] += __shfl_xor_sync(0xffffffffu, sa[j][e], m);
            sb[j][e] += __shfl_xor_sync(0xffffffffu, sb[j][e], m);
          }
      if (gq == 0) {
        float* out = sums_s + 8 * R + wm * G;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * wq + 8 * j + 2 * tq;
          store2(out + col, sa[j][0], sa[j][1]);
          store2(out + R + col, sb[j][0], sb[j][1]);
        }
      }
    }
    __syncthreads();

    // the tile's column sums into the block's, in a fixed order
    if (tid < G) {
      csum += sums_s[8 * R + tid] + sums_s[8 * R + G + tid];
    } else if (tid < G + R) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += sums_s[w * R + tid - G];
      csum += s;
    }

    // 5. [taps | dc] = bf16(dz) . [Wt; Wa]^T: tap products to the scratch,
    // dc in place
    {
      uint32_t az[2][G / 16][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int kk = 0; kk < G / 16; ++kk)
          a_frag(az[i][kk], dz_s, Z_ROW, 32 * wm + 16 * i, kk * 16, lane);
      for (int p = wq; p < KP / 16; p += 4) {
        const int m0 = 16 * p;
        const bool to_dc = m0 >= 3 * R;  // 3R is a multiple of 16
        // dc's running sums, fetched before the products
        float2 old[2][2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = t0 + 32 * wm + 16 * i + gq + 8 * h;
              const int m = m0 + 8 * j + 2 * tq;
              old[i][j][h] = make_float2(0.f, 0.f);
              if (to_dc && !first_launch && t < T && m < K)
                old[i][j][h] = *reinterpret_cast<const float2*>(
                    dc + (row0 + t) * A + (m - 3 * R));
            }
        float acc[2][2][4] = {};
#pragma unroll
        for (int kk = 0; kk < G / 16; ++kk) {
          uint32_t bw[4];
          b_nk(bw, w_s, kk * 16, m0, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            pwgmma::mma_tile<bf16>(acc[i][0], az[i][kk], bw);
            pwgmma::mma_tile<bf16>(acc[i][1], az[i][kk], bw + 2);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = t0 + 32 * wm + 16 * i + gq + 8 * h;
              const int m = m0 + 8 * j + 2 * tq;  // even, as are 3R and K
              if (t >= T || m >= K) continue;
              const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
              if (!to_dc)
                store2(taps_out + (row0 + t) * (3 * R) + m, v0, v1);
              else
                store2(dc + (row0 + t) * A + (m - 3 * R),
                       old[i][j][h].x + v0, old[i][j][h].y + v1);
            }
      }
    }
    slot ^= 1;
  }
  pwgpipe::cp_async_wait<0>();
  if (tid < G + R) colsum[(size_t)blockIdx.x * (G + R) + tid] = csum;
}

// bwd_weight_bf16_kernel: one 64 x 128 block of
// [xcat | c | g]^T . [bf16(dz) | bf16(dso)] over one slab of rows. tile
// 0..2: tap (tile - 1) d of xs against dz; tile 3..3+NC-1: 64 channels of c
// against dz; the last tile: g against [dskip | D_in sqrt(1/2)]. Chunks of
// 64 rows of both sides arrive through a four-slot cp.async ring, both
// stored row-major ([row][channel]) and read as fragments by
// ldmatrix.trans; warp (wm, wn) = (warp % 2, warp / 2) owns output rows
// 32 wm .. +31 and columns 32 wn .. +31. The bias gradients come from the
// data launch.
__global__ void __launch_bounds__(THREADS, 2) bwd_weight_bf16_kernel(
    const bf::bf16* __restrict__ xs, const bf::bf16* __restrict__ c,
    const bf::bf16* __restrict__ dz, const bf::bf16* __restrict__ g,
    const bf::bf16* __restrict__ dskip, const bf::bf16* __restrict__ dres,
    float* __restrict__ partial, int B, int T, int A, int d,
    int rows_per_slab) {
  using namespace bf;
  using pwgpipe::cp_async16;
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const bool g_tile = tile == n_tiles - 1;
  const bool c_tile = tile >= 3 && !g_tile;
  const long long N = (long long)B * T;
  const long long n_begin = (long long)blockIdx.x * rows_per_slab;
  const long long n_end = min(N, n_begin + rows_per_slab);
  const int n_chunks = n_end > n_begin
                           ? (int)((n_end - n_begin + WCH - 1) / WCH)
                           : 0;

  auto issue = [&](int ci) {
    unsigned char* lhs = ring + (ci % WSTAGES) * WSTAGE;
    unsigned char* rhs = lhs + WCH * X_ROW;
    const long long n0 = n_begin + (long long)ci * WCH;
    if (c_tile && A % 8 != 0) {  // c rows in 8-byte pieces
      for (int i = tid; i < WCH * 16; i += THREADS) {
        const int kk = i / 16, v = i % 16;
        const long long n = n0 + kk;
        const int ca = (tile - 3) * 64 + v * 4;
        const bool ok = n < n_end && ca < A;
        pwgpipe::cp_async8(lhs + kk * X_ROW + v * 8, ok ? c + n * A + ca : c,
                           ok);
      }
    } else {
      for (int i = tid; i < WCH * 8; i += THREADS) {
        const int kk = i / 8, ch = i % 8;
        const long long n = n0 + kk;
        const bf16* src = xs;
        bool ok = false;
        if (n < n_end) {
          if (tile < 3) {
            const long long b = n / T;
            const int t = (int)(n - b * T) + (tile - 1) * d;
            ok = t >= 0 && t < T;
            if (ok) src = xs + (b * T + t) * R + ch * 8;
          } else if (g_tile) {
            ok = true;
            src = g + n * R + ch * 8;
          } else {
            const int ca = (tile - 3) * 64 + ch * 8;
            ok = ca < A;
            if (ok) src = c + n * A + ca;
          }
        }
        cp_async16(lhs + kk * X_ROW + ch * 16, src, ok);
      }
    }
    for (int i = tid; i < WCH * 16; i += THREADS) {
      const int kk = i / 16, col = (i % 16) * 8;
      const long long n = n0 + kk;
      const bf16* src = !g_tile  ? dz + n * G + col
                        : col < S ? dskip + n * S + col
                                  : dres + n * R + (col - S);
      cp_async16(rhs + kk * Z_ROW + col * 2, n < n_end ? src : dz, n < n_end);
    }
  };

#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < n_chunks) issue(s);
    pwgpipe::cp_async_commit();
  }

  float acc[2][4][4] = {};
  for (int ci = 0; ci < n_chunks; ++ci) {
    pwgpipe::cp_async_wait<WSTAGES - 2>();
    __syncthreads();
    if (ci + WSTAGES - 1 < n_chunks) issue(ci + WSTAGES - 1);
    pwgpipe::cp_async_commit();
    const unsigned char* lhs = ring + (ci % WSTAGES) * WSTAGE;
    const unsigned char* rhs = lhs + WCH * X_ROW;
#pragma unroll
    for (int k0 = 0; k0 < WCH; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        pwgpipe::ldmatrix_x4_trans(
            a[i], lhs + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * X_ROW +
                      (32 * wm + 16 * i + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        pwgpipe::ldmatrix_x4_trans(
            b, rhs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Z_ROW +
                   (32 * wn + 16 * jp + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pwgmma::mma_tile<bf16>(acc[i][2 * jp], a[i], b);
          pwgmma::mma_tile<bf16>(acc[i][2 * jp + 1], a[i], b + 2);
        }
      }
    }
  }
  pwgpipe::cp_async_wait<0>();

  float* out = partial + ((size_t)blockIdx.x * n_tiles + tile) * 64 * 128;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 32 * wn + 8 * j + 2 * tq;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(out + (32 * wm + 16 * i + gq + 8 * h) * 128 + col,
               acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
}

cudaError_t run_backward_tf32(const float* xs, const float* c,
                              const float* w_tap, const float* b_tap,
                              const float* w_aux, const float* w_so_t,
                              const float* w_cat_t, const float* dskip,
                              float* D, float* taps0, float* taps1, float* dc,
                              float* dz, float* g, float* partial, float* dx,
                              const int* dilations, int L, int B, int T,
                              int A, int n_slabs, cudaStream_t stream) {
  const int M = 3 * R + A;
  const int n_tiles = 3 + (A + 63) / 64 + 1;
  const long long N = (long long)B * T;
  const int rows_per_slab =
      (int)(((N + n_slabs - 1) / n_slabs + KR - 1) / KR * KR);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_data_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::DATA_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_weight_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tc::WEIGHT_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 data_grid((T + TT - 1) / TT, B);
  const dim3 weight_grid(n_slabs, n_tiles);
  float* taps[2] = {taps0, taps1};
  for (int l = L - 1; l >= 0; --l) {
    const bool first = l == L - 1;
    const float* xl = xs + (size_t)l * B * T * R;
    const float* tin = first ? nullptr : taps[(l + 1) % 2];
    const int dp = first ? 0 : dilations[l + 1];
    bwd_data_tc_kernel<<<data_grid, THREADS, tc::DATA_SMEM, stream>>>(
        xl, c, w_tap + (size_t)l * 3 * R * G, b_tap + (size_t)l * G,
        w_aux + (size_t)l * A * G, w_so_t + (size_t)l * SR * R,
        w_cat_t + (size_t)l * G * M, dskip, D, tin, taps[l % 2], dc, dz, g, T,
        A, dilations[l], dp, first ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_weight_tc_kernel<<<weight_grid, THREADS, tc::WEIGHT_SMEM, stream>>>(
        xl, c, dz, g, dskip, D,
        partial + (size_t)l * n_slabs * n_tiles * 65 * 128, B, T, A,
        dilations[l], rows_per_slab);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long groups = N * (R / 4);
  bwd_finish_kernel<float><<<(unsigned)((groups + 255) / 256), 256, 0,
                             stream>>>(D, taps[0], dx, T, dilations[0],
                                       groups);
  return cudaGetLastError();
}

cudaError_t run_backward_bf16(const bf::bf16* xs, const bf::bf16* c,
                              const bf::bf16* w_tap, const bf::bf16* b_tap,
                              const bf::bf16* w_aux, const bf::bf16* w_so,
                              const bf::bf16* dskip, float* D, float* taps0,
                              float* taps1, float* dc, bf::bf16* dz,
                              bf::bf16* g, bf::bf16* dres, float* colsum,
                              float* partial, bf::bf16* dx,
                              const int* dilations, int L, int B, int T,
                              int A, int n_slabs, int blocks,
                              cudaStream_t stream) {
  const int n_tiles = 3 + (A + 63) / 64 + 1;
  const long long N = (long long)B * T;
  const int rows_per_slab =
      (int)(((N + n_slabs - 1) / n_slabs + bf::WCH - 1) / bf::WCH * bf::WCH);
  const size_t smem = bf::data_smem(A);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_data_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_weight_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bf::WEIGHT_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 weight_grid(n_slabs, n_tiles);
  float* taps[2] = {taps0, taps1};
  for (int l = L - 1; l >= 0; --l) {
    const bool first = l == L - 1;
    const bf::bf16* xl = xs + (size_t)l * B * T * R;
    const float* tin = first ? nullptr : taps[(l + 1) % 2];
    const int dp = first ? 0 : dilations[l + 1];
    bwd_data_bf16_kernel<<<blocks, THREADS, smem, stream>>>(
        xl, c, w_tap + (size_t)l * 3 * R * G, b_tap + (size_t)l * G,
        w_aux + (size_t)l * A * G, w_so + (size_t)l * R * SR, dskip, D, tin,
        taps[l % 2], dc, dz, g, dres, colsum + (size_t)l * blocks * (G + R), B,
        T, A, dilations[l], dp, first ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_weight_bf16_kernel<<<weight_grid, THREADS, bf::WEIGHT_SMEM, stream>>>(
        xl, c, dz, g, dskip, dres,
        partial + (size_t)l * n_slabs * n_tiles * 64 * 128, B, T, A,
        dilations[l], rows_per_slab);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long groups = N * (R / 4);
  bwd_finish_kernel<bf::bf16><<<(unsigned)((groups + 255) / 256), 256, 0,
                                stream>>>(D, taps[0], dx, T, dilations[0],
                                          groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Backward of L layers on `stream`; returns a cudaError_t (0 on success).
// The Python wrapper checks shapes, types and alignment, lays out the
// weights and allocates every buffer.
// dtype: 0 = float32, 1 = bfloat16 (xs, c, dx and every weight). body, as
// the wrapper's launch plan names it: 1 = the split-TF32 tensor-core body,
// the one float32 runs; 2 = the bf16 tensor-core body on `blocks`
// persistent blocks, the one bfloat16 runs; any other pair is refused. The
// rows of a weight-launch slab are ceil(B T / n_slabs) rounded up to 32
// (f32) or 64 (bf16).
// xs (L, B, T, 64) saved layer inputs; c (B, T, A); w_tap, b_tap, w_aux as
// in the forward; D (B, T, 64) f32, on entry the cotangent of x_out,
// overwritten; taps0, taps1 (B, T, 192) f32 scratch; dc (B, T, A) f32 out;
// dx (B, T, 64) out; dilations on the host.
// f32 body: w_so_t (L, 128, 64) = Wso transposed; w_cat_t (L, 128, 192+A)
// = [Wt; Wa] transposed; dskip (B, T, 64) f32; dz (B, T, 128) and g
// (B, T, 64) f32 scratch; partial (L, n_slabs, 3 + ceil(A/64) + 1, 65, 128)
// f32 out, to be summed over the slabs (row 64: the bias gradients).
// bf16 body: w_so (L, 64, 128) as the forward takes it; dskip (B, T, 64)
// bf16; dz (B, T, 128), g and dres (B, T, 64) bf16 scratch; colsum
// (L, blocks, 192) f32 out, the column sums of dz and D_in sqrt(1/2) by
// block, to be summed over the blocks; partial (L, n_slabs, 3 + ceil(A/64)
// + 1, 64, 128) f32 out. The other body's pointers may be null.
int pwg_wavenet_stack_backward(int dtype, int body, const void* xs,
                               const void* c, const void* w_tap,
                               const void* b_tap, const void* w_aux,
                               const void* w_so, const void* w_so_t,
                               const void* w_cat_t, const void* dskip,
                               void* D, void* taps0, void* taps1, void* dc,
                               void* dz, void* g, void* dres, void* colsum,
                               void* partial, void* dx, const int* dilations,
                               int L, int B, int T, int A, int n_slabs,
                               int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](void* p) { return static_cast<bf::bf16*>(p); };
  auto ch = [](const void* p) { return static_cast<const bf::bf16*>(p); };
  if (A % 4 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && body == 1)
    return (int)run_backward_tf32(
        cf(xs), cf(c), cf(w_tap), cf(b_tap), cf(w_aux), cf(w_so_t),
        cf(w_cat_t), cf(dskip), f(D), f(taps0), f(taps1), f(dc), f(dz), f(g),
        f(partial), f(dx), dilations, L, B, T, A, n_slabs, s);
  if (dtype == 1 && body == 2 && blocks >= 1)
    return (int)run_backward_bf16(
        ch(xs), ch(c), ch(w_tap), ch(b_tap), ch(w_aux), ch(w_so), ch(dskip),
        f(D), f(taps0), f(taps1), f(dc), h(dz), h(g), h(dres), f(colsum),
        f(partial), h(dx), dilations, L, B, T, A, n_slabs, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// shared memory of the bf16 body's data launch
size_t pwg_wavenet_stack_bwd_bf16_smem(int A) { return bf::data_smem(A); }

const char* pwg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
