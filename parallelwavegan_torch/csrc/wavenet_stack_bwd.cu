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
// Matmul inputs that the forward rounded to the matmul type (xs, c, g, the
// weights) enter rounded here too; every product accumulates in f32. The
// cotangents (dso, dz) stay f32 (the TPU kernel rounds them for its matrix
// unit), which is what autograd through the plain version computes up to
// its bf16 gradient casts.
//
// Design. The TPU kernel walks halo'd windows, keeps the running cotangent
// and two zero-edged tap scratches in VMEM across its sequential layer grid
// steps, overlap-adds dx and dc outside and writes one weight-gradient block
// per (window, layer). None of that fits 227 KB of shared memory or Hopper's
// unordered blocks. Here every layer is two launches over global scratch
// buffers that the wrapper allocates, last layer first:
//
//   data launch   grid (ceil(T/64), B), one 64-row tile per block: recompute
//     ta and sig from xs and c, then dg (K = 128) and [taps | dc] (K = 128,
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
//     accumulates 64 x 128 sums plus the 128 column sums (the bias
//     gradients) in registers, and writes one f32 partial. The wrapper adds
//     the slabs with one torch.sum: deterministic, unlike f32 atomicAdd.
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
//     data launch streams weights and activation columns through a
//     three-slot cp.async ring of 32-row chunks (pipeline.cuh) that runs
//     through its three products without draining; ta, sig, dg and dz
//     live in registers in the accumulators' layout (a warp owns the tanh
//     and sigmoid columns of the same channels). The weight launch streams
//     32-row chunks of both sides through a four-slot ring, one slab per
//     block, as many slabs as keep every block resident (one wave).
//   bfloat16: simt (bwd_data_kernel, bwd_weight_kernel). The same products
//     as register-blocked f32 FMAs on the CUDA cores, with the staging and
//     gate GEMM of wavenet_common.cuh and weights staged synchronously in
//     chunks of 16 rows.
//
// Bound (PWG v1 training batch 6 x 25,600 samples, 30 layers): per row and
// layer 3 (3R + A) G + 2 R (S + R) = 120,832 MAC = 241,664 FLOP (the gate
// product recomputed and transposed twice, the skip/out 1x1 only transposed
// twice), 1.11e12 FLOP in all: 16.6 ms at the f32 CUDA-core peak (67
// TFLOP/s), 6.75 ms for the split-TF32 body (three TF32 products each, 495
// / 3 TFLOP/s), 1.1 ms at the bf16 tensor-core peak. The bytes that must
// move (xs, c, the cotangents, dx, dc; about 1.4 GB) take 0.42 ms, but the
// two-launch design moves more: per row and layer in f32 the data launch
// 4,032 B (xs, c, D read and written, the three tap rows read, taps, dz and
// g written, dc read and written) and the weight launch 1,856 B (xs, c, g,
// dz, dskip, D), 27 GB in all, 8.1 ms at 3.35 TB/s. So for the f32 body the
// byte floor of this design binds before its operations; fusing the
// launches, keeping D and the taps on chip, is the next step.

#include <type_traits>

#include "mma_common.cuh"
#include "pipeline.cuh"
#include "wavenet_common.cuh"

namespace {

using namespace pwg;
using pwgmma::load_a_split;
using pwgmma::mma_tf32;
using pwgmma::mma_tiles;
using pwgmma::split_tf32;

constexpr int KR = 32;  // rows per chunk of the weight-gradient contraction

// bwd_data_kernel: activation tile (reused for dz), weight chunk, dso tile
__host__ __device__ constexpr size_t data_smem_floats(int A) {
  return (size_t)padded_k(A) * TT + (size_t)KC * G + (size_t)SR * TT;
}

// 4 rows x 4 columns: acc[r][j] += a[r] * w[j]
__device__ __forceinline__ void fma_tile4(float acc[4][4], const float4 a,
                                          const float4 w) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av[r], wv[j], acc[r][j]);
}

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

template <typename WT>
__global__ void __launch_bounds__(THREADS, 2) bwd_data_kernel(
    const WT* __restrict__ xs, const WT* __restrict__ c,
    const WT* __restrict__ w_tap, const WT* __restrict__ b_tap,
    const WT* __restrict__ w_aux,
    const WT* __restrict__ w_so_t,   // (SR, R): Wso transposed
    const WT* __restrict__ w_cat_t,  // (G, 3R + A): [Wt; Wa] transposed
    const float* __restrict__ dskip, float* __restrict__ D,
    const float* __restrict__ taps_in, float* __restrict__ taps_out,
    float* __restrict__ dc, float* __restrict__ dz_out,
    float* __restrict__ g_out, int T, int A, int d, int d_prev,
    int first_launch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* a_s = smem;                     // [KP][TT] activation tile
  float* dz_s = smem;                    // [G][TT], after the gate GEMM
  float* w_s = a_s + padded_k(A) * TT;   // [KC][128] weight chunk
  float* dso_s = w_s + KC * G;           // [SR][TT] dso, transposed

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const size_t row0 = (size_t)blockIdx.y * T;
  const int rg = tid / 16;
  const int cg = tid % 16;
  const int M = 3 * R + A;

  // 1. recompute the gate from the saved input
  stage_activations<WT>(a_s, xs, c, row0, t0, T, A, d, tid);

  // dso tile: [dskip | D_in * sqrt(1/2)], where D_in is formed on read and
  // written back in place for the weight-gradient launch and the next layer
  for (int i = tid; i < TT * (S / 4); i += THREADS) {
    const int ch = (i % (S / 4)) * 4;
    const int r = i / (S / 4);
    const int t = t0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < T) load4(dskip + (row0 + t) * S + ch, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) dso_s[(ch + j) * TT + r] = v[j];
  }
  for (int i = tid; i < TT * (R / 4); i += THREADS) {
    const int ch = (i % (R / 4)) * 4;
    const int r = i / (R / 4);
    const int t = t0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < T) {
      incoming_cotangent(v, D, taps_in, row0, t, T, ch, d_prev);
      if (taps_in != nullptr) store4(D + (row0 + t) * R + ch, v);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) dso_s[(S + ch + j) * TT + r] = v[j] * kSqrtHalf;
  }

  float acc[4][8];
  zero_tile(acc);
  gate_gemm<WT>(acc, a_s, w_s, w_tap, w_aux, A, tid, rg, cg);

  float ta[4][4], sig[4][4];
  {
    float bt[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bt[j] = to_f32(b_tap[cg * 4 + j]);
      bt[4 + j] = to_f32(b_tap[R + cg * 4 + j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ta[r][j] = tanhf(acc[r][j] + bt[j]);
        sig[r][j] = 1.f / (1.f + expf(-(acc[r][4 + j] + bt[4 + j])));
        gv[j] = round_to<WT>(ta[r][j] * sig[r][j]);
      }
      const int t = t0 + rg * 4 + r;
      if (t < T) store4(g_out + (row0 + t) * R + cg * 4, gv);
    }
  }

  // 2. dg = dso . Wso^T: 64 rows x 64 columns, 4 x 4 a thread, the columns
  // being the gate channels this thread holds ta and sig for
  float dg[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) dg[r][j] = 0.f;
  for (int k0 = 0; k0 < SR; k0 += KC) {
    __syncthreads();  // dso_s is staged / the previous chunk is consumed
    for (int i = tid; i < KC * R / 4; i += THREADS) {
      const int col = (i % (R / 4)) * 4;
      const int kk = i / (R / 4);
      float v[4];
      load4(w_so_t + (size_t)(k0 + kk) * R + col, v);
      store4(w_s + kk * R + col, v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          dso_s + (k0 + kk) * TT + rg * 4);
      const float4 w = *reinterpret_cast<const float4*>(w_s + kk * R + cg * 4);
      fma_tile4(dg, a, w);
    }
  }

  // 3. dz through the gate; to shared memory (over the activation tile,
  // which every thread has finished reading: the dg loop synchronised) and
  // to global memory for the weight-gradient launch
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float da[4], db[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      da[j] = dg[r][j] * sig[r][j] * (1.f - ta[r][j] * ta[r][j]);
      db[j] = dg[r][j] * ta[r][j] * sig[r][j] * (1.f - sig[r][j]);
      dz_s[(cg * 4 + j) * TT + rg * 4 + r] = da[j];
      dz_s[(R + cg * 4 + j) * TT + rg * 4 + r] = db[j];
    }
    const int t = t0 + rg * 4 + r;
    if (t < T) {
      store4(dz_out + (row0 + t) * G + cg * 4, da);
      store4(dz_out + (row0 + t) * G + R + cg * 4, db);
    }
  }

  // 4. [tap0 | tap1 | tap2 | dc] = dz . [Wt; Wa]^T in panels of 128 columns
  for (int m0 = 0; m0 < M; m0 += 128) {
    zero_tile(acc);
    for (int k0 = 0; k0 < G; k0 += KC) {
      __syncthreads();  // dz_s is complete / the previous chunk is consumed
      for (int i = tid; i < KC * 128 / 4; i += THREADS) {
        const int col = (i % 32) * 4;
        const int kk = i / 32;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (m0 + col < M) load4(w_cat_t + (size_t)(k0 + kk) * M + m0 + col, v);
        store4(w_s + kk * 128 + col, v);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(
            dz_s + (k0 + kk) * TT + rg * 4);
        const float4 w0 =
            *reinterpret_cast<const float4*>(w_s + kk * 128 + cg * 4);
        const float4 w1 =
            *reinterpret_cast<const float4*>(w_s + kk * 128 + 64 + cg * 4);
        fma_tile(acc, a, w0, w1);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + rg * 4 + r;
      if (t >= T) break;
      const size_t row = row0 + t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + h * 64 + cg * 4;  // 4 columns, never straddling 3R
        float v[4] = {acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                      acc[r][4 * h + 3]};
        if (m < 3 * R) {
          store4(taps_out + row * (3 * R) + m, v);
        } else if (m < M) {
          float* p = dc + row * A + (m - 3 * R);
          if (!first_launch) {
            float old[4];
            load4(p, old);
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] += old[j];
          }
          store4(p, v);
        }
      }
    }
  }
}

// One 64 x 128 block of [xcat | c | g]^T . [dz | dso] over one slab of rows.
// tile 0..2: tap (tile - 1) d of xs against dz; tile 3..3+NC-1: 64 channels
// of c against dz; the last tile: g against dso. Row 64 of the partial holds
// the column sums of the right-hand side (dbt from tile 0, dbso from the
// last tile).
template <typename WT>
__global__ void __launch_bounds__(THREADS) bwd_weight_kernel(
    const WT* __restrict__ xs, const WT* __restrict__ c,
    const float* __restrict__ dz, const float* __restrict__ g,
    const float* __restrict__ dskip, const float* __restrict__ D,
    float* __restrict__ partial, int B, int T, int A, int d,
    int rows_per_slab) {
  __shared__ float4 lhs4[KR * 64 / 4];
  __shared__ float4 rhs4[KR * 128 / 4];
  float* lhs_s = reinterpret_cast<float*>(lhs4);  // [KR][64]
  float* rhs_s = reinterpret_cast<float*>(rhs4);  // [KR][128]

  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int cg = tid % 16;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const bool g_tile = tile == n_tiles - 1;
  const long long N = (long long)B * T;
  const long long n_begin = (long long)blockIdx.x * rows_per_slab;
  const long long n_end = min(N, n_begin + rows_per_slab);

  float acc[4][8];
  zero_tile(acc);
  float colsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (long long n0 = n_begin; n0 < n_end; n0 += KR) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < KR * 16; i += THREADS) {
      const int ch = (i % 16) * 4;
      const int kk = i / 16;
      const long long n = n0 + kk;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (n < n_end) {
        if (tile < 3) {
          const long long b = n / T;
          const int t = (int)(n - b * T) + (tile - 1) * d;
          if (t >= 0 && t < T) load4(xs + (b * T + t) * R + ch, v);
        } else if (g_tile) {
          load4(g + n * R + ch, v);
        } else {
          const int ca = (tile - 3) * 64 + ch;
          if (ca < A) load4(c + n * A + ca, v);
        }
      }
      store4(lhs_s + kk * 64 + ch, v);
    }
    for (int i = tid; i < KR * 32; i += THREADS) {
      const int col = (i % 32) * 4;
      const int kk = i / 32;
      const long long n = n0 + kk;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (n < n_end) {
        if (!g_tile) {
          load4(dz + n * G + col, v);
        } else if (col < S) {
          load4(dskip + n * S + col, v);
        } else {
          load4(D + n * R + col - S, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] *= kSqrtHalf;
        }
      }
      store4(rhs_s + kk * 128 + col, v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KR; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(lhs_s + kk * 64 + rg * 4);
      const float4 w0 =
          *reinterpret_cast<const float4*>(rhs_s + kk * 128 + cg * 4);
      const float4 w1 =
          *reinterpret_cast<const float4*>(rhs_s + kk * 128 + 64 + cg * 4);
      fma_tile(acc, a, w0, w1);
      if (rg == 0) {
        colsum[0] += w0.x; colsum[1] += w0.y; colsum[2] += w0.z;
        colsum[3] += w0.w; colsum[4] += w1.x; colsum[5] += w1.y;
        colsum[6] += w1.z; colsum[7] += w1.w;
      }
    }
  }

  float* out = partial + ((size_t)blockIdx.x * n_tiles + tile) * 65 * 128;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    store4(out + (rg * 4 + r) * 128 + cg * 4, &acc[r][0]);
    store4(out + (rg * 4 + r) * 128 + 64 + cg * 4, &acc[r][4]);
  }
  if (rg == 0) {
    store4(out + 64 * 128 + cg * 4, &colsum[0]);
    store4(out + 64 * 128 + 64 + cg * 4, &colsum[4]);
  }
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
// dso (dskip | D_in sqrt(1/2), D_in formed on read as in the SIMT body) and
// then dz sit in one [64][128] tile beside the ring.
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
        mma_tiles<2, 4>(acc, a_hi, a_lo, st + kk * WB_LD + 16 * wq, WB_LD,
                        [](int j) { return (j >> 1) * R + 8 * (j & 1); },
                        gq, tq);
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
        mma_tiles<2, 2>(dg, a_hi, a_lo, st + kk * WS_LD + 16 * wq, WS_LD,
                        [](int j) { return 8 * j; }, gq, tq);
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
        mma_tiles<2, 4>(acc, a_hi, a_lo, st + kk * WB_LD + 32 * wq, WB_LD,
                        [](int j) { return 8 * j; }, gq, tq, n_valid);
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
// over one slab of rows, tiles as in bwd_weight_kernel. Chunks of 32 rows of
// both sides arrive through a four-slot cp.async ring; warp (wm, wn) =
// (warp % 2, warp / 2) owns output rows 32 wm .. +31 and columns 32 wn .. +31.
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
    if (sums && tid < G) {
#pragma unroll 8
      for (int kk = 0; kk < KR; ++kk) colsum += rhs[kk * RHS_LD + tid];
    }
#pragma unroll
    for (int kk = 0; kk < KR; kk += 8) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_at_split(a_hi[i], a_lo[i], lhs + kk * LHS_LD + 32 * wm + 16 * i,
                      LHS_LD, gq, tq);
      mma_tiles<2, 4>(acc, a_hi, a_lo, rhs + kk * RHS_LD + 32 * wn, RHS_LD,
                      [](int j) { return 8 * j; }, gq, tq);
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

template <typename WT>
cudaError_t run_backward(const void* xs_, const void* c_, const void* w_tap_,
                         const void* b_tap_, const void* w_aux_,
                         const void* w_so_t_, const void* w_cat_t_,
                         const float* dskip, float* D, float* taps0,
                         float* taps1, float* dc, float* dz, float* g,
                         float* partial, void* dx, const int* dilations,
                         int L, int B, int T, int A, int n_slabs,
                         cudaStream_t stream) {
  // float32 runs the tensor-core body, bfloat16 the SIMT body
  constexpr bool tensor_cores = std::is_same<WT, float>::value;
  const WT* xs = static_cast<const WT*>(xs_);
  const WT* c = static_cast<const WT*>(c_);
  const WT* w_tap = static_cast<const WT*>(w_tap_);
  const WT* b_tap = static_cast<const WT*>(b_tap_);
  const WT* w_aux = static_cast<const WT*>(w_aux_);
  const WT* w_so_t = static_cast<const WT*>(w_so_t_);
  const WT* w_cat_t = static_cast<const WT*>(w_cat_t_);
  const int M = 3 * R + A;
  const int n_tiles = 3 + (A + 63) / 64 + 1;
  const long long N = (long long)B * T;
  const int rows_per_slab =
      (int)(((N + n_slabs - 1) / n_slabs + KR - 1) / KR * KR);
  const size_t smem = data_smem_floats(A) * sizeof(float);
  cudaError_t err;
  if constexpr (tensor_cores) {
    err = cudaFuncSetAttribute(bwd_data_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tc::DATA_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_weight_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tc::WEIGHT_SMEM);
  } else {
    err = cudaFuncSetAttribute(bwd_data_kernel<WT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err != cudaSuccess) return err;
  const dim3 data_grid((T + TT - 1) / TT, B);
  const dim3 weight_grid(n_slabs, n_tiles);
  float* taps[2] = {taps0, taps1};
  for (int l = L - 1; l >= 0; --l) {
    const bool first = l == L - 1;
    const WT* xl = xs + (size_t)l * B * T * R;
    float* part = partial + (size_t)l * n_slabs * n_tiles * 65 * 128;
    const float* tin = first ? nullptr : taps[(l + 1) % 2];
    const int dp = first ? 0 : dilations[l + 1];
    const WT* wt = w_tap + (size_t)l * 3 * R * G;
    const WT* bt = b_tap + (size_t)l * G;
    const WT* wa = w_aux + (size_t)l * A * G;
    const WT* wso = w_so_t + (size_t)l * SR * R;
    const WT* wcat = w_cat_t + (size_t)l * G * M;
    if constexpr (tensor_cores) {
      bwd_data_tc_kernel<<<data_grid, THREADS, tc::DATA_SMEM, stream>>>(
          xl, c, wt, bt, wa, wso, wcat, dskip, D, tin, taps[l % 2], dc, dz, g,
          T, A, dilations[l], dp, first ? 1 : 0);
    } else {
      bwd_data_kernel<WT><<<data_grid, THREADS, smem, stream>>>(
          xl, c, wt, bt, wa, wso, wcat, dskip, D, tin, taps[l % 2], dc, dz, g,
          T, A, dilations[l], dp, first ? 1 : 0);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if constexpr (tensor_cores) {
      bwd_weight_tc_kernel<<<weight_grid, THREADS, tc::WEIGHT_SMEM, stream>>>(
          xl, c, dz, g, dskip, D, part, B, T, A, dilations[l], rows_per_slab);
    } else {
      bwd_weight_kernel<WT><<<weight_grid, THREADS, 0, stream>>>(
          xl, c, dz, g, dskip, D, part, B, T, A, dilations[l], rows_per_slab);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long groups = N * (R / 4);
  bwd_finish_kernel<WT><<<(unsigned)((groups + 255) / 256), 256, 0, stream>>>(
      D, taps[0], static_cast<WT*>(dx), T, dilations[0], groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Backward of L layers on `stream`; returns a cudaError_t (0 on success).
// The Python wrapper checks shapes, types and alignment, lays out the
// transposed weights and allocates every buffer.
// dtype: 0 = float32, 1 = bfloat16 (xs, c, dx and every weight). body, as
// the wrapper's launch plan names it: 1 = the split-TF32 tensor-core body,
// the one float32 runs, 0 = the SIMT body, the one bfloat16 runs; any other
// pair is refused. The rows of a weight-launch slab are ceil(B T /
// n_slabs) rounded up to 32.
// xs (L, B, T, 64) saved layer inputs; c (B, T, A); w_tap, b_tap, w_aux as in
// the forward; w_so_t (L, 128, 64) = Wso transposed; w_cat_t (L, 128, 192+A)
// = [Wt; Wa] transposed; dskip (B, T, 64) f32; D (B, T, 64) f32, on entry
// the cotangent of x_out, overwritten; taps0, taps1 (B, T, 192) f32, dz
// (B, T, 128) f32 and g (B, T, 64) f32 scratch; dc (B, T, A) f32 out;
// partial (L, n_slabs, 3 + ceil(A/64) + 1, 65, 128) f32 out, to be summed
// over the slabs; dx (B, T, 64) out; dilations on the host.
int pwg_wavenet_stack_backward(int dtype, const void* xs, const void* c,
                               const void* w_tap, const void* b_tap,
                               const void* w_aux, const void* w_so_t,
                               const void* w_cat_t, const void* dskip,
                               void* D, void* taps0, void* taps1, void* dc,
                               void* dz, void* g, void* partial, void* dx,
                               const int* dilations, int L, int B, int T,
                               int A, int n_slabs, int body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (body != (dtype == 0 ? 1 : 0) || A % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)run_backward<float>(
        xs, c, w_tap, b_tap, w_aux, w_so_t, w_cat_t,
        static_cast<const float*>(dskip), f(D), f(taps0), f(taps1), f(dc),
        f(dz), f(g), f(partial), dx, dilations, L, B, T, A, n_slabs, s);
  if (dtype == 1)
    return (int)run_backward<__nv_bfloat16>(
        xs, c, w_tap, b_tap, w_aux, w_so_t, w_cat_t,
        static_cast<const float*>(dskip), f(D), f(taps0), f(taps1), f(dc),
        f(dz), f(g), f(partial), dx, dilations, L, B, T, A, n_slabs, s);
  return (int)cudaErrorInvalidValue;
}

const char* pwg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
