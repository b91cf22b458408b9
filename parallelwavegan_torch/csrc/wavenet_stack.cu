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
// Bound (PWG v1 serving: batch 32 x 131072 samples, 30 layers, bf16):
// 86,016 FLOP per sample and layer, 1.08e13 FLOP in all, 10.9 ms at the
// bf16 tensor-core peak. A per-layer launch must move about 1,184 B per
// sample: x in and out in f32 (256 + 256), skip read and written in f32
// (512), c in bf16 (160); 4.97 GB a layer, 44.5 ms for 30 layers at
// 3.35 TB/s. So on this card the bytes bind a per-layer launch, about 4 x
// above the operations.
//
// bf16: the tensor-core body (wavenet_layer_tc_kernel). Per layer:
//   - persistent blocks (as many as fit the card; the wrapper sizes the
//     grid) load the layer's weights [Wt; Wa; Ws|Wo] (86 KB of bf16) into
//     shared memory once, swizzled, and keep them while they walk time
//     tiles of TT = 64 rows; the per-tile weight stream of the SIMT body
//     (about 5.6 GB of L2 reads a layer) is gone;
//   - the next tile's x rows and c(t) arrive by cp.async into a ring of two
//     slots (pipeline.cuh) while the warps multiply this one, with masks at
//     0 and T: for d < 64 one window t0 - d .. t0 + 63 + d serves all
//     three taps, else each tap has its own 64 rows; x comes as it is
//     stored (f32 residual, or bf16 x in the first layer) and f32 rows are
//     rounded to bf16 as their fragments load;
//   - 8 warps, two for each 16 rows: z = A . [Wt; Wa] on mma.sync m16n8k16
//     bf16 -> f32 (mma_common.cuh), B fragments by ldmatrix.trans. A warp
//     takes n-tiles j and j + 8 (columns c and 64 + c) for its half of the
//     channels, so tanh and sigmoid meet in the same lane and the gate
//     forms in registers (on the special-function unit); the bf16 pairs of
//     two n-tiles are exactly the A fragment of one k-step of so = g .
//     [Ws | Wo], so a warp's own half of g goes from registers straight into
//     that product and the other half (8 KB a tile) comes from its partner
//     through shared memory. Two warps per 16 rows rather than one give
//     each scheduler a second warp to hide fragment loads and the gate
//     behind (one block of 228 KB fits an SM);
//   - the epilogue: one warp of a pair adds skip in place (f32, fetched
//     before the products), the other adds the residual from the staged
//     centre rows and writes x and xs.
//   What still binds it is measured by tools/wavenet_stack_ablation.py
//   (variants without the transcendentals, without the ring's loads,
//   without the epilogue's traffic) and written in PERF.md. Fusing layers
//   to keep x and skip on chip would evict the resident weights (86 KB a
//   layer).
// f32: the SIMT body (wavenet_layer_kernel), the training forward and the
// parity path, whose 1e-4 tolerance TF32 products would break: a block per
// 64-row tile stages the activation tile transposed into shared memory
// (272 x 64 f32), z as a register-blocked SIMT GEMM (4 rows x 8 columns a
// thread, the gate in registers), the weights streaming through shared
// memory in chunks of 16 rows; g through shared memory into the skip|out
// GEMM. It is bound by f32 FMAs (67 TFLOP/s peak). Staging, the gate GEMM
// and the typed loads are shared with the backward kernel through
// wavenet_common.cuh.

#include "mma_common.cuh"
#include "pipeline.cuh"
#include "wavenet_common.cuh"

namespace {

using namespace pwg;

__host__ __device__ constexpr size_t smem_floats(int A) {
  return (size_t)padded_k(A) * TT + (size_t)KC * G + (size_t)R * TT;
}

// WT: weight / matmul type; XIN, XOUT: types of the residual read and written
template <typename WT, typename XIN, typename XOUT>
__global__ void __launch_bounds__(THREADS, 2) wavenet_layer_kernel(
    const XIN* __restrict__ x_in, const WT* __restrict__ c,
    const WT* __restrict__ w_tap, const WT* __restrict__ b_tap,
    const WT* __restrict__ w_aux, const WT* __restrict__ w_so,
    const WT* __restrict__ b_so, XOUT* __restrict__ x_out,
    float* __restrict__ skip, WT* __restrict__ xs, int T, int A, int d,
    int first_layer) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* a_s = smem;                     // [KP][TT] activation tile, transposed
  float* w_s = a_s + padded_k(A) * TT;   // [KC][G] weight chunk
  float* g_s = w_s + KC * G;             // [R][TT] gate output, transposed

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const size_t row0 = (size_t)blockIdx.y * T;  // first row of this item

  // 1. activation tile [x(t-d) | x(t) | x(t+d) | c(t)]
  stage_activations<WT>(a_s, x_in, c, row0, t0, T, A, d, tid);

  // thread tile: rows rg*4..rg*4+3; columns cg*4..+3 and R + cg*4..+3
  const int rg = tid / 16;
  const int cg = tid % 16;
  float acc[4][8];
  zero_tile(acc);

  // 2. z = [taps | c] . [Wt; Wa]
  gate_gemm<WT>(acc, a_s, w_s, w_tap, w_aux, A, tid, rg, cg);

  // gate, in registers: columns j (tanh half) and R + j (sigmoid half)
  float bt[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bt[j] = to_f32(b_tap[cg * 4 + j]);
    bt[4 + j] = to_f32(b_tap[R + cg * 4 + j]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float za = acc[r][j] + bt[j];
      const float zb = acc[r][4 + j] + bt[4 + j];
      const float gv = tanhf(za) * (1.f / (1.f + expf(-zb)));
      g_s[(cg * 4 + j) * TT + rg * 4 + r] = round_to<WT>(gv);
    }

  // 3. so = g . [Ws | Wo]
  zero_tile(acc);
  for (int k0 = 0; k0 < R; k0 += KC) {
    __syncthreads();  // g_s is complete / the previous chunk is consumed
    for (int i = tid; i < KC * SR / 4; i += THREADS) {
      const int col = (i % (SR / 4)) * 4;
      const int k = k0 + i / (SR / 4);
      float v[4];
      load4(w_so + (size_t)k * SR + col, v);
      store4(w_s + (i / (SR / 4)) * SR + col, v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          g_s + (k0 + kk) * TT + rg * 4);
      const float4 w0 =
          *reinterpret_cast<const float4*>(w_s + kk * SR + cg * 4);
      const float4 w1 =
          *reinterpret_cast<const float4*>(w_s + kk * SR + S + cg * 4);
      fma_tile(acc, a, w0, w1);
    }
  }

  float bs[4], bo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bs[j] = to_f32(b_so[cg * 4 + j]);
    bo[j] = to_f32(b_so[S + cg * 4 + j]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + rg * 4 + r;
    if (t >= T) break;
    const size_t row = row0 + t;
    float xo[4], sv[4], xn[4];
    load4(x_in + row * R + cg * 4, xo);
    // the layer's input as its tap GEMM consumed it (rounded to WT)
    if (xs != nullptr) store4(xs + row * R + cg * 4, xo);
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

// ---------------------------------------------------------------------------
// bf16: the layer body on tensor cores.

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 256;  // 2 warps for each 16 time rows of a tile
constexpr int TC_STAGES = 2;     // ring of activation tiles
constexpr int W_ROW = G * 2;     // bytes of one [k][n] bf16 weight row
constexpr int G_ROW = R * 2;     // bytes of one row of g (bf16)

// aux channels padded to the mma depth
__host__ __device__ constexpr int padded_aux(int A) { return (A + 15) / 16 * 16; }

// bytes of one staged x row: 64 channels plus a pad that spreads the rows a
// fragment load touches over distinct banks (odd 16-byte chunks for bf16's
// ldmatrix; 72 words for f32's 8-byte loads)
template <typename XIN>
__host__ __device__ constexpr int x_row_bytes() {
  return sizeof(XIN) == 4 ? R * 4 + 32 : R * 2 + 16;
}
__host__ __device__ constexpr int c_row_bytes(int A) { return padded_aux(A) * 2 + 16; }

// shared memory: resident weights [3R + AP + R][G] bf16, biases f32, the
// gate g [TT][R] bf16, and TC_STAGES x (three x windows + one c window);
// mirrored by
// stack_launch_plan() in ops/cuda/wavenet_stack.py
template <typename XIN>
__host__ __device__ constexpr size_t tc_stage_bytes(int A) {
  return (size_t)3 * TT * x_row_bytes<XIN>() + (size_t)TT * c_row_bytes(A);
}
template <typename XIN>
__host__ __device__ constexpr size_t tc_smem_bytes(int A) {
  return (size_t)(3 * R + padded_aux(A) + R) * W_ROW + 2 * G * sizeof(float) +
         TT * G_ROW + TC_STAGES * tc_stage_bytes<XIN>(A);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (rows m0..m0+15, channels ch0..ch0+15) of a staged x window:
// bf16 rows through ldmatrix, f32 rows as 8-byte loads rounded to bf16
template <typename XIN>
__device__ __forceinline__ void x_fragment(uint32_t a[4],
                                           const unsigned char* win, int m0,
                                           int ch0, int lane) {
  constexpr int XS = x_row_bytes<XIN>();
  if constexpr (sizeof(XIN) == 2) {
    pwgpipe::ldmatrix_x4(a, win + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                                ch0 * 2 + (lane >> 4) * 16);
  } else {
    const int g = lane >> 2, t = lane & 3;
    const unsigned char* p = win + (m0 + g) * XS + (ch0 + 2 * t) * 4;
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * XS);
    const float2 v2 = *reinterpret_cast<const float2*>(p + 32);
    const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * XS + 32);
    a[0] = pack_bf16(v0.x, v0.y);
    a[1] = pack_bf16(v1.x, v1.y);
    a[2] = pack_bf16(v2.x, v2.y);
    a[3] = pack_bf16(v3.x, v3.y);
  }
}

// acc[2 i + (0, 1)] += a (16 rows x 16 k) . W[k0:k0+16][n-tiles 2 np_i,
// 2 np_i + 1] for the four n-tile pairs np_i = NP[i], the weight rows
// resident and swizzled in w_s. Row k0 + (lane & 7) (+ 8) keeps the swizzle
// key lane & 7 whatever k0, so the chunk offsets are fixed per lane.
__device__ __forceinline__ void mma_panel(float acc[8][4], const uint32_t a[4],
                                          const unsigned char* w_s, int k0,
                                          const int np[4], int lane) {
  const unsigned char* row =
      w_s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * W_ROW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t b[4];
    pwgpipe::ldmatrix_x4_trans(
        b, row + (((2 * np[i] + (lane >> 4)) ^ (lane & 7)) << 4));
    pwgmma::mma_tile<bf16>(acc[2 * i], a, b);
    pwgmma::mma_tile<bf16>(acc[2 * i + 1], a, b + 2);
  }
}

// tanh(za) sigmoid(zb) as 1 - 2 / (1 + e^(2 za)) and 1 / (1 + e^(-zb)) on
// the special-function unit (relative error near 1e-6, far below the bf16
// rounding of g that follows; both ends saturate to +-1 and 0 exactly)
__device__ __forceinline__ float gate(float za, float zb) {
  const float th = 1.f - __fdividef(2.f, 1.f + __expf(2.f * za));
  return th * __fdividef(1.f, 1.f + __expf(-zb));
}

__device__ __forceinline__ void zero8(float acc[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// One layer over persistent blocks. Each block loads the layer's weights
// into shared memory once and walks time tiles tile = blockIdx.x,
// + gridDim.x, ... (B * ceil(T / TT) of them); the next tile's activations
// arrive by cp.async while the warps work on this one. Warps w and w + 4
// share rows 16 (w % 4) .. + 15 of the tile; half h = w / 4 owns gate
// channels 32 h .. 32 h + 31 (tanh n-tiles 4h .. 4h + 3, sigmoid n-tiles
// 8 + 4h .. 8 + 4h + 3) and then output n-tiles 8h .. 8h + 7 (skip for
// h = 0, out for h = 1).
template <typename XIN, typename XOUT>
__global__ void __launch_bounds__(TC_THREADS, 1) wavenet_layer_tc_kernel(
    const XIN* __restrict__ x_in, const bf16* __restrict__ c,
    const bf16* __restrict__ w_tap, const bf16* __restrict__ b_tap,
    const bf16* __restrict__ w_aux, const bf16* __restrict__ w_so,
    const bf16* __restrict__ b_so, XOUT* __restrict__ x_out,
    float* __restrict__ skip, bf16* __restrict__ xs, int B, int T, int A,
    int d, int first_layer) {
  constexpr int XS = x_row_bytes<XIN>();
  const int AP = padded_aux(A);
  const int CS = c_row_bytes(A);
  const int KW = 3 * R + AP;  // first row of [Ws | Wo] in w_s
  extern __shared__ float4 smem4[];
  unsigned char* w_s = reinterpret_cast<unsigned char*>(smem4);
  float* bias_s = reinterpret_cast<float*>(w_s + (size_t)(KW + R) * W_ROW);
  unsigned char* g_s = reinterpret_cast<unsigned char*>(bias_s + 2 * G);
  unsigned char* ring = g_s + TT * G_ROW;
  const size_t stage_bytes = tc_stage_bytes<XIN>(A);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int half = warp >> 2, m0 = (warp & 3) * 16;
  const int per_item = (T + TT - 1) / TT;
  const int tiles = B * per_item;
  // n-tile pairs of this half in the gate product and in the second one
  const int np_gate[4] = {2 * half, 2 * half + 1, 4 + 2 * half, 5 + 2 * half};
  const int np_out[4] = {4 * half, 4 * half + 1, 4 * half + 2, 4 * half + 3};

  // the layer's weights, once: rows [Wt (3R); Wa (A); zeros (AP - A); Ws|Wo
  // (R)] of 128 bf16, 16-byte chunks swizzled
  for (int i = tid; i < (KW + R) * (W_ROW / 16); i += TC_THREADS) {
    const int k = i / (W_ROW / 16), ch = i % (W_ROW / 16);
    const bf16* src = w_tap;
    bool ok = true;
    if (k < 3 * R) src = w_tap + (size_t)k * G;
    else if (k < 3 * R + A) src = w_aux + (size_t)(k - 3 * R) * G;
    else if (k < KW) ok = false;
    else src = w_so + (size_t)(k - KW) * SR;
    pwgpipe::cp_async16(w_s + pwgpipe::swizzle(k, ch, W_ROW),
                        ok ? src + ch * 8 : w_tap, ok);
  }
  for (int i = tid; i < 2 * G; i += TC_THREADS)
    bias_s[i] = __bfloat162float(i < G ? b_tap[i] : b_so[i - G]);

  // stage tile `tile` into ring slot `slot`: the rows of x the three taps
  // read and c(t), rows outside [0, T) as zeros; one commit group per call.
  // For d < TT the taps overlap and one window of rows t0 - d .. t0 + TT +
  // d - 1 serves all three (tap k starts at window row k d); otherwise each
  // tap has its own TT rows (tap k starts at row k TT).
  const bool halo = d < TT;
  const int x_rows = halo ? TT + 2 * d : 3 * TT;
  auto fill = [&](int tile, int slot) {
    if (tile < tiles) {
      unsigned char* st = ring + slot * stage_bytes;
      const int b = tile / per_item, t0 = (tile % per_item) * TT;
      const size_t row0 = (size_t)b * T;
      // chunks of one x row; a thread keeps its chunk and steps over rows
      constexpr int XC = R * (int)sizeof(XIN) / 16;
      static_assert(TC_THREADS % XC == 0, "a thread's chunk is fixed");
      const int ch = tid % XC;
      for (int q = tid / XC; q < x_rows; q += TC_THREADS / XC) {
        const int t = halo ? t0 - d + q : t0 + q % TT + (q / TT - 1) * d;
        const bool ok = t >= 0 && t < T;
        pwgpipe::cp_async16(
            st + q * XS + ch * 16,
            ok ? reinterpret_cast<const unsigned char*>(x_in + (row0 + t) * R) +
                     ch * 16
               : reinterpret_cast<const unsigned char*>(x_in),
            ok);
      }
      unsigned char* c_st = st + 3 * TT * XS;
      if (A % 8 == 0) {  // rows of whole 16-byte pieces
        const int CC = AP / 8;
        for (int i = tid; i < TT * CC; i += TC_THREADS) {
          const int v = i % CC, r = i / CC;
          const bool ok = t0 + r < T && v < A / 8;
          pwgpipe::cp_async16(c_st + r * CS + v * 16,
                              ok ? c + (row0 + t0 + r) * A + v * 8 : c, ok);
        }
      } else {  // 8-byte pieces (A is a multiple of 4)
        const int CC = AP / 4;
        for (int i = tid; i < TT * CC; i += TC_THREADS) {
          const int v = i % CC, r = i / CC;
          const bool ok = t0 + r < T && v < A / 4;
          pwgpipe::cp_async8(c_st + r * CS + v * 8,
                             ok ? c + (row0 + t0 + r) * A + v * 4 : c, ok);
        }
      }
    }
    pwgpipe::cp_async_commit();
  };

  fill(blockIdx.x, 0);  // with the weights: one group
  int slot = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    fill(tile + gridDim.x, slot ^ 1);
    pwgpipe::cp_async_wait<1>();  // this tile (and the weights) landed
    __syncthreads();
    const unsigned char* st = ring + slot * stage_bytes;
    const int b = tile / per_item, t0 = (tile % per_item) * TT;
    const size_t row0 = (size_t)b * T;

    // the skip rows half 0 adds to, fetched before the products
    float2 sk[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + m0 + g + 8 * h;
        sk[j][h] = make_float2(0.f, 0.f);
        if (half == 0 && !first_layer && t < T)
          sk[j][h] = *reinterpret_cast<const float2*>(
              skip + (row0 + t) * S + 8 * j + 2 * t4);
      }

    // z = [x(t-d) | x(t) | x(t+d)] . Wt + c . Wa on this half's columns:
    // acc[q] for q < 4 is tanh n-tile 4h + q, acc[q + 4] its sigmoid partner
    float acc[8][4];
    zero8(acc);
    const int tap_rows = halo ? d : TT;  // window rows between taps
#pragma unroll
    for (int s = 0; s < 12; ++s) {
      uint32_t a[4];
      x_fragment<XIN>(a, st + (s / 4) * tap_rows * XS, m0, (s % 4) * 16, lane);
      mma_panel(acc, a, w_s, s * 16, np_gate, lane);
    }
    const unsigned char* c_st = st + 3 * TT * XS;
#pragma unroll 5
    for (int s = 0; s < AP / 16; ++s) {
      uint32_t a[4];
      pwgpipe::ldmatrix_x4(a, c_st + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * CS +
                                  s * 32 + (lane >> 4) * 16);
      mma_panel(acc, a, w_s, 3 * R + s * 16, np_gate, lane);
    }

    // gate in registers: the same lane holds z[:, c] and z[:, R + c]; the
    // bf16 pairs of n-tiles 2kk, 2kk+1 are the A fragment of k-step kk of
    // the next product. This half's two k-steps stay in registers and go to
    // g_s for the other half, whose two it reads back.
    uint32_t ga[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * half + 8 * q + 2 * t4 + (e & 1);
        const float za = acc[q][e] + bias_s[col];
        const float zb = acc[q + 4][e] + bias_s[R + col];
        gv[e] = gate(za, zb);
      }
      ga[q / 2][(q & 1) * 2] = pack_bf16(gv[0], gv[1]);
      ga[q / 2][(q & 1) * 2 + 1] = pack_bf16(gv[2], gv[3]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            g_s + pwgpipe::swizzle(m0 + g + 8 * h, 4 * half + q, G_ROW) +
            4 * t4) = ga[q / 2][(q & 1) * 2 + h];
    }
    // the two warps of these rows meet (named barrier 1 + w % 4, 64 threads)
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (warp & 3)) : "memory");

    // so = g . [Ws | Wo] on this half's output n-tiles
    zero8(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      if (kk / 2 == half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = ga[kk & 1][e];
      } else {
        pwgpipe::ldmatrix_x4(
            a, g_s + pwgpipe::swizzle(m0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                      2 * kk + (lane >> 4), G_ROW));
      }
      mma_panel(acc, a, w_s, KW + kk * 16, np_out, lane);
    }

    // half 0: skip += so[:, :S] + bs. half 1: x = (so[:, S:] + bo + x)
    // sqrt(1/2), x read from the staged centre window, and xs gets the
    // input as the taps saw it
    const unsigned char* centre = st + tap_rows * XS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h, t = t0 + r;
        if (t >= T) continue;
        const int ch = 8 * j + 2 * t4;
        const size_t row = row0 + t;
        if (half == 0) {
          const float s0 = acc[j][2 * h] + bias_s[G + ch];
          const float s1 = acc[j][2 * h + 1] + bias_s[G + ch + 1];
          *reinterpret_cast<float2*>(skip + row * S + ch) =
              first_layer ? make_float2(s0, s1)
                          : make_float2(sk[j][h].x + s0, sk[j][h].y + s1);
          continue;
        }
        float2 xo;
        if constexpr (sizeof(XIN) == 2) {
          xo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              centre + r * XS + ch * 2));
        } else {
          xo = *reinterpret_cast<const float2*>(centre + r * XS + ch * 4);
        }
        if (xs != nullptr)
          *reinterpret_cast<uint32_t*>(xs + row * R + ch) = pack_bf16(xo.x, xo.y);
        const float x0 =
            (acc[j][2 * h] + bias_s[G + S + ch] + xo.x) * kSqrtHalf;
        const float x1 =
            (acc[j][2 * h + 1] + bias_s[G + S + ch + 1] + xo.y) * kSqrtHalf;
        if constexpr (sizeof(XOUT) == 2) {
          *reinterpret_cast<uint32_t*>(x_out + row * R + ch) = pack_bf16(x0, x1);
        } else {
          *reinterpret_cast<float2*>(x_out + row * R + ch) = make_float2(x0, x1);
        }
      }
    __syncthreads();  // the slot and g_s may be refilled by the next tile
    slot ^= 1;
  }
  pwgpipe::cp_async_wait<0>();
}

template <typename XIN, typename XOUT>
cudaError_t launch_layer_tc(const void* x_in, const bf16* c, const bf16* w_tap,
                            const bf16* b_tap, const bf16* w_aux,
                            const bf16* w_so, const bf16* b_so, void* x_out,
                            float* skip, bf16* xs, int B, int T, int A, int d,
                            int first, int blocks, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<XIN>(A);
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_layer_tc_kernel<XIN, XOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wavenet_layer_tc_kernel<XIN, XOUT><<<blocks, TC_THREADS, smem, stream>>>(
      static_cast<const XIN*>(x_in), c, w_tap, b_tap, w_aux, w_so, b_so,
      static_cast<XOUT*>(x_out), skip, xs, B, T, A, d, first);
  return cudaGetLastError();
}

cudaError_t run_stack_tc(const void* x, const void* c_, const void* w_tap_,
                         const void* b_tap_, const void* w_aux_,
                         const void* w_so_, const void* b_so_,
                         const int* dilations, int L, int B, int T, int A,
                         void* x_out, float* skip, void* buf0, void* buf1,
                         void* xs_, int blocks, cudaStream_t stream) {
  const bf16* c = static_cast<const bf16*>(c_);
  const bf16* w_tap = static_cast<const bf16*>(w_tap_);
  const bf16* b_tap = static_cast<const bf16*>(b_tap_);
  const bf16* w_aux = static_cast<const bf16*>(w_aux_);
  const bf16* w_so = static_cast<const bf16*>(w_so_);
  const bf16* b_so = static_cast<const bf16*>(b_so_);
  bf16* xs = static_cast<bf16*>(xs_);
  for (int l = 0; l < L; ++l) {
    const void* src = l == 0 ? x : (l % 2 == 1 ? buf0 : buf1);
    void* dst = l == L - 1 ? x_out : (l % 2 == 0 ? buf0 : buf1);
    const bf16* wt = w_tap + (size_t)l * 3 * R * G;
    const bf16* bt = b_tap + (size_t)l * G;
    const bf16* wa = w_aux + (size_t)l * A * G;
    const bf16* ws = w_so + (size_t)l * R * SR;
    const bf16* bs = b_so + (size_t)l * SR;
    bf16* xl = xs == nullptr ? nullptr : xs + (size_t)l * B * T * R;
    const int d = dilations[l];
    const bool first = l == 0, last = l == L - 1;
    cudaError_t err;
    if (first && last)
      err = launch_layer_tc<bf16, bf16>(src, c, wt, bt, wa, ws, bs, dst, skip,
                                        xl, B, T, A, d, 1, blocks, stream);
    else if (first)
      err = launch_layer_tc<bf16, float>(src, c, wt, bt, wa, ws, bs, dst, skip,
                                         xl, B, T, A, d, 1, blocks, stream);
    else if (last)
      err = launch_layer_tc<float, bf16>(src, c, wt, bt, wa, ws, bs, dst, skip,
                                         xl, B, T, A, d, 0, blocks, stream);
    else
      err = launch_layer_tc<float, float>(src, c, wt, bt, wa, ws, bs, dst,
                                          skip, xl, B, T, A, d, 0, blocks,
                                          stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// f32 all through: x, the residual and x_out are float, so every layer runs
// the one instantiation over the ping-pong buffers
cudaError_t run_stack_simt(const void* x, const void* c, const void* w_tap_,
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
  const auto kernel = wavenet_layer_kernel<float, float, float>;
  const size_t smem = smem_floats(A) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TT - 1) / TT, B);
  for (int l = 0; l < L; ++l) {
    // layer l reads what layer l-1 wrote: x, then buf0, buf1, buf0, ...
    const void* src = l == 0 ? x : (l % 2 == 1 ? buf0 : buf1);
    void* dst = l == L - 1 ? x_out : (l % 2 == 0 ? buf0 : buf1);
    kernel<<<grid, THREADS, smem, stream>>>(
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
// dtype: 0 = float32 (SIMT layer body, one block per 64-row tile),
// 1 = bfloat16 (tensor-core layer body, `blocks` persistent blocks) for x,
// c, x_out, xs and every weight.
// x, x_out (B, T, 64); c (B, T, A); skip (B, T, 64) f32; buf0, buf1
// (B, T, 64) f32 scratch (buf0 needed for L >= 2, buf1 for L >= 3);
// xs (L, B, T, 64) receives every layer's input, or is null;
// weights as fuse_wavenet_stack_params lays them out; dilations on the host.
int pwg_wavenet_stack_forward(int dtype, const void* x, const void* c,
                              const void* w_tap, const void* b_tap,
                              const void* w_aux, const void* w_so,
                              const void* b_so, const int* dilations, int L,
                              int B, int T, int A, void* x_out, void* skip,
                              void* buf0, void* buf1, void* xs, int blocks,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sk = static_cast<float*>(skip);
  if (dtype == 0)
    return (int)run_stack_simt(x, c, w_tap, b_tap, w_aux, w_so, b_so,
                               dilations, L, B, T, A, x_out, sk, buf0, buf1,
                               xs, s);
  if (dtype == 1 && blocks >= 1)
    return (int)run_stack_tc(x, c, w_tap, b_tap, w_aux, w_so, b_so, dilations,
                             L, B, T, A, x_out, sk, buf0, buf1, xs, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// shared memory of one tensor-core layer launch, by the type of the x it
// reads (0 = float32, 1 = bfloat16)
size_t pwg_wavenet_stack_tc_smem(int x_is_bf16, int A) {
  return x_is_bf16 ? tc_smem_bytes<bf16>(A) : tc_smem_bytes<float>(A);
}

const char* pwg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
