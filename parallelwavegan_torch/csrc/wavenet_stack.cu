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
// bf16: the tensor-core body (wavenet_layer_tc_kernel). Per layer:
//   - persistent blocks (as many as fit the card; the wrapper sizes the
//     grid) load the layer's weights [Wt; Wa; Ws|Wo] (86 KB of bf16) into
//     shared memory once, swizzled, and keep them while they walk time
//     tiles of TT = 64 rows, instead of streaming them for every tile
//     (about 5.6 GB of L2 reads a layer at the serving shape);
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

namespace {

using namespace pwg;

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
  return x_is_bf16 ? tc_smem_bytes<bf16>(A) : tc_smem_bytes<float>(A);
}

// shared memory of one split-TF32 layer launch
size_t pwg_wavenet_stack_tf32_smem() { return tf32::SMEM; }

const char* pwg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
