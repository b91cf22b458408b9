// The bf16 tensor-core layer body of the fused WaveNet stack for Hopper
// (sm_90a), shared by wavenet_stack.cu (the serving and training forward)
// and wavenet_variant.cu (the gate experiment). One launch runs one layer
// with dilation d over persistent blocks; per time row t:
//
//   z    = [x(t-d) | x(t) | x(t+d)] . Wt + c(t) . Wa + bt        (G = 128)
//   g    = gate(z[:R], z[R:])                                    (R = 64)
//   skip += g . Ws + bs                                          (S = 64, f32)
//   x    = (g . Wo + bo + x) * sqrt(1/2)                         (f32 state)
//
// with rows outside [0, T) read as zeros. Template knobs:
//   GATE   kSigmoidGate  tanh(a) sigmoid(b)            (wavenet_stack.cu)
//          kTanhGate     tanh(a) (1 + tanh(b)) / 2, the 0.5 of the sigmoid
//                        already folded into b's weights (the variant)
//          kProductGate  a b: no transcendentals (a timing bound)
//   BT     the biases' type: bf16 (wavenet_stack.cu) or f32 (the variant)
//
// Design:
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
//     channels, so both halves of the gate meet in the same lane and it
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
// Bound: a per-layer launch moves about 1,184 B per row (x in and out and
// skip read and written in f32, c in bf16) against 86,016 FLOP per row: on
// this card the bytes bind, about 4 x above the operations at the bf16
// tensor-core peak.

#pragma once

#include "mma_common.cuh"
#include "pipeline.cuh"
#include "wavenet_common.cuh"

namespace pwgtc {

using namespace pwg;
using bf16 = __nv_bfloat16;

enum Gate { kSigmoidGate = 0, kTanhGate = 1, kProductGate = 2 };

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
// mirrored by tc_smem_bytes() in ops/cuda/wavenet_stack.py
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

// the gate of one channel: kTanhGate's (1 + tanh(zb)) / 2 is sigmoid(2 zb)
template <int GATE>
__device__ __forceinline__ float gate_value(float za, float zb) {
  if constexpr (GATE == kSigmoidGate) return gate(za, zb);
  if constexpr (GATE == kTanhGate) return gate(za, 2.f * zb);
  return za * zb;
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
template <typename XIN, typename XOUT, int GATE, typename BT>
__global__ void __launch_bounds__(TC_THREADS, 1) wavenet_layer_tc_kernel(
    const XIN* __restrict__ x_in, const bf16* __restrict__ c,
    const bf16* __restrict__ w_tap, const BT* __restrict__ b_tap,
    const bf16* __restrict__ w_aux, const bf16* __restrict__ w_so,
    const BT* __restrict__ b_so, XOUT* __restrict__ x_out,
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
    bias_s[i] = to_f32(i < G ? b_tap[i] : b_so[i - G]);

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
        gv[e] = gate_value<GATE>(za, zb);
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

// One call of L layers: every layer's weights stacked along a leading axis
// (w_tap (L, 3R, G); b_tap (L, G); w_aux (L, A, G); w_so (L, R, SR); b_so
// (L, SR)); x, x_out (B, T, R) bf16; skip (B, T, S) f32; buf0, buf1
// (B, T, R) f32 ping-pong scratch (buf0 needed for L >= 2, buf1 for
// L >= 3); xs (L, B, T, R) bf16 or null; dilations on the host.
template <typename BT>
struct TcStackArgs {
  const void* x;
  const bf16* c;
  const bf16* w_tap;
  const BT* b_tap;
  const bf16* w_aux;
  const bf16* w_so;
  const BT* b_so;
  const int* dilations;
  int L, B, T, A;
  void* x_out;
  float* skip;
  void* buf0;
  void* buf1;
  bf16* xs;
  int blocks;
  cudaStream_t stream;
};

template <typename XIN, typename XOUT, int GATE, typename BT>
cudaError_t launch_tc_layer(const TcStackArgs<BT>& a, int l, const void* src,
                            void* dst) {
  const size_t smem = tc_smem_bytes<XIN>(a.A);
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_layer_tc_kernel<XIN, XOUT, GATE, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wavenet_layer_tc_kernel<XIN, XOUT, GATE, BT>
      <<<a.blocks, TC_THREADS, smem, a.stream>>>(
          static_cast<const XIN*>(src), a.c, a.w_tap + (size_t)l * 3 * R * G,
          a.b_tap + (size_t)l * G, a.w_aux + (size_t)l * a.A * G,
          a.w_so + (size_t)l * R * SR, a.b_so + (size_t)l * SR,
          static_cast<XOUT*>(dst), a.skip,
          a.xs == nullptr ? nullptr : a.xs + (size_t)l * a.B * a.T * R, a.B,
          a.T, a.A, a.dilations[l], l == 0);
  return cudaGetLastError();
}

// layer l reads what layer l-1 wrote: x, then buf0, buf1, buf0, ...; the
// first layer reads bf16 x, the last writes bf16 x_out, f32 in between
template <int GATE, typename BT>
cudaError_t run_tc_stack(const TcStackArgs<BT>& a) {
  for (int l = 0; l < a.L; ++l) {
    const void* src = l == 0 ? a.x : (l % 2 == 1 ? a.buf0 : a.buf1);
    void* dst = l == a.L - 1 ? a.x_out : (l % 2 == 0 ? a.buf0 : a.buf1);
    const bool first = l == 0, last = l == a.L - 1;
    cudaError_t err;
    if (first && last)
      err = launch_tc_layer<bf16, bf16, GATE, BT>(a, l, src, dst);
    else if (first)
      err = launch_tc_layer<bf16, float, GATE, BT>(a, l, src, dst);
    else if (last)
      err = launch_tc_layer<float, bf16, GATE, BT>(a, l, src, dst);
    else
      err = launch_tc_layer<float, float, GATE, BT>(a, l, src, dst);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace pwgtc
