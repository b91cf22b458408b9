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
// Design. The TPU kernel fuses a whole dilation cycle over halo'd windows
// whose f32 residual state (64 ch x (chunk + 2048) rows) does not fit the
// 227 KB of shared memory a Hopper block may use, so that blocking is not
// carried over. Here each launch runs one layer over tiles of TT = 64 time
// rows of one batch item (grid = (ceil(T/64), B), 256 threads):
//   1. the block stages its activation tile [x(t-d) | x(t) | x(t+d) | c(t)]
//      transposed into shared memory (272 x 64 f32, 68 KB), reading the
//      shifted rows straight from global memory with masks at 0 and T;
//   2. z = A . [Wt; Wa] as a register-blocked SIMT GEMM (each thread owns
//      4 rows x 8 columns: 4 tanh columns j and their sigmoid partners
//      j + 64, so the gate is formed in registers); the weights stream
//      through shared memory in chunks of 16 contraction rows;
//   3. g goes to shared memory, and so = g . [Ws | Wo] is a second GEMM of
//      the same shape, whose epilogue adds skip in place (f32) and writes
//      the new residual.
// The residual state between layers stays f32 in two global ping-pong
// buffers that the wrapper allocates; the first layer reads x in its own
// type and the last writes x_out in that type. For training (save_inputs in
// the TPU kernel, wavenet_stack.py:144) each layer also writes its input,
// rounded to the matmul type, to xs (L, B, T, R): exactly the values its
// tap GEMM consumed, which the backward kernel (wavenet_stack_bwd.cu)
// recomputes the gate from. Staging, the gate GEMM and the typed loads are
// shared with that kernel through wavenet_common.cuh.
//
// Bound (PWG v1 at batch 32 x 131072 samples, 30 layers): 86,016 FLOP per
// sample per layer, 1.08e13 FLOP in all, against 672 B per sample (x in and
// out in bf16, c in bf16, skip out in f32; 2.8 GB). The work is bound by
// operations: ~11 ms at the bf16 tensor-core peak. This first version does
// its arithmetic with f32 FMAs on the CUDA cores (67 TFLOP/s peak, so no
// faster than ~161 ms), and round-trips the f32 residual and skip through
// device memory once per layer. Tensor cores (mma/wgmma), TMA and fusing
// several layers per launch are the next steps.

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

// opt the kernel into more than 48 KB of dynamic shared memory
template <typename WT, typename XIN, typename XOUT>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(wavenet_layer_kernel<WT, XIN, XOUT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename WT, typename XIN, typename XOUT>
cudaError_t launch_layer(const void* x_in, const void* c, const WT* w_tap,
                         const WT* b_tap, const WT* w_aux, const WT* w_so,
                         const WT* b_so, void* x_out, float* skip, WT* xs,
                         int B, int T, int A, int d, int first, size_t smem,
                         cudaStream_t stream) {
  const dim3 grid((T + TT - 1) / TT, B);
  wavenet_layer_kernel<WT, XIN, XOUT><<<grid, THREADS, smem, stream>>>(
      static_cast<const XIN*>(x_in), static_cast<const WT*>(c), w_tap, b_tap,
      w_aux, w_so, b_so, static_cast<XOUT*>(x_out), skip, xs, T, A, d, first);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t run_stack(const void* x, const void* c, const void* w_tap_,
                      const void* b_tap_, const void* w_aux_,
                      const void* w_so_, const void* b_so_,
                      const int* dilations, int L, int B, int T, int A,
                      void* x_out, float* skip, void* buf0, void* buf1,
                      void* xs_, cudaStream_t stream) {
  const WT* w_tap = static_cast<const WT*>(w_tap_);
  const WT* b_tap = static_cast<const WT*>(b_tap_);
  const WT* w_aux = static_cast<const WT*>(w_aux_);
  const WT* w_so = static_cast<const WT*>(w_so_);
  const WT* b_so = static_cast<const WT*>(b_so_);
  WT* xs = static_cast<WT*>(xs_);
  // one attribute call per instantiation this stack launches
  const size_t smem = smem_floats(A) * sizeof(float);
  cudaError_t err = L == 1 ? allow_smem<WT, WT, WT>(smem)
                           : allow_smem<WT, WT, float>(smem);
  if (err == cudaSuccess && L >= 2) err = allow_smem<WT, float, WT>(smem);
  if (err == cudaSuccess && L >= 3) err = allow_smem<WT, float, float>(smem);
  if (err != cudaSuccess) return err;
  for (int l = 0; l < L; ++l) {
    // layer l reads what layer l-1 wrote: x, then buf0, buf1, buf0, ...
    const void* src = l == 0 ? x : (l % 2 == 1 ? buf0 : buf1);
    void* dst = l == L - 1 ? x_out : (l % 2 == 0 ? buf0 : buf1);
    const WT* wt = w_tap + (size_t)l * 3 * R * G;
    const WT* bt = b_tap + (size_t)l * G;
    const WT* wa = w_aux + (size_t)l * A * G;
    const WT* ws = w_so + (size_t)l * R * SR;
    const WT* bs = b_so + (size_t)l * SR;
    WT* xl = xs == nullptr ? nullptr : xs + (size_t)l * B * T * R;
    const int d = dilations[l];
    const bool first = l == 0, last = l == L - 1;
    if (first && last)
      err = launch_layer<WT, WT, WT>(src, c, wt, bt, wa, ws, bs, dst, skip, xl,
                                     B, T, A, d, 1, smem, stream);
    else if (first)
      err = launch_layer<WT, WT, float>(src, c, wt, bt, wa, ws, bs, dst, skip,
                                        xl, B, T, A, d, 1, smem, stream);
    else if (last)
      err = launch_layer<WT, float, WT>(src, c, wt, bt, wa, ws, bs, dst, skip,
                                        xl, B, T, A, d, 0, smem, stream);
    else
      err = launch_layer<WT, float, float>(src, c, wt, bt, wa, ws, bs, dst,
                                           skip, xl, B, T, A, d, 0, smem,
                                           stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Runs L layers on `stream`; returns a cudaError_t (0 on success).
// The Python wrapper checks shapes, types and alignment before the call.
// dtype: 0 = float32, 1 = bfloat16 (x, c, x_out, xs and every weight).
// x, x_out (B, T, 64); c (B, T, A); skip (B, T, 64) f32; buf0, buf1
// (B, T, 64) f32 scratch (buf0 needed for L >= 2, buf1 for L >= 3);
// xs (L, B, T, 64) receives every layer's input, or is null;
// weights as fuse_wavenet_stack_params lays them out; dilations on the host.
int pwg_wavenet_stack_forward(int dtype, const void* x, const void* c,
                              const void* w_tap, const void* b_tap,
                              const void* w_aux, const void* w_so,
                              const void* b_so, const int* dilations, int L,
                              int B, int T, int A, void* x_out, void* skip,
                              void* buf0, void* buf1, void* xs,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sk = static_cast<float*>(skip);
  if (dtype == 0)
    return (int)run_stack<float>(x, c, w_tap, b_tap, w_aux, w_so, b_so,
                                 dilations, L, B, T, A, x_out, sk, buf0, buf1,
                                 xs, s);
  if (dtype == 1)
    return (int)run_stack<__nv_bfloat16>(x, c, w_tap, b_tap, w_aux, w_so,
                                         b_so, dilations, L, B, T, A, x_out,
                                         sk, buf0, buf1, xs, s);
  return (int)cudaErrorInvalidValue;
}

const char* pwg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
