"""HiFi-GAN serving path: functional forward, int8 activation quantisation
and the fused MRF stage.

Counterpart of ``parallelwavegan_tpu/ops/hifigan_infer.py``. The generator
forward is re-expressed over the module's folded kernels so that serving can

  1. run the exact forward (the math of ``HiFiGANGenerator.forward``),
  2. run the MRF conv chain, and optionally the upsampling transposed
     convs, with int8 activations and weights (``scales``),
  3. run chosen MRF stages through the hand-written CUDA kernel
     (``mrf_packs``; ``ops/cuda/mrf_stage.py``).

int8 scheme, as in the JAX package: static per-input-channel activation
scales, folded exactly into the weights. One calibration pass records the
per-channel max |x| of every quantised conv input; at run time x is scaled
per channel (x_q[c] = round(x[c] / sx[c])) and the weight absorbs sx before
its own per-output-channel quantisation (w'[k, c, o] = w[k, c, o] * sx[c]),
so conv(x_q, w'_q) * sw_o is algebraically the original conv. Epilogues
(rescale, bias, LeakyReLU, residual add) stay in floating point; the input
and output convs and tanh stay in the compute dtype.

The integer products of this chain (outside the MRF kernel) are library
products, as the JAX package leaves them to XLA: on CUDA the k taps of a
conv are concatenated to a (B*T, k*Cin) window and multiplied with
``torch._int_mm`` (int8 x int8 -> int32 on the tensor cores); a transposed
conv is ``torch._int_mm`` of (B*T, Cin) by (Cin, K*Cout) followed by an
overlap-add in int32. On the CPU the same sums are taken tap by tap in
float64, where they are exact (|sum| <= k*C*127^2 < 2^53). Both give the
same integers; accumulation is never narrower than int32.

The module holds its own parameters, so the functions take no ``variables``
argument, and there is no interpret mode: on a CUDA tensor a pack launches
the kernel or raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from parallelwavegan_torch.ops.conv import conv1d, conv_transpose1d
from parallelwavegan_torch.ops.cuda.mrf_stage import (
    build_stage_pack,
    mrf_stage,
    unsupported_shape,
)

QuantWeights = Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def supports_fast_inference(gen) -> bool:
    """Non-causal, as many residual branches as residual kernel sizes."""
    return (
        not gen.use_causal_conv
        and len(gen.resblock_kernel_sizes) == len(gen.resblock_dilations)
    )


def _quant_w(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 weight quantisation; w (K, Cin, Cout) f32."""
    s = torch.clamp(w.abs().amax(dim=(0, 1)) / 127.0, min=1e-12)
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return wq, s.float()


def _quant_x(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact."""
    if a.device.type == "cuda":
        M = a.shape[0]
        if M <= 16:  # torch._int_mm needs more than 16 rows
            a = F.pad(a, (0, 0, 0, 17 - M))
        return torch._int_mm(a.contiguous(), b.contiguous())[:M]
    return (a.double() @ b.double()).to(torch.int32)


def int8_conv1d(xq: torch.Tensor, wq: torch.Tensor, padding: int,
                dilation: int) -> torch.Tensor:
    """xq (B, T, Cin) int8 * wq (K, Cin, Cout) int8 -> (B, T', Cout) int32,
    zero padding of ``padding`` frames each side, stride 1."""
    B, T, Cin = xq.shape
    K, _, Cout = wq.shape
    xp = F.pad(xq, (0, 0, padding, padding))
    t_out = T + 2 * padding - dilation * (K - 1)
    if xq.device.type == "cuda":
        win = torch.cat([xp[:, t * dilation: t * dilation + t_out]
                         for t in range(K)], dim=-1)
        y = _int_matmul(win.reshape(B * t_out, K * Cin),
                        wq.reshape(K * Cin, Cout))
        return y.reshape(B, t_out, Cout)
    xp, wd = xp.double(), wq.double()
    y = None
    for t in range(K):
        part = xp[:, t * dilation: t * dilation + t_out] @ wd[t]
        y = part if y is None else y + part
    return y.to(torch.int32)


def int8_conv_transpose1d(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                          padding: int, output_padding: int) -> torch.Tensor:
    """Transposed conv with torch's length semantics on int8 inputs:
    xq (B, T, Cin) * wq (K, Cin, Cout) -> (B, T', Cout) int32. Every input
    frame's (K, Cout) contribution is one product; the contributions are
    overlap-added in groups of ``stride`` taps."""
    B, T, Cin = xq.shape
    K, _, Cout = wq.shape
    groups = -(-K // stride)
    w = F.pad(wq, (0, 0, 0, 0, 0, groups * stride - K))
    contrib = _int_matmul(
        xq.reshape(B * T, Cin),
        w.permute(1, 0, 2).reshape(Cin, groups * stride * Cout),
    ).reshape(B, T, groups, stride, Cout)
    full = torch.zeros((B, T + groups - 1, stride, Cout), dtype=torch.int32,
                       device=xq.device)
    for j in range(groups):
        full[:, j: j + T] += contrib[:, :, j]
    full = full.reshape(B, (T + groups - 1) * stride, Cout)
    length = (T - 1) * stride + K
    full = F.pad(full[:, :length], (0, 0, 0, output_padding))
    return full[:, padding: length - padding + output_padding]


def quantize_weights(gen, scales: Dict[str, np.ndarray]) -> QuantWeights:
    """{key: (wq int8 (K, Cin, Cout), sw f32 (Cout,), sx f32 (Cin,))} for
    every conv of ``gen`` that ``scales`` names, on the generator's device:
    the weight side of ``qconv`` / ``qdeconv``, computed once instead of in
    every forward."""
    out: QuantWeights = {}
    convs = _quantizable_convs(gen)
    for key, sx in scales.items():
        w = convs[key].folded_kernel().detach()
        sx_t = torch.as_tensor(np.asarray(sx, np.float32), device=w.device)
        sx_t = sx_t.expand(w.shape[1]).contiguous()
        wq, sw = _quant_w(w.float() * sx_t.reshape(1, -1, 1))
        out[key] = (wq, sw, sx_t)
    return out


def _quantizable_convs(gen) -> Dict[str, Any]:
    """Calibration key -> conv module, in the JAX package's key names."""
    convs: Dict[str, Any] = {}
    num_blocks = len(gen.resblock_kernel_sizes)
    for i, up in enumerate(gen.upsamples):
        convs[f"s{i}_up"] = up
        for j in range(num_blocks):
            block = gen.blocks[i * num_blocks + j]
            for li, conv in enumerate(block.convs1):
                convs[f"s{i}_b{j}_l{li}_c1"] = conv
            for li, conv in enumerate(block.convs2):
                convs[f"s{i}_b{j}_l{li}_c2"] = conv
    return convs


def _record(stats: Optional[Dict[str, torch.Tensor]], key: str,
            x: torch.Tensor) -> None:
    if stats is not None:
        stats[key] = x.abs().amax(dim=(0, 1)).float()


def _epilogue(y_int, sw, b, like):
    y = y_int.float() * sw
    if b is not None:
        y = y + b
    return y.to(like.dtype)


def _qconv(x, key, conv, k, d, scales, qweights, stats):
    _record(stats, key, x)
    w, b = conv.folded_kernel(), conv.bias
    if scales is None or key not in scales:
        return conv1d(x, w.to(x.dtype), b, padding=(k - 1) // 2 * d,
                      dilation=d)
    wq, sw, sx = qweights[key]
    # the activation is divided by sx in the compute dtype, as in the JAX
    # chain
    y = int8_conv1d(_quant_x(x, sx.to(x.dtype)), wq, (k - 1) // 2 * d, d)
    return _epilogue(y, sw, b, x)


def mrf_chain_stage(
    gen,
    i: int,
    x: torch.Tensor,
    slope: float,
    *,
    scales: Optional[Dict[str, np.ndarray]] = None,
    qweights: Optional[QuantWeights] = None,
    stats: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """MRF stage ``i`` of :func:`hifigan_fast_forward` as a conv chain: per
    branch, LeakyReLU and conv (dilated, then 1-dilation) per layer plus
    the residual, then the mean over branches. The convs whose keys
    ``scales`` holds run in int8 (``qweights`` from
    :func:`quantize_weights`), the others in x's dtype (cuDNN on CUDA).
    ``stats``, where given, receives every conv input's per-channel max
    |x| under its calibration key."""
    num_blocks = len(gen.resblock_kernel_sizes)
    acc = 0.0
    for j, (k_res, dils) in enumerate(zip(gen.resblock_kernel_sizes,
                                          gen.resblock_dilations)):
        block = gen.blocks[i * num_blocks + j]
        xb = x
        for li, d in enumerate(dils):
            xt = _qconv(F.leaky_relu(xb, slope), f"s{i}_b{j}_l{li}_c1",
                        block.convs1[li], k_res, d, scales, qweights, stats)
            if gen.use_additional_convs:
                xt = _qconv(F.leaky_relu(xt, slope), f"s{i}_b{j}_l{li}_c2",
                            block.convs2[li], k_res, 1, scales, qweights,
                            stats)
            xb = xt + xb
        acc = acc + xb
    return acc / num_blocks


def hifigan_fast_forward(
    gen,
    c: torch.Tensor,
    *,
    scales: Optional[Dict[str, np.ndarray]] = None,
    collect_stats: bool = False,
    mrf_packs: Optional[Dict[int, Dict[str, Any]]] = None,
    qweights: Optional[QuantWeights] = None,
):
    """Forward c (B, T', in_ch) -> (B, T' * upsample_factor, out_ch).

    scales=None, collect_stats=False: the exact forward in c's dtype.
    collect_stats=True: returns (y, stats) where stats maps conv keys to the
      per-input-channel max |x| of every would-be-quantised conv input
      (feed through :func:`make_scales`).
    scales=dict: int8 path for the convs whose keys it holds; the others
      stay in c's dtype, which makes the schedule stage-selective.
      ``qweights`` (:func:`quantize_weights` of the same scales) saves
      quantising the weights in every call.
    mrf_packs: per-stage packs from :func:`build_mrf_packs`; those stages
      run the fused MRF kernel (on CUDA) instead of the conv chain.
      Independent of ``scales`` (a pack carries its own quantisation).
    """
    if not supports_fast_inference(gen):
        raise NotImplementedError(
            "the fast HiFi-GAN forward needs a non-causal generator with one "
            "dilation list per residual kernel size")
    slope = gen.nonlinear_activation_params.get("negative_slope", 0.1)
    dtype = c.dtype
    stats: Optional[Dict[str, torch.Tensor]] = {} if collect_stats else None
    if scales is not None and qweights is None:
        qweights = quantize_weights(gen, scales)

    def qdeconv(x, key, conv, s_up):
        _record(stats, key, x)
        w, b = conv.folded_kernel(), conv.bias
        kw = dict(stride=s_up, padding=s_up // 2 + s_up % 2,
                  output_padding=s_up % 2)
        if scales is None or key not in scales:
            return conv_transpose1d(x, w.to(x.dtype), b, **kw)
        wq, sw, sx = qweights[key]
        y = int8_conv_transpose1d(_quant_x(x, sx.to(x.dtype)), wq, **kw)
        return _epilogue(y, sw, b, x)

    pad = (gen.kernel_size - 1) // 2
    x = conv1d(c, gen.input_conv.folded_kernel().to(dtype),
               gen.input_conv.bias, padding=pad)
    for i, s_up in enumerate(gen.upsample_scales):
        x = qdeconv(F.leaky_relu(x, slope), f"s{i}_up", gen.upsamples[i],
                    s_up)
        if mrf_packs is not None and i in mrf_packs:
            pack = mrf_packs[i]
            x = mrf_stage(
                x.contiguous(), pack,
                kernels=tuple(gen.resblock_kernel_sizes),
                dils=tuple(gen.resblock_dilations[0]),
                chunk=pack["chunk"], quant=pack["quant"], slope=slope,
            )
            continue
        x = mrf_chain_stage(gen, i, x, slope, scales=scales,
                            qweights=qweights, stats=stats)
    # the official implementation uses the default slope (0.01) here
    x = F.leaky_relu(x, 0.01)
    y = torch.tanh(conv1d(x, gen.output_conv.folded_kernel().to(dtype),
                          gen.output_conv.bias, padding=pad))
    if collect_stats:
        return y, stats
    return y


def make_scales(stats: Dict[str, Any], margin: float = 1.05
                ) -> Dict[str, np.ndarray]:
    """Calibration stats (per-channel max |x|) -> static scale vectors."""
    return {
        k: (np.maximum(np.asarray(v, np.float32) * margin, 1e-8) / 127.0)
        for k, v in stats.items()
    }


@torch.inference_mode()
def calibrate(gen, c: torch.Tensor) -> Dict[str, np.ndarray]:
    """One full-precision pass over representative mels -> int8 activation
    scales."""
    _, stats = hifigan_fast_forward(gen, c, collect_stats=True)
    return make_scales({k: v.cpu().numpy() for k, v in stats.items()})


def filter_scales_schedule(
    scales: Dict[str, np.ndarray], gen, schedule: str = "auto"
) -> Dict[str, np.ndarray]:
    """Apply a quantisation schedule by filtering calibration scales.

    'all': every calibrated conv runs int8. 'auto' (the JAX package's
    default): int8 on the C >= 128 MRF stages and every upsampling
    transposed conv; the C <= 64 MRF stages stay in the compute dtype.
    """
    if schedule == "all":
        return scales
    if schedule != "auto":
        raise ValueError(f"unknown int8 schedule: {schedule}")
    keep = {}
    for key, v in scales.items():
        if key.endswith("_up"):
            keep[key] = v
            continue
        stage = int(key[1:key.index("_")])
        if gen.channels // (2 ** (stage + 1)) >= 128:
            keep[key] = v
    return keep


def supports_mrf_kernel(gen) -> bool:
    """The fused MRF stage covers 3 branches with one shared per-layer
    dilation schedule and additional (dilation-1) convs: every official
    HiFi-GAN V1/V2 config."""
    dils = [tuple(d) for d in gen.resblock_dilations]
    return (
        supports_fast_inference(gen)
        and gen.use_additional_convs
        and len(gen.resblock_kernel_sizes) == 3
        and len(set(dils)) == 1
    )


def build_mrf_packs(
    gen,
    scales: Optional[Dict[str, np.ndarray]] = None,
    *,
    stages: Optional[Sequence[int]] = None,
    quant: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> Dict[int, Dict[str, Any]]:
    """Per-stage packs for the fused MRF kernel, on the generator's device.

    stages: which upsample stages run the kernel (default: all).
    quant=True folds the calibration ``scales`` (from :func:`calibrate`)
    into int8 weights exactly like ``qconv``; quant=False packs weights of
    ``dtype``. ``pack["chunk"]`` is the JAX kernel's time-chunk size for the
    stage's width; it is kept so that packs stay interchangeable, and the
    CUDA kernel does not read it. A width the CUDA kernel lacks raises
    here, on any device.
    """
    if not supports_mrf_kernel(gen):
        raise NotImplementedError(
            "the fused MRF stage needs a non-causal generator with 3 "
            "residual branches, one shared dilation list and additional "
            "convs")
    if quant and scales is None:
        raise ValueError("quant packs need calibration scales")
    num_blocks = len(gen.resblock_kernel_sizes)
    dils = gen.resblock_dilations[0]
    device = gen.input_conv.folded_kernel().device
    packs: Dict[int, Dict[str, Any]] = {}
    for i in range(len(gen.upsample_scales)):
        if stages is not None and i not in stages:
            continue
        c_stage = gen.channels // (2 ** (i + 1))
        bad = unsupported_shape(c_stage, gen.resblock_kernel_sizes, dils,
                                torch.int8 if quant else dtype)
        if bad:
            raise NotImplementedError(
                f"the mrf_stage kernel does not support {bad}")
        weights, sxs = [], []
        for j in range(num_blocks):
            block = gen.blocks[i * num_blocks + j]
            w_list, s_list = [], []
            for li in range(len(dils)):
                for ci, conv in ((1, block.convs1[li]), (2, block.convs2[li])):
                    w_list.append((
                        conv.folded_kernel().detach().float().cpu().numpy(),
                        conv.bias.detach().float().cpu().numpy(),
                    ))
                    s_list.append(
                        np.asarray(scales[f"s{i}_b{j}_l{li}_c{ci}"],
                                   np.float32)
                        if quant else np.ones((c_stage,), np.float32)
                    )
            weights.append(w_list)
            sxs.append(s_list)
        pack: Dict[str, Any] = build_stage_pack(weights, sxs, quant=quant,
                                                dtype=dtype, device=device)
        pack["chunk"] = {32: 4096, 64: 4096, 128: 2048}.get(c_stage, 1024)
        pack["quant"] = quant
        packs[i] = pack
    return packs
