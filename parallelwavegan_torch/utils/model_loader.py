"""Public inference API: load a trained generator and synthesize waveforms.

Counterpart of ``parallelwavegan_tpu/utils/model_loader.py`` for the ported
families, Parallel WaveGAN, HiFi-GAN, MelGAN, StyleMelGAN, the VQ-VAE and
UHiFiGAN: read the config, build the generator, load its weights (a
``.gckpt``, the parameters or the EMA stream of a train-state ``.ckpt``, or
a reference PyTorch ``.pkl``) with weight norm folded, cast to the compute
dtype, register mean/scale stats, attach PQMF synthesis for a multi-band
generator (``out_channels`` > 1), and synthesize a list of mels as one
bucketed batch, or one long mel in overlapping windows
(``inference_chunked``). On CUDA a Parallel WaveGAN generator runs through
``pwg_fused_forward`` (the WaveNet stack kernel), on the CPU through its
plain per-layer forward; the config's ``inference_fused_wavenet`` can ask
for either on any device (:func:`fused_wavenet`). A HiFi-GAN generator
runs its exact forward (``hifigan_fast_forward``); ``quantize_int8``
switches its conv chain to int8, and ``use_mrf_kernel`` routes its MRF
stages to the fused CUDA kernel. A MelGAN or StyleMelGAN generator runs
its module forward (cuDNN convs); StyleMelGAN's mels are edge-padded to its
noise grid and its noise drawn from the caller's ``torch.Generator``. A
VQ-VAE serves wav2wav, one utterance a call: ``vq_encode`` (audio -> code
indices) and ``vq_decode`` (codes and conditions -> audio, merged by PQMF
at ``out_channels`` > 1), in float32 only. UHiFiGAN serves one utterance a
call through ``inference(c, f0=..., excitation=...)``, at its exact shape,
as the JAX package's single-utterance path does, and so do the
discrete-symbol generators, from token ids (T', 1|2) (int64, exact in any
dtype; the JAX path casts float ids to the serving dtype): the token
HiFi-GAN as it is; a duration generator at ``max_reg_len`` frames on its
predicted durations, the wave cut to sum(clip(round(exp(d) - offset), 0))
x the upsample factor, computed in numpy as there; the F0 generator with
its f0 (T',); the token StyleMelGAN on ids edge-padded to its noise grid
and noise z drawn from the caller's ``torch.Generator``, the wave cut to
T' x the upsample factor.

Spans (``utils/tracing.py``): each serving entry is one ``serve.call``,
its request the model's count of calls (``calls``); in a batched call
``serve.prepare`` (``serve.pad``, ``serve.h2d``, ``serve.noise``),
``serve.forward`` and ``serve.readback``. The copies to and from the
device are counted.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallelwavegan_torch.layers.duration import durations_from_log
from parallelwavegan_torch.layers.pqmf import PQMF
from parallelwavegan_torch.models import DISCRETE_GENERATORS, get_model_class
from parallelwavegan_torch.ops.cuda.pwg_infer import (
    pwg_fused_forward,
    unsupported_fused_settings,
)
from parallelwavegan_torch.ops.cuda.wavenet_stack import (
    check_kernel_channels,
    fuse_wavenet_stack_params,
)
from parallelwavegan_torch.ops.hifigan_infer import (
    build_mrf_packs,
    calibrate,
    filter_scales_schedule,
    hifigan_fast_forward,
    quantize_weights,
    supports_fast_inference,
    supports_mrf_kernel,
)
from parallelwavegan_torch.utils.io import load_config, read_hdf5
from parallelwavegan_torch.utils.params import convert_jax_params
from parallelwavegan_torch.utils import tracing


def resolve_device(device: Any = "cuda") -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def _version_leq(a: str, b: str) -> bool:
    """Dotted-version a <= b (non-numeric parts compare as 0), for the
    reference's back-compat switch of the PQMF prototype."""

    def parts(v: str) -> List[int]:
        return [int(p) if p.isdigit() else 0
                for p in str(v).replace("-", ".").split(".")]

    pa, pb = parts(a), parts(b)
    n = max(len(pa), len(pb))
    return pa + [0] * (n - len(pa)) <= pb + [0] * (n - len(pb))


def pqmf_for(config: Dict[str, Any]) -> Optional[PQMF]:
    """The PQMF synthesis a generator with ``out_channels`` > 1 needs, as
    the JAX InferenceModel builds it: ``pqmf_params`` where the config has
    them; else, for a config of version <= 0.4.2 or none, the old
    prototype (taps 62, cutoff 0.15, beta 9.0); else PQMF's defaults."""
    out_ch = config.get("generator_params", {}).get("out_channels", 1)
    if out_ch <= 1:
        return None
    defaults: Dict[str, Any] = {}
    if _version_leq(config.get("version", "0.1.0"), "0.4.2"):
        defaults = {"taps": 62, "cutoff_ratio": 0.15, "beta": 9.0}
    return PQMF(subbands=out_ch, **config.get("pqmf_params", defaults))


def upsample_factor(config: Dict[str, Any]) -> int:
    """Output samples per mel frame, the JAX InferenceModel's rule: the
    product of the upsample scales (a Parallel WaveGAN's under
    ``upsample_params``; none for a VQ-VAE, whose decoder undoes its
    encoder), times the subband count."""
    gp = config.get("generator_params", {})
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    if gen_type == "ParallelWaveGANGenerator":
        scales = (gp.get("upsample_params") or {}).get(
            "upsample_scales", [4, 4, 4, 4])
    elif gen_type == "VQVAE":
        scales = []
    else:
        scales = gp.get("upsample_scales", [8, 8, 2, 2])
    return int(np.prod(scales)) * gp.get("out_channels", 1)


def chunk_windows(T: int, chunk_frames: int, context_frames: int
                  ) -> List[Tuple[int, int, int, int]]:
    """(lo, hi, a, b) for each window of ``InferenceModel.inference_chunked``
    over T frames: frames [lo, hi) are synthesized and the output of frames
    [a, b) is kept. A mel no longer than one window is one window; else the
    windows are chunk + 2 context frames long, those at the ends shorter
    (the first) or shifted inward (the last), as in the JAX package."""
    window = chunk_frames + 2 * context_frames
    if T <= window:
        return [(0, T, 0, T)]
    out = []
    for a in range(0, T, chunk_frames):
        b = min(a + chunk_frames, T)
        lo = max(0, min(a - context_frames, T - window))
        hi = min(T, lo + window) if lo > 0 else b + context_frames
        out.append((lo, hi, a, b))
    return out


def _randn(shape, generator: torch.Generator, device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) noise drawn on ``generator``'s device, then moved to
    ``device``: a CPU generator gives a CUDA model the noise it gives a CPU
    model."""
    z = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=dtype)
    tracing.count_transfer(z, device)
    return z.to(device)


def fused_wavenet(config: Dict[str, Any], device: torch.device) -> bool:
    """Whether a Parallel WaveGAN serves through ``pwg_fused_forward``:
    the config's ``inference_fused_wavenet`` (true, false or "auto", the
    default: fused on CUDA only)."""
    setting = config.get("inference_fused_wavenet", "auto")
    if setting == "auto":
        return device.type == "cuda"
    if isinstance(setting, bool):
        return setting
    raise ValueError(
        f"inference_fused_wavenet must be true, false or 'auto', not "
        f"{setting!r}")


def _served(method: Callable) -> Callable:
    """``method`` as one call into the serving API: a ``serve.call`` span,
    whose request is the model's count of calls."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        self.calls += 1
        with tracing.span("serve.call", self.calls):
            return method(self, *args, **kwargs)

    return call


class InferenceModel:
    """Generator (folded weights, compute dtype, on a device) + stats."""

    def __init__(self, config: Dict[str, Any], variables: Dict[str, Any],
                 dtype: Optional[torch.dtype] = None, pcm16: bool = False,
                 device: Any = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
        if self.gen_type == "VQVAE" and dtype not in (None, torch.float32):
            # the JAX InferenceModel fails there too: its conv gets f32
            # audio and bf16 weights
            raise NotImplementedError(
                f"VQVAE serves in float32 only, not {dtype}")
        gen_params = dict(config.get("generator_params", {}))
        # reference back-compat: the upsample_kernal_sizes typo
        if "upsample_kernal_sizes" in gen_params:
            gen_params["upsample_kernel_sizes"] = gen_params.pop(
                "upsample_kernal_sizes"
            )
        self.generator = get_model_class(self.gen_type)(**gen_params)
        self.generator.load_state_dict(
            convert_jax_params(variables["params"]), strict=True
        )
        self.dtype = dtype or torch.float32
        self.generator.to(device=self.device, dtype=self.dtype).eval()
        # Parallel WaveGAN: inference_fused_wavenet picks the forward, as in
        # the JAX package ("auto": fused on CUDA, the module forward on the
        # CPU; true: fused on any device, the kernel on CUDA and the stack's
        # plain version on the CPU; false: gen(z, c) everywhere). The fused
        # weights are made once here; settings the fused path lacks raise
        self.stack_params: Optional[Dict[str, torch.Tensor]] = None
        if self.gen_type == "ParallelWaveGANGenerator" \
                and fused_wavenet(config, self.device):
            gen = self.generator
            bad = unsupported_fused_settings(gen)
            if bad:
                raise NotImplementedError(
                    f"{self.gen_type} with {', '.join(bad)} has no fused "
                    "path; set inference_fused_wavenet: false for the "
                    "per-layer one")
            if self.device.type == "cuda":
                check_kernel_channels(gen.residual_channels,
                                      gen.gate_channels, gen.skip_channels)
            with torch.no_grad():
                self.stack_params = fuse_wavenet_stack_params(gen.conv_layers)
        # HiFi-GAN serving modes: int8 scales and their quantised weights
        # (quantize_int8), per-stage packs of the fused MRF kernel
        # (use_mrf_kernel); None = the exact forward
        self._int8_scales: Optional[Dict[str, np.ndarray]] = None
        self._int8_weights = None
        self._mrf_packs: Optional[Dict[int, Dict[str, Any]]] = None
        self.mean: Optional[np.ndarray] = None
        self.scale: Optional[np.ndarray] = None
        # multi-band: PQMF merges the subbands after the generator, in the
        # compute dtype, and the upsample factor counts them
        self.pqmf = pqmf_for(config)
        self.upsample_factor = upsample_factor(
            dict(config, generator_params=gen_params))
        # pcm16: convert to int16 PCM on the device (clip to [-1, 1],
        # *32767, truncate), as utils.io.write_wav does on the host
        self.pcm16 = bool(pcm16)
        # serving calls made: the request id of each ``serve.call`` span
        self.calls = 0

    def register_stats(self, stats: str) -> None:
        """Register mean/scale for de-normalization (h5 or npy)."""
        if stats.endswith(".h5"):
            self.mean = read_hdf5(stats, "mean").reshape(-1)
            self.scale = read_hdf5(stats, "scale").reshape(-1)
        elif stats.endswith(".npy"):
            arr = np.load(stats)
            self.mean = arr[0].reshape(-1)
            self.scale = arr[1].reshape(-1)
        else:
            raise ValueError(f"stats must be .h5 or .npy: {stats}")
        logging.info("Successfully registered stats.")

    def _forward_fn(self) -> Callable[[torch.Tensor,
                                       Optional[torch.Tensor]], torch.Tensor]:
        """fn(c, z): the device call of the current serving mode. z is the
        noise of a Parallel WaveGAN or a StyleMelGAN and None for the other
        families."""
        gen, w, pqmf = self.generator, self.stack_params, self.pqmf
        scales, qweights = self._int8_scales, self._int8_weights
        packs = self._mrf_packs

        @torch.inference_mode()
        def fn(c: torch.Tensor, z: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
            with tracing.span("serve.forward"):
                if self.gen_type == "ParallelWaveGANGenerator":
                    y = (gen(z, c) if w is None
                         else pwg_fused_forward(gen, z, c, w))
                elif self.gen_type == "StyleMelGANGenerator":
                    y = gen(c, z)
                else:
                    if self.gen_type == "HiFiGANGenerator" \
                            and supports_fast_inference(gen):
                        y = hifigan_fast_forward(gen, c, scales=scales,
                                                 qweights=qweights,
                                                 mrf_packs=packs)
                    else:
                        y = gen(c)
                    if pqmf is not None:
                        y = pqmf.synthesis(y)
                if self.pcm16:
                    # f32 before scaling: bf16's 8-bit mantissa would
                    # quantize worse than the 16-bit target format
                    y = (y.float().clamp(-1.0, 1.0) * 32767.0).to(
                        torch.int16)
                return y

        return fn

    def _check_hifigan_mode(self, what: str) -> None:
        if self.gen_type != "HiFiGANGenerator":
            raise ValueError(
                f"{what} supports HiFiGANGenerator, not {self.gen_type}"
            )
        if not supports_fast_inference(self.generator):
            raise ValueError(
                f"{what} requires a non-causal HiFi-GAN generator"
            )
        if self.pqmf is not None:
            # as the JAX package's int8 mode: the quantised paths are not
            # held on multi-band generators
            raise ValueError(
                f"{what} does not support multi-band (PQMF) generators"
            )

    def _calibration_batch(self, calib_mels) -> torch.Tensor:
        cs = [np.asarray(c, np.float32) for c in calib_mels]
        bucket = max(len(c) for c in cs)
        batch = np.stack([
            np.pad(c, ((0, bucket - len(c)), (0, 0)), mode="edge") for c in cs
        ])
        return torch.from_numpy(batch).to(self.device, self.dtype)

    def quantize_int8(self, calib_mels, schedule: str = "auto") -> None:
        """Enable the int8-activation HiFi-GAN serving mode.

        One calibration pass over representative (normalized) mels records
        the per-channel max |x| of every MRF conv and upsampling conv
        input; later ``synthesize_batch`` / ``inference`` calls run those
        convs with int8 activations and weights
        (``ops/hifigan_infer.py``). schedule: 'auto' (int8 on the C >= 128
        MRF stages and every upsampling conv) or 'all' (everything
        calibrated); see ``filter_scales_schedule``.
        """
        self._check_hifigan_mode("int8 serving")
        self._int8_scales = filter_scales_schedule(
            calibrate(self.generator, self._calibration_batch(calib_mels)),
            self.generator, schedule,
        )
        self._int8_weights = quantize_weights(self.generator,
                                              self._int8_scales)

    def use_mrf_kernel(self, quant: bool, calib_mels=None,
                       stages: Optional[Sequence[int]] = None) -> None:
        """Route the MRF stages (all, or ``stages``) to the fused kernel:
        later forwards call ``hifigan_fast_forward(..., mrf_packs=packs)``.

        quant=True packs int8 weights with scales calibrated on
        ``calib_mels`` (normalized mels, as for ``quantize_int8``);
        quant=False packs weights of the compute dtype. On a CUDA model the
        forward then launches the kernel or raises; on a CPU model the
        stages run the kernel's plain version.
        """
        self._check_hifigan_mode("the fused MRF stage")
        if not supports_mrf_kernel(self.generator):
            raise ValueError(
                "the fused MRF stage needs 3 residual branches with one "
                "shared dilation list and additional convs"
            )
        scales = None
        if quant:
            if calib_mels is None:
                raise ValueError("quant=True needs calib_mels")
            scales = calibrate(self.generator,
                               self._calibration_batch(calib_mels))
        self._mrf_packs = build_mrf_packs(
            self.generator, scales, stages=stages, quant=quant,
            dtype=self.dtype,
        )

    def prepare_batch(
        self,
        cs: Sequence[np.ndarray],
        normalize_before: bool = False,
        generator: Optional[torch.Generator] = None,
        bucket_size: int = 64,
    ) -> Tuple[Callable, Tuple[torch.Tensor, Optional[torch.Tensor]],
               List[int]]:
        """Host-side prep for one batched call: normalize, edge-pad mels to
        a shared bucket length (plus, for Parallel WaveGAN, the context
        window; for StyleMelGAN, then on to its noise grid), draw the noise
        z from ``generator`` on its device (by default a fresh one on the
        model's, seeded 0; for StyleMelGAN (B, noise frames, in_channels);
        None for the families that take no noise) and resolve the forward.
        Returns (fn, (c, z), lengths); ``fn(c, z)`` is the device call,
        and callers may pass their own z in its place."""
        if self.gen_type == "VQVAE":
            raise ValueError("a VQVAE serves audio through vq_encode and "
                             "vq_decode, not mels")
        if self.gen_type == "UHiFiGANGenerator":
            raise ValueError("UHiFiGAN serves one utterance a call through "
                             "inference(c, f0=..., excitation=...)")
        if self.gen_type in DISCRETE_GENERATORS:
            raise ValueError(f"{self.gen_type} serves one utterance a call "
                             "through inference(c, ...)")
        with tracing.span("serve.prepare"):
            with tracing.span("serve.pad"):
                cs = [np.asarray(c, dtype=np.float32) for c in cs]
                if normalize_before:
                    if self.mean is None:
                        raise ValueError("register_stats first")
                    cs = [(c - self.mean) / self.scale for c in cs]
                lengths = [len(c) for c in cs]
                bucket = -(-max(lengths) // bucket_size) * bucket_size
                pwg = self.gen_type == "ParallelWaveGANGenerator"
                ctx = self.generator.aux_context_window if pwg else 0
                padded = np.stack([
                    np.pad(c, ((ctx, bucket - len(c) + ctx), (0, 0)),
                           mode="edge")
                    for c in cs
                ])
                style = self.gen_type == "StyleMelGANGenerator"
                if style:
                    # the bucket edge-padded on to the noise grid (the JAX
                    # package's padding: the instance norms see these
                    # frames)
                    frames = self.generator.noise_frames(bucket)
                    grid = frames * self.generator.noise_upsample_factor
                    padded = np.pad(padded,
                                    ((0, 0), (0, grid - bucket), (0, 0)),
                                    mode="edge")
            with tracing.span("serve.h2d"):
                c = torch.from_numpy(padded)
                tracing.count_transfer(c, self.device)
                c = c.to(self.device, self.dtype)
            z = None
            if pwg or style:
                with tracing.span("serve.noise"):
                    if generator is None:
                        generator = torch.Generator(
                            device=self.device).manual_seed(0)
                    shape = ((len(cs), frames, self.generator.in_channels)
                             if style else
                             (len(cs), bucket * self.upsample_factor,
                              self.generator.in_channels))
                    z = _randn(shape, generator, self.device, self.dtype)
            return self._forward_fn(), (c, z), lengths

    @_served
    def synthesize_batch(
        self,
        cs: Sequence[np.ndarray],
        normalize_before: bool = False,
        generator: Optional[torch.Generator] = None,
        bucket_size: int = 64,
    ) -> List[np.ndarray]:
        """Batched synthesis cropped to the true lengths: float32 arrays,
        or int16 when the model was built with pcm16=True."""
        return self._synthesize(cs, normalize_before, generator, bucket_size)

    def _synthesize(self, cs: Sequence[np.ndarray], normalize_before: bool,
                    generator: Optional[torch.Generator], bucket_size: int
                    ) -> List[np.ndarray]:
        fn, args, lengths = self.prepare_batch(cs, normalize_before,
                                               generator, bucket_size)
        y = fn(*args)
        with tracing.span("serve.readback"):
            y = y if self.pcm16 else y.float()
            tracing.count_transfer(y, "cpu")
            y = y.cpu().numpy()
            return [y[i, : n * self.upsample_factor]
                    for i, n in enumerate(lengths)]

    def inference(self, c: np.ndarray, normalize_before: bool = False,
                  generator: Optional[torch.Generator] = None,
                  f0: Optional[np.ndarray] = None,
                  excitation: Optional[np.ndarray] = None) -> np.ndarray:
        """Mel (T', C) -> wave (T, out_channels), no bucket padding.
        UHiFiGAN takes the utterance's excitation (T samples, or
        (T', hop)) and its f0 (T' frames, unused by the generator); the
        F0 generator its f0; the other families ignore both. A discrete
        generator takes token ids (T', 1|2) or (T',) (``generator`` draws
        the token StyleMelGAN's noise, a fresh one seeded 0 by default)."""
        if self.gen_type == "UHiFiGANGenerator":
            return self._inference_excitation(c, f0, excitation)
        if self.gen_type in DISCRETE_GENERATORS:
            return self._inference_tokens(c, f0, generator)
        return self.synthesize_batch([c], normalize_before, generator,
                                     bucket_size=1)[0]

    @_served
    @torch.inference_mode()
    def _inference_excitation(self, c: np.ndarray, f0: Optional[np.ndarray],
                              excitation: Optional[np.ndarray]
                              ) -> np.ndarray:
        """UHiFiGAN's single-utterance path, as the JAX package's
        ``_inference_special``: batch 1 at the exact shape, c, f0 and the
        excitation cast to the parameters' dtype, a float32 wave back.
        Like that path it applies neither ``normalize_before`` nor
        ``pcm16``."""
        if excitation is None:
            raise ValueError("UHiFiGAN requires an excitation")

        def tensor(a: np.ndarray, shape) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, np.float32).reshape(shape)
                                    ).to(self.device, self.dtype)

        c_in = tensor(c, (1,) + np.shape(c))
        f0_in = None if f0 is None else tensor(f0, (1, -1, 1))
        y = self.generator(c_in, f0_in, tensor(excitation, (1, -1, 1)))
        return y[0].float().cpu().numpy()

    def _token_input(self, c: np.ndarray) -> torch.Tensor:
        """One utterance's ids (T', 1|2) or (T',) as (1, T', 1|2) int64 on
        the device, checked against the tables on the host first; the float
        features of ``use_embedding_feats`` in the parameters' dtype."""
        c = np.asarray(c)
        if c.ndim == 1:
            c = c[:, None]
        if getattr(self.generator, "token_inputs", True):
            self.generator.check_ids(c[None])
            return torch.from_numpy(c.astype(np.int64)[None]).to(self.device)
        return torch.from_numpy(np.asarray(c, np.float32)[None]).to(
            self.device, self.dtype)

    @torch.inference_mode()
    def _log_durations(self, c: np.ndarray) -> torch.Tensor:
        if self.gen_type != "DiscreteSymbolDurationGenerator":
            raise ValueError(f"{self.gen_type} predicts no durations")
        return self.generator.log_durations(self._token_input(c))[0]

    def predicted_log_durations(self, c: np.ndarray) -> np.ndarray:
        """A duration generator's predicted log-durations (T',) of one
        utterance's ids, float32: the deterministic duration predictor (the
        wave's length is sum(clip(round(exp(d) - offset), 0)) x the
        upsample factor of these, in numpy)."""
        return self._log_durations(c).float().cpu().numpy()

    def predicted_durations(self, c: np.ndarray) -> np.ndarray:
        """The integer durations (T',) the generator regulates the tokens
        by, rounded in the parameters' dtype (in bf16 they may differ from
        the numpy rounding of ``predicted_log_durations``, as in the JAX
        package)."""
        return durations_from_log(self._log_durations(c),
                                  self.generator.duration_offset
                                  ).cpu().numpy()

    @_served
    @torch.inference_mode()
    def _inference_tokens(self, c: np.ndarray, f0: Optional[np.ndarray],
                          generator: Optional[torch.Generator]
                          ) -> np.ndarray:
        """The discrete generators' single-utterance path (``inference``),
        the JAX package's ``_inference_special``: batch 1 at the exact
        shape, a float32 wave back; neither ``normalize_before`` nor
        ``pcm16`` applies."""
        gen, c_in = self.generator, self._token_input(c)
        T = c_in.shape[1]
        if self.gen_type == "DiscreteSymbolDurationGenerator":
            y, ds_out = gen(c_in)
            ds = np.clip(np.round(np.exp(ds_out.float().cpu().numpy())
                                  - gen.duration_offset), 0, None)
            n = int(ds.astype(np.int64).sum()) * self.upsample_factor
            return y[0, :n].float().cpu().numpy()
        if self.gen_type == "DiscreteSymbolF0Generator":
            f0_in = None if f0 is None else torch.from_numpy(
                np.asarray(f0, np.float32).reshape(1, -1, 1)).to(
                    self.device, self.dtype)
            return gen(c_in, f0_in)[0].float().cpu().numpy()
        if self.gen_type == "DiscreteSymbolStyleMelGANGenerator":
            # the ids edge-padded to the noise grid, one noise frame per
            # noise_upsample_factor ids
            frames = gen.noise_frames(T)
            pad = frames * gen.noise_upsample_factor - T
            c_in = torch.cat([c_in, c_in[:, -1:].expand(-1, pad, -1)], dim=1)
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            # drawn in f32, so that every serving dtype gets this noise
            z = _randn((1, frames, gen.in_channels), generator, self.device,
                       torch.float32).to(self.dtype)
            return gen(c_in, z)[0, :T * self.upsample_factor].float() \
                .cpu().numpy()
        return gen(c_in)[0].float().cpu().numpy()

    @torch.inference_mode()
    def vq_encode(self, audio: np.ndarray) -> np.ndarray:
        """Audio (T,) -> code indices (T // prod(downsample_scales),), as
        the JAX ``InferenceModel.vq_encode``."""
        x = torch.from_numpy(np.asarray(audio, np.float32).reshape(1, -1, 1))
        return self.generator.encode(x.to(self.device))[0].cpu().numpy()

    @_served
    @torch.inference_mode()
    def vq_decode(self, indices: np.ndarray, l: Optional[np.ndarray] = None,
                  g: Optional[int] = None) -> np.ndarray:
        """Code indices (T',) with an optional local condition (T', C) and
        speaker id -> wave (T, 1) (T, out_channels subbands merged by PQMF),
        as the JAX ``InferenceModel.vq_decode``."""
        dev = self.device
        idx = torch.from_numpy(np.asarray(indices, np.int64)[None]).to(dev)
        l_in = None if l is None else torch.from_numpy(
            np.asarray(l, np.float32)[None]).to(dev)
        g_in = None if g is None else torch.from_numpy(
            np.asarray(g, np.int64).reshape(1)).to(dev)
        y = self.generator.decode(idx, l_in, g_in)
        if self.pqmf is not None:
            y = self.pqmf.synthesis(y)
        return y[0].float().cpu().numpy()

    @_served
    def inference_chunked(
        self,
        c: np.ndarray,
        chunk_frames: int = 256,
        context_frames: int = 64,
        normalize_before: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> np.ndarray:
        """Mel (T', C) -> wave (T, 1) in overlapping windows, for
        utterances too long for one call.

        Each chunk of ``chunk_frames`` frames is synthesized from a window
        with ``context_frames`` real neighbouring frames on each side (the
        windows all have one of at most three lengths) and cropped to its
        own frames. A conv generator's border effects reach only the
        receptive field from a window's edge, so where the context covers
        it the chunks equal the whole-utterance forward. Each window goes
        through ``synthesize_batch(..., bucket_size=1)``, so through the
        forward of the current serving mode (the WaveNet stack kernel, the
        fused MRF stage). A Parallel WaveGAN draws each window's noise from
        ``generator`` (a fresh one seeded 0 by default), in window order;
        its chunks are the forward of their windows on that noise.

        StyleMelGAN chunks on its noise grid, as the JAX package does:
        chunk and context are rounded up to whole noise frames, the mel is
        edge-padded to the grid, one draw from ``generator`` covers the
        whole utterance (the draw ``inference`` makes) and each window
        takes its slice of it. Its instance norms take their statistics
        over the window, so the chunks come close to the whole forward
        without equalling it.
        """
        if self.gen_type not in ("ParallelWaveGANGenerator",
                                 "MelGANGenerator", "HiFiGANGenerator",
                                 "StyleMelGANGenerator"):
            # the JAX package asserts the same four families
            raise NotImplementedError(
                f"chunked synthesis not supported for {self.gen_type}")
        c = np.asarray(c, dtype=np.float32)
        if normalize_before:
            if self.mean is None:
                raise ValueError("register_stats first")
            c = (c - self.mean) / self.scale
        if generator is None and self.gen_type in (
                "ParallelWaveGANGenerator", "StyleMelGANGenerator"):
            generator = torch.Generator(device=self.device).manual_seed(0)
        if self.gen_type == "StyleMelGANGenerator":
            return self._inference_chunked_style(c, chunk_frames,
                                                 context_frames, generator)
        up = self.upsample_factor
        outs = []
        for lo, hi, a, b in chunk_windows(len(c), chunk_frames,
                                          context_frames):
            y = self._synthesize([c[lo:hi]], False, generator, 1)[0]
            outs.append(y[(a - lo) * up: (b - lo) * up])
        return np.concatenate(outs, axis=0)

    def _inference_chunked_style(self, c: np.ndarray, chunk_frames: int,
                                 context_frames: int,
                                 generator: torch.Generator) -> np.ndarray:
        """StyleMelGAN's windows on the noise grid (``inference_chunked``):
        every boundary is a whole number of noise frames, so each window's
        mel pairs with a contiguous slice of the one noise draw."""
        gen = self.generator
        nf = gen.noise_upsample_factor
        align = lambda n: -(-n // nf) * nf  # noqa: E731
        T = len(c)
        T_pad = align(T)
        c_pad = torch.from_numpy(
            np.pad(c, ((0, T_pad - T), (0, 0)), mode="edge")[None]
        ).to(self.device, self.dtype)
        z = _randn((1, T_pad // nf, gen.in_channels), generator,
                   self.device, self.dtype)
        fn, up = self._forward_fn(), self.upsample_factor
        outs = []
        for lo, hi, a, b in chunk_windows(T_pad, align(max(chunk_frames, 1)),
                                          align(max(context_frames, 1))):
            y = fn(c_pad[:, lo:hi], z[:, lo // nf: hi // nf])
            y = (y if self.pcm16 else y.float()).cpu().numpy()
            outs.append(y[0, (a - lo) * up: (b - lo) * up])
        return np.concatenate(outs, axis=0)[: T * up]


def load_model(
    checkpoint: str,
    config: Optional[Dict[str, Any]] = None,
    stats: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    pcm16: bool = False,
    device: Any = "cuda",
    use_ema: bool = False,
) -> InferenceModel:
    """Load an InferenceModel from a generator-only ``.gckpt``, a
    train-state ``.ckpt`` of either package or a reference PyTorch
    ``checkpoint-<N>steps.pkl``.

    The config defaults to ``config.yml`` beside the checkpoint.
    ``use_ema`` serves the EMA generator weights of a ``.ckpt`` trained
    with ``generator_ema_decay`` (a ``.gckpt`` holds exactly the parameters
    chosen at its export; a ``.pkl`` has no EMA stream).
    """
    from parallelwavegan_torch.engine.checkpoint import (
        load_generator_checkpoint,
        load_reference_checkpoint,
    )

    if config is None:
        config = load_config(
            os.path.join(os.path.dirname(checkpoint), "config.yml")
        )
    if use_ema and checkpoint.endswith((".pkl", ".gckpt")):
        raise ValueError(
            "use_ema applies to full train-state .ckpt files only (a "
            ".gckpt already holds exactly the params chosen at export; "
            "reference .pkl checkpoints have no EMA stream)")
    if checkpoint.endswith(".pkl"):
        variables = load_reference_checkpoint(checkpoint, config)["generator"]
    elif checkpoint.endswith(".gckpt"):
        variables = load_generator_checkpoint(checkpoint)
    else:
        tree = load_generator_checkpoint(checkpoint)
        params = tree["params_g"]
        if use_ema:
            if float(config.get("generator_ema_decay", 0.0) or 0.0) <= 0.0:
                raise ValueError(
                    "use_ema=True but the checkpoint's config has no "
                    "generator_ema_decay: this run kept no EMA stream")
            # a file from before the run kept one: the stream starts at the
            # parameters (the rule engine.checkpoint applies on resume)
            params = tree.get("ema_g") or params
        variables = {"params": params}
    model = InferenceModel(config, variables, dtype=dtype, pcm16=pcm16,
                           device=device)
    if stats is not None:
        model.register_stats(stats)
    return model
