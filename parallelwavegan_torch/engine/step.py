"""GAN train and eval steps: the generator update, then the discriminator
update, in one function.

Counterpart of ``parallelwavegan_tpu/engine/step.py`` for Parallel WaveGAN,
HiFi-GAN, MelGAN (full-band and multi-band), StyleMelGAN, the VQ-VAE,
UHiFiGAN and the discrete-symbol generators on one device. Warm-up gating
selects a step variant by (train_g, use_adv, train_d), as there. The loss
arithmetic follows the JAX step: a VQ-VAE starts the generator loss with
its quantisation loss mean((z_q - sg(z_e))^2) plus ``lambda_commit`` times
its commitment loss mean((z_e - sg(z_q))^2), and a duration generator with
its duration loss on the predicted log-durations against the batch's
``ds`` (no weight of its own, before the factor ``lambda_aux`` as in the
JAX step); a multi-band output is merged by the
criterion's PQMF before the full-band STFT loss; with the subband STFT loss
that loss is halved and half the subband loss (on the PQMF analysis of the
target against the generator's subbands) added; then the mel loss, all
times ``lambda_aux``, plus ``lambda_adv`` times the adversarial loss, to
which feature matching adds ``lambda_feat_match`` times its value;
gradient clipping, the optimizers and the schedules live in
``optimizers``. Differences that PyTorch brings: the parameters are updated
in place in the state's modules.

Data parallelism (``build_steps(..., group=)``, the JAX step's
``shard_map`` branch): each rank runs the step on its shard of the batch,
and the step all-reduces G's gradients before G's update and D's before
D's (a mean in one bucket per dtype, JAX's ``pmean``), and the metrics at
the end. The dead-code restart sums the code counts over the ranks (JAX's
``psum``) and averages the restart rows (``pmean``) before the write, its
gate drawn from the shared stream; so the codebook, like every parameter
and optimizer moment, stays the same on each rank. The spectral-norm
vectors ``u`` and ``ema_g`` depend on the parameters alone and stay
replicated with no collective (JAX's note on ``shard_map``'s outputs).
Each rank's ``step_generator`` folds in its rank (``fold_step_rng``), so
the ranks draw different noise, windows, restart rows and dropout masks;
``SHARED_STREAM`` is never folded. A global batch the ranks cannot share
equally raises ``ValueError``, where the JAX step falls back to GSPMD.

Random draws: Parallel WaveGAN (and any generator with ``use_noise_input``)
takes its noise z from the batch. StyleMelGAN's generator noise and its
discriminator's random windows come from the step's random source, a
``torch.Generator`` passed to each call (``step_generator``: the trainer
seeds one from its seed and the step count, as the JAX trainer folds the
step into its key), drawn in
the JAX step's order: in the generator update the noise, then the windows
of the fake pass, then of the real pass when feature matching is on; in the
discriminator update fresh noise for the recompute, then the windows of the
real pass and of the fake pass; ``eval_step`` likewise. A step whose
families draw and that is given no source raises.

With ``vq_dead_code_restart`` a VQ-VAE's codes that no latent of the
batch chose are restarted after the generator's update and before the
EMA (``dead_code_restart``): each takes a random latent of the batch, drawn
from the step's source, where a gate drawn from ``shared_rng`` (a stream
every data-parallel rank would share, so that the codebook stays the same
on each) passes ``vq_restart_prob``; the metric ``vq_codes_used`` counts
the codes used.

UHiFiGAN takes (c, f0, excitation) from the batch, a duration generator
(c, ds), the F0 generator (c, f0), the token StyleMelGAN (c, z) as
StyleMelGAN does, the token HiFi-GAN c alone. Dropout (UHiFiGAN's, the
duration predictor's) is on in the train step, as the JAX step calls its
generator with ``deterministic=False``: the generator draws the keep masks
for the batch it gets (``batch_dropout_masks``), those of the generator
update's forward, then of the discriminator update's recompute, from the
step's ``dropout_rng`` (``step_generator(seed, steps, DROPOUT_STREAM,
device)``: the trainer seeds it on the models' device, so the masks are
drawn there and not copied from the host). ``eval_step`` runs it
deterministic.

Token ids stay exact: ``prepare_batch`` turns a token generator's c into
int64 before any dtype cast, and the casts touch floating tensors only. The
JAX step's mixed precision casts the collater's float32 ids to bfloat16,
where an id above 256 may round to a neighbour.

A spectral-normed discriminator advances its vectors ``u`` only in the
discriminator update (training mode), once per pass: twice a step with the
two-pass update, the fake pass starting from the real pass's ``u``. During
the generator update it runs in eval mode. With ``generator_ema_decay`` the
state's ``ema_g`` follows the generator after each of its updates.

``mixed_precision: true`` runs both networks on bfloat16 copies of the
float32 master parameters, of the batch and of ``u``, with explicit casts
as in the JAX step (no ``torch.autocast``); outputs return to float32
before PQMF and the losses, which run in float32, the gradients arrive in
float32, and the stored ``u`` is the bfloat16 result widened again. A
VQ-VAE's code distances and argmin run in bfloat16 there, as in the JAX
step.

The train step's phases are spans (``utils/tracing.py``): ``step.g_forward``
(the generator's forward and the PQMF merge), ``step.g_loss`` (the losses,
the discriminator's forward among them), ``step.g_backward``,
``step.g_update`` (the optimizer, the restart, the EMA),
``step.d_recompute``, ``step.d_loss``, ``step.d_backward``,
``step.d_update``, and ``step.all_reduce`` around each collective.
``eval_step`` opens none.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from parallelwavegan_torch.engine.state import GANTrainState
from parallelwavegan_torch.layers.vq import code_distances
from parallelwavegan_torch.ops.cuda.pwg_infer import unsupported_fused_settings
from parallelwavegan_torch.ops.cuda.wavenet_stack import check_kernel_channels
from parallelwavegan_torch.utils import tracing

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


# the stream of step_generator that every data-parallel rank would share:
# the dead-code restart draws its gate there
SHARED_STREAM = 0x5BDEAD
# the stream the dropout masks (UHiFiGAN's, the duration predictor's) are
# drawn from
DROPOUT_STREAM = 0xD50


def step_generator(seed: int = 0, steps: int = 0, stream: int = 0,
                   device: Any = "cpu", rank: int = 0, world: int = 1
                   ) -> torch.Generator:
    """The step's random source: a ``torch.Generator`` on ``device`` (the
    CPU by default) seeded from (``seed``, ``steps``, ``stream``), so that a
    run resumed at a step draws what an unbroken run draws there. The step
    hands it to the modules' ``draw_noise``, ``draw_window_starts`` and
    ``draw_dropout_masks``. A generator on another device draws other
    numbers from the same seed. At a ``world`` above 1 the ``rank`` is
    folded into the seed, as the JAX step folds the device index under
    ``shard_map`` (``fold_step_rng``), except into ``SHARED_STREAM``,
    which every rank shares; one process draws what it always drew."""
    key = [int(seed), int(steps), int(stream)]
    if world > 1 and stream != SHARED_STREAM:
        key.append(int(rank))
    state = np.random.SeedSequence(key)
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


_NO_SPAN = contextlib.nullcontext()


def _no_phase(name: str):
    """The eval step's phases: no spans."""
    return _NO_SPAN


def _is_style_generator(config: Dict[str, Any]) -> bool:
    """StyleMelGAN and the token StyleMelGAN (the JAX step's branch)."""
    return "StyleMelGAN" in config.get("generator_type", "")


def _is_style_discriminator(config: Dict[str, Any]) -> bool:
    return config.get("discriminator_type") == "StyleMelGANDiscriminator"


def is_vqvae(config: Dict[str, Any]) -> bool:
    return config.get("generator_type") == "VQVAE"


def is_uhifigan(config: Dict[str, Any]) -> bool:
    return config.get("generator_type") == "UHiFiGANGenerator"


def is_duration(config: Dict[str, Any]) -> bool:
    return "Duration" in config.get("generator_type", "")


def is_discrete_f0(config: Dict[str, Any]) -> bool:
    return config.get("generator_type") == "DiscreteSymbolF0Generator"


def uses_f0(config: Dict[str, Any]) -> bool:
    """Whether the batches (and a decoded utterance) carry the f0: the
    ``use_f0`` key (the CLIs' ``--use-f0``), or the F0 generator with its
    ``use_f0`` (default true), as the JAX CLIs decide."""
    return bool(config.get("use_f0", False)) or (
        is_discrete_f0(config)
        and config.get("generator_params", {}).get("use_f0", True))


def token_ids(generator, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """``batch`` with a token generator's c as int64 ids (a float batch of
    ids is exact below 2^24), so that no dtype cast reaches them; any
    other batch as it is."""
    if getattr(generator, "token_inputs", False) \
            and batch["c"].dtype != torch.int64:
        return dict(batch, c=batch["c"].long())
    return batch


def vq_restarts(config: Dict[str, Any]) -> bool:
    """Whether the step restarts a VQ-VAE's dead codes
    (``vq_dead_code_restart``)."""
    return is_vqvae(config) and bool(config.get("vq_dead_code_restart",
                                                False))


def needs_step_random(config: Dict[str, Any]) -> bool:
    """Whether the step draws from its random source: StyleMelGAN's
    generator (its noise) or discriminator (its windows), or a VQ-VAE's
    dead-code restart."""
    return (_is_style_generator(config) or _is_style_discriminator(config)
            or vq_restarts(config))


def uses_noise(config: Dict[str, Any]) -> bool:
    """Whether the generator takes noise z from the batch: Parallel WaveGAN
    always, any other generator but StyleMelGAN (which the step draws for)
    with ``use_noise_input: true`` (JAX engine/step.py:52-55, where
    StyleMelGAN's branch comes first)."""
    if _is_style_generator(config):
        return False
    return (config.get("generator_type", "ParallelWaveGANGenerator")
            == "ParallelWaveGANGenerator"
            or bool(config.get("use_noise_input", False)))


def with_noise(generator, batch: Dict[str, torch.Tensor],
               rng: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """``batch`` with a StyleMelGAN generator's noise z (B, noise frames,
    in_channels) drawn from ``rng`` (f32, on the batch's device); any other
    generator's batch as it is."""
    if not hasattr(generator, "draw_noise"):
        return batch
    c = batch["c"]
    z = generator.draw_noise(c.shape[0], c.shape[1], rng)
    return dict(batch, z=z.to(c.device))


def make_generator_forward(config: Dict[str, Any], generator
                           ) -> Callable[..., Tuple[torch.Tensor, Params]]:
    """Adapter (params, batch, masks=None) -> (y_hat, aux). ``params`` are
    the generator's named parameters or copies of them (cast, detached).
    ``aux`` holds a VQ-VAE's latents ``z_e`` and ``z_q``, a duration
    generator's predicted log-durations ``ds_out``, and is empty for the
    other families. ``masks`` are the dropout keep masks of a training
    forward (UHiFiGAN's, the duration predictor's: the generator's
    ``batch_dropout_masks``), None for a deterministic one; the other
    families have no dropout and are given None.

    As in the JAX step, a VQ-VAE takes the batch's ``x_vq`` (the PQMF
    subbands of y that ``prepare_batch`` adds at ``in_channels`` > 1) or
    else y, with its conditions ``l`` and ``g`` where the batch has them;
    Parallel WaveGAN and any generator with ``use_noise_input: true`` take
    (z, c), StyleMelGAN and the token StyleMelGAN (c, z) with the z that
    ``with_noise`` puts in the batch, UHiFiGAN (c, f0, excitation), a
    duration generator (c, ds), the F0 generator (c, f0), every other
    generator c alone. A Parallel WaveGAN generator on CUDA takes the fused path (the WaveNet
    stack kernels, trainable grouping) unless ``fused_wavenet`` is false;
    there a config the kernels lack raises, it does not fall back. On the
    CPU the per-layer forward runs.
    """
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    if is_vqvae(config):
        def forward_vq(params: Params, batch: Batch, masks=None):
            y_, z_e, z_q = functional_call(
                generator, params, (batch.get("x_vq", batch["y"]),
                                    batch.get("l"), batch.get("g")))
            return y_, {"z_e": z_e, "z_q": z_q}

        return forward_vq
    if is_duration(config):
        def forward_d(params: Params, batch: Batch, masks=None):
            y_, ds_out = functional_call(
                generator, params, (batch["c"], batch["ds"]),
                {"deterministic": masks is None, "masks": masks})
            return y_, {"ds_out": ds_out}

        return forward_d
    if is_uhifigan(config):
        def forward_u(params: Params, batch: Batch, masks=None):
            return functional_call(
                generator, params,
                (batch["c"], batch.get("f0"), batch.get("excitation")),
                {"deterministic": masks is None, "masks": masks}), {}

        return forward_u
    if _is_style_generator(config):
        def forward_style(params: Params, batch: Batch, masks=None):
            return functional_call(generator, params,
                                   (batch["c"], batch["z"])), {}

        return forward_style
    if is_discrete_f0(config):
        def forward_f0(params: Params, batch: Batch, masks=None):
            return functional_call(generator, params,
                                   (batch["c"], batch.get("f0"))), {}

        return forward_f0
    if not uses_noise(config):
        def forward_c(params: Params, batch: Batch, masks=None):
            return functional_call(generator, params, (batch["c"],)), {}

        return forward_c
    device = next(generator.parameters()).device
    is_pwg = gen_type == "ParallelWaveGANGenerator"
    fused = (is_pwg and device.type == "cuda"
             and config.get("fused_wavenet", "auto") in (True, "auto", "true"))
    if fused:
        bad = unsupported_fused_settings(generator)
        if bad:
            raise NotImplementedError(
                f"{gen_type} with {', '.join(bad)} has no fused CUDA path; "
                "set fused_wavenet: false for the per-layer one"
            )
        check_kernel_channels(generator.residual_channels,
                              generator.gate_channels,
                              generator.skip_channels)
    kwargs = {"fused": fused, "trainable": fused} if is_pwg else {}

    def forward(params: Params, batch: Batch, masks=None):
        kw = kwargs if masks is None else dict(kwargs, masks=masks)
        return functional_call(generator, params, (batch["z"], batch["c"]),
                               kw), {}

    return forward


def fuse_real_fake_default(discriminator_type: str) -> bool:
    """Whether the discriminator sees real and fake in one pass when the
    config does not say (``fuse_real_fake_discriminator``): off for the
    multi-scale multi-period discriminator and for StyleMelGAN's, as in
    the JAX step. Every module of the others is pointwise in the batch, so
    one pass over concat([real, fake]) gives the two passes' numbers; the
    spectral norm's power iteration advances once instead of twice."""
    return ("StyleMelGAN" not in discriminator_type
            and "HiFiGANMultiScaleMultiPeriod" not in discriminator_type)


def make_discriminator_forward(config: Dict[str, Any], discriminator
                               ) -> Callable[..., Any]:
    """Adapter (params, x, train, buffers=None, *, window_starts=None,
    masks=None) -> discriminator outputs (a tensor, or a list of lists of
    tensors). ``train`` selects the module's mode for the call: in training
    mode the spectral-norm vectors advance. ``buffers`` are stand-ins for
    the module's own buffers (read, and in training mode advanced, in their
    place). ``window_starts`` go to StyleMelGAN's discriminator, dropout
    keep ``masks`` to the residual Parallel WaveGAN discriminator's."""
    def forward(params: Params, x: torch.Tensor, train: bool,
                buffers: Optional[Params] = None, *,
                window_starts: Optional[List[int]] = None,
                masks: Optional[List[torch.Tensor]] = None):
        was_training = discriminator.training
        discriminator.train(train)
        args = (x,) if window_starts is None else (x, window_starts)
        if masks is not None:
            args = (x, masks)
        try:
            return functional_call(discriminator,
                                   {**params, **(buffers or {})}, args)
        finally:
            discriminator.train(was_training)

    return forward


def _cast(tensors: Params, src: torch.dtype, dst: torch.dtype) -> Params:
    """The tensors of dtype ``src`` among ``tensors`` cast to ``dst``."""
    return {k: v.to(dst) if v.dtype == src else v for k, v in tensors.items()}


def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], outputs):
    """``fn`` over a discriminator's outputs (a tensor or nested lists)."""
    if isinstance(outputs, (list, tuple)):
        return [_tree_map(fn, o) for o in outputs]
    return fn(outputs)


def build_steps(config: Dict[str, Any], generator, discriminator,
                criterion: Dict[str, Any], opt_g, opt_d, group=None):
    """Return (train_step_factory, eval_step).

    train_step_factory(train_g, use_adv, train_d) -> step
      step(state, batch, rng=None, shared_rng=None, dropout_rng=None)
      -> (state, metrics); the state is updated in place
    eval_step(state, batch, use_adv=True, rng=None) -> metrics

    ``batch`` holds tensors on the models' device: y (B, T, 1), c, z, a
    VQ-VAE's conditions l (B, T', C) and g (B,), UHiFiGAN's f0 (B, T', 1)
    and excitation (B, T, 1), a duration generator's ds (B, T'). ``rng`` is the step's random source
    (``step_generator``), which StyleMelGAN needs, and the dead-code
    restart with ``shared_rng`` (``step_generator(seed, steps,
    SHARED_STREAM)``, the stream data-parallel ranks would share);
    the dropout (UHiFiGAN's, the duration predictor's, the WaveNet blocks'
    of Parallel WaveGAN and of the residual PWG discriminator, the last in
    the discriminator update only) draws its masks from ``dropout_rng``
    (``step_generator(seed, steps, DROPOUT_STREAM, device)``). Metrics are
    detached 0-d tensors on the device.

    ``group`` (a ``parallel.dist.Group``, None for one process) makes the
    train step data-parallel: ``batch`` is this rank's shard of a global
    batch of ``batch_size``, and the gradients, the metrics and the
    restart's counts and rows are all-reduced (the module docstring). The
    eval step runs no collective.
    """
    if group is not None:
        from parallelwavegan_torch.parallel.dist import per_rank_batch

        per_rank_batch(config.get("batch_size", 0), group.size())
    gen_forward_raw = make_generator_forward(config, generator)
    dis_forward_raw = make_discriminator_forward(config, discriminator)
    lambda_aux = config.get("lambda_aux", 1.0)
    lambda_adv = config.get("lambda_adv", 4.0)
    lambda_fm = config.get("lambda_feat_match", 2.0)
    dis_type = config.get("discriminator_type", "ParallelWaveGANDiscriminator")
    fuse_rf = bool(config.get("fuse_real_fake_discriminator",
                              fuse_real_fake_default(dis_type)))
    out_ch = config.get("generator_params", {}).get("out_channels", 1)
    pqmf = criterion["pqmf"] if out_ch > 1 else None
    needs_rng = needs_step_random(config)
    style_d = _is_style_discriminator(config)
    vq = is_vqvae(config)
    lambda_commit = config.get("lambda_commit", 0.25)
    vq_subbands = vq and config["generator_params"].get("in_channels", 1) > 1
    restart = vq_restarts(config)
    restart_prob = float(config.get("vq_restart_prob", 1.0))
    dropout = getattr(generator, "dropout", 0.0) > 0.0
    d_dropout = getattr(discriminator, "dropout", 0.0) > 0.0

    def starts(x: torch.Tensor, rng: Optional[torch.Generator]):
        """One pass's window starts (StyleMelGAN), else None."""
        if not style_d:
            return None
        return discriminator.draw_window_starts(x.shape[1], rng)

    def full_band(y_hat: torch.Tensor) -> torch.Tensor:
        """The generator's output as one band: subbands merged by PQMF."""
        return y_hat if pqmf is None else pqmf.synthesis(y_hat)

    def check_rng(rng: Optional[torch.Generator]) -> None:
        if needs_rng and rng is None:
            raise ValueError(
                f"{config.get('generator_type')} / "
                f"{config.get('discriminator_type')} draw noise, windows or "
                "restarted codes from the step's random source: pass "
                "step_generator(...)")

    def prepare_batch(batch: Batch) -> Batch:
        """A VQ-VAE at ``in_channels`` > 1 encodes the PQMF subbands of y
        (``x_vq``), as the JAX step's ``prepare_batch``; a token
        generator's ids become int64 (``token_ids``)."""
        batch = token_ids(generator, batch)
        if vq_subbands:
            return dict(batch, x_vq=criterion["pqmf"].analysis(batch["y"]))
        return batch

    recompute = config.get("update_prediction_after_generator_update", True)
    ema_decay = float(config.get("generator_ema_decay", 0.0) or 0.0)

    def dropout_masks(batch: Batch, dropout_rng: Optional[torch.Generator]):
        """The keep masks of one training forward of ``batch`` (the
        generator's ``batch_dropout_masks`` on ``dropout_rng``), None for
        the families without dropout."""
        if not dropout:
            return None
        if dropout_rng is None:
            raise ValueError(
                f"{config.get('generator_type')} draws dropout masks in "
                "training: pass dropout_rng=step_generator(seed, steps, "
                "DROPOUT_STREAM, device)")
        return generator.batch_dropout_masks(batch, dropout_rng)

    f32, bf16 = torch.float32, torch.bfloat16
    if config.get("mixed_precision", False):
        def gen_forward(params: Params, batch: Batch, masks=None):
            y_, aux = gen_forward_raw(_cast(params, f32, bf16),
                                      _cast(batch, f32, bf16), masks)
            return y_.to(f32), _cast(aux, bf16, f32)

        def dis_forward(params: Params, x: torch.Tensor, train: bool, *,
                        window_starts: Optional[List[int]] = None,
                        masks: Optional[List[torch.Tensor]] = None):
            buffers = dict(discriminator.named_buffers())
            half = _cast(buffers, f32, bf16)
            outs = dis_forward_raw(_cast(params, f32, bf16), x.to(bf16),
                                   train, half, window_starts=window_starts,
                                   masks=masks)
            if train:  # the carried power-iteration state back to f32
                with torch.no_grad():
                    for key, value in buffers.items():
                        value.copy_(half[key])
            return _tree_map(lambda t: t.to(f32), outs)
    else:
        gen_forward, dis_forward = gen_forward_raw, dis_forward_raw

    def gen_losses(params_g: Params, params_d: Params, batch: Batch,
                   use_adv: bool, rng: Optional[torch.Generator],
                   masks: Optional[List[torch.Tensor]] = None,
                   phase: Callable[[str], Any] = _no_phase):
        metrics = {}
        with phase("step.g_forward"):
            batch = with_noise(generator, batch, rng)
            # y_mb_ (B, T / S, S) when multi-band
            y_mb_, aux = gen_forward(params_g, batch, masks)
            y_ = full_band(y_mb_)
        with phase("step.g_loss"):
            y = batch["y"]
            gen_loss = 0.0
            if vq:
                z_e, z_q = aux["z_e"], aux["z_q"]
                quant = torch.mean((z_q - z_e.detach()) ** 2)
                commit = torch.mean((z_e - z_q.detach()) ** 2)
                metrics["quantization_loss"] = quant
                metrics["commitment_loss"] = commit
                gen_loss = gen_loss + (quant + lambda_commit * commit)
            if "ds_out" in aux:
                d_loss = criterion["duration"](aux["ds_out"], batch["ds"])
                metrics["duration_loss"] = d_loss
                gen_loss = gen_loss + d_loss
            if "stft" in criterion:
                sc_loss, mag_loss = criterion["stft"](y_[..., 0], y[..., 0])
                metrics["spectral_convergence_loss"] = sc_loss
                metrics["log_stft_magnitude_loss"] = mag_loss
                gen_loss = gen_loss + (sc_loss + mag_loss)
            if "sub_stft" in criterion:
                # full band and subbands weigh alike
                gen_loss = gen_loss * 0.5
                y_mb = pqmf.analysis(y)
                sub_sc, sub_mag = criterion["sub_stft"](
                    y_mb_.transpose(1, 2), y_mb.transpose(1, 2))
                metrics["sub_spectral_convergence_loss"] = sub_sc
                metrics["sub_log_stft_magnitude_loss"] = sub_mag
                gen_loss = gen_loss + 0.5 * (sub_sc + sub_mag)
            if "mel" in criterion:
                mel_loss = criterion["mel"](y_[..., 0], y[..., 0])
                metrics["mel_loss"] = mel_loss
                gen_loss = gen_loss + mel_loss
            gen_loss = gen_loss * lambda_aux
            if use_adv:
                # the discriminator in eval mode, and no gradient with
                # respect to its parameters
                fixed_d = {k: v.detach() for k, v in params_d.items()}
                feat_match = criterion.get("feat_match")
                p = None
                if fuse_rf and feat_match is not None:
                    nb = y_.shape[0]
                    p_all = dis_forward(fixed_d, torch.cat([y_, y], dim=0),
                                        False, window_starts=starts(y_, rng))
                    p_ = _tree_map(lambda t: t[:nb], p_all)
                    p = _tree_map(lambda t: t[nb:], p_all)
                else:
                    p_ = dis_forward(fixed_d, y_, False,
                                     window_starts=starts(y_, rng))
                adv_loss = criterion["gen_adv"](p_)
                metrics["adversarial_loss"] = adv_loss
                if feat_match is not None:
                    if p is None:
                        # the real features are constants
                        with torch.no_grad():
                            p = dis_forward(fixed_d, y, False,
                                            window_starts=starts(y, rng))
                    fm_loss = feat_match(p_, p)
                    metrics["feature_matching_loss"] = fm_loss
                    adv_loss = adv_loss + lambda_fm * fm_loss
                gen_loss = gen_loss + lambda_adv * adv_loss
            metrics["generator_loss"] = gen_loss
        return gen_loss, metrics, y_, aux

    def d_masks(x: torch.Tensor, train: bool,
                dropout_rng: Optional[torch.Generator]):
        """The keep masks of one training pass of the discriminator over x
        (the residual PWG discriminator's dropout), else None."""
        if not (train and d_dropout):
            return None
        if dropout_rng is None:
            raise ValueError(
                f"{dis_type} draws dropout masks in training: pass "
                "dropout_rng=step_generator(seed, steps, DROPOUT_STREAM, "
                "device)")
        return discriminator.draw_dropout_masks(x.shape[0], x.shape[1],
                                                dropout_rng)

    def dis_losses(params_d: Params, y: torch.Tensor, y_hat: torch.Tensor,
                   train: bool, rng: Optional[torch.Generator],
                   dropout_rng: Optional[torch.Generator] = None):
        y_hat = y_hat.detach()
        if fuse_rf:
            nb = y.shape[0]
            both = torch.cat([y, y_hat], dim=0)
            p_all = dis_forward(params_d, both, train,
                                window_starts=starts(y, rng),
                                masks=d_masks(both, train, dropout_rng))
            p = _tree_map(lambda t: t[:nb], p_all)
            p_ = _tree_map(lambda t: t[nb:], p_all)
        else:
            p = dis_forward(params_d, y, train, window_starts=starts(y, rng),
                            masks=d_masks(y, train, dropout_rng))
            p_ = dis_forward(params_d, y_hat, train,
                             window_starts=starts(y_hat, rng),
                             masks=d_masks(y_hat, train, dropout_rng))
        real_loss, fake_loss = criterion["dis_adv"](p_, p)
        dis_loss = real_loss + fake_loss
        metrics = {"real_loss": real_loss, "fake_loss": fake_loss,
                   "discriminator_loss": dis_loss}
        return dis_loss, metrics

    def _detached(metrics):
        return {k: v.detach() for k, v in metrics.items()}

    def _grads(loss: torch.Tensor, params: Params):
        """d loss / d params; zeros for a parameter the loss does not reach
        (the last layer's residual 1x1 feeds nothing)."""
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params.values(), grads)]

    @torch.no_grad()
    def dead_code_restart(params_g: Params, z_e: torch.Tensor,
                          rng: torch.Generator,
                          shared_rng: torch.Generator) -> torch.Tensor:
        """The dead-code restart of the JAX step, after the generator's
        update: a code that no latent of z_e (the loss forward's, before
        the update) is nearest to under the updated codebook takes a random
        row of z_e, where a gate uniform < ``vq_restart_prob`` lets it. The
        rows come from ``rng``, the gate from ``shared_rng``; Adam's
        moments of the restarted rows stay. Returns the number of codes
        used. Data-parallel, a code is dead when no latent of any rank
        chose it (the counts summed), and the ranks write the mean of
        their rows, so the codebook stays the same on each."""
        emb = params_g["codebook.embedding"]
        k = emb.shape[0]
        flat = z_e.detach().reshape(-1, emb.shape[-1])
        used = torch.zeros(k, dtype=torch.float32, device=emb.device)
        used.index_add_(0, torch.argmin(code_distances(flat, emb), dim=-1),
                        torch.ones(flat.shape[0], device=emb.device))
        rows = torch.randint(0, flat.shape[0], (k,), generator=rng)
        repl = flat[rows.to(flat.device)]
        if group is not None:
            with tracing.span("step.all_reduce"):
                used, = group.all_reduce_sum([used])
                repl, = group.all_reduce_mean([repl])
        gate = torch.rand(k, generator=shared_rng) < restart_prob
        dead = (used == 0.0) & gate.to(emb.device)
        emb.copy_(torch.where(dead[:, None], repl.to(emb.dtype), emb))
        return torch.sum(used > 0.0).to(torch.float32)

    @functools.lru_cache(maxsize=8)
    def train_step_factory(train_g: bool, use_adv: bool, train_d: bool):
        def step(state: GANTrainState, batch: Batch,
                 rng: Optional[torch.Generator] = None,
                 shared_rng: Optional[torch.Generator] = None,
                 dropout_rng: Optional[torch.Generator] = None
                 ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
            check_rng(rng)
            if restart and train_g and shared_rng is None:
                raise ValueError(
                    "the dead-code restart draws its gate from the shared "
                    "stream: pass shared_rng=step_generator(seed, steps, "
                    "SHARED_STREAM)")
            batch = prepare_batch(batch)
            metrics: Dict[str, torch.Tensor] = {}
            params_g, params_d = state.params_g, state.params_d
            span = tracing.span
            y_hat = None
            if train_g:
                gen_loss, m, y_hat, aux = gen_losses(
                    params_g, params_d, batch, use_adv, rng,
                    dropout_masks(batch, dropout_rng), span)
                with span("step.g_backward"):
                    grads = _grads(gen_loss, params_g)
                if group is not None:
                    with span("step.all_reduce"):
                        grads = group.all_reduce_mean(grads)
                y_hat = y_hat.detach()
                metrics.update(_detached(m))
                del gen_loss, m
                with span("step.g_update"):
                    opt_g.step(params_g, grads)
                    if restart:
                        metrics["vq_codes_used"] = dead_code_restart(
                            params_g, aux["z_e"], rng, shared_rng)
                    del aux
                    if ema_decay > 0.0 and state.ema_g is not None:
                        with torch.no_grad():
                            ema = [state.ema_g[k] for k in params_g]
                            torch._foreach_mul_(ema, ema_decay)
                            torch._foreach_add_(ema, list(params_g.values()),
                                                alpha=1.0 - ema_decay)
            if train_d:
                if recompute or y_hat is None:
                    # a second forward with the updated generator; nothing
                    # is saved for a backward
                    with span("step.d_recompute"), torch.no_grad():
                        y_hat = full_band(gen_forward(
                            params_g, with_noise(generator, batch, rng),
                            dropout_masks(batch, dropout_rng))[0])
                with span("step.d_loss"):
                    dis_loss, m = dis_losses(params_d, batch["y"], y_hat,
                                             True, rng, dropout_rng)
                with span("step.d_backward"):
                    grads_d = _grads(dis_loss, params_d)
                if group is not None:
                    with span("step.all_reduce"):
                        grads_d = group.all_reduce_mean(grads_d)
                metrics.update(_detached(m))
                with span("step.d_update"):
                    opt_d.step(params_d, grads_d)
            state.steps += 1
            if group is not None:
                with span("step.all_reduce"):
                    metrics = group.mean_metrics(metrics)
            return state, metrics

        return step

    @torch.no_grad()
    def eval_step(state: GANTrainState, batch: Batch, use_adv: bool = True,
                  rng: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        check_rng(rng)
        batch = prepare_batch(batch)
        _, metrics, y_hat, _ = gen_losses(state.params_g, state.params_d,
                                          batch, use_adv, rng)
        if use_adv:
            metrics.update(
                dis_losses(state.params_d, batch["y"], y_hat, False, rng)[1])
        return metrics

    return train_step_factory, eval_step
