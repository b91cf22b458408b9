"""Build models, optimizers and the initial train state from a
(reference-compatible) config.

Counterpart of ``parallelwavegan_tpu/engine/build.py`` for Parallel WaveGAN,
HiFi-GAN, MelGAN, StyleMelGAN, the VQ-VAE, UHiFiGAN and the four
discrete-symbol generators; other families raise ``NotImplementedError``
(from the model registry). A duration generator's ``max_reg_len`` is pinned
to the training window's frames (``batch_max_steps // hop_size``), as in
the JAX package: a window's tokens regulate to exactly its frames. The
models are built in their training form (``kernel_v``/``kernel_g``),
initialised from a seeded ``torch.Generator`` on the CPU and then moved to
the device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from parallelwavegan_torch.engine.state import GANTrainState
from parallelwavegan_torch.engine.step import uses_f0, uses_noise
from parallelwavegan_torch.models import DISCRETE_GENERATORS, get_model_class
from parallelwavegan_torch.optimizers import Optimizer, build_optimizer
from parallelwavegan_torch.utils.model_loader import resolve_device


_GENERATORS = ("ParallelWaveGANGenerator", "HiFiGANGenerator",
               "MelGANGenerator", "StyleMelGANGenerator", "VQVAE",
               "UHiFiGANGenerator") + DISCRETE_GENERATORS


def build_models(config: Dict[str, Any], generator: torch.Generator = None):
    """(generator, discriminator) modules in their training form, on the
    CPU. ``generator`` is the random source of the initializers."""
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    dis_type = config.get("discriminator_type", "ParallelWaveGANDiscriminator")
    if gen_type not in _GENERATORS:
        raise NotImplementedError(f"unknown generator: {gen_type}")
    gen_params = dict(config.get("generator_params", {}))
    # reference back-compat: the upsample_kernal_sizes typo
    if "upsample_kernal_sizes" in gen_params:
        gen_params["upsample_kernel_sizes"] = gen_params.pop(
            "upsample_kernal_sizes")
    if "Duration" in gen_type and "hop_size" in config:
        steps = config.get("batch_max_steps", 8192)
        gen_params["max_reg_len"] = (steps - steps % config["hop_size"]) \
            // config["hop_size"]
    gen = get_model_class(gen_type)(
        **gen_params, folded=False, generator=generator,
    )
    dis = get_model_class(dis_type)(
        **config.get("discriminator_params", {}), folded=False,
        generator=generator,
    )
    return gen, dis


def example_batch(config: Dict[str, Any], batch_size: int = 2
                  ) -> Dict[str, np.ndarray]:
    """Tiny batch with the training shapes, for dry runs. Noise z goes to
    the generators the step gives it to: Parallel WaveGAN and any config
    with ``use_noise_input`` (the JAX package's batch gives it to Parallel
    WaveGAN alone, and its step then fails on the missing z); StyleMelGAN
    draws its own in the step. A VQ-VAE's batch is y with, as the config
    asks, speaker ids g (zeros) and a local condition l of
    ``num_local_embeds`` (or 2) channels at one frame a hop, as in the
    JAX package. UHiFiGAN's adds an excitation (B, T, 1) and an f0
    (B, T', 1) of |N(0, 1)|, drawn after c (and z) as there. A discrete
    generator's c is int32 ones of (B, T', 2), or (B, T', 1) without
    speakers (the JAX batch is always 2 wide, so the JAX init of a recipe
    without speakers fails its assert); a duration generator's adds ds,
    ones (B, T'); the F0 generator's an f0 (B, T', 1) of |N(0, 1)| (the
    JAX batch returns before its f0, so its init builds no f0_embedding)."""
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    if gen_type not in _GENERATORS:
        raise NotImplementedError(f"unknown generator: {gen_type}")
    gp = config.get("generator_params", {})
    hop = config.get("hop_size", 256)
    steps = config.get("batch_max_steps", 8192)
    steps -= steps % hop
    frames = steps // hop
    ctx = gp.get("aux_context_window", 0)
    num_mels = config.get("num_mels", gp.get("aux_channels", 80))
    rng = np.random.default_rng(0)
    f32 = np.float32
    batch = {
        "y": rng.standard_normal((batch_size, steps, 1)).astype(f32) * 0.1}
    if "DiscreteSymbol" in gen_type:
        cols = 2 if gp.get("num_spk_embs", 128) > 0 else 1
        batch["c"] = np.ones((batch_size, frames, cols), np.int32)
        if "Duration" in gen_type:
            batch["ds"] = np.ones((batch_size, frames), np.int32)
        if uses_f0(config):
            batch["f0"] = np.abs(rng.standard_normal(
                (batch_size, frames, 1))).astype(f32)
        return batch
    if gen_type == "VQVAE":
        if config.get("use_global_condition", False):
            batch["g"] = np.zeros((batch_size,), np.int32)
        if config.get("use_local_condition", False):
            batch["l"] = rng.standard_normal(
                (batch_size, frames, gp.get("num_local_embeds") or 2)
            ).astype(f32)
        return batch
    batch["c"] = rng.standard_normal(
        (batch_size, frames + 2 * ctx, num_mels)).astype(f32)
    if uses_noise(config):
        batch["z"] = rng.standard_normal(
            (batch_size, steps, gp.get("in_channels", 1))).astype(f32)
    if gen_type == "UHiFiGANGenerator":
        batch["excitation"] = rng.standard_normal(
            (batch_size, steps, 1)).astype(f32)
        batch["f0"] = np.abs(
            rng.standard_normal((batch_size, frames, 1))).astype(f32)
    return batch


def _optimizer(config: Dict[str, Any], prefix: str) -> Optimizer:
    return build_optimizer(
        config.get(f"{prefix}_optimizer_type", "RAdam"),
        config.get(f"{prefix}_optimizer_params", {}),
        config.get(f"{prefix}_scheduler_type", "StepLR"),
        config.get(f"{prefix}_scheduler_params", {}),
        config.get(f"{prefix}_grad_norm", -1),
    )


def init_train_state(config: Dict[str, Any], seed: int = 0,
                     device: Any = "cuda"
                     ) -> Tuple[GANTrainState, Any, Any, Optimizer, Optimizer]:
    """Initialize (state, generator, discriminator, opt_g, opt_d) on
    ``device`` (cuda unless the caller asks for the cpu)."""
    device = resolve_device(device)
    generator, discriminator = build_models(
        config, torch.Generator().manual_seed(seed))
    generator.to(device).train()
    discriminator.to(device).train()
    opt_g = _optimizer(config, "generator")
    opt_d = _optimizer(config, "discriminator")
    state = GANTrainState(
        steps=0, generator=generator, discriminator=discriminator,
        opt_g=opt_g, opt_d=opt_d,
    )
    opt_g.init(state.params_g)
    opt_d.init(state.params_d)
    if float(config.get("generator_ema_decay", 0.0) or 0.0) > 0.0:
        # real copies of the initial parameters; a resume or a legacy
        # checkpoint reseeds them (engine.checkpoint)
        state.seed_ema()
    return state, generator, discriminator, opt_g, opt_d
