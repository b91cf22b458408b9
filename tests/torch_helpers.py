"""Shared pieces of the port's JAX-side tests (tests/test_torch_*.py): model
widths, the small HiFi-GAN train recipe, the helpers that put one train
state into both packages and compare what a step did to each, the
perturbation of a MelGAN tree, and a stand-in for the ``jax`` name of a
JAX-package module that hands out given random draws."""

import numpy as np


def flax_generator_kwargs(**overrides):
    """The small PWG config of tests/test_pallas_kernels.py."""
    kw = dict(
        layers=12, stacks=2, residual_channels=16, gate_channels=32,
        skip_channels=16, aux_channels=20, aux_context_window=2,
        upsample_params={"upsample_scales": [2, 2]},
    )
    kw.update(overrides)
    return kw


PWG_V1_KWARGS = dict(
    layers=30, stacks=3, residual_channels=64, gate_channels=128,
    skip_channels=64, aux_channels=80, aux_context_window=2,
    upsample_params={"upsample_scales": [4, 4, 4, 4]},
)


def small_hifigan_train_config(**overrides):
    """The small HiFi-GAN v1 recipe of tests/test_trainer.py
    (test_hifigan_training_with_msmpd) with the optimizers, losses and EMA
    of assets/quality/config.yml: both sides of the HiFi-GAN step tests
    build from this one dict. One departure: Adam's eps is 1e-3, not the
    default 1e-8, so that an update stays a continuous function of the
    gradient where the gradient is rounding noise (with 1e-8 the first
    update is lr * sign(g), and the two packages' parameters part by 2 lr
    wherever a near-zero gradient rounds to another sign)."""
    config = {
        "sampling_rate": 16000, "hop_size": 64, "num_mels": 16,
        "batch_max_steps": 512, "batch_size": 3, "format": "npy",
        "generator_type": "HiFiGANGenerator",
        "generator_params": {
            "in_channels": 16, "channels": 32, "upsample_scales": (4, 4, 4),
            "upsample_kernel_sizes": (8, 8, 8),
            "resblock_kernel_sizes": (3,), "resblock_dilations": ((1, 3),),
        },
        "discriminator_type": "HiFiGANMultiScaleMultiPeriodDiscriminator",
        "discriminator_params": {
            "scales": 2,
            "scale_discriminator_params": {
                "channels": 8, "downsample_scales": (2, 2), "max_groups": 4,
                "max_downsample_channels": 32,
            },
            "follow_official_norm": True,
            "periods": (2, 3),
            "period_discriminator_params": {
                "channels": 4, "downsample_scales": (3, 1),
                "max_downsample_channels": 16,
            },
        },
        "use_stft_loss": False,
        "use_mel_loss": True,
        "mel_loss_params": {
            "fs": 16000, "fft_size": 128, "hop_size": 32, "win_length": 128,
            "num_mels": 16, "fmin": 0, "fmax": 8000, "log_base": None,
        },
        "use_feat_match_loss": True,
        "feat_match_loss_params": {
            "average_by_discriminators": False, "average_by_layers": False,
            "include_final_outputs": False,
        },
        "generator_adv_loss_params": {"average_by_discriminators": False},
        "discriminator_adv_loss_params": {"average_by_discriminators": False},
        "lambda_aux": 45.0, "lambda_adv": 1.0, "lambda_feat_match": 2.0,
        "generator_optimizer_type": "Adam",
        "generator_optimizer_params": {"lr": 2e-4, "betas": (0.5, 0.9),
                                       "eps": 1e-3, "weight_decay": 0.0},
        "generator_scheduler_type": "MultiStepLR",
        "generator_scheduler_params": {"gamma": 0.5, "milestones": [3, 6]},
        "generator_grad_norm": -1,
        "discriminator_optimizer_type": "Adam",
        "discriminator_optimizer_params": {"lr": 2e-4, "betas": (0.5, 0.9),
                                           "eps": 1e-3, "weight_decay": 0.0},
        "discriminator_scheduler_type": "MultiStepLR",
        "discriminator_scheduler_params": {"gamma": 0.5,
                                           "milestones": [3, 6]},
        "discriminator_grad_norm": -1,
        "generator_ema_decay": 0.999,
        "generator_train_start_steps": 1,
        "discriminator_train_start_steps": 0,
    }
    config.update(overrides)
    return config


def perturbed(tree, rng):
    """Weight-norm g starts at ||v|| and the biases at zero: move them."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) * (1 + 0.2 * rng.standard_normal(
            a.shape)) + 0.02 * rng.standard_normal(a.shape), a.dtype), tree)


def load_jax_state(state, generator, discriminator):
    """Load a JAX train state's parameters (and spectral-norm vectors) into
    the port's trainable modules, strictly."""
    import jax

    from parallelwavegan_torch.utils.params import convert_jax_params

    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    generator.load_state_dict(
        convert_jax_params(as_np(state.params_g), fold=False), strict=True)
    discriminator.load_state_dict(
        convert_jax_params(as_np(state.params_d), fold=False,
                           spectral=as_np(state.extra_d).get("spectral")),
        strict=True)


def both_train_states(config, seed=0, mesh=None):
    """(JAX state, JAX (factory, eval_step), port state, port (factory,
    eval_step)) on the same perturbed parameters; the port on the CPU. A
    ``mesh`` builds the JAX steps data-parallel over it (``shard_map``)."""
    import jax

    from parallelwavegan_tpu.engine.build import (
        init_train_state as jax_init_train_state,
    )
    from parallelwavegan_tpu.engine.criterion import (
        build_criterion as jax_build_criterion,
    )
    from parallelwavegan_tpu.engine.step import build_steps as jax_build_steps
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.criterion import build_criterion
    from parallelwavegan_torch.engine.step import build_steps

    rng = np.random.default_rng(seed)
    state, gen, dis, opt_g, opt_d = jax_init_train_state(
        config, jax.random.key(seed))
    params_g = perturbed(state.params_g, rng)
    params_d = perturbed(state.params_d, rng)
    state = state.replace(params_g=params_g, opt_g=opt_g.init(params_g),
                          params_d=params_d, opt_d=opt_d.init(params_d))
    if state.ema_g is not None:
        state = state.replace(ema_g=jax.tree.map(lambda a: a + 0, params_g))
    jax_steps = jax_build_steps(config, gen, dis, jax_build_criterion(config),
                                opt_g, opt_d, mesh=mesh)
    t_state, t_gen, t_dis, t_opt_g, t_opt_d = init_train_state(
        config, seed, device="cpu")
    load_jax_state(state, t_gen, t_dis)
    if t_state.ema_g is not None:
        t_state.seed_ema()
    steps = build_steps(config, t_gen, t_dis, build_criterion(config),
                        t_opt_g, t_opt_d)
    return state, jax_steps, t_state, steps


def port_first_train_states(config, seed=0, unit_g=False):
    """What ``both_train_states`` returns, with both states built from the
    port's init: the JAX state holds the port's parameters (perturbed as
    there) under the flax names, its spectral vectors, its EMA copies, and
    the optimizer states the JAX optimizers' own ``init`` makes. The JAX
    package's ``init_train_state`` runs flax's init op by op, compiling
    each parameter shape apart: about 40 s for the small UHiFiGAN recipe,
    whose U-Net has many conv shapes. ``unit_g`` sets the generator's
    weight-norm g to 1 before the perturbation (kernels of unit norm a
    channel: at the init's N(0, 0.01) a HiFi-GAN trunk's wave sits near
    1e-3, where the mel loss's clamps decide its gradients)."""
    import jax
    import jax.numpy as jnp

    from parallelwavegan_tpu.engine.build import (
        build_models as jax_build_models,
    )
    from parallelwavegan_tpu.engine.criterion import (
        build_criterion as jax_build_criterion,
    )
    from parallelwavegan_tpu.engine.state import GANTrainState as JaxState
    from parallelwavegan_tpu.engine.step import build_steps as jax_build_steps
    from parallelwavegan_tpu.optimizers import build_optimizer
    from parallelwavegan_torch.engine.build import init_train_state
    from parallelwavegan_torch.engine.criterion import build_criterion
    from parallelwavegan_torch.engine.step import build_steps
    from parallelwavegan_torch.utils.params import nested

    t_state, t_gen, t_dis, t_opt_g, t_opt_d = init_train_state(
        config, seed, device="cpu")
    if unit_g:
        import torch

        with torch.no_grad():
            for name, p in t_gen.named_parameters():
                if name.endswith("kernel_g"):
                    p.fill_(1.0)
    rng = np.random.default_rng(seed)

    def tree(named):
        return jax.tree.map(jnp.asarray, nested(
            {k: v.detach().numpy() for k, v in named}))

    params_g = perturbed(tree(t_gen.named_parameters()), rng)
    params_d = perturbed(tree(t_dis.named_parameters()), rng)
    buffers = dict(t_dis.named_buffers())
    extra_d = {"spectral": tree(buffers.items())} if buffers else {}

    def optimizer(prefix):
        return build_optimizer(
            config.get(f"{prefix}_optimizer_type", "RAdam"),
            config.get(f"{prefix}_optimizer_params", {}),
            config.get(f"{prefix}_scheduler_type", "StepLR"),
            config.get(f"{prefix}_scheduler_params", {}),
            config.get(f"{prefix}_grad_norm", -1))

    opt_g, opt_d = optimizer("generator"), optimizer("discriminator")
    ema = float(config.get("generator_ema_decay", 0.0) or 0.0) > 0.0
    state = JaxState(
        steps=jnp.asarray(0, jnp.int32), params_g=params_g, extra_g={},
        opt_g=opt_g.init(params_g), params_d=params_d, extra_d=extra_d,
        opt_d=opt_d.init(params_d),
        ema_g=jax.tree.map(lambda a: a + 0, params_g) if ema else None)
    gen, dis = jax_build_models(config)
    jax_steps = jax_build_steps(config, gen, dis, jax_build_criterion(config),
                                opt_g, opt_d)
    load_jax_state(state, t_gen, t_dis)
    if t_state.ema_g is not None:
        t_state.seed_ema()
    steps = build_steps(config, t_gen, t_dis, build_criterion(config),
                        t_opt_g, t_opt_d)
    return state, jax_steps, t_state, steps


def sine_batch(config, seed=1):
    """The JAX package's example batch with sines plus noise as y."""
    from parallelwavegan_tpu.engine.build import example_batch

    batch = example_batch(config, batch_size=config["batch_size"])
    rng = np.random.default_rng(seed)
    t = np.arange(batch["y"].shape[1]) / config["sampling_rate"]
    batch["y"] = np.stack([
        0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t)
        + 0.02 * rng.standard_normal(t.shape)
        for i in range(config["batch_size"])
    ]).astype(np.float32)[..., None]
    return batch


def as_jax(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def flat_jax(tree):
    """A flax parameter tree as {dotted name: numpy array}."""
    import jax

    from parallelwavegan_torch.utils.params import convert_jax_params

    return {k: v.numpy() for k, v in convert_jax_params(
        jax.tree.map(np.asarray, tree), fold=False).items()}


def assert_losses(metrics, ref, names, rtol):
    assert sorted(metrics) == sorted(ref) == sorted(names)
    for name in names:
        np.testing.assert_allclose(float(metrics[name]), float(ref[name]),
                                   rtol=rtol, err_msg=name)


def assert_tensors(got, tree, atol, what):
    """{name: tensor} against a flax tree of the same names."""
    want = flat_jax(tree)
    got = {k: v.detach().numpy() for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol,
                                   err_msg=f"{what} {key}")


def assert_params(module, tree, atol, what):
    assert_tensors(dict(module.named_parameters()), tree, atol, what)


def assert_first_moment(opt, jax_opt_state, what, rel=1e-3, floor=1e-6):
    """After the first update mu = (1 - b1) * clipped gradient, so this
    holds the gradients themselves: each to ``rel`` of its largest entry
    plus ``floor`` of the largest gradient in the network. The gradients of
    kernel_v are differences of nearly equal terms (the kernel does not
    change along v), and they go through a log and a division by small
    spectral magnitudes in f32."""
    from parallelwavegan_torch.utils.params import convert_jax_params

    def find_mu(node):
        """The first moments, wherever the chain keeps them (its layout
        depends on whether the gradients are clipped)."""
        if hasattr(node, "mu"):
            return node.mu
        if isinstance(node, dict) and "mu" in node:
            return node["mu"]
        children = node.values() if isinstance(node, dict) else (
            node if isinstance(node, (tuple, list)) else ())
        for child in children:
            found = find_mu(child)
            if found is not None:
                return found
        return None

    got = find_mu(opt.state_dict())
    want = flat_jax(find_mu(jax_opt_state))
    got = {k: v.numpy() for k, v in convert_jax_params(got, fold=False).items()}
    assert sorted(got) == sorted(want)
    largest = max(np.abs(b).max() for b in want.values())
    assert largest > 0
    for key, b in want.items():
        err = np.abs(got[key] - b).max()
        assert err <= rel * np.abs(b).max() + floor * largest, (what, key, err)


def tf32_round(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away
    from zero, keeping 10 of f32's 23 mantissa bits (float32 in and out)."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32x3_matmul(a, b):
    """a @ b as the f32 tensor-core bodies form it: each operand
    split as hi = tf32(x) and lo = x - hi, which the tensor core truncates
    to TF32 (it ignores the low 13 bits), and lo_a hi_b + hi_a lo_b +
    hi_a hi_b summed (here in float64)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_truncate(a - a_hi), tf32_truncate(b - b_hi)
    f = lambda v: v.astype(np.float64)  # noqa: E731
    return (f(a_lo) @ f(b_hi) + f(a_hi) @ f(b_lo)) + f(a_hi) @ f(b_hi)


def tf32_truncate(x):
    """x with its low 13 mantissa bits cleared: how a TF32 tensor-core
    product reads an f32 operand."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def melgan_perturbed(variables, seed=0):
    """Move every leaf of a flax tree off its init. Weight-norm g becomes
    1 + 0.3 N(0, 1): with MelGAN's N(0, 0.02) kernels each conv would
    shrink its input about threefold, and the generator's output would
    vanish."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        noise = rng.standard_normal(a.shape)
        if path[-1].key == "kernel_g":
            return jnp.asarray(1 + 0.3 * noise, a.dtype)
        return jnp.asarray(a * (1 + 0.3 * noise) + 0.05 * noise, a.dtype)

    return jax.tree_util.tree_map_with_path(move, variables)


_SMALL_STFT = {"fft_sizes": [128, 256, 64], "hop_sizes": [16, 32, 8],
               "win_lengths": [64, 128, 32], "window": "hann_window"}
_SMALL_MSD = {
    "scales": 2, "downsample_pooling": "AvgPool1d",
    "downsample_pooling_params": {"kernel_size": 4, "stride": 2,
                                  "padding": 1, "count_include_pad": False},
    "kernel_sizes": [5, 3], "channels": 4, "downsample_scales": [4, 4],
    "nonlinear_activation": "LeakyReLU",
    "nonlinear_activation_params": {"negative_slope": 0.2},
}


def small_melgan_train_config(kind, **overrides):
    """Small recipes of the three shapes that train with the MelGAN family
    or its discriminator, at hop 64 and 1,024-sample windows:

    - ``mb_melgan``: multi_band_melgan.v2.yaml's shape (4 subbands through
      PQMF, the multi-scale MelGAN discriminator, the subband STFT loss,
      lambda_adv 2.5, Adam + MultiStepLR);
    - ``melgan_v1``: melgan.v1.yaml's (the full-band MelGAN generator
      against the Parallel WaveGAN discriminator, RAdam + StepLR);
    - ``pwg_v3``: parallel_wavegan.v3.yaml's (the Parallel WaveGAN
      generator with kernel size 5 against the multi-scale MelGAN
      discriminator, feature matching x 25), per-layer
      (``fused_wavenet: false``).

    Adam's eps is 1e-3, not the recipe's 1e-7, for the reason
    ``small_hifigan_train_config`` gives, and its rate 1e-4, not 1e-3: the
    kernel_v gradients carry rounding of up to 1e-3 of their size (the log
    of small STFT magnitudes), which an update of lr g / (|g| + eps) passes
    on to the parameters at lr times that."""
    config = {
        "sampling_rate": 16000, "hop_size": 64, "num_mels": 16,
        "batch_max_steps": 1024, "batch_size": 2, "format": "npy",
        "stft_loss_params": dict(_SMALL_STFT),
        "discriminator_train_start_steps": 0,
    }
    if kind == "mb_melgan":
        adam = {"lr": 1e-4, "eps": 1e-3, "weight_decay": 0.0}
        multistep = {"gamma": 0.5, "milestones": [3, 6]}
        config.update({
            "generator_type": "MelGANGenerator",
            "generator_params": {
                "in_channels": 16, "out_channels": 4, "kernel_size": 7,
                "channels": 32, "upsample_scales": [4, 4],
                "stack_kernel_size": 3, "stacks": 2, "use_weight_norm": True,
                "use_causal_conv": False,
            },
            "discriminator_type": "MelGANMultiScaleDiscriminator",
            "discriminator_params": dict(_SMALL_MSD,
                                         max_downsample_channels=16),
            "use_subband_stft_loss": True,
            "subband_stft_loss_params": {
                "fft_sizes": [64, 128, 32], "hop_sizes": [8, 16, 4],
                "win_lengths": [32, 64, 16], "window": "hann_window"},
            "use_feat_match_loss": False,
            "lambda_adv": 2.5,
            "generator_optimizer_type": "Adam",
            "generator_optimizer_params": dict(adam),
            "generator_scheduler_type": "MultiStepLR",
            "generator_scheduler_params": dict(multistep),
            "generator_grad_norm": -1,
            "discriminator_optimizer_type": "Adam",
            "discriminator_optimizer_params": dict(adam),
            "discriminator_scheduler_type": "MultiStepLR",
            "discriminator_scheduler_params": dict(multistep),
            "discriminator_grad_norm": -1,
        })
    elif kind == "melgan_v1":
        config.update({
            "generator_type": "MelGANGenerator",
            "generator_params": {
                "in_channels": 16, "out_channels": 1, "kernel_size": 7,
                "channels": 64, "upsample_scales": [8, 8],
                "stack_kernel_size": 3, "stacks": 2, "use_weight_norm": True,
            },
            "discriminator_type": "ParallelWaveGANDiscriminator",
            "discriminator_params": {"layers": 4, "conv_channels": 8},
            "lambda_adv": 4.0,
            "generator_optimizer_params": {"lr": 1e-4, "eps": 1e-6},
            "generator_grad_norm": 10,
            "discriminator_optimizer_params": {"lr": 5e-5, "eps": 1e-6},
            "discriminator_grad_norm": 1,
        })
    elif kind == "pwg_v3":
        config.update({
            "generator_type": "ParallelWaveGANGenerator",
            "generator_params": dict(flax_generator_kwargs(
                layers=4, stacks=2, kernel_size=5, residual_channels=8,
                gate_channels=16, skip_channels=8, aux_channels=16,
                upsample_params={"upsample_scales": [4, 4, 4]})),
            "discriminator_type": "MelGANMultiScaleDiscriminator",
            "discriminator_params": dict(_SMALL_MSD,
                                         max_downsample_channels=32,
                                         use_weight_norm=True),
            "use_feat_match_loss": True,
            "lambda_feat_match": 25.0,
            "lambda_adv": 4.0,
            "generator_optimizer_params": {"lr": 1e-4, "eps": 1e-6},
            "generator_grad_norm": 10,
            "discriminator_optimizer_params": {"lr": 5e-5, "eps": 1e-6},
            "discriminator_grad_norm": 1,
            "fused_wavenet": False,
        })
    else:
        raise ValueError(kind)
    config.update(overrides)
    return config


class _RandomDraws:
    def __init__(self, normals, ints, uniforms=()):
        import jax

        self._random = jax.random
        self.normals, self.ints = list(normals), list(ints)
        self.uniforms = list(uniforms)

    def normal(self, key, shape, dtype=None):
        import jax.numpy as jnp

        a = np.asarray(self.normals.pop(0))
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    def randint(self, key, shape, minval, maxval):
        """An int for shape (), an int array of ``shape`` otherwise."""
        import jax.numpy as jnp

        v = self.ints.pop(0)
        a = np.asarray(v)
        assert a.shape == tuple(shape) or (a.ndim == 0 and shape == ()), (
            a.shape, shape)
        assert (minval <= a).all() and (a < max(maxval, minval + 1)).all(), (
            v, minval, maxval)
        return v if a.ndim == 0 else jnp.asarray(a, jnp.int32)

    def uniform(self, key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        import jax.numpy as jnp

        a = np.asarray(self.uniforms.pop(0))
        assert a.shape == tuple(shape), (a.shape, shape)
        assert (minval <= a).all() and (a < maxval).all(), (minval, maxval)
        return jnp.asarray(a, dtype or jnp.float32)

    def __getattr__(self, name):
        return getattr(self._random, name)


class JaxDraws:
    """Stands in for the ``jax`` name of a JAX-package module (set with
    ``monkeypatch.setattr``): ``random.normal``, ``random.randint`` and
    ``random.uniform`` hand out ``normals``, ``ints`` and ``uniforms`` in
    call order (asserting the shape and the range), everything else is
    jax's. Under ``jax.jit`` the draws are read when the function is
    traced."""

    def __init__(self, normals=(), ints=(), uniforms=()):
        import jax

        self._jax = jax
        self.random = _RandomDraws(normals, ints, uniforms)

    def __getattr__(self, name):
        return getattr(self._jax, name)


def small_style_melgan_train_config(**overrides):
    """style_melgan.v1.yaml's shape at hop 16: the TADE generator on a
    noise grid of 8 frames (noise scales 4, 2; upsample scales 2, 2, 2, 2,
    1), the random-window discriminator (2 repeats of windows of 32 to 256
    samples through PQMF at 1, 2, 4 and 8 subbands, MelGAN
    sub-discriminators of 8 channels), the STFT and the MSE adversarial
    loss with lambda_adv 1, Adam + MultiStepLR, the discriminator from step
    0. Windows of 384 samples = 24 frames = 3 noise frames, so that every
    window start is drawn. Adam's eps is 1e-3, for the reason
    ``small_hifigan_train_config`` gives."""
    adam = {"lr": 1e-4, "betas": (0.5, 0.9), "eps": 1e-3,
            "weight_decay": 0.0}
    config = {
        "sampling_rate": 8000, "hop_size": 16, "num_mels": 16,
        "batch_max_steps": 384, "batch_size": 2, "format": "npy",
        "generator_type": "StyleMelGANGenerator",
        "generator_params": {
            "in_channels": 16, "aux_channels": 16, "channels": 16,
            "kernel_size": 9, "dilation": 2, "noise_upsample_scales": [4, 2],
            "upsample_scales": [2, 2, 2, 2, 1], "gated_function": "softmax",
            "use_weight_norm": True,
        },
        "discriminator_type": "StyleMelGANDiscriminator",
        "discriminator_params": {
            "repeats": 2, "window_sizes": [32, 64, 128, 256],
            "pqmf_params": [[1, None, None, None], [2, 62, 0.267, 9.0],
                            [4, 62, 0.142, 9.0], [8, 62, 0.07949, 9.0]],
            "discriminator_params": {
                "out_channels": 1, "kernel_sizes": [5, 3], "channels": 8,
                "max_downsample_channels": 32, "downsample_scales": [4, 1],
                "pad": "ReflectionPad1d", "pad_params": {},
            },
            "use_weight_norm": True,
        },
        "stft_loss_params": {"fft_sizes": [64, 128, 32],
                             "hop_sizes": [8, 16, 4],
                             "win_lengths": [32, 64, 16],
                             "window": "hann_window"},
        "lambda_aux": 1.0, "lambda_adv": 1.0,
        "generator_adv_loss_params": {"average_by_discriminators": False},
        "discriminator_adv_loss_params": {"average_by_discriminators": False},
        "generator_optimizer_type": "Adam",
        "generator_optimizer_params": dict(adam),
        "generator_scheduler_type": "MultiStepLR",
        "generator_scheduler_params": {"gamma": 0.5, "milestones": [3, 6]},
        "generator_grad_norm": -1,
        "discriminator_optimizer_type": "Adam",
        "discriminator_optimizer_params": dict(adam, lr=2e-4),
        "discriminator_scheduler_type": "MultiStepLR",
        "discriminator_scheduler_params": {"gamma": 0.5,
                                           "milestones": [3, 6]},
        "discriminator_grad_norm": -1,
        "generator_train_start_steps": 0,
        "discriminator_train_start_steps": 0,
    }
    config.update(overrides)
    return config


def small_uhifigan_train_config(**overrides):
    """egs/opencpop/voc1/conf/uhifigan.v1.yaml's shape at hop 16: the U-Net
    of 4 channels (downsampling 4 x 4, upsampling 4 x 4, one residual
    block of kernel 3 with dilations 1 and 3, dropout 0.1), the
    multi-scale multi-period discriminator, the STFT, mel and
    feature-matching losses with lambda_aux 45, the generator from step 1
    and the discriminator from step 0, Adam + MultiStepLR, no EMA (the
    recipe keeps none), on ``small_hifigan_train_config``'s discriminator,
    mel loss and optimizers. The generator's Adam takes eps 100: its
    gradients at this init reach 1e3 (45 x the mel L1 through the U-Net),
    so with eps 1e-3 its first update is lr * sign(g), and wherever a
    gradient lies within the two packages' rounding of 0 (differences of
    up to 5e-2 on entries of 1e2, measured) the parameters part by 2 lr;
    with eps 100 the update is a continuous function of the gradient."""
    config = small_hifigan_train_config(
        generator_type="UHiFiGANGenerator",
        generator_params={
            "in_channels": 16, "out_channels": 1, "channels": 4,
            "kernel_size": 7, "downsample_scales": (4, 4),
            "downsample_kernel_sizes": (8, 8), "upsample_scales": (4, 4),
            "upsample_kernel_sizes": (8, 8), "resblock_kernel_sizes": (3,),
            "resblock_dilations": ((1, 3),), "dropout": 0.1,
        },
        hop_size=16, batch_size=2, use_stft_loss=True,
        stft_loss_params={"fft_sizes": [64, 128, 32],
                          "hop_sizes": [8, 16, 4],
                          "win_lengths": [32, 64, 16],
                          "window": "hann_window"},
    )
    del config["generator_ema_decay"]
    config["generator_optimizer_params"] = dict(
        config["generator_optimizer_params"], eps=100.0)
    config.update(overrides)
    return config


class FlaxMasks:
    """Stands in for ``flax.linen.stochastic.random`` (set with
    ``monkeypatch.setattr``): ``bernoulli`` hands out ``masks`` (flax
    dropout's keep masks) in call order, asserting each shape; everything
    else is ``jax.random``'s. Under ``jax.jit`` the masks are read when the
    function is traced."""

    def __init__(self, masks):
        self.masks = [np.asarray(m) for m in masks]

    def bernoulli(self, key, p, shape):
        import jax.numpy as jnp

        mask = self.masks.pop(0)
        assert mask.shape == tuple(shape), (mask.shape, shape)
        return jnp.asarray(mask)

    def __getattr__(self, name):
        import jax

        return getattr(jax.random, name)


def small_vqvae_train_config(cond="none", **overrides):
    """conditioned_melgan_vae.v3.yaml's shape at 8 kHz, hop 16 and
    512-sample windows: an encoder tower of 8 to 16 channels downsampling
    16 times (the hop, so that a local condition's frames are the latent
    frames), a codebook of 16 x 8, a MelGAN decoder of 16 channels
    upsampling 16 times, the multi-scale MelGAN discriminator with feature
    matching x 25, lambda_commit 0.25, lambda_adv 4, the discriminator from
    step 0. ``cond``: "none"; "global" (4 speakers x 4 dims, the VCTK
    recipe's condition); "local" (local_conditioned_melgan_vae.v3.yaml's:
    a 2-channel local condition through a 1x1 conv to 3 dims, and the
    speakers). Adam with eps 1e-3 and lr 1e-4, for the reasons
    ``small_melgan_train_config`` gives. The STFT loss takes its framed
    product (``method: matmul``, the port's CUDA route) in both packages:
    the unconditioned reconstruction has spectral bins at the power clamp
    (1e-7), where the log-magnitude gradient 1 / (2 power) turns the f32
    rounding of the CPU FFT into errors of 1e-2 of the gradient (the
    port's FFT route against its float64 one; the framed product stays
    within 7e-5), and the two packages' FFTs round differently."""
    gp = {
        "in_channels": 1, "out_channels": 1, "num_embeds": 16,
        "embed_dim": 8,
        "encoder_conf": {"out_channels": 8, "downsample_scales": [4, 4],
                         "max_downsample_channels": 16, "channels": 8},
        "decoder_conf": {"in_channels": 8, "upsample_scales": [4, 4],
                         "channels": 16, "stacks": 1},
    }
    config = {
        "sampling_rate": 8000, "hop_size": 16, "num_mels": 16,
        "batch_max_steps": 512, "batch_size": 2, "format": "npy",
        "generator_type": "VQVAE", "generator_params": gp,
        "discriminator_type": "MelGANMultiScaleDiscriminator",
        "discriminator_params": dict(_SMALL_MSD, max_downsample_channels=16,
                                     use_weight_norm=True),
        "stft_loss_params": {"fft_sizes": [64, 128, 32],
                             "hop_sizes": [8, 16, 4],
                             "win_lengths": [32, 64, 16],
                             "window": "hann_window", "method": "matmul"},
        "use_feat_match_loss": True, "lambda_feat_match": 25.0,
        "lambda_commit": 0.25, "lambda_adv": 4.0,
        "generator_optimizer_type": "Adam",
        "generator_optimizer_params": {"lr": 1e-4, "eps": 1e-3},
        "generator_grad_norm": 10,
        "discriminator_optimizer_type": "Adam",
        "discriminator_optimizer_params": {"lr": 1e-4, "eps": 1e-3},
        "discriminator_grad_norm": 1,
        "discriminator_train_start_steps": 0,
    }
    if cond in ("global", "local"):
        config["use_global_condition"] = True
        gp.update(num_global_embeds=4, global_embed_dim=4)
        gp["decoder_conf"]["in_channels"] += 4
    if cond == "local":
        config["use_local_condition"] = True
        gp.update(num_local_embeds=2, local_embed_dim=3)
        gp["decoder_conf"]["in_channels"] += 3
    elif cond not in ("none", "global"):
        raise ValueError(cond)
    config.update(overrides)
    return config


def seed_codebook(variables, z_e, seed=0):
    """A flax VQVAE tree whose codebook rows are latents of z_e (B, T', D),
    drawn without replacement, as a dead-code restart would seed them: at
    the U(+-1/K) init one or two codes win every assignment."""
    import jax
    import jax.numpy as jnp

    flat = np.asarray(z_e, np.float32).reshape(-1, np.shape(z_e)[-1])
    emb = variables["params"]["codebook"]["embedding"]
    rows = np.random.default_rng(seed).choice(len(flat), emb.shape[0],
                                              replace=len(flat) < emb.shape[0])
    variables = jax.tree.map(lambda a: a, variables)
    variables["params"]["codebook"]["embedding"] = jnp.asarray(flat[rows])
    return variables


def assert_codes(got, want, z_e, embedding, rel=1e-5):
    """Codes (B, T') of two routes: equal, but at a near-tie
    (``layers.vq.code_gaps`` below ``rel``). Returns the number of codes
    that differ."""
    import torch

    from parallelwavegan_torch.layers.vq import code_gaps

    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    near_tie = code_gaps(torch.from_numpy(np.array(z_e, np.float64)),
                         torch.from_numpy(np.array(embedding, np.float64))
                         ).numpy() < rel
    differ = got.reshape(-1) != want.reshape(-1)
    assert not (differ & ~near_tie).any(), (
        f"{int((differ & ~near_tie).sum())} codes differ away from a tie")
    return int(differ.sum())
