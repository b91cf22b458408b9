"""MB-MelGAN's first moments on the port's init (ROADMAP C-6), explained.

Two G steps of the small multi-band MelGAN recipe
(``torch_helpers.small_melgan_train_config("mb_melgan", batch_size=4)``),
both states from the port's init (``port_first_train_states``), put a few
of G's first moments of the port 2-6 x ``assert_first_moment``'s allowance
from the JAX step's. A third route, the port's step in float64 from the
same init, shows why: both float32 routes lie 30-73 allowances from it,
ten times further than from each other. At the second step's point
37-57 % of the full-band STFT bins of G's output lie below 1e-3 (many at
the power clamp, sqrt(1e-7)), and there the log-magnitude term's float32
gradient with respect to the wave lies 0.23 of its largest entry from
float64 (the spectral convergence's 9e-4): 1 / |X| at bins float32
resolves poorly, in either package. Each STFT term alone keeps the two
packages within the allowance (the first update then leads elsewhere).
The rule and the allowance of ``assert_first_moment`` are unchanged.
"""

import jax
import numpy as np
import pytest
import torch

from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import build_steps
from parallelwavegan_torch.utils.params import convert_jax_params
from tests.torch_helpers import (
    as_jax,
    as_torch,
    flat_jax,
    port_first_train_states,
    sine_batch,
    small_melgan_train_config,
)

G_ONLY = (True, False, False)


def _first_moments(node):
    """The first moments, wherever the optimizer state keeps them."""
    if hasattr(node, "mu"):
        return node.mu
    if isinstance(node, dict) and "mu" in node:
        return node["mu"]
    children = node.values() if isinstance(node, dict) else (
        node if isinstance(node, (tuple, list)) else ())
    for child in children:
        found = _first_moments(child)
        if found is not None:
            return found
    return None


def _float64_route(config):
    """The port's state and step from the same init, in float64."""
    _, _, state, _ = port_first_train_states(config)
    state.generator.double()
    state.discriminator.double()
    state.opt_g.init(state.params_g)
    state.opt_d.init(state.params_d)
    factory, _ = build_steps(config, state.generator, state.discriminator,
                             build_criterion(config), state.opt_g,
                             state.opt_d)
    return state, factory


def _as64(batch):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in as_torch(batch).items()}


@pytest.fixture(scope="module")
def config():
    return small_melgan_train_config("mb_melgan", batch_size=4)


def test_port_and_jax_part_from_float64_not_from_each_other(config):
    """After two G steps: every first moment of the port within
    ``assert_first_moment``'s allowance a of the JAX step's, or within a
    fifth of the distance of either float32 route from float64."""
    state, (factory, _), t_state, (t_factory, _) = port_first_train_states(
        config)
    e_state, e_factory = _float64_route(config)
    for i in range(2):
        batch = sine_batch(config, seed=10 + i)
        state, _ = factory(*G_ONLY)(state, as_jax(batch), jax.random.key(i))
        t_factory(*G_ONLY)(t_state, as_torch(batch))
        e_factory(*G_ONLY)(e_state, _as64(batch))
    port, e = ({k: v.double().numpy() for k, v in convert_jax_params(
        _first_moments(s.opt_g.state_dict()), fold=False).items()}
        for s in (t_state, e_state))
    jx = flat_jax(_first_moments(state.opt_g))
    largest = max(np.abs(b).max() for b in jx.values())
    past = []
    for key, want in jx.items():
        allowed = 1e-3 * np.abs(want).max() + 1e-6 * largest
        pj = np.abs(port[key] - want).max()
        pe, je = (np.abs(a - e[key]).max() for a in (port[key], want))
        assert pj <= max(allowed, 0.2 * min(pe, je)), (key, pj / allowed,
                                                       pe / allowed,
                                                       je / allowed)
        if pj > allowed:
            past.append(key)
    # the observation C-6 recorded is still there: tensors past a from
    # JAX (12 of 49), each far from float64 in both packages
    assert past


def test_log_magnitude_gradient_is_ill_conditioned_at_the_second_step(
        config):
    """At float64's point after one G step: many full-band STFT bins of
    G's output below 1e-3, and the log-magnitude term's float32 gradient
    with respect to the wave far from float64 while the spectral
    convergence's holds."""
    from parallelwavegan_torch.ops.spectral import stft_magnitude

    e_state, e_factory = _float64_route(config)
    e_factory(*G_ONLY)(e_state, _as64(sine_batch(config, seed=10)))
    batch = as_torch(sine_batch(config, seed=11))
    crit = build_criterion(config)
    with torch.no_grad():
        y_hat = crit["pqmf"].synthesis(
            e_state.generator(batch["c"].double()))[..., 0]
    y = batch["y"].double()[..., 0]
    params = config["stft_loss_params"]
    quiet = [float((stft_magnitude(y_hat, fft, hop, win, method="fft",
                                   power_clamp_min=1e-7) < 1e-3)
                   .double().mean())
             for fft, hop, win in zip(params["fft_sizes"],
                                      params["hop_sizes"],
                                      params["win_lengths"])]
    assert min(quiet) > 0.2, quiet
    grads = {}
    for dtype in (torch.float64, torch.float32):
        x = y_hat.to(dtype).clone().requires_grad_(True)
        sc, mag = crit["stft"](x, y.to(dtype))
        grads[dtype] = [torch.autograd.grad(term, x, retain_graph=True)[0]
                        .double() for term in (sc, mag)]
    rel = [float((p - e).abs().max() / e.abs().max())
           for p, e in zip(grads[torch.float32], grads[torch.float64])]
    assert rel[0] < 2e-3 and rel[1] > 0.05, rel
