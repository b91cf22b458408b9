"""The port's optimizers, schedules and gradient clipping against optax as
the JAX package chains it: parameter trajectories over 14 updates, the
learning rate of every update, and the layout of the optimizer state."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from parallelwavegan_tpu.optimizers import (
    build_optimizer as jax_build_optimizer,
    build_schedule as jax_build_schedule,
)
from parallelwavegan_torch.optimizers import build_optimizer, build_schedule

SHAPES = {"a.kernel_v": (3, 4, 5), "a.bias": (5,), "b.kernel_g": (1, 1, 7)}
STEPS = 14

# (optimizer, its params, scheduler, its params, grad_norm). RAdam's
# rectification switches on at the 6th update (rho > 5 with beta2 0.999).
CASES = {
    "radam_steplr_clip": ("RAdam", {"lr": 1e-2, "eps": 1e-6,
                                    "weight_decay": 0.0},
                          "StepLR", {"step_size": 4, "gamma": 0.5}, 10),
    "radam_decay_multistep": ("RAdam", {"lr": 1e-2, "weight_decay": 0.01},
                              "MultiStepLR",
                              {"milestones": [3, 7], "gamma": 0.5}, -1),
    "radam_betas": ("RAdam", {"lr": 3e-3, "betas": [0.5, 0.9]}, "StepLR",
                    {"step_size": 100, "gamma": 0.5}, 1),
    "adam_exponential_clip": ("Adam", {"lr": 1e-2}, "ExponentialLR",
                              {"gamma": 0.9}, 0.5),
    "adam_decay_cosine": ("Adam", {"lr": 1e-2, "weight_decay": 0.1},
                          "CosineAnnealingLR",
                          {"T_max": 10, "eta_min": 1e-4}, -1),
    "adamw_constant_clip": ("AdamW", {"lr": 1e-2}, None, None, 1.0),
    "sgd_momentum_steplr": ("SGD", {"lr": 1e-1, "momentum": 0.9}, "StepLR",
                            {"step_size": 5, "gamma": 0.1}, -1),
    "sgd_constant_clip": ("SGD", {"lr": 1e-1}, "Constant", None, 2.0),
}


def _nest(flat):
    out = {}
    for key, value in flat.items():
        mod, leaf = key.split(".")
        out.setdefault(mod, {})[leaf] = value
    return out


def _leaf_paths(tree, prefix=""):
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out += _leaf_paths(value, f"{prefix}{key}/")
        else:
            out.append(prefix + key)
    return sorted(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_and_state_layout_match_optax(case):
    """f32 on both sides; the port takes b ** count and the schedule in
    double precision, optax in f32: 1e-5 absolute on parameters of
    magnitude 1 after 14 updates with rates up to 0.1."""
    args = CASES[case]
    jax_opt, opt = jax_build_optimizer(*args), build_optimizer(*args)
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    jp = jax.tree.map(jnp.asarray, _nest(p0))
    js = jax_opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt.init(tp)
    for i in range(STEPS):
        # every third gradient is large, so the clip triggers on some steps
        scale = 3.0 if i % 3 == 0 else 0.1
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        updates, js = jax_opt.update(jax.tree.map(jnp.asarray, _nest(g)), js,
                                     jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, [torch.from_numpy(g[k]) for k in tp])
        for key, value in tp.items():
            mod, leaf = key.split(".")
            np.testing.assert_allclose(value.numpy(), np.asarray(jp[mod][leaf]),
                                       atol=1e-5, err_msg=f"{key} step {i}")
    want = serialization.to_state_dict(js)
    got = opt.state_dict()
    assert _leaf_paths(got) == _leaf_paths(want)
    # the state restores into a fresh optimizer, and from optax's tree
    again = build_optimizer(*args)
    again.init({k: torch.zeros_like(v) for k, v in tp.items()})
    again.load_state_dict(jax.tree.map(np.asarray, want))
    assert again.lr == opt.lr
    assert _leaf_paths(again.state_dict()) == _leaf_paths(got)
    for a, b in zip(jax.tree.leaves(again.state_dict()),
                    jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("scheduler,params", [
    ("StepLR", {"step_size": 4, "gamma": 0.5}),
    ("StepLR", {}),
    ("MultiStepLR", {"milestones": [3, 7], "gamma": 0.5}),
    ("ExponentialLR", {"gamma": 0.9}),
    ("CosineAnnealingLR", {"T_max": 10, "eta_min": 1e-4}),
    ("Constant", None),
    (None, None),
])
def test_learning_rate_of_every_update_matches_optax(scheduler, params):
    """The count starts at 0 and an update uses the rate of the count
    before it: the first update runs at the base rate, and a StepLR of
    step_size 4 halves the rate from the 5th update on."""
    ref = jax_build_schedule(scheduler, params, 1e-2)
    got = build_schedule(scheduler, params, 1e-2)
    for count in range(13):
        want = float(ref(count)) if callable(ref) else ref
        np.testing.assert_allclose(got(count), want, rtol=1e-6)
    assert got(0) == 1e-2
    opt = build_optimizer("SGD", {"lr": 1e-2}, scheduler, params)
    p = {"w": torch.zeros(3)}
    opt.init(p)
    for count in range(6):
        assert opt.lr == got(count)
        p["w"].zero_()
        opt.step(p, [torch.ones(3)])
        np.testing.assert_allclose(-p["w"].numpy(), got(count), rtol=1e-6)


def test_clip_scales_by_max_norm_over_the_larger_of_norm_and_max_norm():
    opt = build_optimizer("SGD", {"lr": 1.0}, "Constant", None, grad_norm=2.0)
    p = {"a": torch.zeros(2), "b": torch.zeros(2)}
    opt.init(p)
    opt.step(p, [torch.tensor([3.0, 0.0]), torch.tensor([0.0, 4.0])])
    np.testing.assert_allclose(p["a"].numpy(), [-3.0 * 2 / 5, 0], rtol=1e-6)
    np.testing.assert_allclose(p["b"].numpy(), [0, -4.0 * 2 / 5], rtol=1e-6)
    # below the threshold the gradient passes through bit for bit
    q = {"a": torch.zeros(2)}
    opt.init(q)
    opt.step(q, [torch.tensor([0.3, -0.4])])
    assert torch.equal(q["a"], torch.tensor([-0.3, 0.4]))


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="optimizer"):
        build_optimizer("Lion")
    with pytest.raises(ValueError, match="scheduler"):
        build_schedule("OneCycleLR", {}, 1e-3)
