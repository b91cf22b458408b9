"""Checkpoints read and written without flax: the generator-only
``.gckpt`` and the train-state ``.ckpt``; the reference toolkit's
``.pkl`` is read through ``utils/torch_import.py`` (for serving, and as a
``--pretrain`` source of a generator and its discriminator).

Counterpart of ``parallelwavegan_tpu/engine/checkpoint.py``. Both files are
flax's msgpack of a tree: a map of maps whose array leaves are
``ExtType(1, packb((shape, dtype_name, buffer)))`` (ext 3 for a numpy
scalar). Numpy has no bfloat16, so a ``b"bfloat16"`` leaf is read as uint16
and viewed as ``torch.bfloat16``. Leaves come back as CPU tensors.

A ``.ckpt`` holds the JAX package's ``GANTrainState`` fields: ``steps``,
``params_g`` and ``params_d`` under the flax names (``kernel_v`` /
``kernel_g``), the collections ``extra_g`` (empty) and ``extra_d`` (the
``spectral`` collection of a spectral-normed discriminator: its ``u``
buffers), ``opt_g`` and ``opt_d`` in the optax chain's layout (which the
port's optimizers share, see ``optimizers``) and ``ema_g`` (the EMA of
``params_g``, or none). Either package restores a ``.ckpt`` the other wrote.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from parallelwavegan_torch.engine.state import GANTrainState
from parallelwavegan_torch.utils.msgpack_lite import ExtType, packb, unpackb
from parallelwavegan_torch.utils.params import (
    as_tensor,
    convert_jax_params,
    folded_state_dict,
    nested,
    nested_buffers,
)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _tensor_from_bytes(data: bytes) -> torch.Tensor:
    shape, dtype_name, buffer = unpackb(data)
    if dtype_name == "bfloat16":
        arr = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)
    return torch.from_numpy(arr.copy())


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _tensor_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _tensor_from_bytes(data).reshape(())
    raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")


def _tensor_to_ext(t: torch.Tensor) -> ExtType:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        name, raw = arr.dtype.name, arr.tobytes()
    return ExtType(_EXT_NDARRAY, packb((tuple(t.shape), name, raw)))


def _default(obj: Any) -> Any:
    return _tensor_to_ext(obj) if isinstance(obj, torch.Tensor) else obj


def module_variables(module: nn.Module) -> Dict[str, Any]:
    """A module's serving form (weight norm folded) as a flax-style
    {"params": nested dict}."""
    return {"params": nested(folded_state_dict(module))}


def _write(path: str, data: bytes) -> None:
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _prepare(tree: Any, dtype: Optional[torch.dtype]) -> Any:
    """Sorted keys (as flax writes them), floating leaves cast to dtype."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k], dtype) for k in sorted(tree)}
    if isinstance(tree, np.ndarray):
        tree = as_tensor(tree)
    if dtype is not None and isinstance(tree, torch.Tensor) \
            and tree.is_floating_point():
        tree = tree.to(dtype)
    return tree


def save_generator_checkpoint(
    path: str,
    source: Union[nn.Module, GANTrainState, Dict[str, Any]],
    dtype: Optional[torch.dtype] = None,
    use_ema: bool = False,
) -> None:
    """Inference-only checkpoint: just the generator variables.

    Takes a port module or a train state (written with folded kernels,
    whichever form they are held in; the JAX package loads them as plain
    ``kernel`` leaves) or a variables tree of tensors / numpy arrays.
    ``use_ema`` writes a train state's EMA stream instead of its
    parameters. ``dtype=torch.bfloat16`` halves the file.
    """
    if isinstance(source, GANTrainState):
        params = source.generator.state_dict()
        if use_ema:
            if source.ema_g is None:
                raise ValueError(
                    "use_ema=True but the train state has no EMA stream "
                    "(set generator_ema_decay in the training config)")
            params = source.ema_g
        variables = {"params": nested(folded_state_dict(params))}
    elif use_ema:
        raise ValueError("use_ema only applies to a GANTrainState")
    elif isinstance(source, nn.Module):
        variables = module_variables(source)
    else:
        variables = source
    _write(path, packb(_prepare(variables, dtype), default=_default))


def _read(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return unpackb(f.read(), ext_hook=_ext_hook)


def load_generator_checkpoint(path: str) -> Dict[str, Any]:
    """Restore generator variables from a .gckpt as nested dicts of CPU
    tensors (bf16 leaves as torch.bfloat16)."""
    return _read(path)


def save_checkpoint(path: str, state: GANTrainState) -> None:
    """Write the whole train state as a ``.ckpt``."""
    tree = {
        "steps": torch.tensor(state.steps, dtype=torch.int32),
        "params_g": nested(state.params_g),
        "extra_g": {},
        "opt_g": state.opt_g.state_dict(),
        "params_d": nested(state.params_d),
        "extra_d": nested_buffers(state.discriminator),
        "opt_d": state.opt_d.state_dict(),
        "ema_g": None if state.ema_g is None else nested(state.ema_g),
    }
    _write(path, packb(tree, default=_default))


def _load_params(module: nn.Module, tree: Dict[str, Any],
                 extra: Optional[Dict[str, Any]] = None) -> None:
    module.load_state_dict(
        convert_jax_params(tree, fold=False,
                           spectral=(extra or {}).get("spectral")),
        strict=True)


def _load_ema(state: GANTrainState, tree: Dict[str, Any]) -> None:
    """The EMA stream across format generations: a state without EMA drops
    the file's; a file without one (a run that kept none) seeds the stream
    from the restored generator parameters."""
    if state.ema_g is None:
        return
    if tree.get("ema_g") is None:
        state.seed_ema()
        return
    ema = convert_jax_params(tree["ema_g"], fold=False)
    if sorted(ema) != sorted(state.ema_g):
        raise ValueError("the checkpoint's ema_g does not match the generator")
    with torch.no_grad():
        for key, value in state.ema_g.items():
            value.copy_(ema[key])


def load_checkpoint(path: str, state: GANTrainState) -> GANTrainState:
    """Restore a ``.ckpt`` (of either package) into ``state``, in place:
    parameters, spectral-norm vectors, the EMA stream, optimizer states and
    the step counter."""
    tree = _read(path)
    _load_params(state.generator, tree["params_g"])
    _load_params(state.discriminator, tree["params_d"], tree.get("extra_d"))
    _load_ema(state, tree)
    state.opt_g.load_state_dict(tree["opt_g"])
    state.opt_d.load_state_dict(tree["opt_d"])
    state.steps = int(tree["steps"])
    return state


def load_params_only(path: str, state: GANTrainState,
                     load_discriminator: bool = True,
                     config: Optional[Dict[str, Any]] = None
                     ) -> GANTrainState:
    """``--pretrain`` semantics: restore the model parameters and keep the
    fresh optimizers and step counter. A generator-only ``.gckpt`` (with
    ``kernel_v``/``kernel_g`` leaves) warm-starts the generator alone. A
    reference ``.pkl`` (named by ``config``'s model types) warm-starts the
    generator and, where the file holds one, the discriminator with its
    spectral-norm vectors."""
    if path.endswith(".pkl"):
        if config is None:
            raise ValueError("a reference .pkl is read with its config")
        ref = load_reference_checkpoint(path, config)
        _load_params(state.generator, ref["generator"]["params"])
        if state.ema_g is not None:
            state.seed_ema()
        if load_discriminator and "discriminator" in ref:
            _load_params(state.discriminator, ref["discriminator"]["params"],
                         ref["discriminator"])
        return state
    tree = _read(path)
    if path.endswith(".gckpt"):
        _load_params(state.generator, tree["params"])
        if state.ema_g is not None:
            state.seed_ema()
        return state
    _load_params(state.generator, tree["params_g"])
    _load_ema(state, tree)
    if load_discriminator:
        _load_params(state.discriminator, tree["params_d"],
                     tree.get("extra_d"))
    return state


def load_reference_checkpoint(path: str, config: Dict[str, Any]
                              ) -> Dict[str, Any]:
    """A reference ``checkpoint-<N>steps.pkl`` -> {"generator": {"params":
    tree}, "discriminator": {...} where the file has one, "steps": int},
    the trees under the flax names (numpy, float32)."""
    from parallelwavegan_torch.utils.torch_import import (
        import_model_params,
        load_torch_checkpoint,
    )

    ckpt = load_torch_checkpoint(path)
    out: Dict[str, Any] = {"steps": int(ckpt.get("steps", 0))}
    out["generator"] = import_model_params(
        ckpt["model"]["generator"],
        config.get("generator_type", "ParallelWaveGANGenerator"),
        config.get("generator_params", {}),
    )
    if "discriminator" in ckpt.get("model", {}):
        out["discriminator"] = import_model_params(
            ckpt["model"]["discriminator"],
            config.get("discriminator_type", "ParallelWaveGANDiscriminator"),
            config.get("discriminator_params", {}),
        )
    return out
