"""Checkpoints read and written without flax: the generator-only
``.gckpt`` and the train-state ``.ckpt``.

Counterpart of ``parallelwavegan_tpu/engine/checkpoint.py``. Both files are
flax's msgpack of a tree: a map of maps whose array leaves are
``ExtType(1, packb((shape, dtype_name, buffer)))`` (ext 3 for a numpy
scalar). Numpy has no bfloat16, so a ``b"bfloat16"`` leaf is read as uint16
and viewed as ``torch.bfloat16``. Leaves come back as CPU tensors.

A ``.ckpt`` holds the JAX package's ``GANTrainState`` fields: ``steps``,
``params_g`` and ``params_d`` under the flax names (``kernel_v`` /
``kernel_g``), the empty collections ``extra_g`` / ``extra_d``, ``opt_g``
and ``opt_d`` in the optax chain's layout (which the port's optimizers
share, see ``optimizers``) and ``ema_g`` (none). Either package restores a
``.ckpt`` the other wrote.
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
    path: str, module_or_variables: Union[nn.Module, Dict[str, Any]],
    dtype: Optional[torch.dtype] = None,
) -> None:
    """Inference-only checkpoint: just the generator variables.

    Takes a port module (written with folded kernels, whichever form it
    holds them in; the JAX package loads them as plain ``kernel`` leaves)
    or a variables tree of tensors / numpy arrays. ``dtype=torch.bfloat16``
    halves the file.
    """
    variables = (
        module_variables(module_or_variables)
        if isinstance(module_or_variables, nn.Module) else module_or_variables
    )
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
        "params_g": nested(state.generator.state_dict()),
        "extra_g": {},
        "opt_g": state.opt_g.state_dict(),
        "params_d": nested(state.discriminator.state_dict()),
        "extra_d": {},
        "opt_d": state.opt_d.state_dict(),
        "ema_g": None,
    }
    _write(path, packb(tree, default=_default))


def _load_params(module: nn.Module, tree: Dict[str, Any]) -> None:
    module.load_state_dict(convert_jax_params(tree, fold=False), strict=True)


def load_checkpoint(path: str, state: GANTrainState) -> GANTrainState:
    """Restore a ``.ckpt`` (of either package) into ``state``, in place:
    parameters, optimizer states and the step counter. An EMA stream in
    the file is dropped (EMA is not ported yet)."""
    tree = _read(path)
    _load_params(state.generator, tree["params_g"])
    _load_params(state.discriminator, tree["params_d"])
    state.opt_g.load_state_dict(tree["opt_g"])
    state.opt_d.load_state_dict(tree["opt_d"])
    state.steps = int(tree["steps"])
    return state


def load_params_only(path: str, state: GANTrainState,
                     load_discriminator: bool = True) -> GANTrainState:
    """``--pretrain`` semantics: restore the model parameters and keep the
    fresh optimizers and step counter. A generator-only ``.gckpt`` (with
    ``kernel_v``/``kernel_g`` leaves) warm-starts the generator alone."""
    tree = _read(path)
    if path.endswith(".gckpt"):
        _load_params(state.generator, tree["params"])
        return state
    _load_params(state.generator, tree["params_g"])
    if load_discriminator:
        _load_params(state.discriminator, tree["params_d"])
    return state
