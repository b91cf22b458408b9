"""Generator-only ``.gckpt`` checkpoints, read and written without flax.

Counterpart of ``save_generator_checkpoint`` / ``load_generator_checkpoint``
in ``parallelwavegan_tpu/engine/checkpoint.py``. A ``.gckpt`` is flax's
msgpack of the variables tree: a map of maps whose array leaves are
``ExtType(1, packb((shape, dtype_name, buffer)))`` (ext 3 for a numpy
scalar). Numpy has no bfloat16, so a ``b"bfloat16"`` leaf is read as uint16
and viewed as ``torch.bfloat16``. Leaves come back as CPU tensors.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from parallelwavegan_torch.utils.msgpack_lite import ExtType, packb, unpackb
from parallelwavegan_torch.utils.params import as_tensor

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
    """A module's state_dict as a flax-style {"params": nested dict}."""
    params: Dict[str, Any] = {}
    for key, value in module.state_dict().items():
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return {"params": params}


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

    Takes a port module (written with its folded kernels, which the JAX
    package loads as plain ``kernel`` leaves) or a variables tree of
    tensors / numpy arrays. ``dtype=torch.bfloat16`` halves the file.
    """
    variables = (
        module_variables(module_or_variables)
        if isinstance(module_or_variables, nn.Module) else module_or_variables
    )
    data = packb(_prepare(variables, dtype), default=_default)
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def load_generator_checkpoint(path: str) -> Dict[str, Any]:
    """Restore generator variables from a .gckpt as nested dicts of CPU
    tensors (bf16 leaves as torch.bfloat16)."""
    with open(path, "rb") as f:
        return unpackb(f.read(), ext_hook=_ext_hook)
