"""Parameter transforms: the weight-norm fold and flax-tree conversion.

``fold_weight_norm`` is the counterpart of the JAX package's fold
(``parallelwavegan_tpu/utils/params.py``, ``layers/common.py:144-147`` and
``ops/pallas/wavenet_stack.py:55``): kernel = v * g / max(||v||, 1e-12), the
norm taken per output channel over every axis where g has size 1. It is
differentiable and computes in the dtype it is given; the trainable modules
call it in their forward. ``convert_jax_params`` turns a flax parameter tree
into a ``state_dict`` for the port's modules, whose parameter names are the
tree's paths: folded (``...kernel``, the serving form) or, with
``fold=False``, as it is (``...kernel_v`` / ``...kernel_g``, the training
form). Kernels of any rank fold alike (a ``Conv2d``'s (KH, KW, Cin, Cout)
with ``kernel_g`` (1, 1, 1, Cout)). Leaves that are not kernels carry over by name under their
path: a token table's ``embedding``, a ``Dense`` layer's ``kernel`` and
``bias``, a LayerNorm's ``scale`` and ``bias``, a bare top-level
parameter (the F0 generator's ``weights``). A discriminator's flax
``spectral``
collection (the power-iteration vectors ``u``) has the parameters' paths,
so it converts with them into the modules' ``u`` buffers, and
``nested_buffers`` turns those back into the collection.
``folded_state_dict`` makes the serving form from a trainable module.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn


def as_tensor(a: Any) -> torch.Tensor:
    """numpy array (bf16 from ml_dtypes included) or tensor -> CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def fold_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """v * g / max(||v||, 1e-12), in the dtype of v."""
    axes = tuple(d for d in range(v.dim()) if g.shape[d] == 1)
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    return v * (g / torch.clamp(norm, min=1e-12))


def convert_jax_params(tree: Mapping[str, Any], fold: bool = True,
                       spectral: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Flax params tree (nested dicts of arrays, f32 or bf16, with
    kernel_v/kernel_g or kernel) -> float32 state_dict.

    Pass the tree under ``"params"``. With ``fold`` (the default) weight
    norm is folded in the dtype the tree is stored in and the result cast
    to float32 afterwards, as the JAX ``InferenceModel`` does (a bf16
    ``.gckpt`` folds in bf16; a float32 tree is unaffected):
    {"first_conv": {"kernel_v": ...}} -> {"first_conv.kernel": ...},
    which a folded module strict-loads. With
    ``fold=False`` the names stay (``first_conv.kernel_v``), which a
    trainable module strict-loads. ``spectral`` is the flax collection of
    that name (``extra_d["spectral"]``): its ``u`` leaves join the result
    under the same paths, where the spectral-normed convs keep their buffers.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        folds = fold and "kernel_v" in node and "kernel_g" in node
        if folds:
            out[prefix + "kernel"] = fold_weight_norm(
                as_tensor(node["kernel_v"]), as_tensor(node["kernel_g"])
            ).float()
        for key, sub in node.items():
            if folds and key in ("kernel_v", "kernel_g"):
                continue
            if isinstance(sub, Mapping):
                walk(sub, f"{prefix}{key}.")
            else:
                out[prefix + key] = as_tensor(sub).float()

    walk(tree, "")
    if spectral:
        fold = False
        walk(spectral, "")
    return out


def nested(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a.b.kernel": t} -> {"a": {"b": {"kernel": t}}}: a state_dict as
    the flax tree it came from (the inverse of ``convert_jax_params``'s
    flattening)."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def nested_buffers(module: nn.Module) -> Dict[str, Any]:
    """A module's buffers as a flax-style extra-collections dict:
    {"spectral": tree of u} for a spectral-normed discriminator, {} for a
    module without buffers (what flax keeps beside ``params``)."""
    buffers = dict(module.named_buffers())
    return {"spectral": nested(buffers)} if buffers else {}


def folded_state_dict(module: Union[nn.Module, Mapping[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """A module's state_dict (or any flat dict of its parameters) with every
    kernel_v/kernel_g pair folded into ``kernel``: what the same module built
    in its folded form strict-loads. A folded module's state_dict comes back
    as it is."""
    state = module.state_dict() if isinstance(module, nn.Module) else module
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith("kernel_g"):
            continue
        if key.endswith("kernel_v"):
            prefix = key[: -len("kernel_v")]
            out[prefix + "kernel"] = fold_weight_norm(
                value.float(), state[prefix + "kernel_g"].float()
            ).to(value.dtype)
        else:
            out[key] = value
    return out
