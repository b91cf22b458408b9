"""Parameter transforms: the weight-norm fold and flax-tree conversion.

``fold_weight_norm`` is the counterpart of the JAX package's fold
(``parallelwavegan_tpu/utils/params.py`` and
``ops/pallas/wavenet_stack.py:55``): kernel = v * g / max(||v||, 1e-12), the
norm taken per output channel over every axis where g has size 1.
``convert_jax_params`` turns a flax parameter tree into a ``state_dict`` for
the port's modules, whose parameter names are the tree's paths.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def as_tensor(a: Any) -> torch.Tensor:
    """numpy array (bf16 from ml_dtypes included) or tensor -> CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def fold_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """v * g / max(||v||, 1e-12), computed in float32."""
    v, g = v.float(), g.float()
    axes = tuple(d for d in range(v.dim()) if g.shape[d] == 1)
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    return v * (g / torch.clamp(norm, min=1e-12))


def convert_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params tree (nested dicts of arrays, f32 or bf16, with
    kernel_v/kernel_g or kernel) -> float32 state_dict with folded kernels.

    Pass the tree under ``"params"``: {"first_conv": {"kernel_v": ...}} ->
    {"first_conv.kernel": ...}.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        if "kernel_v" in node and "kernel_g" in node:
            out[prefix + "kernel"] = fold_weight_norm(
                as_tensor(node["kernel_v"]), as_tensor(node["kernel_g"])
            )
        for key, sub in node.items():
            if key in ("kernel_v", "kernel_g"):
                continue
            if isinstance(sub, Mapping):
                walk(sub, f"{prefix}{key}.")
            else:
                out[prefix + key] = as_tensor(sub).float()

    walk(tree, "")
    return out
