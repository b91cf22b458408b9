"""The run's environment: caches inside the checkout, the modules that
must not be loaded, the card's description."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List

# top-level module names that no run may load: the JAX package and JAX
BANNED = ("jax", "jaxlib", "flax", "parallelwavegan_tpu")


def banned_modules(modules=None) -> List[str]:
    """The banned top-level names among the loaded modules, each compared
    whole (``parallelwavegan_torch`` is not ``parallelwavegan_tpu``)."""
    names = {name.split(".", 1)[0] for name in (modules or sys.modules)}
    return sorted(names.intersection(BANNED))


def pin_caches(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout: the program's own
    nvcc cache is ``parallelwavegan_torch/_build/``; PyTorch's extension
    and Triton caches, should anything use them, go beside it."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"
