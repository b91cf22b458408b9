"""Build the hand-written CUDA sources under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside the package (the
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source builds anew), then loaded with ``ctypes``. Nothing is built
when a module is imported: the first kernel call builds its library, or a
caller (``chip_smoke.py``) builds them all at once with
:func:`build_libraries`, one ``nvcc`` process per source, all started
together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(source.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_libraries(names: Sequence[str]) -> Dict[str, Dict[str, object]]:
    """Compile every named source that is not built yet, in parallel.

    Returns {name: {"path", "seconds", "log"}} with the compiler's output
    (ptxas register and shared-memory report) for each source built now.
    Raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    results: Dict[str, Dict[str, object]] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, out, start) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>; one handle per process."""
    path = build_libraries([name])[name]["path"]
    return ctypes.CDLL(str(path))
