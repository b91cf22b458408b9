"""Every module of the JAX package has its counterpart in the port: the
``.py`` and ``.cc`` files of ``parallelwavegan_tpu/`` against those of
``parallelwavegan_torch/`` under an explicit map of the renames, and the
one module ported as a decision rather than a file, named in the README."""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX module -> its counterpart in the port, where the name differs
RENAMES = {
    "ops/pallas/__init__.py": "ops/cuda/__init__.py",
    "ops/pallas/mrf_stage.py": "ops/cuda/mrf_stage.py",
    "ops/pallas/pwg_infer.py": "ops/cuda/pwg_infer.py",
    "ops/pallas/wavenet_stack.py": "ops/cuda/wavenet_stack.py",
    "ops/pallas/wavenet_stack_train.py": "ops/cuda/wavenet_stack_train.py",
    "parallel/mesh.py": "parallel/dist.py",
}
# JAX modules with no file in the port, and where the decision stands
DECIDED = {"utils/compile_cache.py": "README.md"}


def _modules(package):
    root = os.path.join(REPO, package)
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_build")]
        for name in filenames:
            if name.endswith((".py", ".cc")):
                out.add(os.path.relpath(os.path.join(dirpath, name), root))
    return out


def test_every_jax_module_has_a_counterpart():
    jax_modules = _modules("parallelwavegan_tpu")
    port_modules = _modules("parallelwavegan_torch")
    assert len(jax_modules) > 70
    missing = sorted(m for m in jax_modules if m not in DECIDED
                     and RENAMES.get(m, m) not in port_modules)
    assert not missing, missing
    assert all(m in jax_modules for m in RENAMES), "a stale rename"
    for module, doc in DECIDED.items():
        assert module in jax_modules
        assert module not in port_modules
        with open(os.path.join(REPO, doc)) as f:
            assert module.split("/")[-1] in f.read(), (module, doc)
