"""The port's .gckpt reader/writer (no flax, no msgpack package) against the
JAX package's save_generator_checkpoint and flax's msgpack."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from parallelwavegan_tpu.engine.checkpoint import (
    load_generator_checkpoint as jax_load_gckpt,
    save_generator_checkpoint as jax_save_gckpt,
)
from parallelwavegan_tpu.models import (
    ParallelWaveGANGenerator as FlaxGenerator,
)
from parallelwavegan_torch.engine.checkpoint import (
    load_generator_checkpoint,
    save_generator_checkpoint,
)
from parallelwavegan_torch.models import ParallelWaveGANGenerator
from parallelwavegan_torch.utils import msgpack_lite
from parallelwavegan_torch.utils.params import convert_jax_params
from tests.torch_helpers import flax_generator_kwargs

torch.set_num_threads(2)


def _flax_variables(layers=2):
    g = FlaxGenerator(**flax_generator_kwargs(layers=layers, stacks=1))
    z = jnp.zeros((1, 32, 1))
    c = jnp.zeros((1, 12, 20))
    return g.init({"params": jax.random.key(0)}, z, c)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _as_bits(a):
    """Raw bits of a numpy (ml_dtypes bf16 included) array or tensor."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16], ids=["f32", "bf16"])
def test_reader_matches_flax_bit_for_bit(tmp_path, dtype):
    path = str(tmp_path / "g.gckpt")
    jax_save_gckpt(path, _flax_variables(), dtype=dtype)
    ref = dict(_leaves(jax_load_gckpt(path)))
    got = dict(_leaves(load_generator_checkpoint(path)))
    assert sorted(got) == sorted(ref)
    for key, value in got.items():
        want = torch.bfloat16 if dtype is not None else torch.float32
        assert value.dtype == want, key
        assert tuple(value.shape) == ref[key].shape, key
        np.testing.assert_array_equal(_as_bits(value), _as_bits(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16], ids=["f32", "bf16"])
def test_writer_round_trips_to_the_same_bytes(tmp_path, dtype):
    src, dst = str(tmp_path / "a.gckpt"), str(tmp_path / "b.gckpt")
    jax_save_gckpt(src, _flax_variables(), dtype=dtype)
    save_generator_checkpoint(dst, load_generator_checkpoint(src))
    with open(src, "rb") as f_src, open(dst, "rb") as f_dst:
        assert f_src.read() == f_dst.read()


def test_module_checkpoint_loads_in_both_packages(tmp_path):
    path = str(tmp_path / "port.gckpt")
    gen = ParallelWaveGANGenerator(**flax_generator_kwargs(layers=2, stacks=1),
                                   generator=torch.Generator().manual_seed(0))
    save_generator_checkpoint(path, gen, dtype=torch.bfloat16)
    restored = load_generator_checkpoint(path)
    state = convert_jax_params(restored["params"])
    for key, value in gen.state_dict().items():
        assert torch.equal(state[key], value.to(torch.bfloat16).float()), key
    flax_tree = jax_load_gckpt(path)  # flax reads the port's file
    for key, value in _leaves(flax_tree):
        np.testing.assert_array_equal(
            _as_bits(value), _as_bits(dict(_leaves(restored))[key]))


def test_msgpack_lite_matches_msgpack_on_every_type():
    ext = msgpack_lite.ExtType
    cases = [
        None, True, False, 0, 5, 127, 128, 255, 256, 65535, 65536, 2**32,
        -1, -32, -33, -128, -129, -32768, -32769, -(2**31) - 1, 1.5, -0.25,
        "", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, b"", b"x" * 300,
        b"y" * 70000, [1, [2, 3]], list(range(20)), {"k": {"n": 1}},
        {str(i): i for i in range(20)},
    ]
    for obj in cases:
        packed = msgpack.packb(obj, use_bin_type=True)
        assert msgpack_lite.packb(obj) == packed, obj
        assert msgpack_lite.unpackb(packed) == obj
    for n in (1, 2, 4, 8, 16, 3, 300, 70000):
        packed = msgpack.packb(msgpack.ExtType(1, b"z" * n))
        assert msgpack_lite.packb(ext(1, b"z" * n)) == packed, n
        assert msgpack_lite.unpackb(packed) == ext(1, b"z" * n)
    tree = serialization.msgpack_serialize({"a": np.arange(3.0)})
    restored = msgpack_lite.unpackb(tree)
    assert isinstance(restored["a"], ext) and restored["a"].code == 1
