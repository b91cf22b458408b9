"""The port's yaml and hdf5 readers and writers against PyYAML, h5py and the
JAX package's ``utils/io.py``.

``parallelwavegan_torch/utils/yaml_lite.py`` reads every recipe in
``egs/**/conf``, the shipped ``assets/quality/config.yml`` and what
PyYAML's ``safe_dump`` writes as ``yaml.safe_load`` does, and writes
configs that both read back equal;
``utils/hdf5_lite.py`` reads what h5py writes and writes what h5py reads.
The GPU machine has neither library: the port's ``utils/io.py`` goes
through these modules on every machine.
"""

import glob
import json
import math
import os

import h5py
import numpy as np
import pytest
import yaml

from parallelwavegan_torch.utils import hdf5_lite, yaml_lite
from parallelwavegan_torch.utils import io as port_io
from parallelwavegan_tpu.utils import io as jax_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(glob.glob(os.path.join(REPO, "egs", "**", "conf", "*.yaml"),
                           recursive=True)) + [
    os.path.join(REPO, "assets", "quality", "config.yml")]


def _same(a, b) -> bool:
    """Equal values and types (mappings in any order), NaN equal to NaN,
    -0.0 apart from 0.0."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a, key=repr) == sorted(
            b, key=repr) and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a):
            return math.isnan(b)
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    return type(a) is type(b) and a == b


def test_every_recipe_is_counted():
    assert len(RECIPES) == 111


@pytest.mark.parametrize("path", RECIPES,
                         ids=[os.path.relpath(p, REPO) for p in RECIPES])
def test_yaml_lite_reads_the_recipe_as_pyyaml(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = yaml_lite.load_file(path)
    assert _same(got, want)
    # and writes it back so that both read it equal
    text = yaml_lite.dump(want)
    assert _same(yaml.safe_load(text), want)
    assert _same(yaml_lite.load(text), want)


SCALARS = [
    "1.0e-06", "1e-6", "1.0e6", "1.0e+6", "-1.5", ".5", "1.", "1_000",
    "0x1F", "0o17", "017", "0b101", "1:30", "-0", "+7", ".inf", "-.Inf",
    ".NaN", "yes", "No", "ON", "off", "True", "FALSE", "y", "~", "null",
    "Null", "", "hann", "hello world", "a:b", "x#y", "'1'", '"a\\tb"',
    "'it''s'", '"\\u00e9"', "[1, [2, 3], {a: b}]", "{}", "[]",
    "{a: , b: 2}", "[a b, c]",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_lite_resolves_scalars_as_pyyaml(text):
    doc = f"key: {text}\n"
    assert _same(yaml_lite.load(doc), yaml.safe_load(doc))


def test_yaml_lite_reads_block_layouts_as_pyyaml():
    doc = ("# a comment\n"
           "a:\n"
           "- 1\n"
           "- - 2\n"
           "  - 3\n"
           "- b: 1  # trailing comment\n"
           "  c: [4, 5]\n"
           "-\n"
           "  d: e\n"
           "f:\n"
           "    g:\n"
           "        - x\n"
           "    h: plain text\n"
           "      continued\n"
           "i: 'quoted\n"
           "  on two lines'\n"
           "'j k': null\n"
           "1: int key\n")
    assert _same(yaml_lite.load(doc), yaml.safe_load(doc))


def test_yaml_lite_reads_pyyaml_anchors_and_aliases():
    """PyYAML's safe_dump writes an object that sits under two keys once,
    anchored, and aliases it after (a config whose optimizer dicts are one
    object, as some tests build them)."""
    shared, steps = {"lr": 1e-4, "betas": [0.5, 0.9]}, [100000, 200000]
    config = {"generator_optimizer_params": shared,
              "discriminator_optimizer_params": shared, "milestones": steps,
              "more": [shared, steps, {"again": steps}], "k": {"a": shared}}
    for flow in (False, None):
        text = yaml.safe_dump(config, default_flow_style=flow)
        assert "&id001" in text and "*id001" in text
        assert _same(yaml_lite.load(text), yaml.safe_load(text))
    doc = "a: &x [1, 2]\nb:\n- &y\n  c: 3\n- *x\nd: *y\n"
    assert _same(yaml_lite.load(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("doc", [
    "a: *alias", "a: !!str 1", "&a k: 1", "a: 1\n<<: {b: 2}",
    "a: |\n  block", "a: >\n  x", "a: 2001-12-14", "a: 1\n---\nb: 2",
    "? complex\n: key", "a: [1, 2", "a:\n  - 1\n   - 2"])
def test_yaml_lite_refuses_what_is_outside_the_subset(doc):
    with pytest.raises(ValueError, match=r"line \d+"):
        yaml_lite.load(doc)


CONFIG = {
    "eps": 1e-6, "eps_string": "1e-6", "yes_string": "yes", "none": None,
    "flag": True, "int": 400000, "neg": -0.0, "big": 1e300, "inf": math.inf,
    "window": "hann_window", "empty": "", "spaced": " x ", "colon": "a: b",
    "hash": "a #b", "path": "/tmp/exp dir/config.yml", "unicode": "é\u2028",
    "generator_params": {"upsample_scales": [4, 4, 4, 4], "pad_params": {},
                         "nested": [[1, 3], [{"k": [0.5, None]}], []]},
    "tuple": (1, 2),
}


def test_save_config_round_trips_through_pyyaml_and_yaml_lite(tmp_path):
    path = str(tmp_path / "config.yml")
    port_io.save_config(path, CONFIG)
    want = dict(CONFIG, tuple=[1, 2])
    with open(path) as f:
        assert _same(yaml.safe_load(f), want)
    got = port_io.load_config(path)
    assert _same(got, want)
    assert isinstance(got["eps"], float) and got["eps_string"] == "1e-6"
    # what PyYAML's safe_dump writes (the JAX package's save_config) reads
    # back equal too
    jax_path = str(tmp_path / "jax.yml")
    jax_io.save_config(jax_path, want)
    assert _same(port_io.load_config(jax_path), port_io.load_config(path))


def test_yaml_lite_refuses_to_write_other_types():
    with pytest.raises(TypeError, match="ndarray"):
        yaml_lite.dump({"a": np.zeros(2)})


def test_load_config_overrides_and_json(tmp_path):
    path = str(tmp_path / "c.yml")
    with open(path, "w") as f:
        f.write("a: 1\nb: {c: 2}\n")
    assert port_io.load_config(path, overrides={"a": 3}) == \
        jax_io.load_config(path, overrides={"a": 3}) == {"a": 3,
                                                         "b": {"c": 2}}
    with open(str(tmp_path / "c.json"), "w") as f:
        json.dump({"a": 1e-6}, f)
    assert port_io.load_config(str(tmp_path / "c.json")) == {"a": 1e-6}


def test_find_files_without_the_root_dir_matches_jax(tmp_path):
    for name in ("b/x.wav", "a.wav", "c/d/y.wav", "z.txt"):
        os.makedirs(os.path.dirname(tmp_path / name), exist_ok=True)
        (tmp_path / name).write_bytes(b"")
    for include in (True, False):
        assert port_io.find_files(str(tmp_path), "*.wav", include) == \
            jax_io.find_files(str(tmp_path), "*.wav", include)


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "wave": rng.standard_normal(1000).astype(np.float32),
        "feats": rng.standard_normal((7, 80)).astype(np.float32),
        "f64": rng.standard_normal((3, 4, 5)),
        "global": np.array([3], dtype=np.int64),
        "empty": np.zeros((0,), dtype=np.float32),
        "empty2d": np.zeros((0, 80), dtype=np.float32),
        "i32": np.arange(-5, 5, dtype=np.int32),
        "u8": np.arange(5, dtype=np.uint8),
        "scalar": np.float64(2.5),
        "f16": np.linspace(-1, 1, 9).astype(np.float16),
        "transposed": rng.standard_normal((4, 3)).T,
    }


def _assert_equal_array(got, want, name):
    want = np.asarray(want)
    assert got.dtype == want.dtype, name
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", list(_arrays()))
def test_hdf5_lite_reads_what_h5py_writes(tmp_path, name):
    path = str(tmp_path / "a.h5")
    arrays = _arrays()
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        f.create_group("grp").create_dataset("x", data=np.arange(4.0))
        f["wave"].attrs["note"] = 1
    _assert_equal_array(port_io.read_hdf5(path, name), arrays[name], name)
    _assert_equal_array(port_io.read_hdf5(path, "grp/x"), np.arange(4.0),
                        "grp/x")


def test_h5py_reads_what_hdf5_lite_writes(tmp_path):
    path = str(tmp_path / "b.h5")
    arrays = _arrays()
    hdf5_lite.write(path, arrays)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(arrays)
        for k, v in arrays.items():
            _assert_equal_array(f[k][()], v, k)
    for k, v in arrays.items():
        _assert_equal_array(port_io.read_hdf5(path, k), v, k)
    # h5py appends to the file and deletes from it
    with h5py.File(path, "a") as f:
        f.create_dataset("new", data=np.arange(3))
        del f["wave"]
    assert "wave" not in port_io.hdf5_keys(path)
    _assert_equal_array(port_io.read_hdf5(path, "new"), np.arange(3), "new")


def test_hdf5_lite_many_datasets_both_ways(tmp_path):
    """Past one symbol node (8 names) and up to the writer's 256."""
    many = {f"k{i:03d}": np.full(i % 5 + 1, i, np.float32)
            for i in range(hdf5_lite.MAX_DATASETS)}
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    hdf5_lite.write(ours, many)
    with h5py.File(ours, "r") as f:
        for k, v in many.items():
            _assert_equal_array(f[k][()], v, k)
    with h5py.File(theirs, "w") as f:
        for k, v in many.items():
            f.create_dataset(k, data=v)
    for k, v in many.items():
        _assert_equal_array(port_io.read_hdf5(theirs, k), v, k)
    with pytest.raises(ValueError, match="at most 256"):
        hdf5_lite.write(ours, dict(many, extra=np.zeros(1)))


def test_write_hdf5_overwrite_and_append_match_jax(tmp_path):
    """The same calls of write_hdf5 give files of the same datasets; the
    three errors carry the JAX package's messages."""
    calls = [("wave", np.arange(10, dtype=np.float32), True),
             ("feats", np.ones((2, 3), np.float32), True),
             ("wave", np.arange(4, dtype=np.float32), True),
             ("global", np.array([2], np.int64), True)]
    paths = {}
    for tag, io in (("port", port_io), ("jax", jax_io)):
        paths[tag] = str(tmp_path / tag / "sub" / "u.h5")
        for name, data, overwrite in calls:
            io.write_hdf5(paths[tag], name, data, is_overwrite=overwrite)
    with h5py.File(paths["jax"], "r") as f:
        want = {k: f[k][()] for k in f}
    assert sorted(port_io.hdf5_keys(paths["port"])) == sorted(want)
    for k, v in want.items():
        _assert_equal_array(port_io.read_hdf5(paths["port"], k), v, k)
    for tag, io in (("port", port_io), ("jax", jax_io)):
        with pytest.raises(RuntimeError) as err:
            io.write_hdf5(paths[tag], "wave", np.zeros(1), is_overwrite=False)
        assert str(err.value) == f"Dataset wave already exists in {paths[tag]}."
        with pytest.raises(KeyError) as err:
            io.read_hdf5(paths[tag], "f0")
        assert err.value.args[0] == (
            f"There is no such a data in hdf5 file (f0 in {paths[tag]}).")
        missing = str(tmp_path / "none.h5")
        with pytest.raises(FileNotFoundError) as err:
            io.read_hdf5(missing, "wave")
        assert str(err.value) == f"There is no such a hdf5 file ({missing})."


def test_hdf5_lite_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "c.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("chunked", data=np.arange(100.0), chunks=(10,))
        f.create_dataset("gzip", data=np.arange(100.0), compression="gzip")
        f.create_dataset("string", data="abc")
        f.create_dataset("big", data=np.arange(3, dtype=">f4"))
    for name, what in (("chunked", "chunked layout"),
                       ("gzip", "filter pipeline"),
                       ("string", "variable-length datatype"),
                       ("big", "big-endian")):
        with pytest.raises(ValueError, match=what):
            port_io.read_hdf5(path, name)
    latest = str(tmp_path / "latest.h5")
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3.0))
    with pytest.raises(ValueError, match="superblock version 3"):
        port_io.read_hdf5(latest, "x")
    with pytest.raises(TypeError, match="bool"):
        hdf5_lite.write(str(tmp_path / "d.h5"), {"b": np.ones(2, bool)})
    with pytest.raises(ValueError, match="root group"):
        hdf5_lite.write(str(tmp_path / "d.h5"), {"a/b": np.ones(2)})
