"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import os
import re

import pytest

from portbench.core import manifest as mf
from portbench.tests.support import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(_dim|_rank)$|channels|hidden|intermediate|latent|"
                    r"state|proj|head|expan|experts_per")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["command"]) <= 32
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_names_units_and_text(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    for group in ("configs", "workloads"):
        assert len({n for g, n in names if g == group}) == len(bench[group])
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for entry in (bench["configs"] + bench["workloads"]
                  + bench["per_layer"]):
        for key in ("why", "layer", "source"):
            if key in entry and key != "source" or (
                    key == "source" and entry in bench["configs"]):
                text = entry[key]
                assert 1 <= len(text) <= 200
                assert "\n" not in text and "\t" not in text


def test_entries_have_only_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_cells(bench):
    configs = {c["name"] for c in bench["configs"]}
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = [w for w in cells if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert len(four) <= max(1, len(cells) // 4)
    assert {w["config"] for w in cells} == configs
    for w in cells:
        assert w["config"] in configs


def test_every_cell_reports_setup_and_an_end_to_end_and_a_layer(bench):
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    manifest = mf.Manifest(ROOT)
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.metrics(w["name"], False)}
        layer = manifest.metrics(w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_per_layer_moves_and_layers(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_file_is_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        config = mf.config(c["name"])
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert config["portbench"]["reference"].startswith(
            "portbench.reference.")
    for w in bench["workloads"]:
        traffic = mf.traffic(w["traffic"])
        assert traffic["kind"] in ("decode", "single", "train")
        assert mf.limits(w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert set(traffic["kind"] for _ in [0]) <= set(
            mf.config(w["config"])["portbench"]["libraries"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(mf.reader(m["name"]).read)


def test_files_under_paths_are_named_from_name_characters(bench):
    ok = re.compile(r"^[A-Za-z0-9_.-]+$")
    for p in bench["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for name in files + dirs:
                assert ok.match(name), os.path.join(dirpath, name)


def test_a_reader_that_finds_nothing_returns_nothing():
    run = {"trace": None, "records": [], "seconds": 1.0}
    for name in ("b1_roofline.decode", "b3_roofline.decode",
                 "b2_roofline.train", "idle_pct.decode",
                 "api_exposed_ms.tts"):
        assert mf.read_metric(name, run) is None
