"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``portbench/configs/<config>.json``; a traffic mix is
``portbench/traffic/<traffic>.json``; a metric, end to end or per layer,
is the reader ``portbench/metrics/<metric>.py`` (a ``read(run)`` that
returns a number, or None where it finds nothing to read); a cell's
correctness limits are ``portbench/limits/<cell>.json``. A configuration
names, in its ``portbench`` block, the modules that know its family: its
plain reference (``reference``), its training step in the reference
(``train_reference``) and its operation counts (``counts``). A later
cell, mix, metric or family is a new file and a new entry, and no edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: str):
        self.root = root
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer metrics
        (traced): those that list the cell, or list no cells."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell in m.get("workloads", [cell])]


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def plugin(config: dict, key: str):
    """The module the configuration names under ``portbench.<key>``."""
    return importlib.import_module(config["portbench"][key])


def limits(cell: str) -> Dict[str, float]:
    return _json(os.path.join(HERE, "limits", f"{cell}.json"))["limits"]


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (the name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(metric: str, run: dict) -> Optional[float]:
    return reader(metric).read(run)
