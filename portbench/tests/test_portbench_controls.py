"""On the card, at each cell's own size: the control (the reference at
the precision below the configuration's, or the program's own int8 path)
and the planted training fault come out not correct, on three seeds,
while the program's own runs stay within the limits. Run on the card:

    python -m pytest portbench/tests/test_portbench_controls.py -q
"""

import json
import subprocess
import sys

import pytest

from portbench.core import manifest as mf
from portbench.tests.support import ROOT, cuda_device  # noqa: F401

SEEDS = "2147483801,2147483802,2147483803"
CELLS = [w["name"] for w in mf.Manifest(ROOT).data["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cuda_device, tmp_path,
                                                  cell):
    out = tmp_path / "readings.json"
    done = subprocess.run(
        [sys.executable, "portbench/tools/readings.py", "--workload", cell,
         "--seeds", SEEDS, "--control-seeds", SEEDS, "--seconds", "10",
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=1800)
    assert done.returncode == 0, done.stderr[-3000:]
    limits = mf.limits(cell)
    for row in json.loads(out.read_text())["rows"]:
        assert all(row["program"][k] <= v for k, v in limits.items()
                   if k in row["program"]), row
        assert any(row["control"][k] > v for k, v in limits.items()
                   if k in row["control"]), row
        if "fault_half_batch" in row:
            assert any(row["fault_half_batch"][k] > v
                       for k, v in limits.items()
                       if k in row["fault_half_batch"]), row
