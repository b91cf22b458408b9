"""Operations of one training step, counted from the configuration's
layer shapes by its family's ``train_step_flops``, times the steps
completed, over the window's wall time, over the peak of the cell's
dtype, in %."""

from portbench.core import yardstick
from portbench.core.manifest import plugin


def read(run):
    counts = plugin(run["config"], "counts")
    if "steps" not in run or not hasattr(counts, "train_step_flops"):
        return None
    flops = counts.train_step_flops(run["config"], run["batch"],
                                    run["samples"])
    peak = yardstick.PEAK_FLOPS[run["traffic"]["dtype"]]
    return 100.0 * flops * run["steps"] / run["seconds"] / peak
