"""Kernel B3 (HiFi-GAN's fused MRF stage): the least time of the traced
calls' four stages (operations at the dtype's peak or bytes at the memory
rate, per stage from its rows and channels) over the device time of the
B3 kernels in the trace, in %."""

from portbench.core import yardstick

PATTERN = r"mrf_(conv|pair|mean)_kernel"


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    seconds = tr.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    gp = run["config"]["generator_params"]
    dtype = run["traffic"]["serving"]["dtype"]
    kernels = gp["resblock_kernel_sizes"]
    layers = len(gp["resblock_dilations"][0])
    least = 0.0
    for r in run["traced_calls"]:
        stages = yardstick.hifigan_mrf_stage_rows(gp, len(r["lengths"]),
                                                  r["frames"])
        for rows, C in stages.values():
            least += yardstick.least_seconds(
                yardstick.mrf_flops(rows, C, kernels, layers),
                yardstick.mrf_bytes(rows, C, kernels, layers, dtype), dtype)
    return 100.0 * least / seconds
