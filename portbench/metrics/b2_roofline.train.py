"""Kernel B2 (the WaveNet stack backward): the least time of the traced
steps' stack backward over all layers (operations at the dtype's peak or
bytes at the memory rate, from the batch and window) over the device time
of the B2 kernels in the trace, in %."""

from portbench.core import yardstick

PATTERN = r"bwd_\w*kernel"


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    seconds = tr.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    L = run["config"]["generator_params"]["layers"]
    B, T = run["batch"], run["samples"]
    dtype = run["traffic"]["dtype"]
    least = run["traced_steps"] * yardstick.least_seconds(
        yardstick.backward_flops(B, T, L),
        yardstick.backward_bytes(B, T, L, dtype), dtype)
    return 100.0 * least / seconds
