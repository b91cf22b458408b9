"""Kernel B1 (the WaveNet stack forward): the least time of the traced
calls' stacks (operations at the dtype's peak or bytes at the memory rate,
counted from each call's batch and padded length) over the device time of
the B1 kernels in the trace, in %."""

from portbench.core import readers

PATTERN = r"wavenet_layer_(tf32|tc)_kernel"


def read(run):
    return readers.b1_roofline(run, PATTERN)
