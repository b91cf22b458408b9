"""What the per-layer metric files share: each file under
``portbench/metrics/`` names one metric and its cells, and reads it with
one of these (a kernel's name pattern stays in its metric's file)."""

from __future__ import annotations

from typing import Optional

from portbench.core import yardstick
from portbench.core.manifest import plugin


def idle_pct(run) -> Optional[float]:
    """Share of the traced stretch with no kernel, copy or memset on the
    card (the union of their intervals), in %."""
    tr = run["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def api_exposed_ms(run) -> Optional[float]:
    """Mean over the traced calls of each call span's time with no device
    work under it (host preparation, transfers, waits, the crop), in ms."""
    tr = run["trace"]
    if tr is None:
        return None
    exposed = tr.exposed("call")
    return 1e3 * sum(exposed) / len(exposed) if exposed else None


def mfu_serving(run) -> Optional[float]:
    """Model operations of the audio returned (true lengths, not padding)
    over the window's wall time over the peak of the cell's dtype, in %."""
    if "records" not in run:
        return None
    config = run["config"]
    samples = sum(sum(r["lengths"]) * config["hop_size"]
                  for r in run["records"] if "error" not in r)
    peak = yardstick.PEAK_FLOPS[run["traffic"]["serving"]["dtype"]]
    return (100.0 * plugin(config, "counts").forward_flops(config, samples)
            / run["seconds"] / peak)


def b1_roofline(run, pattern: str) -> Optional[float]:
    """The traced calls' stack least time (each call's batch and padded
    length) over the device time of the kernels ``pattern`` matches, in
    %."""
    tr = run["trace"]
    seconds = tr.kernel_seconds(pattern) if tr is not None else 0.0
    if seconds <= 0:
        return None
    config = run["config"]
    L, hop = config["generator_params"]["layers"], config["hop_size"]
    dtype = run["traffic"]["serving"]["dtype"]
    least = 0.0
    for r in run["traced_calls"]:
        B, T = len(r["lengths"]), r["frames"] * hop
        least += yardstick.least_seconds(
            yardstick.stack_flops(B, T, L),
            yardstick.stack_bytes(B, T, L, dtype), dtype)
    return 100.0 * least / seconds
