"""The 95th percentile over every request of the window, from the
client's call to the waveform in host memory; a failed request counts as
missing every limit (infinite)."""

import numpy as np


def read(run):
    if "records" not in run:
        return None
    lat = [(r["end"] - r["start"]) * 1e3 if "error" not in r else np.inf
           for r in run["records"]]
    return float(np.percentile(lat, 95))
