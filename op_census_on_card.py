#!/usr/bin/env python3
"""``chip_smoke.py`` step 19 alone: the op census
(``parallelwavegan_torch/tools/op_census.py``) of one f32 (G, adv, D) step
of each of ``chip_smoke.CENSUS_RECIPES``, the CPU routes on a pool of
``chip_smoke.POOL_WORKERS`` processes.

    python3 op_census_on_card.py

Run from the root of a checkout, on the card. Prints the table by op kind
and the total; exits non-zero on a key that gives a wrong result.
"""

import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor

import torch

import chip_smoke


def main() -> int:
    if not torch.cuda.is_available():
        print("op_census_on_card: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with ProcessPoolExecutor(
            max_workers=chip_smoke.POOL_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        chip_smoke.op_census_phase(torch.device("cuda", 0),
                                   chip_smoke.card_line(), pool)
    return 0


if __name__ == "__main__":
    sys.exit(main())
