#!/usr/bin/env python3
"""Convert checkpoints between the port and the reference toolkit.

Counterpart of ``parallelwavegan_tpu/bin/convert_checkpoint.py``. By
default a reference ``.pkl`` (``checkpoint-<N>steps.pkl``; the generator
and, where it holds one, the discriminator) becomes a train-state
``checkpoint-<N>steps.ckpt`` of the state ``engine.build`` makes from the
config, fresh optimizers, the EMA stream seeded from the imported
generator; with ``--to-reference`` a ``.ckpt`` (of either package) becomes
a generator-only ``.pkl`` that the reference's ``utils.load_model`` reads.
``config.yml`` is written beside the output. Builds the models on CUDA by
default (``--device cpu`` for the host):

    python -m parallelwavegan_torch.bin.convert_checkpoint \
        --checkpoint ref/checkpoint-400000steps.pkl --outdir exp
    python -m parallelwavegan_torch.bin.convert_checkpoint --to-reference \
        --checkpoint exp/checkpoint-400000steps.ckpt --outdir ref
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

from parallelwavegan_torch.engine.build import init_train_state
from parallelwavegan_torch.engine.checkpoint import (
    load_checkpoint,
    load_params_only,
    save_checkpoint,
)
from parallelwavegan_torch.utils.io import load_config, save_config
from parallelwavegan_torch.utils.params import nested
from parallelwavegan_torch.utils.torch_export import save_reference_checkpoint
from parallelwavegan_torch.utils.torch_import import load_torch_checkpoint


def main(argv: Optional[list] = None) -> str:
    parser = argparse.ArgumentParser(
        description="Convert a reference .pkl checkpoint to a .ckpt, or a "
        ".ckpt to a reference .pkl.")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", type=str, default=None,
                        help="config.yml (defaults to the one next to the "
                        "checkpoint)")
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--to-reference", action="store_true",
                        help="export a .ckpt to a reference .pkl (generator "
                        "only) instead of importing")
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="build the models on the GPU (default; fails without one) or "
        "the CPU")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARN,
        stream=sys.stdout,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )
    config = load_config(args.config or os.path.join(
        os.path.dirname(args.checkpoint), "config.yml"))
    state = init_train_state(config, 0, args.device)[0]
    os.makedirs(args.outdir, exist_ok=True)
    if args.to_reference:
        load_checkpoint(args.checkpoint, state)
        out = os.path.join(args.outdir, f"checkpoint-{state.steps}steps.pkl")
        save_reference_checkpoint(out, nested(state.params_g), config,
                                  steps=state.steps)
    else:
        load_params_only(args.checkpoint, state, config=config)
        state.steps = int(load_torch_checkpoint(args.checkpoint).get(
            "steps", 0))
        out = os.path.join(args.outdir, f"checkpoint-{state.steps}steps.ckpt")
        save_checkpoint(out, state)
    save_config(os.path.join(args.outdir, "config.yml"), config)
    logging.info(f"Converted {args.checkpoint} -> {out}")
    return out


if __name__ == "__main__":
    main()
