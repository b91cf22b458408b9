"""One rank of a data-parallel port step on the CPU, started by
``parallelwavegan_torch.distributed.launch`` (gloo).

    python -m parallelwavegan_torch.distributed.launch --nproc_per_node 2 \
        --master_port P tests/torch_parallel_worker.py JOB.pt OUTDIR

``JOB.pt`` holds the config, the state's tensors to start from (by
``GANTrainState.tensors`` name), the flags of the step and, per step, each
rank's shard. Each rank writes ``OUTDIR/rank<r>.pt``: its state's tensors
and its metrics after every step. Imports no JAX.
"""

import os
import sys

import torch

from parallelwavegan_torch.engine.build import init_train_state
from parallelwavegan_torch.engine.criterion import build_criterion
from parallelwavegan_torch.engine.step import (
    DROPOUT_STREAM,
    SHARED_STREAM,
    build_steps,
    step_generator,
)
from parallelwavegan_torch.parallel import dist


def main(job_path: str, outdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_distributed("cpu")
    rank, world = dist.rank(), dist.world_size()
    job = torch.load(job_path, weights_only=False)
    config, seed = job["config"], job.get("seed", 0)
    state, gen, dis, opt_g, opt_d = init_train_state(config, seed, "cpu")
    with torch.no_grad():
        for name, t in state.tensors().items():
            t.copy_(job["init"][name])
    group = dist.default_group()
    factory, _ = build_steps(config, gen, dis, build_criterion(config),
                             opt_g, opt_d, group=group)
    step = factory(*job["flags"])
    metrics = []
    for shards in job["batches"]:
        s = state.steps
        _, m = step(state, shards[rank],
                    step_generator(seed, s, rank=rank, world=world),
                    step_generator(seed, s, SHARED_STREAM),
                    step_generator(seed, s, DROPOUT_STREAM, rank=rank,
                                   world=world))
        metrics.append({k: float(v) for k, v in m.items()})
    torch.save({"tensors": state.tensors(), "metrics": metrics},
               os.path.join(outdir, f"rank{rank}.pt"))
    dist.shutdown_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:])
