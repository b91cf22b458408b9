#!/usr/bin/env python3
"""Multi-process launcher: ``--nproc_per_node`` processes of a training
script (or, with ``-c``, of a command), each with the rendezvous variables
that ``parallel.dist.init_distributed`` reads.

Counterpart of ``parallelwavegan_tpu/distributed/launch.py``, with its
flags and its variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), plus ``LOCAL_WORLD_SIZE``, the processes of this
node, by which a rank tells whether each process owns a GPU. When a
process fails, the others are terminated and the launcher raises
``CalledProcessError`` with the first failed exit code: a rank left alone
would wait in its next collective. Two ranks on one GPU train through gloo:

    python -m parallelwavegan_torch.distributed.launch --nproc_per_node 2 \\
        -c python -m parallelwavegan_torch.bin.train --train-dumpdir D \\
        --dev-dumpdir D --outdir exp --config conf.yaml
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Distributed training launcher.")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--master_addr", default="127.0.0.1", type=str)
    parser.add_argument("--master_port", default=29500, type=int)
    parser.add_argument(
        "-c", "--command", action="store_true",
        help="run a command instead of a python script")
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def rank_environments(args) -> List[dict]:
    """The environment of each process of this node."""
    world_size = args.nnodes * args.nproc_per_node
    envs = []
    for local_rank in range(args.nproc_per_node):
        env = os.environ.copy()
        env.update(
            MASTER_ADDR=args.master_addr, MASTER_PORT=str(args.master_port),
            WORLD_SIZE=str(world_size),
            RANK=str(args.node_rank * args.nproc_per_node + local_rank),
            LOCAL_RANK=str(local_rank),
            LOCAL_WORLD_SIZE=str(args.nproc_per_node))
        envs.append(env)
    return envs


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.command:
        cmd = [args.training_script] + args.training_script_args
    else:
        cmd = [sys.executable, "-u", args.training_script] + \
            args.training_script_args
    processes = [subprocess.Popen(cmd, env=env)
                 for env in rank_environments(args)]
    try:
        running = list(processes)
        while running:
            for p in list(running):
                if p.poll() is None:
                    continue
                running.remove(p)
                if p.returncode != 0:
                    raise subprocess.CalledProcessError(p.returncode, p.args)
            time.sleep(0.05)
    except BaseException:
        for p in processes:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in processes:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        raise


if __name__ == "__main__":
    main()
