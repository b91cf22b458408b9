"""A data-parallel step emulated in one process: the ranks as threads, each
with its own train state and shard, whose collectives sum (JAX's ``psum``)
and average (``pmean``) the threads' tensors in rank order.

The reference against which ``chip_smoke.py`` step 16 and
``tests/test_torch_parallel.py`` hold the ranks of
``distributed/launch.py``: the same step code (``build_steps(...,
group=ThreadGroup(n))``) on the same shards and per-rank draws, with the
all-reduce done in memory instead of through ``torch.distributed``. At
two ranks a sum has one order, so the emulation and gloo or NCCL agree
bit for bit wherever each rank's own arithmetic does.

    group = ThreadGroup(2)
    results = run_ranks(group, lambda rank: train(rank, group))
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List

import torch

from parallelwavegan_torch.parallel.dist import Group


class ThreadGroup(Group):
    """``n`` ranks as the threads of ``run_ranks``."""

    def __init__(self, n: int, timeout: float = 600.0):
        super().__init__()
        self.n = n
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: List[Any] = [None] * n
        self.local = threading.local()

    def size(self) -> int:
        return self.n

    def rank(self) -> int:
        return self.local.rank

    def _exchange(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``flat``, in rank order."""
        self.slots[self.rank()] = flat.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()  # nobody overwrites a slot still being read
        return got

    def sum_(self, flat: torch.Tensor) -> None:
        parts = self._exchange(flat)
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        flat.copy_(total)

    def broadcast_(self, flat: torch.Tensor, src: int = 0) -> None:
        flat.copy_(self._exchange(flat)[src])


def run_ranks(group: ThreadGroup, fn: Callable[[int], Any]) -> List[Any]:
    """``fn(rank)`` for each rank of ``group`` in a thread of its own; the
    results in rank order. The first error is raised once every thread has
    ended (a failing rank breaks the barrier so the others stop)."""
    results: List[Any] = [None] * group.n
    errors: List[BaseException] = []

    def body(rank: int) -> None:
        group.local.rank = rank
        try:
            results[rank] = fn(rank)
        except BaseException as err:  # handed to the caller
            errors.append(err)
            group.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(group.n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
