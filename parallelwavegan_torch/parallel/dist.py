"""Data parallelism over ``torch.distributed``: one process per rank, the
parameters replicated, each rank training on its own shard of the batch.

Counterpart of ``parallelwavegan_tpu/parallel/mesh.py``. There a batch
sharded over the mesh's ``data`` axis and ``shard_map`` with explicit
``pmean`` / ``psum`` keep the replicas equal; here each rank loads its own
shard (``bin/train`` builds per-rank loaders, as the JAX CLI does under
several processes), the step all-reduces the gradients, the metrics and
the dead-code restart's counts and rows (``Group``), and the state starts
from the same seeded init on every rank plus a broadcast from rank 0 after
the init, ``--pretrain`` and ``--resume`` (``Group.broadcast_tensors_``),
as the reference's DDP does.

``init_distributed`` reads the launcher's rendezvous variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``; ``distributed/launch.py`` sets them). Without them it does
nothing: one process trains as it always did. Under the launcher it joins
the group even at a world of one, so that the collectives run. Each rank's
device is ``cuda:LOCAL_RANK % device_count`` unless the caller asks for
the CPU. The backend is NCCL when every rank of the node owns a GPU of its
own, and gloo otherwise (NCCL refuses two ranks on one device; gloo
all-reduces CUDA tensors through the host); the choice is printed, not
configurable, as the JAX package has no such knob.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def launched() -> bool:
    """Whether the launcher's rendezvous variables are set."""
    return all(k in os.environ for k in _ENV)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count``, or the CPU
    when ``device`` is "cpu"."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def choose_backend(device: torch.device) -> str:
    """NCCL when the ranks of this node each own a GPU, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                      os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the launcher's process group (once; a later call returns the
    same device) and return this rank's device. A process started without
    the launcher's variables stays alone and gets ``device``."""
    if not launched():
        return torch.device(device)
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev)
    addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(minutes=30))
    print(f"torch.distributed: rank {rank()} of {world_size()} on {dev}, "
          f"backend {backend}", flush=True)
    return dev


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def per_rank_batch(batch_size: int, world: int) -> int:
    """Each rank's share of the global batch; a batch the ranks cannot
    share equally raises (the JAX step falls back to its GSPMD path)."""
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} is not divisible by the "
                         f"world size {world}")
    return batch_size // world


def _buckets(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    """The positions of ``tensors`` by dtype, in order."""
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


class Group:
    """The ranks' collectives: gradients and metrics all-reduced through
    one flat bucket per dtype. ``group`` is a ``torch.distributed`` process
    group, None for the default one."""

    def __init__(self, group=None):
        self.group = group

    def size(self) -> int:
        return dist.get_world_size(self.group)

    def sum_(self, flat: torch.Tensor) -> None:
        """All-reduce one flat tensor in place (sum)."""
        dist.all_reduce(flat, group=self.group)

    def broadcast_(self, flat: torch.Tensor, src: int = 0) -> None:
        dist.broadcast(flat, src, group=self.group)

    def _reduce_(self, tensors: Sequence[torch.Tensor], fn
                 ) -> List[torch.Tensor]:
        """``fn`` on one flat bucket per dtype of ``tensors``, the results
        copied back into them: the callers keep their own tensors, so what
        reads them next (the optimizer's norms and sums) sees the layout
        of a one-process step."""
        for idx in _buckets(tensors).values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            fn(flat)
            for i, part in zip(idx, flat.split(
                    [tensors[i].numel() for i in idx])):
                tensors[i].copy_(part.view_as(tensors[i]))
        return list(tensors)

    @torch.no_grad()
    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The ranks' sums of ``tensors`` (JAX ``psum``), in place."""
        return self._reduce_(tensors, self.sum_)

    @torch.no_grad()
    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """The ranks' means of ``tensors`` (JAX ``pmean``), in place:
        summed in one bucket per dtype, then divided by the world size."""
        n = self.size()

        def mean_(flat):
            self.sum_(flat)
            flat.div_(n)

        return self._reduce_(tensors, mean_)

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The ranks' means of 0-d metrics, as new tensors."""
        keys = sorted(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(())
                              for k in keys])
        self.all_reduce_mean([values])
        return dict(zip(keys, values.unbind()))

    @torch.no_grad()
    def broadcast_tensors_(self, tensors: Sequence[torch.Tensor],
                           src: int = 0) -> None:
        """Overwrite ``tensors`` in place with rank ``src``'s."""
        self._reduce_(tensors, lambda flat: self.broadcast_(flat, src))


def default_group() -> Optional[Group]:
    """The ranks' ``Group`` once a process group is initialised, else
    None (one process: the step runs no collective)."""
    return Group() if dist.is_initialized() else None
