"""Data parallelism: the process group, the ranks' collectives, the
per-rank batch."""

from parallelwavegan_torch.parallel.dist import (  # noqa: F401
    Group,
    default_group,
    init_distributed,
    per_rank_batch,
    rank,
    shutdown_distributed,
    world_size,
)
