"""Data parallelism, one process per card (``mesh``), and the bootstrap of
the process group (``multihost``)."""

from collaborative_gan_sampling_torch.parallel.mesh import (  # noqa: F401
    all_gather,
    all_reduce_mean,
    all_reduce_sum,
    make_group,
    replicate,
    run_sharded,
    shard_batch,
)
from collaborative_gan_sampling_torch.parallel.multihost import (  # noqa: F401
    maybe_initialize_distributed,
)
