"""Data and scene parallelism over ``torch.distributed`` (mirror of
``pointcloudsegmentation_tpu.parallel``)."""
from .distributed import (global_mesh, initialize,  # noqa: F401
                          local_batch_to_global, run_ranks)
from .mesh import Mesh, make_mesh, replicate, shard_batch  # noqa: F401
