"""The multi-card layer: the (data, model) mesh, tensor parallelism and
spatial sharding over ``torch.distributed``."""

from .mesh import (Mesh, data_parallel_size, flat_buckets, gather_rows,
                   make_mesh, pad_along_axis, pad_to_multiple, shard_rows,
                   single, wrap_pad)
from .multihost import initialize_multihost

__all__ = ["Mesh", "data_parallel_size", "flat_buckets", "gather_rows",
           "initialize_multihost", "make_mesh", "pad_along_axis",
           "pad_to_multiple", "shard_rows", "single", "wrap_pad"]
