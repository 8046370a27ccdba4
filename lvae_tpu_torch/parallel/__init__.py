"""Multi-process training and evaluation on torch.distributed, counterpart
of ``lvae_tpu/parallel/``: the process grid and data sharding (mesh.py),
the verification utilities (dist_utils.py) and H-sharded evaluation with
an exact halo exchange (spatial.py). The JAX package's fast_device_get has
no counterpart (mesh.py says why)."""
from lvae_tpu_torch.parallel.mesh import (
    init_distributed, get_data_mesh, shard_batch, replicate, data_sharding,
    replicated_sharding, process_count, process_index, local_batch_slice,
    Mesh, Sharding,
)
from lvae_tpu_torch.parallel.spatial import get_2d_mesh, image_sharding, \
    spatial_eval, sharded
from lvae_tpu_torch.parallel import dist_utils

__all__ = ['Mesh', 'Sharding', 'data_sharding', 'dist_utils',
           'get_2d_mesh', 'get_data_mesh', 'image_sharding',
           'init_distributed', 'local_batch_slice', 'process_count',
           'process_index', 'replicate', 'replicated_sharding',
           'shard_batch', 'sharded', 'spatial_eval']
