"""Sharded rendering and training over a mesh of devices.

Port of ``bifrost3d_tpu/parallel``: pixel rows shard over the devices of a
1-D ``'tiles'`` mesh, the scene replicates on every device, and gradient
reductions sum over the shards (``parallel/render.py``, one process) or
over processes with ``torch.distributed`` (``parallel/distributed.py``).
"""

from bifrost3d_tpu_torch.parallel.mesh import (
    render_mesh,
    tile_sharding,
    replicated_sharding,
    pad_to_multiple,
)
from bifrost3d_tpu_torch.parallel.render import (
    render_smallpt_sharded,
    make_sharded_smallpt,
    make_sharded_render,
    make_sharded_train_step,
)
from bifrost3d_tpu_torch.parallel.distributed import (
    initialize as initialize_distributed,
    global_render_mesh,
    make_multihost_smallpt,
    make_multihost_render,
    make_global_rows,
    gather_rows,
    shard_rows_local,
)
