"""Multi-device paths of the port on ``torch.distributed``: one process a
device, a ``DeviceMesh`` over the world (``sharding.py``), sharded mesh
generation (``mesh.py``), multi-process initialisation (``multihost.py``),
the counted collectives (``collectives.py``) and a local launcher
(``launch.py``)."""

from bsdmg_tpu_torch.parallel.mesh import (
    ShardedField,
    distribute_field,
    extract_sharded,
    generate_mesh_sharded,
    refine_field_sharded,
)
from bsdmg_tpu_torch.parallel.sharding import (
    make_mesh,
    render_grid_sharded,
    render_sharded,
    render_sharded_pallas,
    shard_rays,
    train_step,
    train_step_fused,
)

__all__ = [
    "ShardedField",
    "distribute_field",
    "extract_sharded",
    "generate_mesh_sharded",
    "make_mesh",
    "refine_field_sharded",
    "render_grid_sharded",
    "render_sharded",
    "render_sharded_pallas",
    "shard_rays",
    "train_step",
    "train_step_fused",
]
