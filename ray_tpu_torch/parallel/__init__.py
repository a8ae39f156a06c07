"""The device plane: meshes, topology, sharding rules, collectives.
Counterpart of ``ray_tpu/parallel/``.

The JAX package expresses tensor communication as shardings over a
``jax.sharding.Mesh``, and XLA inserts the collectives.  The port lays
a ``DeviceMesh`` over the ranks of a ``torch.distributed`` process
group (NCCL on the card, gloo on the CPU), places parameters as
``DTensor``s by the same logical-axis rules, and runs the collectives
itself (``parallel/collective.py``).  Importing it imports no torch.
"""

from ray_tpu_torch.parallel.topology import (
    TpuGeneration,
    SliceTopology,
    parse_accelerator_type,
    ici_domains,
)
from ray_tpu_torch.parallel.mesh import (
    MeshSpec,
    make_mesh,
    make_hybrid_mesh,
    active_mesh,
    mesh_context,
    fake_mesh,
    local_mesh,
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_TENSOR,
    AXIS_SEQ,
    AXIS_EXPERT,
    AXIS_PIPELINE,
)
from ray_tpu_torch.parallel.sharding import (
    LogicalAxisRules,
    logical_to_mesh_axes,
    mesh_axes_for_shape,
    shard_by_shape,
    shardings_by_shape,
    shard_params,
    with_logical_constraint,
    DEFAULT_RULES,
    DECODE_RULES,
)
from ray_tpu_torch.parallel import collective

__all__ = [
    "TpuGeneration", "SliceTopology", "parse_accelerator_type",
    "ici_domains", "MeshSpec", "make_mesh", "make_hybrid_mesh",
    "active_mesh", "mesh_context", "fake_mesh", "local_mesh",
    "LogicalAxisRules", "logical_to_mesh_axes",
    "mesh_axes_for_shape", "shard_by_shape", "shardings_by_shape",
    "shard_params", "with_logical_constraint", "DEFAULT_RULES",
    "DECODE_RULES", "collective",
    "AXIS_DATA", "AXIS_FSDP", "AXIS_TENSOR", "AXIS_SEQ", "AXIS_EXPERT",
    "AXIS_PIPELINE",
]
