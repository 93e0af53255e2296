"""Multi-device layout of the port: a mesh of torch devices
(:mod:`repro_torch.parallel.mesh`) and the logical-axis rules over it
(:mod:`repro_torch.parallel.sharding`)."""
from repro_torch.parallel.mesh import Mesh, make_mesh
from repro_torch.parallel.sharding import (
    LOGICAL_RULES,
    NamedSharding,
    PartitionSpec,
    current_mesh,
    logical_to_spec,
    named_shardings,
    param_spec,
    place,
    shard,
    use_mesh,
)

__all__ = ["Mesh", "make_mesh", "LOGICAL_RULES", "NamedSharding",
           "PartitionSpec", "current_mesh", "logical_to_spec", "named_shardings",
           "param_spec",
           "place", "shard", "use_mesh"]
