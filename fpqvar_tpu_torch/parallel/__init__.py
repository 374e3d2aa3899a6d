"""The distributed layer: the ``{dp, tp}`` process mesh, its sharding
rules and the tensor-parallel collectives (``torch.distributed``)."""
from fpqvar_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_params,
    make_mesh,
    param_specs,
    shard_params,
)
