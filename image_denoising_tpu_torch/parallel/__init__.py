from .mesh import (Mesh, PerDevice, forward_over_mesh, grad_replica, make_mesh,
                   module_on, replicate, shard_batch)

__all__ = ["Mesh", "PerDevice", "forward_over_mesh", "grad_replica", "make_mesh",
           "module_on", "replicate", "shard_batch"]
