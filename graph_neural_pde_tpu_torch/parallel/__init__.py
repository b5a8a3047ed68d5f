"""Multi-device edge sharding over ``torch.distributed`` (the PyTorch port
of the JAX package's ``parallel/``): the mesh (``mesh``), the
autograd-aware collectives (``collectives``) and the sharded aggregations
(``shard_spmm``)."""

from graph_neural_pde_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_graph,
    split_mesh,
)
