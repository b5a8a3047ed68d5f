"""graph_neural_pde_tpu_torch — the PyTorch/CUDA port of graph_neural_pde_tpu.

GRAND graph neural diffusion on one NVIDIA H100: encoder, then an ODE block
dx/dt = f(x(t), G) integrated by the port's own solvers with a discrete or
continuous adjoint gradient, then a decoder. The weighted row-sorted SpMM of
the laplacian RHS and its weight gradient, the per-node segment softmax,
the fused attention RHS of the transformer function (GRAND-nl) with its
backward passes, and the dual scatter of the composed attention RHS
(squareplus, reweighted and GAT attention) with its gradient run as
hand-written CUDA kernels (``kernels/``, sources in ``csrc/``); every other
op is PyTorch. ``bench.py`` is the bench entry: the kernels against
on-device oracles, then GRAND-nl's throughput at ogbn-arxiv scale.

This package imports torch and numpy only, never jax and never the JAX
package ``graph_neural_pde_tpu``, which stays in the repository as the
reference the port is tested against.
"""

__version__ = "0.1.0"
