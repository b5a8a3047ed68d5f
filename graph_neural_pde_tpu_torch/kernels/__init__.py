"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
on CPU tensors, and counts its kernel launches in ``<wrapper>.launches``.
Importing this package builds nothing; the kernels compile at first launch
(``kernels.build``).
"""

from graph_neural_pde_tpu_torch.kernels.csr_spmm import (  # noqa: F401
    csr_spmm,
    csr_spmm_plain,
)
from graph_neural_pde_tpu_torch.kernels.edge_dot import (  # noqa: F401
    edge_dot,
    edge_dot_plain,
)
from graph_neural_pde_tpu_torch.kernels.fused_rhs import (  # noqa: F401
    fused_rhs_ax,
    fused_rhs_bwd,
    fused_rhs_bwd_plain,
    fused_rhs_bwd_sym,
    fused_rhs_bwd_sym_plain,
    fused_rhs_f,
    fused_rhs_fwd,
    fused_rhs_fwd_plain,
    fused_rowmax,
    fused_rowmax_plain,
    make_fused_ax_sym,
)
from graph_neural_pde_tpu_torch.kernels.segment_norm import (  # noqa: F401
    segment_norm,
    segment_norm_bwd,
    segment_norm_bwd_plain,
    segment_norm_plain,
)

KERNELS = (csr_spmm, edge_dot, segment_norm, segment_norm_bwd,
           fused_rhs_fwd, fused_rowmax, fused_rhs_bwd, fused_rhs_bwd_sym)
