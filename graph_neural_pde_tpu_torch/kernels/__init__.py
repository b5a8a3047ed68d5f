"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
on CPU tensors, and counts its kernel launches in ``<wrapper>.launches``.
Importing this package builds nothing; the kernels compile at first launch
(``kernels.build``).
"""

from graph_neural_pde_tpu_torch.kernels.blocked import (  # noqa: F401
    blocked_sddmm,
    blocked_sddmm_plain,
    blocked_spmm,
    blocked_spmm_plain,
)
from graph_neural_pde_tpu_torch.kernels.csr_spmm import (  # noqa: F401
    column_sum,
    csr_spmm,
    csr_spmm_plain,
)
from graph_neural_pde_tpu_torch.kernels.dense import (  # noqa: F401
    node_project,
    node_tables_plain,
    outer_reduce,
    outer_reduce_plain,
)
from graph_neural_pde_tpu_torch.kernels.dual_scatter import (  # noqa: F401
    column_head_sum,
    dual_gather,
    dual_gather_plain,
    dual_scatter,
    dual_scatter_add,
    dual_scatter_plain,
)
from graph_neural_pde_tpu_torch.kernels.edge_dot import (  # noqa: F401
    edge_dot,
    edge_dot_plain,
)
from graph_neural_pde_tpu_torch.kernels.fused_rhs import (  # noqa: F401
    fused_aggregate,
    fused_aggregate_plain,
    fused_bwd_composition,
    fused_rhs_aggregate,
    fused_rhs_ax,
    fused_rhs_bwd,
    fused_rhs_bwd_col,
    fused_rhs_bwd_col_plain,
    fused_rhs_bwd_heads,
    fused_rhs_bwd_heads_plain,
    fused_rhs_bwd_plain,
    fused_rhs_bwd_sym,
    fused_rhs_bwd_sym_plain,
    fused_rhs_f,
    fused_rhs_fwd,
    fused_rhs_fwd_plain,
    fused_rowmax,
    fused_rowmax_plain,
    fused_score_max,
    fused_score_max_plain,
    make_fused_ax_colplan,
    make_fused_ax_sym,
)
from graph_neural_pde_tpu_torch.kernels.norm1 import (  # noqa: F401
    make_fused_ax_norm1,
    norm1_bwd,
    norm1_bwd_plain,
    norm1_den,
    norm1_den_plain,
    norm1_fwd,
    norm1_fwd_plain,
)
from graph_neural_pde_tpu_torch.kernels.row_gather import (  # noqa: F401
    row_gather,
    row_gather_plain,
)
from graph_neural_pde_tpu_torch.kernels.segment_norm import (  # noqa: F401
    segment_norm,
    segment_norm_bwd,
    segment_norm_bwd_plain,
    segment_norm_plain,
)
from graph_neural_pde_tpu_torch.kernels.shard_scatter import (  # noqa: F401
    ScatterPlan,
    shard_scatter,
)
from graph_neural_pde_tpu_torch.kernels.smem_gather import (  # noqa: F401
    smem_gather,
    smem_gather_plain,
)

KERNELS = (csr_spmm, edge_dot, segment_norm, segment_norm_bwd,
           fused_rhs_fwd, fused_rowmax, fused_rhs_bwd, fused_rhs_bwd_sym,
           dual_scatter, dual_gather, norm1_den, norm1_fwd, norm1_bwd,
           fused_rhs_bwd_col, fused_aggregate, fused_score_max,
           fused_rhs_bwd_heads, row_gather, smem_gather, blocked_spmm,
           blocked_sddmm)
# the dense products every fused kernel runs (csrc/dense.cuh): their
# launches inside the fused entry points count too (dense.count_fused)
DENSE_KERNELS = (node_project, outer_reduce)
# the kernels with a bfloat16-table mode, whose ``bf16_launches`` count the
# launches in it among their own (``fused_rhs_fwd.bf16_shifted_launches``
# those of them with the exact mode's shifts, ``csr_spmm.
# table_bf16_launches`` those of K1's in table mode, ``fused_rhs_bwd.
# bf16_rows_launches`` those of K8 without dxg, whose launches
# ``rows_launches`` counts apart from ``launches``; K20's bf16 mode writes
# bfloat16 rows)
BF16_KERNELS = (csr_spmm, edge_dot, fused_rhs_fwd, fused_rowmax,
                fused_rhs_bwd, fused_rhs_bwd_sym, fused_rhs_bwd_col,
                norm1_den, norm1_fwd, norm1_bwd, fused_aggregate,
                fused_score_max, fused_rhs_bwd_heads, dual_scatter,
                dual_gather, row_gather)
# the walks over row pieces, whose ``piece_builds`` count the calls that
# built the pieces from rowptr because none were handed over
ROW_WALKS = (fused_rhs_fwd, fused_rowmax, fused_rhs_bwd, fused_rhs_bwd_sym,
             norm1_den, norm1_fwd, norm1_bwd, dual_scatter, dual_gather,
             fused_aggregate, fused_score_max, fused_rhs_bwd_heads)
