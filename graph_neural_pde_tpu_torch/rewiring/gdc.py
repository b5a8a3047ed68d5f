"""Graph Diffusion Convolution (GDC / DIGL) rewiring, its positional
encoding and the two-hop rewiring (PyTorch port of ``rewiring/gdc.py``).

The reference drives these through ``graph_rewiring.apply_gdc`` and
``GDCWrapper.position_encoding``:

* transition matrices: ``sym`` D^-1/2 A D^-1/2 with D the COLUMN sums on
  both sides (as the JAX package computes it), ``col`` A D^-1, ``row``
  D^-1 A;
* exact diffusion: PPR alpha (I - (1 - alpha) T)^-1 and heat exp(t (T - I));
  the approximate PPR by 64 power iterations;
* sparsification: the top k entries of each column (an entry equal to the
  k-th value is kept, so ties keep more than k) or a global threshold.

The math is dense N x N, as in the reference's exact path, so it is meant
for the citation-scale graphs it is used on. It runs in float32 torch on
``device``, the card unless the caller asks for the CPU (``run.py``
passes the run's device);
``torch.linalg.inv``, ``matrix_exp`` and ``matmul`` stand where the JAX
package leaves the same products to XLA. The rewired edge list comes back
to the host as a new ``Graph`` whose edge multiset and weights are in
general not symmetric. ``two_hop`` is a host scipy product, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.ops.graph import (Graph, dense_adjacency,
                                                  make_graph)


def _safe_inverse(deg: torch.Tensor, fn) -> torch.Tensor:
    pos = deg > 0
    return torch.where(pos, fn(torch.where(pos, deg, torch.ones_like(deg))),
                       torch.zeros_like(deg))


def transition_matrix(a: torch.Tensor, normalization: str) -> torch.Tensor:
    deg = torch.sum(a, dim=0)
    if normalization == "sym":
        dis = _safe_inverse(deg, torch.rsqrt)
        return dis[:, None] * a * dis[None, :]
    if normalization == "col":
        return a * _safe_inverse(deg, torch.reciprocal)[None, :]
    if normalization == "row":
        deg_r = torch.sum(a, dim=1)
        return _safe_inverse(deg_r, torch.reciprocal)[:, None] * a
    raise ValueError(normalization)


def _eye(t_mat: torch.Tensor) -> torch.Tensor:
    return torch.eye(t_mat.shape[0], dtype=t_mat.dtype, device=t_mat.device)


def exact_ppr_matrix(t_mat: torch.Tensor, alpha: float) -> torch.Tensor:
    """alpha (I - (1 - alpha) T)^-1 (DIGL's exact personalised PageRank)."""
    return alpha * torch.linalg.inv(_eye(t_mat) - (1.0 - alpha) * t_mat)


def exact_heat_matrix(t_mat: torch.Tensor, t: float) -> torch.Tensor:
    """exp(t (T - I)), the heat kernel."""
    return torch.linalg.matrix_exp(t * (t_mat - _eye(t_mat)))


def approx_ppr_matrix(t_mat: torch.Tensor, alpha: float,
                      iters: int = 64) -> torch.Tensor:
    """Power-iteration PPR: S_{k+1} = alpha I + (1 - alpha) T S_k from
    S_0 = I."""
    eye = _eye(t_mat)
    s = eye
    for _ in range(iters):
        s = alpha * eye + (1.0 - alpha) * t_mat @ s
    return s


def sparsify_topk(mat: torch.Tensor, k: int, dim: int = 0) -> torch.Tensor:
    """Keep the entries at or above the k-th largest along ``dim``: per
    column with ``dim=0`` (PyG's ``sparsify_dense`` 'topk')."""
    kth = torch.topk(mat, k, dim=dim).values.select(dim, k - 1)
    kth = kth[None, :] if dim == 0 else kth[:, None]
    return torch.where(mat >= kth, mat, torch.zeros_like(mat))


def sparsify_threshold(mat: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(mat >= eps, mat, torch.zeros_like(mat))


def diffusion_dense(g: Graph, cfg: Config, device="cuda") -> torch.Tensor:
    """Self-loops, the 'sym' transition, then the exact or approximate
    diffusion: the dense [N, N] matrix on ``device``."""
    a = dense_adjacency(g, device)
    if cfg.self_loop_weight:
        a = a + cfg.self_loop_weight * _eye(a)
    t_in = transition_matrix(a, "sym")
    if cfg.gdc_method == "ppr":
        if cfg.exact:
            return exact_ppr_matrix(t_in, cfg.ppr_alpha)
        return approx_ppr_matrix(t_in, cfg.ppr_alpha)
    if cfg.gdc_method == "heat":
        return exact_heat_matrix(t_in, cfg.heat_time)
    raise ValueError(f"unknown gdc_method {cfg.gdc_method}")


def apply_gdc(g: Graph, cfg: Config, *, pad_multiple: int = 1,
              device="cuda") -> Graph:
    """GDC rewiring: diffuse, sparsify, normalise over columns; returns a
    new host Graph of the matrix's nonzeros in row-major order (the
    reference's apply_gdc 'combined' semantics)."""
    s = diffusion_dense(g, cfg, device)
    if cfg.gdc_sparsification == "topk":
        s = sparsify_topk(s, cfg.gdc_k, dim=0)
    else:
        s = sparsify_threshold(s, cfg.gdc_threshold)
    s = transition_matrix(s, "col").cpu().numpy()
    r, c = np.nonzero(s)
    return make_graph(r.astype(np.int32), c.astype(np.int32), s[r, c],
                      num_nodes=g.num_nodes, pad_multiple=pad_multiple)


def gdc_position_encoding(g: Graph, cfg: Config,
                          device="cuda") -> torch.Tensor:
    """The dense diffusion matrix, normalised over columns and not
    sparsified, as positional encodings: rows or (default) columns per
    ``cfg.pos_enc_orientation``."""
    s = transition_matrix(diffusion_dense(g, cfg, device), "col")
    return s if cfg.pos_enc_orientation == "row" else s.T


def two_hop(g: Graph, *, pad_multiple: int = 1) -> Graph:
    """The graph with its two-hop edges added, self-loops dropped and each
    (row, col) pair kept once (the reference's TwoHop transform), as a host
    scipy product."""
    import scipy.sparse as sp
    mask = g.mask.cpu().numpy()
    r = g.row.cpu().numpy()[mask]
    c = g.col.cpu().numpy()[mask]
    n = g.num_nodes
    a = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n)).tocsr()
    a2 = (a @ a).tocoo()
    rows = np.concatenate([r, a2.row])
    cols = np.concatenate([c, a2.col])
    keep = rows != cols
    key = rows[keep].astype(np.int64) * n + cols[keep]
    _, idx = np.unique(key, return_index=True)
    rr, cc = rows[keep][idx], cols[keep][idx]
    return make_graph(rr.astype(np.int32), cc.astype(np.int32), None,
                      num_nodes=n, pad_multiple=pad_multiple)
