"""K6-K9, K17-K19: the fused attention right-hand side of GRAND-nl, its
row maxima, its backward passes, and the same over a per-edge payload.

One evaluation of the transformer ODE function recomputes multihead
attention and aggregates with it. With row-normalised softmax the softmax
groups are the aggregation's output rows, so one walk over a row's edges
gives everything (``n`` a row, ``e`` its edges, ``c = col[e]``):

    q_n  = x_n Qw + qb                       [ATT]
    k_e  = x_c Kw + kb                       [ATT]
    s_eh = score_h(q_n, k_e)                 (five families, below)
    u_eh = exp(s_eh - gmax - shift_eh)       (or squareplus of the same)
    den[n, h] = sum_e u_eh
    ax[n]     = (1/H) sum_h (sum_e u_eh x_c) / (den[n, h] + 1e-16)

The families are the reference's four (scaled_dot, cosine_sim, pearson,
exp_kernel with its ``var`` and ``ls``) and BLEND's split-space
``exp_kernel_beltrami``, the product of a feature-space and a
position-space Gaussian kernel. Its q and k pack both spaces side by side
(``models.functions.pack_beltrami``: ATT = 2 A, the feature projection
Qx in columns [0, A), the position projection Qp in [A, 2 A)); head h reads
its d_k = A / H columns in each half, and ``var``, ``ls`` hold two elements
each, the feature factor's and the position factor's:

    s_eh = var_0^2 exp(-|qx - kx|^2 / 2 ls_0^2) var_1^2 exp(-|qp - kp|^2 / 2 ls_1^2)

* K6 ``fused_rhs_fwd``     -> (ax, den[, num]) or, folded, the guarded
  ``f = alpha (ax - x)``; replaces ``ops/pallas/fused_rhs.py``
  ``_rhs_kernel_ax`` / ``_fused_ax_call``.
* K7 ``fused_rowmax``      -> per-row, per-head maxima of the scaled-dot
  scores (edgeless rows 0), over K6's row pieces; replaces
  ``_rowmax_kernel`` / ``fused_rowmax``.
* K8 ``fused_rhs_bwd``     -> (dq, per-edge dxg, dkw, dkb, dgmax, dvar, dls)
  from the cotangents (a walk over the row pieces that also writes each
  edge's dk_e, then dxg on the tensor cores, ``csrc/fused_bwd_edges.cu``),
  or without the per-edge dxg and dk (``want_dxg=False``: dq, dgmax and
  the score scalars, the same walk alone, ``csrc/fused_bwd_rows.cu``);
  replaces ``_bwd_kernel`` / ``_fused_bwd_mega_call``.
* K9 ``fused_rhs_bwd_sym`` -> the same with x[col]'s cotangent reduced into
  ``dxrow[n]`` through each edge's reverse edge, for symmetric edge
  multisets; replaces ``_bwd_sym_kernel`` / ``_fused_bwd_mega_sym_call``.
* K17 ``fused_rhs_bwd_col`` -> x[col]'s cotangent summed per column, and
  dkw, dkb from each column's summed dk, on any graph: a walk over the CSC
  view, its columns cut into pieces of at most ``COL_PIECE`` edges, that
  recomputes each edge's cotangent from node tables, so that no per-edge
  array exists; replaces
  ``_bwd_dx_col_kernel`` / ``_bwd_dx_col_call``.
* K18 ``fused_aggregate``  -> (num, den) with the keys projected from a
  per-EDGE payload ``x_g`` [E_pad, D] (the TPU kernel's operand, which need
  not be x[col]); replaces ``_rhs_kernel`` / ``_fused_call``. For the
  scaled-dot score no key is formed: Kw folds into each row's query
  (``csrc/payload_walk.cuh``) and the walk reads each payload row once.
* K19 ``fused_score_max``  -> the global maximum of the scaled-dot scores
  against that payload's keys; replaces ``_max_kernel`` /
  ``_fused_score_max_impl``.
* K8's per-head mode ``fused_rhs_bwd_heads`` -> the backward of K18 from
  per-head cotangents ``ct_num`` [N, H·D] (K8 takes their head average
  ``ct_ax`` with ``recip_p``); ``_bwd_kernel`` / ``_fused_bwd_mega_call``
  with ``recip_p=None``. For the scaled-dot score on K18's fold: dxg and
  each row's [a | b] in one walk, dq and dKw head by head in a node pass
  (:func:`node_design`).

K6-K9 and K17 (and so ``make_fused_ax_sym``, ``make_fused_ax_colplan``,
``fused_rhs_ax`` and ``fused_rhs_f``) also take the JAX package's bfloat16
payload (``rhs_payload_dtype="bfloat16"``): a bfloat16 column table
``xcol`` (x cast once a call) beside the row side ``x`` (float32, or
bfloat16 under the bf16 ODE state). q comes from x in float32; the
gathered values from ``xcol``; k from ``xcol`` as the JAX package's
composition computes ``k_e = x[col] @ Kw.astype(bf16) + kb.astype(bf16)``
in bfloat16 (:func:`bf16_k_table`), and its derivative is the bf16-rounded
Kw. Every cotangent, sum and output stays float32; the backward treats
each cast as the identity (the JAX package's own autodiff rounds the
cotangent of x[col] to bfloat16 and sums it there, and its Pallas column
plan packs its node table to bfloat16: neither is mirrored).

K18, K19 and K8's per-head mode (and so ``fused_rhs_aggregate``) take the
payload's bfloat16 mode as the JAX package's P8, P9 and P11 take it: a
bfloat16 ``x_g`` beside a float32 or (the bf16 ODE state) bfloat16
``x_n``. Each row is widened to float32 where it is read, and k_e =
x_g[e] Kw + kb is projected from the widened row with the float32 Kw and
kb and NOT rounded (unlike :func:`bf16_k_table`): every definition of the
op in the JAX package outside Pallas computes it so (``_scores_u``,
``_fused_bwd_composition``, the bench's oracle, the sharded RHS by type
promotion), and so does its Pallas kernel at ``dtype=float32``. Sums,
cotangents and outputs stay float32; ``fused_rhs_aggregate`` returns the
gradients of x_n and x_g in their own dtypes, each cast once at the end,
as the JAX package's ``_fused_bwd`` does.

The graph is the row-sorted CSR prefix ``Graph.sort_by_row`` leaves (K6-K9
walk its rows cut into ``Graph.row_pieces``, K17 its CSC view's column
pieces); the kernels gather their node rows themselves (see
``csrc/fused_rhs.cu``, ``csrc/fused_fwd.cu``, ``csrc/fused_common.cuh``,
``csrc/fused_bwd_rows.cuh``, ``csrc/fused_bwd_edges.cu`` and
``csrc/fused_payload.cu`` for what bounds them on the H100). On a
CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
PyTorch version beside it, which defines the semantics. ``fused_rhs_ax``,
``make_fused_ax_sym``, ``make_fused_ax_colplan`` and ``fused_rhs_f`` keep
the JAX package's names: the differentiable ops the models call;
``fused_rhs_aggregate`` (K18 and K8's per-head mode) and
``fused_bwd_composition``, its hand-derived backward in torch ops, those
the bench's oracles call.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from graph_neural_pde_tpu_torch.kernels import build
from graph_neural_pde_tpu_torch.kernels.csr_spmm import column_sum
from graph_neural_pde_tpu_torch.kernels.dense import (  # noqa: F401
    bf16_k_table, bf16_round, count_fused, dk_sums, project, reduce_blocks,
    sm_count)
from graph_neural_pde_tpu_torch.kernels.lanes import lanes
from graph_neural_pde_tpu_torch.ops.graph import (SCATTER_WHOLE, ColPieces,
                                                 column_pieces)

SCORES = {"scaled_dot": 0, "cosine_sim": 1, "pearson": 2, "exp_kernel": 3,
          "exp_kernel_beltrami": 4}
# the families with learnable scalars: elements of ``var`` and of ``ls``
SCALARS = {"exp_kernel": 1, "exp_kernel_beltrami": 2}
EPS = 1e-16
EPS_NORM = 1e-5         # the reference's cosine / pearson norm floor
MAX_DIM, MAX_ATT, MAX_HEADS = 256, 256, 32
MAX_SHARED_BYTES = 227 * 1024
WARPS_PER_BLOCK = 4


def head_slices(score: str, heads: int) -> int:
    """How many d_k-wide slices a q or k row holds: one a head, and two a
    head (features, then positions) for exp_kernel_beltrami."""
    return 2 * heads if score == "exp_kernel_beltrami" else heads


def edge_scores(src: torch.Tensor, dst: torch.Tensor, score: str,
                var: Optional[torch.Tensor] = None,
                ls: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge, per-head raw scores [E, H] from q/k rows [E, S, d_k]
    (``S = head_slices(score, H)``): the four reference score families
    (``exp_kernel`` takes its ``output_var`` and ``lengthscale``) and
    ``exp_kernel_beltrami`` (slices [0, H) the features, [H, 2 H) the
    positions; ``var`` and ``ls`` [2], the two factors' scalars)."""
    d_k = src.shape[-1]
    if score == "exp_kernel":
        sq = torch.sum((src - dst) ** 2, dim=-1)
        return var ** 2 * torch.exp(-sq / (2.0 * ls ** 2))
    if score == "exp_kernel_beltrami":
        sq = torch.sum((src - dst) ** 2, dim=-1)
        h = sq.shape[1] // 2
        return (var[0] ** 2 * torch.exp(-sq[:, :h] / (2.0 * ls[0] ** 2))
                * var[1] ** 2 * torch.exp(-sq[:, h:] / (2.0 * ls[1] ** 2)))
    if score == "scaled_dot":
        return torch.sum(src * dst, dim=-1) / math.sqrt(d_k)
    if score == "pearson":
        src = src - torch.mean(src, dim=-1, keepdim=True)
        dst = dst - torch.mean(dst, dim=-1, keepdim=True)
    elif score != "cosine_sim":
        raise ValueError(f"unknown score family '{score}'")
    num = torch.sum(src * dst, dim=-1)
    den = (torch.clamp_min(torch.linalg.vector_norm(src, dim=-1), EPS_NORM)
           * torch.clamp_min(torch.linalg.vector_norm(dst, dim=-1), EPS_NORM))
    return num / den


def _u_duds(sm: torch.Tensor, square_plus: bool):
    if square_plus:
        r = torch.sqrt(sm * sm + 4.0)
        return (sm + r) * 0.5, (1.0 + sm / r) * 0.5
    u = torch.exp(sm)
    return u, u


def _edges(rowptr, row, col):
    n_valid = int(rowptr[-1])
    return n_valid, row[:n_valid].long(), col[:n_valid].long()


def _node_sum(n: int, index: torch.Tensor, vals: torch.Tensor):
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add(0, index, vals)


def bf16_round_st(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 in value, in its dtype; the identity in the
    gradient (the kernels' backward takes every cast so)."""
    return t + (bf16_round(t) - t).detach()


def _col_side(x, xcol, kw, kb, c):
    """What an edge reads at its column: (the row side x in the weights'
    float type, the gathered values [E, D], the k rows [E, ATT], the Kw
    that is k's derivative). Without ``xcol`` the float32 path: x[c] and its per-edge
    projection; with it the bfloat16 column table and its k table."""
    if xcol is None:
        xe = x[c]
        return x, xe, xe @ kw + kb, kw
    wide = kw.dtype
    return (x.to(wide), xcol.to(wide)[c], bf16_k_table(xcol, kw, kb)[c],
            bf16_round(kw))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_rhs_fwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, *,
                        heads: int, score: str, var=None, ls=None,
                        shifts=None, square_plus: bool = False, alpha=None,
                        want_num: bool = False, xcol=None):
    """Plain version of K6: gathers, a per-head loop of ``index_add`` sums
    and the head-mean divide, in float32 (with ``xcol`` the values and k
    from that bfloat16 column table, see :func:`_col_side`)."""
    nv, r, c = _edges(rowptr, row, col)
    n, d = x.shape
    x, xe, ke, _ = _col_side(x, xcol, kw, kb, c)
    slices = head_slices(score, heads)
    src = (x @ qw + qb)[r].reshape(nv, slices, -1)
    ke = ke.reshape(nv, slices, -1)
    u, _ = _u_duds(_shifted(edge_scores(src, ke, score, var, ls), gmax,
                            shifts, nv), square_plus)
    den = _node_sum(n, r, u)
    num = torch.stack([_node_sum(n, r, u[:, h, None] * xe)
                       for h in range(heads)], dim=1)          # [N, H, D]
    out = torch.sum(num * (1.0 / (den + EPS))[:, :, None], dim=1) / heads
    if alpha is not None:
        out = torch.where(den_guard(den, rowptr, per_row=True),
                          torch.full_like(out, torch.nan), alpha * (out - x))
    return out, den, (num.reshape(n, heads * d) if want_num else None)


def fused_rowmax_plain(rowptr, row, col, x, qw, qb, kw, kb, *, heads: int,
                       xcol=None):
    """Plain version of K7: scaled-dot scores and a scatter max per row
    (with ``xcol`` the k rows of that bfloat16 column table, as K6 reads
    them: see :func:`_col_side`)."""
    nv, r, c = _edges(rowptr, row, col)
    n = x.shape[0]
    x, _, ke, _ = _col_side(x, xcol, kw, kb, c)
    src = (x @ qw + qb)[r].reshape(nv, heads, -1)
    s = edge_scores(src, ke.reshape(nv, heads, -1), "scaled_dot")
    m = torch.full((n, heads), -torch.inf, dtype=x.dtype, device=x.device)
    m = m.scatter_reduce(0, r[:, None].expand_as(s), s, "amax",
                         include_self=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _scores_vjp(src, ke, score, heads, var, ls):
    """The scores [E, H] of the q rows ``src`` and k rows ``ke`` [E, ATT],
    and their pullback: ``ds -> (dsrc, dke[, dvar, dls])``, the score's own
    derivative by autograd over :func:`edge_scores`."""
    with torch.enable_grad():
        src = src.detach().requires_grad_(True)
        ke = ke.detach().requires_grad_(True)
        wrt = [src, ke]
        if score in SCALARS:
            var = var.detach().requires_grad_(True)
            ls = ls.detach().requires_grad_(True)
            wrt += [var, ls]
        slices = head_slices(score, heads)
        s = edge_scores(src.reshape(src.shape[0], slices, -1),
                        ke.reshape(ke.shape[0], slices, -1), score, var, ls)
    return s.detach(), lambda ds: torch.autograd.grad(s, wrt, ds)


def _shifted(s, gmax, shifts, nv):
    sm = s - gmax
    return sm if shifts is None else sm - shifts[:nv]


def _bwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p,
               ct_den, *, heads, score, var, ls, shifts, square_plus,
               by_col, xcol=None):
    """The per-edge backward of both normalisations: ``recip_p`` and
    ``ct_den`` are read at each edge's softmax group, its row or
    (``by_col``) its column. Returns fused_rhs_bwd_plain's tuple; with
    ``xcol`` (see :func:`_col_side`) dxg, dkw and dkb are those of the
    bfloat16 column table's values and k."""
    nv, r, c = _edges(rowptr, row, col)
    n, d = ct_ax.shape
    x, xe, ke, kw = _col_side(x, xcol, kw, kb, c)
    s, pullback = _scores_vjp((x @ qw + qb)[r], ke, score, heads, var, ls)
    u, duds = _u_duds(_shifted(s, gmax, shifts, nv), square_plus)
    group = c if by_col else r
    rg = recip_p[group]
    dot = torch.sum(ct_ax[r] * xe, dim=1, keepdim=True)
    ds = (rg * dot + ct_den[group]) * duds
    dsrc, dke, *dextra = pullback(ds)
    dq = _node_sum(n, r, dsrc)
    dxg = torch.zeros((row.shape[0], d), dtype=ct_ax.dtype,
                      device=x.device)
    dxg[:nv] = (torch.sum(u * rg, dim=1, keepdim=True) * ct_ax[r]
                + dke @ kw.T)
    dvar, dls = dextra if dextra else (None, None)
    return (dq, dxg, xe.T @ dke, torch.sum(dke, dim=0), -torch.sum(ds), dvar,
            dls)


def fused_rhs_bwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax,
                        recip_p, ct_den, *, heads: int, score: str, var=None,
                        ls=None, shifts=None, square_plus: bool = False,
                        want_dxg: bool = True, xcol=None):
    """Plain version of K8. With ``recip_p = 1 / (H (den + 1e-16))`` and
    ``ct_den`` the total cotangent of ``den``:

        du_eh = (ct_ax[n] . x_c) recip_p[n, h] + ct_den[n, h]
        ds_eh = du_eh  du/ds
        dq[n] = sum_e ds . ds/dq,   dk_e = ds . ds/dk
        dxg[e] = (sum_h u_eh recip_p[n, h]) ct_ax[n] + dk_e Kw^T
        dkw = sum_e x_c^T dk_e,  dkb = sum_e dk_e,  dgmax = -sum ds

    The score's own derivative comes from autograd over
    :func:`edge_scores`. Returns (dq [N, ATT], dxg [E_pad, D], dkw, dkb,
    dgmax, dvar, dls); dxg, dkw and dkb are None without ``want_dxg``
    (K17 forms dkw and dkb there), dvar and dls (shaped as var and ls) are
    None but for ``exp_kernel`` and ``exp_kernel_beltrami``. With ``xcol``
    x_c and k_e come from that bfloat16 column table (:func:`_col_side`),
    Kw is its bf16-rounded self, and dxg, dkw and dkb are the table's."""
    out = _bwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax,
                     recip_p, ct_den, heads=heads, score=score, var=var,
                     ls=ls, shifts=shifts, square_plus=square_plus,
                     by_col=False, xcol=xcol)
    return out if want_dxg else (out[0], None, None, None) + out[4:]


def fused_rhs_bwd_sym_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax,
                            recip_p, ct_den, *, heads: int, score: str,
                            var=None, ls=None, square_plus: bool = False,
                            xcol=None):
    """Plain version of K9: K8's outputs with the per-edge ``dxg`` summed
    over columns into ``dxrow`` [N, D] (on a symmetric edge multiset the
    kernel reaches the same sum through each edge's reverse edge); with
    ``xcol`` over the bfloat16 column table (:func:`_col_side`)."""
    dq, dxg, dkw, dkb, dgmax, dvar, dls = _bwd_plain(
        rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den,
        heads=heads, score=score, var=var, ls=ls, shifts=None,
        square_plus=square_plus, by_col=False, xcol=xcol)
    nv, _, c = _edges(rowptr, row, col)
    return dq, _node_sum(x.shape[0], c, dxg[:nv]), dkw, dkb, dgmax, dvar, dls


def fused_rhs_bwd_col_plain(colptr, col_by_col, row_by_col, x, qw, qb, kw,
                            kb, gmax, ct_ax, recip_p, ct_den, *, heads: int,
                            score: str, var=None, ls=None,
                            square_plus: bool = False, xcol=None):
    """Plain version of K17: K8's per-edge ``dxg`` (softmax groups the rows)
    over the edges in column order, summed per column into dx [N, D]:

        dx[n] = sum_{e: col[e]=n} (sum_h u_eh recip_p[r, h]) ct_ax[r]
                                  + dk_e Kw^T,            r = row[e]

    (the caller adds ``dq Qw^T``), and K8's ``dkw = sum_e x_c^T dk_e`` and
    ``dkb = sum_e dk_e``; with ``xcol`` over that bfloat16 column table
    (:func:`_col_side`). Returns (dx, dkw, dkb)."""
    out = _bwd_plain(colptr, row_by_col, col_by_col, x, qw, qb, kw, kb,
                     gmax, ct_ax, recip_p, ct_den, heads=heads, score=score,
                     var=var, ls=ls, shifts=None, square_plus=square_plus,
                     by_col=False, xcol=xcol)
    nv, _, c = _edges(colptr, row_by_col, col_by_col)
    return _node_sum(x.shape[0], c, out[1][:nv]), out[2], out[3]


def fused_aggregate_plain(rowptr, row, x_n, x_g, qw, qb, kw, kb, gmax, *,
                          heads: int, score: str, var=None, ls=None,
                          shifts=None, square_plus: bool = False):
    """Plain version of K18: ``(num [N, H·D], den [N, H])`` with the keys
    projected from the per-edge payload ``x_g`` [E_pad, D] (edge e's row of
    the row-sorted CSR prefix), not from a node table:

        q_n = x_n[n] Qw + qb,  k_e = x_g[e] Kw + kb,  s_eh = score_h(q_n, k_e)
        u_eh = exp(s_eh - gmax - shift_eh)     (or squareplus of the same)
        num[n, h·D:(h+1)·D] = sum_e u_eh x_g[e],  den[n, h] = sum_e u_eh

    A bfloat16 x_n or x_g is widened to the weights' type where it is
    read; k_e is not rounded.
    """
    nv, r, _ = _edges(rowptr, row, row)
    n = x_n.shape[0]
    x_n, xe = x_n.to(qw.dtype), x_g[:nv].to(qw.dtype)
    slices = head_slices(score, heads)
    src = (x_n @ qw + qb)[r].reshape(nv, slices, -1)
    ke = (xe @ kw + kb).reshape(nv, slices, -1)
    u, _ = _u_duds(_shifted(edge_scores(src, ke, score, var, ls), gmax,
                            shifts, nv), square_plus)
    num = torch.cat([_node_sum(n, r, u[:, h, None] * xe)
                     for h in range(heads)], dim=1)
    return num, _node_sum(n, r, u)


def fused_score_max_plain(rowptr, row, q, x_g, kw, kb, *, heads: int):
    """Plain version of K19: the largest scaled-dot score <q[row e], x_g[e]
    Kw + kb>_h / sqrt(d_k) over every valid edge and head, as a one-element
    tensor; 0 when it is not finite (an edgeless graph). A bfloat16 x_g
    is widened to the weights' type."""
    nv = int(rowptr[-1])
    if nv == 0:
        return torch.zeros(1, dtype=q.dtype, device=q.device)
    src = q[row[:nv].long()].reshape(nv, heads, -1)
    ke = (x_g[:nv].to(kw.dtype) @ kw + kb).reshape(nv, heads, -1)
    m = torch.amax(edge_scores(src, ke, "scaled_dot")).reshape(1)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def fused_rhs_bwd_heads_plain(rowptr, row, x_n, x_g, qw, qb, kw, kb, gmax,
                              ct_num, ct_den, *, heads: int, score: str,
                              var=None, ls=None, square_plus: bool = False):
    """Plain version of K8's per-head mode, the backward of K18 from the
    per-head cotangents ``ct_num`` [N, H·D] and ``ct_den`` [N, H]:

        du_eh = <ct_num[n, h], x_g[e]> + ct_den[n, h],  ds_eh = du_eh du/ds
        dq[n] = sum_e ds . ds/dq,   dk_e = ds . ds/dk
        dxg[e] = sum_h u_eh ct_num[n, h] + dk_e Kw^T
        dkw = sum_e x_g[e]^T dk_e,  dkb = sum_e dk_e,  dgmax = -sum ds

    Returns (dq [N, ATT], dxg [E_pad, D], dkw, dkb, dgmax, dvar, dls); dvar
    and dls (shaped as var and ls) are None but for ``exp_kernel`` and
    ``exp_kernel_beltrami``. A bfloat16 x_n or x_g is widened to the
    weights' type (dxg is of that type too)."""
    nv, r, _ = _edges(rowptr, row, row)
    n, d = x_n.shape
    x_n, xe = x_n.to(qw.dtype), x_g[:nv].to(qw.dtype)
    s, pullback = _scores_vjp((x_n @ qw + qb)[r], xe @ kw + kb, score, heads,
                              var, ls)
    u, duds = _u_duds(s - gmax, square_plus)
    ctn = ct_num.reshape(n, heads, d)[r]                       # [E, H, D]
    ds = (torch.sum(ctn * xe[:, None, :], dim=2) + ct_den[r]) * duds
    dsrc, dke, *dextra = pullback(ds)
    dxg = xe.new_zeros((x_g.shape[0], d))
    dxg[:nv] = torch.sum(u[:, :, None] * ctn, dim=1) + dke @ kw.T
    dvar, dls = dextra if dextra else (None, None)
    return (_node_sum(n, r, dsrc), dxg, xe.T @ dke, torch.sum(dke, dim=0),
            -torch.sum(ds), dvar, dls)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, rowptr, row, col, x, qw, qb, kw, kb, heads, score,
           var=None, ls=None, extra=(), xcol=None, xcol_shape=None):
    """Device, type, shape and contiguity of what the kernels read.
    ``extra`` is (name, tensor, shape) for the call's own float operands.
    The kernels are float32; on the CPU the plain versions also take
    float64 operands (all of one type). With a bfloat16 column table
    ``xcol`` (K6-K9, K12-K14, K17; of x's shape, or ``xcol_shape``: K18's
    and K8's per-head bfloat16 payload) x may be float32 or bfloat16. For
    exp_kernel_beltrami ``att`` is the packed width of both halves."""
    dev = x.device
    if score not in SCORES:
        raise ValueError(f"{name}: unknown score family '{score}'")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [N, D]")
    n, d = x.shape
    att = qw.shape[-1]
    if (heads < 1 or heads > MAX_HEADS or att % head_slices(score, heads)
            or att > MAX_ATT or d > MAX_DIM):
        raise ValueError(f"{name}: state width {d}, attention_dim {att}, "
                         f"heads {heads} outside the kernel's range (width "
                         f"<= {MAX_DIM}, heads <= {MAX_HEADS} dividing "
                         f"attention_dim <= {MAX_ATT}, each half of it "
                         "for exp_kernel_beltrami)")
    ints = (("rowptr", rowptr, (n + 1,)), ("row", row, None),
            ("col", col, row.shape))
    floats = [("x", x, (n, d)), ("qw", qw, (d, att)), ("qb", qb, (att,)),
              ("kw", kw, (d, att)), ("kb", kb, (att,)), *extra]
    if xcol is not None:
        _check_tables(name, x, xcol, xcol_shape)
        floats = floats[1:]
    if score in SCALARS:
        if var is None or ls is None:
            raise ValueError(f"{name}: {score} needs var and ls")
        floats += [("var", var, None), ("ls", ls, None)]
    _check_operands(name, dev, ints, floats)
    for t_name, t in (("var", var), ("ls", ls)):
        if score in SCALARS and t.numel() != SCALARS[score]:
            raise ValueError(f"{name}: {t_name} must hold {SCALARS[score]} "
                             f"element(s) for {score}")


def _check_operands(name, dev, ints, floats):
    """Each (name, tensor, shape or None) of ``ints`` (int32) and
    ``floats`` (float32; float64 also on the CPU, all of one type) on
    ``dev``, contiguous and of its shape; a CPU or CUDA device."""
    for t_name, t, shape in (*ints, *floats):
        if t.device != dev:
            raise ValueError(f"{name}: {t_name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {t_name} is {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    for t_name, t, _ in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {t_name} must be int32")
    wide = dev.type == "cpu" and floats[0][1].dtype == torch.float64
    for t_name, t, _ in floats:
        if t.dtype != (torch.float64 if wide else torch.float32):
            raise TypeError(f"{name}: {t_name} must be float32")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name}: no kernel for {dev}")


def _check_tables(name, x, xcol, shape=None):
    """The bfloat16 column table of K6-K9, K12-K14 and K17 (of x's shape)
    or the bfloat16 payload of K18, K19 and K8's per-head mode (of
    ``shape``) beside the row side x (K19: q, float32)."""
    shape = tuple(x.shape if shape is None else shape)
    if xcol.dtype != torch.bfloat16 or x.dtype not in (torch.float32,
                                                       torch.bfloat16):
        raise TypeError(f"{name}: the bfloat16 table must be bfloat16 and "
                        f"x float32 or bfloat16, not {xcol.dtype} and "
                        f"{x.dtype}")
    if xcol.device != x.device or tuple(xcol.shape) != shape:
        raise ValueError(f"{name}: the bfloat16 table {tuple(xcol.shape)} "
                         f"on {xcol.device} must be {shape} on {x.device}")
    if not (x.is_contiguous() and xcol.is_contiguous()):
        raise ValueError(f"{name}: x and the bfloat16 table must be "
                         "contiguous")


def _tables(x, xcol) -> int:
    """The C entry points' TABLES code: 0 float32, 1 a float32 row side
    beside a bfloat16 column table, 2 both bfloat16."""
    if xcol is None:
        return 0
    return 1 if x.dtype == torch.float32 else 2


def _col_projection(kw, kb, xcol):
    """The Kw and kb a kernel's k table is projected with: as given, or
    rounded to bfloat16 for a bfloat16 column table."""
    if xcol is None:
        return kw, kb
    return bf16_round(kw).contiguous(), bf16_round(kb).contiguous()


def _shared_bytes(name: str, floats_per_warp: int) -> None:
    if floats_per_warp * 4 * WARPS_PER_BLOCK > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: state width, attention_dim and heads "
                         "need more shared memory than a block has")


_ptr = build.ptr


def _node_tables(x: torch.Tensor, att: int) -> torch.Tensor:
    """Scratch for a kernel's first pass: every node's q and k projections
    [2, N, ATT], which the row walk then gathers per edge. The caller holds
    it in a variable across the launch: a temporary would hand its memory
    to the next allocation."""
    return torch.empty((2, x.shape[0], att), dtype=torch.float32,
                       device=x.device)


class NodeTables:
    """The kernels' scratch: every node's q and k projections [N, ATT],
    which a row walk gathers per edge (the k table in bfloat16 beside a
    bfloat16 column table, in the first half of its float32 storage). The
    first launch that takes the tables fills them (``project()`` answers 1
    once), later launches on the same operands reuse them."""

    def __init__(self, x: torch.Tensor, att: int):
        self.q, self.k = _node_tables(x, att)
        self.filled = False

    def project(self) -> int:
        first, self.filled = not self.filled, True
        return int(first)


def node_tables(x: torch.Tensor, att: int):
    """Tables for the launches of one forward or one backward pass over
    ``x`` (None on the CPU: the plain versions keep no scratch)."""
    return NodeTables(x, att) if x.device.type == "cuda" else None


def _flags(score: str, square_plus: bool) -> int:
    return SCORES[score] | (8 if square_plus else 0)


def _row_pieces(fn, rowptr, pieces: Optional[ColPieces], n: int, dev,
                whole: int = 0):
    """The row pieces a walk over rows takes on CUDA tensors (K6, K8
    without dxg, K9-K14): the graph's own (``Graph.row_pieces``, K10's
    ``Graph.scatter_pieces``, which every model path hands over), or, when
    None, ``column_pieces(rowptr, whole=whole)`` built here, a copy to the
    host that the wrapper ``fn`` counts (``fn.piece_builds``)."""
    if pieces is None:
        pieces = column_pieces(rowptr, whole=whole)
        fn.piece_builds += 1
    if pieces.ptr.device != dev or pieces.n_pieces < n:
        raise ValueError(f"{fn.__name__}: the row pieces must be those of "
                         f"this graph's rowptr, on {dev}")
    return pieces


def _aligned(d: int, *tensors) -> int:
    """1 when the D-wide rows of every tensor given start on 16-byte
    boundaries (d % 4 == 0, aligned storage): the walks' ``vec``."""
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors
                                  if t is not None))


def fused_rhs_fwd(rowptr, row, col, x, qw, qb, kw, kb, gmax, *, heads: int,
                  score: str, var=None, ls=None, shifts=None,
                  square_plus: bool = False, alpha=None,
                  want_num: bool = False, xcol=None,
                  pieces: Optional[ColPieces] = None):
    """K6. Returns ``(ax [N, D], den [N, H], num)``; ``num`` [N, H·D], the
    per-head numerators the backward reads, only when ``want_num``. With
    ``alpha`` (a one-element tensor) the first output is instead the folded
    ``alpha (ax - x)``, NaN on every row whose ``den`` under- or overflowed
    (``den <= 0`` with edges, or non-finite). ``gmax`` is a one-element
    tensor, ``shifts`` optional per-edge score shifts [E_pad, H] (the
    exact mode's, K7's row maxima). ``xcol`` is the bfloat16 column table
    (x cast to bfloat16; see the module docstring). ``pieces``: the rows
    cut into pieces of at most ``COL_PIECE`` edges (``Graph.row_pieces``),
    which the kernel's warps walk (``csrc/fused_common.cuh``,
    ``fwd_walk_piece``); built from ``rowptr`` when None. ``row`` is only
    read by the plain version. Every sum has a fixed order: two calls
    agree bit for bit. Not differentiable by itself."""
    n, d = x.shape
    extra = [("gmax", gmax, None)]
    if shifts is not None:
        extra.append(("shifts", shifts, (row.shape[0], heads)))
    if alpha is not None:
        extra.append(("alpha", alpha, None))
    _check("fused_rhs_fwd", rowptr, row, col, x, qw, qb, kw, kb, heads,
           score, var, ls, extra, xcol)
    kwargs = dict(heads=heads, score=score, var=var, ls=ls, shifts=shifts,
                  square_plus=square_plus, alpha=alpha, want_num=want_num)
    if x.device.type == "cpu":
        return fused_rhs_fwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                                   xcol=xcol, **kwargs)
    att = qw.shape[1]
    dev = x.device
    pc = _row_pieces(fused_rhs_fwd, rowptr, pieces, n, dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    den = torch.empty((n, heads), dtype=torch.float32, device=dev)
    num = (torch.empty((n, heads * d), dtype=torch.float32, device=dev)
           if want_num else None)
    # scratch: the pieces' partial sums, H numerators and H denominators
    part = (torch.empty((pc.n_slots, heads * (d + 1)), dtype=torch.float32,
                        device=dev) if pc.n_multi else None)
    tabs = _node_tables(x, att)
    kw, kb = _col_projection(kw, kb, xcol)
    build.launch("fused_rhs_fwd", dev, pc.ptr.data_ptr(), pc.col.data_ptr(),
                 pc.slot.data_ptr(), pc.multi_col.data_ptr(),
                 pc.multi_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                 _ptr(xcol), qw.data_ptr(), qb.data_ptr(), kw.data_ptr(),
                 kb.data_ptr(), gmax.data_ptr(), _ptr(var), _ptr(ls),
                 _ptr(shifts), _ptr(alpha), tabs[0].data_ptr(),
                 tabs[1].data_ptr(), out.data_ptr(), den.data_ptr(),
                 _ptr(num), _ptr(part), n, pc.n_pieces, pc.n_multi, d, att,
                 heads, _flags(score, square_plus),
                 _aligned(d, x, xcol, out, num), _tables(x, xcol))
    fused_rhs_fwd.launches += 1
    count_fused(_tables(x, xcol), 1)
    fused_rhs_fwd.bf16_launches += xcol is not None
    fused_rhs_fwd.bf16_shifted_launches += (xcol is not None
                                            and shifts is not None)
    return out, den, num


def fused_rowmax(rowptr, row, col, x, qw, qb, kw, kb, *, heads: int,
                 xcol=None, pieces: Optional[ColPieces] = None):
    """K7: [N, H] per-row maxima of the scaled-dot scores, 0 on edgeless
    rows: the shifts of the exact softmax. Its kernel walks the rows cut
    into ``pieces`` (``Graph.row_pieces``; built from ``rowptr`` when None,
    see :func:`fused_rhs_fwd`) and scores each edge as K6's does (the same
    tables, with the bfloat16 column table ``xcol`` K6's bf16 k table, and
    the same order of every sum), so each row's largest shifted score is
    exactly 0; the pieces of a longer row are merged in piece order. Not
    differentiable."""
    _check("fused_rowmax", rowptr, row, col, x, qw, qb, kw, kb, heads,
           "scaled_dot", xcol=xcol)
    if x.device.type == "cpu":
        return fused_rowmax_plain(rowptr, row, col, x, qw, qb, kw, kb,
                                  heads=heads, xcol=xcol)
    n, d = x.shape
    att = qw.shape[1]
    dev = x.device
    pc = _row_pieces(fused_rowmax, rowptr, pieces, n, dev)
    smax = torch.empty((n, heads), dtype=torch.float32, device=dev)
    # scratch: the pieces' maxima
    part = (torch.empty((pc.n_slots, heads), dtype=torch.float32, device=dev)
            if pc.n_multi else None)
    tabs = _node_tables(x, att)
    kw, kb = _col_projection(kw, kb, xcol)
    build.launch("fused_rowmax", dev, pc.ptr.data_ptr(), pc.col.data_ptr(),
                 pc.slot.data_ptr(), pc.multi_col.data_ptr(),
                 pc.multi_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                 _ptr(xcol), qw.data_ptr(), qb.data_ptr(), kw.data_ptr(),
                 kb.data_ptr(), tabs[0].data_ptr(), tabs[1].data_ptr(),
                 smax.data_ptr(), _ptr(part), n, pc.n_pieces, pc.n_multi, d,
                 att, heads, _tables(x, xcol))
    fused_rowmax.launches += 1
    count_fused(_tables(x, xcol), 1)
    fused_rowmax.bf16_launches += xcol is not None
    return smax


def _bwd_extra(x, heads, gmax, ct_ax, recip_p, ct_den, shifts, cap):
    n = x.shape[0]
    extra = [("gmax", gmax, None), ("ct_ax", ct_ax, x.shape),
             ("recip_p", recip_p, (n, heads)), ("ct_den", ct_den, (n, heads))]
    if shifts is not None:
        extra.append(("shifts", shifts, (cap, heads)))
    return extra


ROW_SUMS = 5        # a row's ds and the score scalars' terms (see _row_totals)


def _row_totals(row_sums, score, var, ls):
    """Second pass of the scalar reductions: dgmax and the score scalars'
    gradients from the per-row sums [N, 5] (ds; then var, ls of the
    feature factor and var, ls of the position factor), in a fixed
    order."""
    tot = torch.sum(row_sums, dim=0)                      # [5]
    dvar = dls = None
    if score in SCALARS:
        k = SCALARS[score]
        dvar = tot[1:1 + 2 * k:2].reshape(var.shape)
        dls = tot[2:2 + 2 * k:2].reshape(ls.shape)
    return -tot[0], dvar, dls


def _partials(rows: int, d: int, att: int, dev):
    """The first pass's partial tiles of the [x | 1]^T dk reduction (its
    row ranges :func:`~graph_neural_pde_tpu_torch.kernels.dense.
    reduce_blocks`), each written whole by the kernel: (blocks, [blocks,
    D + 1, ATT])."""
    blocks = reduce_blocks(rows, d, att, sm_count(dev))
    return blocks, torch.empty((blocks, d + 1, att), dtype=torch.float32,
                               device=dev)


def fused_rhs_bwd(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p,
                  ct_den, *, heads: int, score: str, var=None, ls=None,
                  shifts=None, square_plus: bool = False,
                  want_dxg: bool = True, xcol=None,
                  pieces: Optional[ColPieces] = None, tabs=None):
    """K8: the general backward (see :func:`fused_rhs_bwd_plain` for the
    formulas and the return value), over the rows cut into ``pieces``
    (``Graph.row_pieces``; built from ``rowptr`` when None, see
    :func:`fused_rhs_fwd`). Without ``want_dxg`` it forms neither the
    per-edge dxg nor dk_e, and so neither dkw nor dkb: the form that K17
    completes, counted in ``fused_rhs_bwd.rows_launches``
    (``bf16_rows_launches`` on the bfloat16 column table), which takes
    ``tabs`` (CUDA only): the q and k tables of a :func:`node_tables`
    call, which it fills for K17 to read. With dxg (the exact re-solve's
    backward, counted in ``launches`` and ``bf16_launches``) the same walk
    (``csrc/fused_bwd_rows.cuh``) also writes each edge's dk_e and w_e =
    sum_h u_eh recip_p[n, h], a pass on the tensor cores forms dxg[e] =
    w_e ct_ax[n] + dk_e Kw^T for every slot (zeros past the valid edges)
    and dkw, dkb are reduced over the slots (``csrc/fused_bwd_edges.cu``).
    With the bfloat16 column table ``xcol`` (K6's) it reads the gathered
    values and k there, and dxg and dkw are that table's. The reductions
    over all edges take two passes with fixed orders, so two calls agree
    bit for bit."""
    cap = row.shape[0]
    _check("fused_rhs_bwd", rowptr, row, col, x, qw, qb, kw, kb, heads,
           score, var, ls,
           _bwd_extra(x, heads, gmax, ct_ax, recip_p, ct_den, shifts, cap),
           xcol)
    kwargs = dict(heads=heads, score=score, var=var, ls=ls, shifts=shifts,
                  square_plus=square_plus, want_dxg=want_dxg, xcol=xcol)
    if x.device.type == "cpu":
        return fused_rhs_bwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                                   ct_ax, recip_p, ct_den, **kwargs)
    n, d = x.shape
    att = qw.shape[1]
    dev = x.device
    dq = torch.empty((n, att), dtype=torch.float32, device=dev)
    # scratch: each row's sums of ds and of the score scalars' terms
    row_sums = torch.empty((n, ROW_SUMS), dtype=torch.float32, device=dev)
    kw, kb = _col_projection(kw, kb, xcol)
    pc = _row_pieces(fused_rhs_bwd, rowptr, pieces, n, dev)
    # scratch: the pieces' partial sums, dq and the row sums
    part = (torch.empty((pc.n_slots, att + ROW_SUMS), dtype=torch.float32,
                        device=dev) if pc.n_multi else None)
    table = x if xcol is None else xcol
    vec = _aligned(d, table, ct_ax)
    if not want_dxg:
        tabs = tabs or node_tables(x, att)
        project = tabs.project()
        build.launch("fused_rhs_bwd_rows", dev, pc.ptr.data_ptr(),
                     pc.col.data_ptr(), pc.slot.data_ptr(),
                     pc.multi_col.data_ptr(), pc.multi_ptr.data_ptr(),
                     col.data_ptr(), x.data_ptr(), _ptr(xcol), qw.data_ptr(),
                     qb.data_ptr(), kw.data_ptr(), kb.data_ptr(),
                     gmax.data_ptr(), _ptr(var), _ptr(ls), _ptr(shifts),
                     ct_ax.data_ptr(), recip_p.data_ptr(), ct_den.data_ptr(),
                     tabs.q.data_ptr(), tabs.k.data_ptr(), dq.data_ptr(),
                     row_sums.data_ptr(), _ptr(part), n, pc.n_pieces,
                     pc.n_multi, d, att, heads, _flags(score, square_plus),
                     vec, project, _tables(x, xcol))
        fused_rhs_bwd.rows_launches += 1
        count_fused(_tables(x, xcol), project)
        fused_rhs_bwd.bf16_rows_launches += xcol is not None
        return (dq, None, None, None) + _row_totals(row_sums, score, var, ls)
    # dxg is written whole; dke (zeroed on the padding by the kernel) and
    # w are scratch, and so are the partial tiles of dkw, dkb
    blocks, partials = _partials(cap, d, att, dev)
    dxg = torch.empty((cap, d), dtype=torch.float32, device=dev)
    dke = torch.empty((cap, att), dtype=torch.float32, device=dev)
    w = torch.empty((cap,), dtype=torch.float32, device=dev)
    tabs, kw_t = _node_tables(x, att), kw.t().contiguous()
    build.launch("fused_rhs_bwd", dev, pc.ptr.data_ptr(), pc.col.data_ptr(),
                 pc.slot.data_ptr(), pc.multi_col.data_ptr(),
                 pc.multi_ptr.data_ptr(), row.data_ptr(), col.data_ptr(),
                 x.data_ptr(), _ptr(xcol), qw.data_ptr(), qb.data_ptr(),
                 kw.data_ptr(), kb.data_ptr(), gmax.data_ptr(), _ptr(var),
                 _ptr(ls), _ptr(shifts), ct_ax.data_ptr(),
                 recip_p.data_ptr(), ct_den.data_ptr(), kw_t.data_ptr(),
                 tabs[0].data_ptr(), tabs[1].data_ptr(), dq.data_ptr(),
                 dxg.data_ptr(), dke.data_ptr(), w.data_ptr(),
                 row_sums.data_ptr(), _ptr(part), partials.data_ptr(), n,
                 pc.n_pieces, pc.n_multi, d, att, heads,
                 _flags(score, square_plus), cap, blocks, vec,
                 _tables(x, xcol))
    fused_rhs_bwd.launches += 1
    count_fused(_tables(x, xcol), 1, reduce=True)
    fused_rhs_bwd.bf16_launches += xcol is not None
    return ((dq, dxg) + dk_sums(partials, d)
            + _row_totals(row_sums, score, var, ls))


def sym_design(d: int, att: int, heads: int, score: str) -> dict:
    """What K9 and K14's walk runs at these widths (csrc/fused_common.cuh,
    launch_walk and make_heads): its register tiles (``kd`` 16-byte
    column groups of a D-wide row and ``ka`` columns of a q or k row a
    lane, the kernel's template sizes) and how a head's terms are summed
    (``"lanes"``: a butterfly over d_k lanes; ``"tiles"``: over the 32
    lanes of d_k / 32 tiles; ``"buffer"``: in column order through the
    warp's buffer). One warp walks one edge of a row piece at a time."""
    d_k = att // head_slices(score, heads)
    belt = score == "exp_kernel_beltrami"
    paired = not belt or (att // 2) % 32 == 0 or att <= 32
    pow2 = d_k & (d_k - 1) == 0
    kd = 1 if d <= 128 else 2
    if score in ("cosine_sim", "pearson"):
        ka = 2 if att <= 64 else 8
    else:
        ka = 1 if att <= 32 else 2 if att <= 64 else 4 if att <= 128 else 8
    return dict(kd=kd, ka=ka,
                head_sum=("buffer" if not pow2 or not paired
                          else "lanes" if d_k <= 32 else "tiles"))


def fwd_design(d: int, att: int, heads: int, score: str) -> dict:
    """What K6 and K13's forward walk runs at these widths
    (csrc/fused_common.cuh, launch_fwd_walk and launch_fwd_heads): K9's
    tiles and way of summing a head (:func:`sym_design`), and ``kh``, the
    heads whose numerators K6 keeps in registers at once (2, or 8 at D <=
    128 when the row has more than 2; a row of more heads than ``kh``
    walks its piece once a group of ``kh``)."""
    design = sym_design(d, att, heads, score)
    return dict(design, kh=2 if heads <= 2 or design["kd"] == 2 else 8)


# K7's edges whose k rows are in flight at once (csrc/fused_fwd.cu,
# kRowmaxBatch)
ROWMAX_BATCH = 4
# the dxg pass's tile (csrc/dense.cuh: kMmaRows edges, kMmaCols columns of
# D, kProjDepth columns of ATT a stage)
DXG_ROWS, DXG_COLS, DXG_DEPTH = 128, 64, 32


def rowmax_design(att: int, heads: int) -> dict:
    """What K7's walk runs at these widths (csrc/fused_fwd.cu,
    launch_rowmax): K6's ``ka`` and way of summing a head
    (:func:`sym_design`, scaled_dot) and ``batch``, the edges of a row
    piece whose k rows are loaded and summed together."""
    design = sym_design(1, att, heads, "scaled_dot")
    return dict(ka=design["ka"], head_sum=design["head_sum"],
                batch=ROWMAX_BATCH)


def dxg_design(d: int, att: int, heads: int, score: str) -> dict:
    """What K8 with dxg runs at these widths: its walk's tiles
    (:func:`sym_design`, the walk of K8 without dxg) and the dxg pass's
    tensor-core tile (csrc/fused_bwd_edges.cu, launch_edge_project):
    ``rows`` edges by ``cols`` columns of D, ``groups`` column groups of D,
    ``ksteps`` stages of ``DXG_DEPTH`` columns of ATT (Kw^T resident)."""
    return dict(sym_design(d, att, heads, score), rows=DXG_ROWS,
                cols=DXG_COLS, groups=-(-d // DXG_COLS),
                ksteps=-(-att // DXG_DEPTH))


def sym_node_table(recip_p: torch.Tensor, ct_den: torch.Tensor):
    """The [N, H, 2] float32 table of each node's (recip_p, ct_den) per
    head, which K9 and K14 read at an edge's column in one 8-byte load a
    head."""
    return torch.stack((recip_p, ct_den), dim=-1).contiguous()


def _sym_walk(fn, rowptr, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p,
              ct_den, qtab, ktab, project, *, heads, score, var, ls,
              square_plus, xcol, pieces):
    """The launch behind K9 and K14 (the wrapper ``fn``) on CUDA tensors:
    the walk over the rows' ``pieces`` (:func:`_row_pieces`), the merge of
    multi-piece rows, and the reductions' second passes. ``qtab``,
    ``ktab`` the node tables [N, ATT] (filled by the launch unless
    ``project`` is 0). Returns (dq, dxrow, dkw, dkb, dgmax, dvar, dls)."""
    n, d = x.shape
    att = qw.shape[1]
    dev = x.device
    pc = _row_pieces(fn, rowptr, pieces, n, dev)
    dq = torch.empty((n, att), dtype=torch.float32, device=dev)
    dxrow = torch.empty((n, d), dtype=torch.float32, device=dev)
    # scratch: dk summed per NODE (each row's reverse edges), each row's
    # sums of ds and of the score scalars' terms, the pieces' partial sums
    dkn = torch.empty((n, att), dtype=torch.float32, device=dev)
    row_sums = torch.empty((n, ROW_SUMS), dtype=torch.float32, device=dev)
    part = (torch.empty((pc.n_slots, d + 2 * att + ROW_SUMS),
                        dtype=torch.float32, device=dev)
            if pc.n_multi else None)
    blocks, partials = _partials(n, d, att, dev)
    kw, kb = _col_projection(kw, kb, xcol)
    kw_t = kw.t().contiguous()
    rc = sym_node_table(recip_p, ct_den)
    table = x if xcol is None else xcol
    vec = _aligned(d, table, ct_ax, kw_t, dxrow)
    build.launch(fn.__name__, dev, pc.ptr.data_ptr(), pc.col.data_ptr(),
                 pc.slot.data_ptr(), pc.multi_col.data_ptr(),
                 pc.multi_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                 _ptr(xcol), qw.data_ptr(), qb.data_ptr(), kw.data_ptr(),
                 kb.data_ptr(), gmax.data_ptr(), _ptr(var), _ptr(ls),
                 ct_ax.data_ptr(), rc.data_ptr(), kw_t.data_ptr(),
                 qtab.data_ptr(), ktab.data_ptr(), dq.data_ptr(),
                 dxrow.data_ptr(), dkn.data_ptr(), row_sums.data_ptr(),
                 _ptr(part), partials.data_ptr(), n, pc.n_pieces,
                 pc.n_multi, d, att, heads, _flags(score, square_plus),
                 blocks, vec, *(() if project is None else (project,)),
                 _tables(x, xcol))
    count_fused(_tables(x, xcol), 1 if project is None else project,
                reduce=True)
    return ((dq, dxrow) + dk_sums(partials, d)
            + _row_totals(row_sums, score, var, ls))


def fused_rhs_bwd_sym(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax,
                      recip_p, ct_den, *, heads: int, score: str, var=None,
                      ls=None, square_plus: bool = False, xcol=None,
                      pieces: Optional[ColPieces] = None):
    """K9: the backward over a SYMMETRIC edge multiset (the caller checks
    ``Graph.rev is not None``): returns (dq, dxrow [N, D], dkw, dkb, dgmax,
    dvar, dls) with ``dxrow`` the whole x[col] cotangent. No per-edge array
    is written and no reverse-edge map is read: each edge (n, c) also
    evaluates its reverse edge (c, n) from node rows gathered at c. With
    the bfloat16 column table ``xcol`` (K6's), ``dxrow`` is the cotangent
    of that table's values and k (through the bf16-rounded Kw), taken as
    x's, and dkw is reduced over the table. ``pieces``: the rows cut into
    pieces (``Graph.row_pieces``), built from ``rowptr`` when None (see
    :func:`fused_rhs_fwd`). Every sum has a fixed order: two calls agree
    bit for bit."""
    _check("fused_rhs_bwd_sym", rowptr, row, col, x, qw, qb, kw, kb, heads,
           score, var, ls,
           _bwd_extra(x, heads, gmax, ct_ax, recip_p, ct_den, None, 0),
           xcol)
    kwargs = dict(heads=heads, score=score, var=var, ls=ls,
                  square_plus=square_plus)
    if x.device.type == "cpu":
        return fused_rhs_bwd_sym_plain(rowptr, row, col, x, qw, qb, kw, kb,
                                       gmax, ct_ax, recip_p, ct_den,
                                       xcol=xcol, **kwargs)
    tabs = _node_tables(x, qw.shape[1])
    out = _sym_walk(fused_rhs_bwd_sym, rowptr, col, x, qw, qb, kw, kb,
                    gmax, ct_ax, recip_p, ct_den, tabs[0], tabs[1], None,
                    xcol=xcol, pieces=pieces, **kwargs)
    fused_rhs_bwd_sym.launches += 1
    fused_rhs_bwd_sym.bf16_launches += xcol is not None
    return out


def fused_rhs_bwd_col(colptr, col_by_col, row_by_col, x, qw, qb, kw, kb,
                      gmax, ct_ax, recip_p, ct_den, *, heads: int, score: str,
                      var=None, ls=None, square_plus: bool = False,
                      xcol=None, pieces: Optional[ColPieces] = None,
                      tabs=None):
    """K17: (dx [N, D], dkw, dkb), x[col]'s cotangent summed per column
    and the key projection's gradients (see :func:`fused_rhs_bwd_col_plain`),
    on any graph. It walks the CSC view (``colptr``, ``row_by_col``) cut
    into ``pieces`` of at most ``COL_PIECE`` edges of one column
    (``Graph.col_pieces``; built from ``colptr`` when None, a copy to the
    host): one warp a piece computes the column's k once, recomputes each
    edge's score and cotangent from the node rows of its row (q, ct_ax,
    recip_p, ct_den) and sums them; a column of one piece is finished
    there, the partial sums of a longer column's pieces are added in piece
    order by a second pass. The column's summed dk is multiplied by Kw^T
    once; dkw and dkb are reduced from it over nodes, as K9's are. With
    the bfloat16 column table ``xcol`` (K6's) the column's own row and k
    come from that table and its k table, and dx is the table's cotangent
    (through the bf16-rounded Kw), taken as x's; dkw is reduced over the
    table. ``tabs`` (CUDA only): the q and k tables of a
    :func:`node_tables` call, which K8 without dxg filled on the same
    operands (the column-plan backward), or None: projected here.
    ``col_by_col`` is only read by the plain version. No atomics: two
    calls agree bit for bit."""
    n, d = x.shape
    _check("fused_rhs_bwd_col", colptr, col_by_col, row_by_col, x, qw, qb,
           kw, kb, heads, score, var, ls,
           _bwd_extra(x, heads, gmax, ct_ax, recip_p, ct_den, None, 0), xcol)
    if x.device.type == "cpu":
        return fused_rhs_bwd_col_plain(
            colptr, col_by_col, row_by_col, x, qw, qb, kw, kb, gmax, ct_ax,
            recip_p, ct_den, heads=heads, score=score, var=var, ls=ls,
            square_plus=square_plus, xcol=xcol)
    att = qw.shape[1]
    _shared_bytes("fused_rhs_bwd_col", 4 * d + 3 * att + 10 * heads)
    dev = x.device
    pc = column_pieces(colptr) if pieces is None else pieces
    if pc.ptr.device != dev or pc.n_pieces < n:
        raise ValueError("fused_rhs_bwd_col: the column pieces must be those "
                         f"of this CSC view, on {dev}")
    dx = torch.empty((n, d), dtype=torch.float32, device=dev)
    dkn = torch.empty((n, att), dtype=torch.float32, device=dev)
    part = (torch.empty((pc.n_slots, d + att), dtype=torch.float32,
                        device=dev) if pc.n_multi else None)
    blocks, partials = _partials(n, d, att, dev)
    kw, kb = _col_projection(kw, kb, xcol)
    tabs, kw_t = tabs or node_tables(x, att), kw.t().contiguous()
    project = tabs.project()
    build.launch("fused_rhs_bwd_col", dev, pc.ptr.data_ptr(),
                 pc.col.data_ptr(), pc.slot.data_ptr(),
                 pc.multi_col.data_ptr(), pc.multi_ptr.data_ptr(),
                 row_by_col.data_ptr(), x.data_ptr(), _ptr(xcol),
                 qw.data_ptr(), qb.data_ptr(), kw.data_ptr(), kb.data_ptr(),
                 gmax.data_ptr(), _ptr(var), _ptr(ls), ct_ax.data_ptr(),
                 recip_p.data_ptr(), ct_den.data_ptr(), kw_t.data_ptr(),
                 tabs.q.data_ptr(), tabs.k.data_ptr(), dx.data_ptr(),
                 dkn.data_ptr(), _ptr(part), partials.data_ptr(), n,
                 pc.n_pieces, pc.n_multi, d, att, heads,
                 _flags(score, square_plus), blocks, project,
                 _tables(x, xcol))
    fused_rhs_bwd_col.launches += 1
    count_fused(_tables(x, xcol), project, reduce=True)
    fused_rhs_bwd_col.bf16_launches += xcol is not None
    return (dx,) + dk_sums(partials, d)


# K8's per-head mode for the key families runs PAYLOAD_WARPS warps a
# block, which share the block's copy of Qw and Kw (rows padded by one
# float), and keeps a group of GROUP_EDGES payload rows per warp in shared
# memory: the sums of csrc/fused_payload.cu's ``padded_weight_floats`` and
# ``bwd_heads_warp_floats``.
GROUP_EDGES, PAYLOAD_WARPS = 8, 8


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _payload_shared(name, d, att, nbytes, staged="Qw and Kw are"):
    """Raise unless ``nbytes`` of shared memory fit in a block."""
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: state width {d} and attention_dim {att} "
                         f"need more shared memory than a block has ({staged} "
                         "staged there)")


def _payload_check(name, rowptr, row, x_n, x_g, qw, qb, kw, kb, heads, score,
                   var, ls, extra):
    """The operands of K18 and K8's per-head mode: the payload x_g
    [E_pad, D] float32 beside a float32 x_n, or bfloat16 beside a float32
    or bfloat16 x_n; everything else float32."""
    shape = (row.shape[0], x_n.shape[1])
    if x_g.dtype == torch.bfloat16:
        _check(name, rowptr, row, row, x_n, qw, qb, kw, kb, heads, score,
               var, ls, extra, xcol=x_g, xcol_shape=shape)
    else:
        _check(name, rowptr, row, row, x_n, qw, qb, kw, kb, heads, score,
               var, ls, [("x_g", x_g, shape), *extra])


def _payload_tables(x_n, x_g) -> int:
    """The TABLES code of K18, K19 and K8's per-head mode (see
    :func:`_tables`): the payload takes the column table's place."""
    return _tables(x_n, x_g if x_g.dtype == torch.bfloat16 else None)


# K18 and K8's per-head mode over the scaled-dot score walk the payload
# once with Kw folded into each row's query (csrc/payload_walk.cuh,
# payload_fwd.cu, payload_bwd.cu): r_nh = Kw_h q_nh / sqrt(d_k), c_nh =
# <q_nh, kb_h> / sqrt(d_k), s_eh = <x_g[e], r_nh> + c_nh. The other
# families need each edge's key and keep the walk of fused_payload.cu.


def payload_stride(d: int, heads: int) -> int:
    """S: the floats of a row's [a | b] and of a piece's partial row,
    H (D + 1) rounded up to 16 bytes (``csrc/piece_merge.cuh``,
    ``payload_stride``)."""
    return -(-heads * (d + 1) // 4) * 4


# the node pass of K8's per-head mode (csrc/payload_bwd.cu): nodes a
# stage, a head's columns a block at most, ranges of at least NODE_MIN
# nodes; an SM's shared memory and registers (what bounds the blocks
# resident on it), a thread's registers at most by rows (the kernel's
# launch bounds: 64 at 8 rows)
NODE_TILE, NODE_COLS, NODE_MIN = 32, 32, 64
SM_SHARED_BYTES, SM_REGISTERS = 228 * 1024, 65536
NODE_REGISTERS = {8: 64, 16: 128}


def node_design(d: int, att: int, heads: int) -> dict:
    """The node pass's block (``payload_bwd.cu``, ``launch_node_pass``):
    JC = ``cols`` of a head's d_k columns (``col_blocks`` blocks a head),
    R = ``rows`` of the D + 1 rows of [Kw_h | kb_h] a thread (8, or 16
    where 8 would take more than 512 threads), C = ``chunks`` of them,
    the threads (C JC rounded up to a warp), the shared memory (two
    stages of NODE_TILE nodes' rows and q columns, and dq's shares) and
    the blocks an SM holds."""
    dk = att // heads
    cols = min(dk, NODE_COLS)
    rows = 8 if -(-(d + 1) // 8) * cols <= 512 else 16
    chunks = -(-(d + 1) // rows)
    threads = -(-chunks * cols // 32) * 32
    shared = 4 * NODE_TILE * (2 * (chunks * rows + cols) + chunks * cols)
    per_sm = max(1, min(SM_SHARED_BYTES // (shared + 1024), 2048 // threads,
                        SM_REGISTERS // (NODE_REGISTERS[rows] * threads)))
    return dict(cols=cols, col_blocks=-(-dk // cols), rows=rows,
                chunks=chunks, threads=threads, shared=shared, per_sm=per_sm)


def node_ranges(n: int, d: int, att: int, heads: int, sms: int) -> int:
    """The node pass's ranges of nodes (each a block per head and column
    block): one wave of the blocks the SMs hold, each range at least
    NODE_MIN nodes."""
    des = node_design(d, att, heads)
    blocks = heads * des["col_blocks"]
    return max(1, min(-(-des["per_sm"] * sms // blocks), -(-n // NODE_MIN)))


def _piece_args(pc: ColPieces):
    return (pc.ptr.data_ptr(), pc.col.data_ptr(), pc.slot.data_ptr(),
            pc.multi_col.data_ptr(), pc.multi_ptr.data_ptr())


def _aggregate_walk(rowptr, x_n, x_g, qw, qb, kw, kb, gmax, heads, shifts,
                    square_plus, pieces):
    """K18 for the scaled-dot score: q on the node projections' tile, then
    the fold's walk (payload_fwd.cu)."""
    n, d = x_n.shape
    att = qw.shape[1]
    dev = x_n.device
    pc = _row_pieces(fused_aggregate, rowptr, pieces, n, dev, SCATTER_WHOLE)
    q, kwt = project(x_n, qw, qb), kw.t().contiguous()
    num = torch.empty((n, heads * d), dtype=torch.float32, device=dev)
    den = torch.empty((n, heads), dtype=torch.float32, device=dev)
    part = (torch.empty((pc.n_slots, payload_stride(d, heads)),
                        dtype=torch.float32, device=dev)
            if pc.n_multi else None)
    group, vec = lanes("payload_walk", d, x_g,
                       *[t for t in (kwt, num, part) if t is not None],
                       heads=heads)
    build.launch("payload_aggregate", dev, *_piece_args(pc), x_g.data_ptr(),
                 q.data_ptr(), kwt.data_ptr(), kb.data_ptr(), gmax.data_ptr(), _ptr(shifts), num.data_ptr(),
                 den.data_ptr(), _ptr(part), n, pc.n_pieces, pc.n_multi, d,
                 att, heads, int(square_plus), group, vec,
                 int(x_g.dtype == torch.bfloat16))
    fused_aggregate.walk_launches += 1
    return num, den


def _bwd_heads_walk(rowptr, x_n, x_g, qw, qb, kw, kb, gmax, ct_num, ct_den,
                    heads, square_plus, pieces):
    """K8's per-head mode for the scaled-dot score: q on the node
    projections' tile, then one call (payload_bwd.cu): the fold's walk
    writing dxg whole and each row's [a | b], and the node pass forming dq,
    dKw, dKb head by head and dgmax = -sum b (:func:`node_design`)."""
    n, d = x_n.shape
    att = qw.shape[1]
    cap = x_g.shape[0]
    dev = x_n.device
    stride = payload_stride(d, heads)
    pc = _row_pieces(fused_rhs_bwd_heads, rowptr, pieces, n, dev,
                     SCATTER_WHOLE)
    q, kwt = project(x_n, qw, qb), kw.t().contiguous()
    ranges = node_ranges(n, d, att, heads, sm_count(dev))

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    # every element of these is written by the walk or the node pass: no
    # memset
    dxg, ab, dq = empty(cap, d), empty(n, stride), empty(n, att)
    part = empty(pc.n_slots, stride) if pc.n_multi else None
    node_part, node_bsum = empty(ranges, d + 1, att), empty(ranges, heads)
    dkw, dkb, dgmax = empty(d, att), empty(att), empty()
    group, vec = lanes("payload_walk", d, x_g,
                       *[t for t in (kwt, ct_num, dxg, ab, part)
                         if t is not None], heads=heads)
    build.launch("payload_bwd", dev, *_piece_args(pc), x_g.data_ptr(),
                 q.data_ptr(), kwt.data_ptr(), kw.data_ptr(), kb.data_ptr(),
                 gmax.data_ptr(), ct_num.data_ptr(), ct_den.data_ptr(),
                 dxg.data_ptr(), ab.data_ptr(), _ptr(part), dq.data_ptr(),
                 node_part.data_ptr(), node_bsum.data_ptr(), dkw.data_ptr(),
                 dkb.data_ptr(), dgmax.data_ptr(), n, pc.n_pieces,
                 pc.n_multi, cap, d, att, heads, int(square_plus), group,
                 vec, int(x_g.dtype == torch.bfloat16), ranges)
    fused_rhs_bwd_heads.walk_launches += 1
    fused_rhs_bwd_heads.node_launches += 1
    return dq, dxg, dkw, dkb, dgmax, None, None


def fused_aggregate(rowptr, row, x_n, x_g, qw, qb, kw, kb, gmax, *,
                    heads: int, score: str, var=None, ls=None, shifts=None,
                    square_plus: bool = False,
                    pieces: Optional[ColPieces] = None):
    """K18: ``(num [N, H·D], den [N, H])`` of the attention RHS over the
    per-edge payload ``x_g`` [E_pad, D] (see :func:`fused_aggregate_plain`);
    ``gmax`` a one-element tensor, ``shifts`` optional per-edge score
    shifts [E_pad, H]. For the scaled-dot score Kw folds into each row's
    query (``csrc/payload_walk.cuh``): q on the node projections' tile,
    then lane groups sized by the row width fold each row and walk
    ``pieces`` (``Graph.scatter_pieces``; built from rowptr when None, a
    copy to the host counted in ``piece_builds``), reading each payload
    row once. The other families walk the same pieces in windows of
    consecutive pieces a block (``csrc/fused_payload.cu``): each tile of
    staged payload rows has its keys projected on the tensor cores from
    Kw's TF32 parts kept in shared memory (which must hold them and a tile
    of 16 rows: else it raises, :func:`key_design`), then is scored against
    q and summed from the same rows. Every sum runs in the row's edge
    order: two calls agree bit for bit. ``x_g`` may be bfloat16
    beside a float32 or bfloat16 ``x_n`` (see the module docstring); num
    and den are float32. Not differentiable by itself (see
    :func:`fused_rhs_aggregate`)."""
    extra = [("gmax", gmax, None)]
    if shifts is not None:
        extra.append(("shifts", shifts, (row.shape[0], heads)))
    _payload_check("fused_aggregate", rowptr, row, x_n, x_g, qw, qb, kw, kb,
                   heads, score, var, ls, extra)
    if x_n.device.type == "cpu":
        return fused_aggregate_plain(rowptr, row, x_n, x_g, qw, qb, kw, kb,
                                     gmax, heads=heads, score=score, var=var,
                                     ls=ls, shifts=shifts,
                                     square_plus=square_plus)
    if score == "scaled_dot":
        num, den = _aggregate_walk(rowptr, x_n, x_g, qw, qb, kw, kb, gmax,
                                   heads, shifts, square_plus, pieces)
    else:
        num, den = _aggregate_keys(rowptr, row, x_n, x_g, qw, qb, kw, kb,
                                   gmax, heads, score, var, ls, shifts,
                                   square_plus, pieces)
    fused_aggregate.launches += 1
    fused_aggregate.bf16_launches += x_g.dtype == torch.bfloat16
    return num, den


# K18 for the key families (csrc/fused_payload.cu, payload_keys_kernel):
# KEY_THREADS a block, whose shared memory holds Kw split into its high and
# low TF32 parts, two buffers of CAP staged payload rows and of their
# edges' row numbers (the next tile's arrive while one is used), their
# keys, their u and the carried sums: the largest CAP of KEY_CAPS at which
# two blocks share an SM, else the largest at which one fits. One wave of
# blocks, each a window of the pieces (the launcher divides the edges
# among them).
KEY_THREADS = 256
KEY_CAPS = (64, 48, 32, 16)
KEY_BLOCK_RESERVED = 1024           # shared memory the card keeps a block
# K19's blocks (csrc/payload_fwd.cu), which write a maximum each
SCORE_MAX_THREADS = 128


def key_shared(d: int, att: int, heads: int, elem: int, cap: int) -> dict:
    """The shared bytes of K18's key-family block at width ``d``, ``att``
    and ``heads`` over a payload of ``elem``-byte elements and tiles of
    ``cap`` rows, by region (``csrc/fused_payload.cu``'s ``key_layout``):
    ``weights`` (Kw's TF32 parts) and ``tiles`` (the rest)."""
    d8, a8 = -(-d // 8) * 8, -(-att // 8) * 8
    align = 128 // elem
    xs = -(-d // align) * align + 16 // elem
    return dict(weights=8 * d8 * a8,
                tiles=(2 * cap * (xs * elem + 4) + 4 * cap * (a8 + 1)
                       + 4 * cap * heads + 4 * payload_stride(d, heads)
                       + 16))


def key_design(d: int, att: int, heads: int, elem: int = 4) -> dict:
    """K18's key-family walk at width ``d``, ``att`` and ``heads`` over a
    payload of ``elem``-byte elements: ``cap`` payload rows a tile, the
    block's ``shared`` bytes (:func:`key_shared`) and the blocks an SM
    holds by them (``per_sm``). Raises where a tile of 16 rows does not
    fit a block (:func:`_payload_shared`)."""
    def shared(cap):
        return sum(key_shared(d, att, heads, elem, cap).values())

    for per_sm, caps in ((2, KEY_CAPS[:3]), (1, KEY_CAPS)):
        for cap in caps:
            sh = shared(cap)
            if (sh <= MAX_SHARED_BYTES
                    and per_sm * (sh + KEY_BLOCK_RESERVED) <= SM_SHARED_BYTES):
                return dict(cap=cap, shared=sh, per_sm=per_sm)
    _payload_shared("fused_aggregate", d, att, shared(KEY_CAPS[-1]),
                    "Kw's TF32 parts and a tile of payload rows are")


def _aggregate_keys(rowptr, row, x_n, x_g, qw, qb, kw, kb, gmax, heads,
                    score, var, ls, shifts, square_plus, pieces):
    """K18 for the families that need each edge's key: q on the node
    projections' tile, then one walk over windows of ``pieces`` (one a
    block) projecting each tile's keys on the tensor cores
    (csrc/fused_payload.cu), and the merge of rows of several pieces."""
    n, d = x_n.shape
    att = qw.shape[1]
    dev = x_n.device
    des = key_design(d, att, heads, x_g.element_size())
    pc = _row_pieces(fused_aggregate, rowptr, pieces, n, dev, SCATTER_WHOLE)
    q = project(x_n, qw, qb)
    num = torch.empty((n, heads * d), dtype=torch.float32, device=dev)
    den = torch.empty((n, heads), dtype=torch.float32, device=dev)
    part = (torch.empty((pc.n_slots, payload_stride(d, heads)),
                        dtype=torch.float32, device=dev)
            if pc.n_multi else None)
    vec = int(d * x_g.element_size() % 16 == 0 and x_g.data_ptr() % 16 == 0)
    build.launch("payload_keys", dev, *_piece_args(pc), row.data_ptr(),
                 x_g.data_ptr(), q.data_ptr(), kw.data_ptr(), kb.data_ptr(),
                 gmax.data_ptr(), _ptr(var), _ptr(ls), _ptr(shifts),
                 num.data_ptr(), den.data_ptr(), _ptr(part), n,
                 pc.n_pieces, pc.n_multi, d, att, heads,
                 _flags(score, square_plus), pc.n_edges, des["cap"], vec,
                 int(x_g.dtype == torch.bfloat16))
    fused_aggregate.walk_launches += 1
    return num, den


def fused_score_max(rowptr, row, q, x_g, kw, kb, *, heads: int,
                    pieces: Optional[ColPieces] = None):
    """K19: the largest scaled-dot score of the query table ``q`` [N, ATT]
    against the keys of the per-edge payload ``x_g`` [E_pad, D] over every
    valid edge and head, a one-element tensor, 0 unless finite (see
    :func:`fused_score_max_plain`): the shift the oracle hands K18. On K18's
    scaled-dot fold (``csrc/payload_fwd.cu``): lane groups sized by the row
    width fold each row's q with Kw^T and walk ``pieces`` (as
    :func:`fused_aggregate` takes them; built from rowptr when None, a copy
    to the host counted in ``piece_builds``), reading each payload row once
    and forming each score as K18's walk does; each block writes its
    maximum, one block the blocks'. A NaN score wins; no atomics, two calls
    agree bit for bit. ``x_g`` may be bfloat16 (widened where it is read);
    q and the weights are float32. Not differentiable."""
    if q.dim() != 2 or x_g.dim() != 2:
        raise ValueError("fused_score_max: q and x_g must be 2-D")
    n, att = q.shape
    d = x_g.shape[1]
    if heads < 1 or heads > MAX_HEADS or att % heads or att > MAX_ATT \
            or d > MAX_DIM:
        raise ValueError(f"fused_score_max: width {d}, attention_dim {att}, "
                         f"heads {heads} outside the kernel's range")
    floats = [("q", q, None), ("kw", kw, (d, att)), ("kb", kb, (att,))]
    if x_g.dtype == torch.bfloat16:
        _check_tables("fused_score_max", q, x_g, (row.shape[0], d))
    else:
        floats.insert(1, ("x_g", x_g, (row.shape[0], d)))
    _check_operands("fused_score_max", q.device,
                    (("rowptr", rowptr, (n + 1,)), ("row", row, None)),
                    floats)
    if q.device.type == "cpu":
        return fused_score_max_plain(rowptr, row, q, x_g, kw, kb,
                                     heads=heads)
    dev = q.device
    pc = _row_pieces(fused_score_max, rowptr, pieces, n, dev, SCATTER_WHOLE)
    kwt = kw.t().contiguous()
    group, vec = lanes("payload_walk", d, x_g, kwt, heads=heads)
    partial = torch.empty((max(1, -(-pc.n_pieces * group
                                     // SCORE_MAX_THREADS)),),
                          dtype=torch.float32, device=dev)
    out = torch.empty((1,), dtype=torch.float32, device=dev)
    build.launch("payload_score_max", dev, *_piece_args(pc), x_g.data_ptr(),
                 q.data_ptr(), kwt.data_ptr(), kb.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), n, pc.n_pieces, d, att,
                 heads, group, vec, int(x_g.dtype == torch.bfloat16))
    fused_score_max.launches += 1
    fused_score_max.bf16_launches += x_g.dtype == torch.bfloat16
    return out


def fused_rhs_bwd_heads(rowptr, row, x_n, x_g, qw, qb, kw, kb, gmax, ct_num,
                        ct_den, *, heads: int, score: str, var=None, ls=None,
                        square_plus: bool = False,
                        pieces: Optional[ColPieces] = None):
    """K8's per-head-cotangent mode: the backward of K18 from ``ct_num``
    [N, H·D] and ``ct_den`` [N, H] (see :func:`fused_rhs_bwd_heads_plain`
    for the formulas and the return value). For the scaled-dot score, K18's
    fold (``pieces`` as :func:`fused_aggregate` takes them): one walk
    writes every slot of dxg (no memset) and each row's [a | b] (a_nh =
    sum_e ds_eh x_g[e], b_nh = sum_e ds_eh), and a node pass forms dq_nh =
    (Kw_h^T a_nh + b_nh kb_h) / sqrt(d_k) and reduces dkw, dkb over the
    nodes head by head (:func:`node_design`), dgmax = -sum b. The other
    families run K8's row walk over the payload, projecting q_n and each
    edge's key as K18 does, with dkw, dkb reduced over the payload's slots.
    Every reduction has a fixed order: two calls agree bit for bit.
    ``x_g`` may be bfloat16 beside a float32 or bfloat16 ``x_n``; every
    output is float32."""
    n, d = x_n.shape
    cap = row.shape[0]
    extra = [("gmax", gmax, None), ("ct_num", ct_num, (n, heads * d)),
             ("ct_den", ct_den, (n, heads))]
    _payload_check("fused_rhs_bwd_heads", rowptr, row, x_n, x_g, qw, qb, kw,
                   kb, heads, score, var, ls, extra)
    if x_n.device.type == "cpu":
        return fused_rhs_bwd_heads_plain(
            rowptr, row, x_n, x_g, qw, qb, kw, kb, gmax, ct_num, ct_den,
            heads=heads, score=score, var=var, ls=ls,
            square_plus=square_plus)
    if score == "scaled_dot":
        out = _bwd_heads_walk(rowptr, x_n, x_g, qw, qb, kw, kb, gmax, ct_num,
                              ct_den, heads, square_plus, pieces)
    else:
        out = _bwd_heads_keys(rowptr, x_n, x_g, qw, qb, kw, kb, gmax, ct_num,
                              ct_den, heads, score, var, ls, square_plus, cap)
    fused_rhs_bwd_heads.launches += 1
    fused_rhs_bwd_heads.bf16_launches += x_g.dtype == torch.bfloat16
    return out


def _bwd_heads_keys(rowptr, x_n, x_g, qw, qb, kw, kb, gmax, ct_num, ct_den,
                    heads, score, var, ls, square_plus, cap):
    """K8's per-head mode for the families that need each edge's key
    (fused_payload.cu), dkw reduced over the payload's slots."""
    n, d = x_n.shape
    att = qw.shape[1]
    g = GROUP_EDGES
    _payload_shared("fused_rhs_bwd_heads", d, att,
                    4 * (2 * _round4(d * (att + 1)) + PAYLOAD_WARPS * _round4(
                        g * d + g * att + 2 * att + g * (att + 1)
                        + heads * (d + 1) + g * 10 * heads + 2 * g * heads)))
    dev = x_n.device
    dq = torch.empty((n, att), dtype=torch.float32, device=dev)
    # padding slots keep dxg and dk_e at 0; the dkw / dkb reduction walks
    # them too (the valid count stays on the device)
    dxg = torch.zeros((cap, d), dtype=torch.float32, device=dev)
    dke = torch.zeros((cap, att), dtype=torch.float32, device=dev)
    blocks, partials = _partials(cap, d, att, dev)
    row_sums = torch.empty((n, ROW_SUMS), dtype=torch.float32, device=dev)
    build.launch("fused_rhs_bwd_heads", dev, rowptr.data_ptr(),
                 x_g.data_ptr(), x_n.data_ptr(), qw.data_ptr(), qb.data_ptr(),
                 kw.data_ptr(), kb.data_ptr(), gmax.data_ptr(), _ptr(var),
                 _ptr(ls), ct_num.data_ptr(), ct_den.data_ptr(),
                 dq.data_ptr(), dxg.data_ptr(), dke.data_ptr(),
                 row_sums.data_ptr(), partials.data_ptr(), n, d, att, heads,
                 _flags(score, square_plus), cap, blocks,
                 _payload_tables(x_n, x_g))
    count_fused(0, 0, reduce=True)
    return ((dq, dxg) + dk_sums(partials, d)
            + _row_totals(row_sums, score, var, ls))


fused_rhs_fwd.launches = 0
fused_rowmax.launches = 0
fused_rhs_bwd.launches = 0
fused_rhs_bwd_sym.launches = 0
fused_rhs_bwd_col.launches = 0
# the launches on a bfloat16 column table or payload, among each one's own
# (K6's with the exact mode's shifts counted apart again)
fused_rhs_fwd.bf16_launches = 0
fused_rhs_fwd.bf16_shifted_launches = 0
fused_rowmax.bf16_launches = 0
fused_rhs_bwd.bf16_launches = 0
# K8's launches without dxg (its walk over row pieces), counted apart from
# those with dxg, and those of them on a bfloat16 column table
fused_rhs_bwd.rows_launches = 0
fused_rhs_bwd.bf16_rows_launches = 0
fused_rhs_bwd_sym.bf16_launches = 0
fused_rhs_bwd_col.bf16_launches = 0
fused_aggregate.launches = 0
fused_score_max.launches = 0
fused_rhs_bwd_heads.launches = 0
fused_aggregate.bf16_launches = 0
fused_score_max.bf16_launches = 0
fused_rhs_bwd_heads.bf16_launches = 0
# the launches by pass, among K18's and the per-head mode's own: the walks
# (each with its merge; K18's over the scaled-dot fold and over the key
# families' tiles) and the scaled-dot per-head mode's node pass (dq, dKw,
# dKb, dgmax: two kernels); q is a launch of the node projections' tile,
# counted in node_project.launches
fused_aggregate.walk_launches = 0
fused_rhs_bwd_heads.walk_launches = 0
fused_rhs_bwd_heads.node_launches = 0
# the row pieces the walks over rows built from rowptr because their caller
# handed none (a copy to the host; 0 on every model path)
fused_rhs_fwd.piece_builds = 0
fused_rowmax.piece_builds = 0
fused_rhs_bwd.piece_builds = 0
fused_rhs_bwd_sym.piece_builds = 0
# (K18's, K19's and the per-head mode's)
fused_aggregate.piece_builds = 0
fused_score_max.piece_builds = 0
fused_rhs_bwd_heads.piece_builds = 0


# ---------------------------------------------------------------------------
# differentiable ops (the JAX package's names)
# ---------------------------------------------------------------------------

def score_scalars(score: str, score_params) -> Tuple:
    """(var, ls) of the kernels from the model's scalars: exp_kernel's
    (output_var, lengthscale), or exp_kernel_beltrami's (output_var_x,
    lengthscale_x, output_var_p, lengthscale_p) as two pairs, each
    concatenated (differentiably) into one [2] tensor."""
    if score == "exp_kernel":
        var, ls = score_params
        return var, ls
    if score == "exp_kernel_beltrami":
        var_x, ls_x, var_p, ls_p = (t.reshape(1) for t in score_params)
        return torch.cat([var_x, var_p]), torch.cat([ls_x, ls_p])
    return None, None


def _node_cotangents(ct_ax, ct_den_in, num, den, heads):
    """The node-level part of the backward: ``recip_p = 1 / (H (den +
    eps))`` and den's total cotangent, ``ct_den_in - (ct_ax . num_h)
    recip_h^2 / H``."""
    n, d = ct_ax.shape
    recip = 1.0 / (den + EPS)
    dots = torch.sum(ct_ax[:, None, :] * num.view(n, heads, d), dim=2)
    ct_den = ct_den_in - dots * recip * recip / heads
    return (recip / heads).contiguous(), ct_den.contiguous()


class _FusedAx(torch.autograd.Function):
    """(ax, den) = K6, with one of three backwards (``engine``):

    * ``"sym"``: K9, x's whole gradient from the kernel (symmetric edge
      multisets);
    * ``"col"``: K8 without its per-edge dxg and dk for dq, dgmax and the
      score scalars, then K17 for x[col]'s cotangent, dkw and dkb
      over the CSC view (any graph);
    * ``"dxg"``: K8 with the per-edge dxg, summed over columns by K1's walk
      in table mode, through the reverse edges or the CSC view (any graph;
      the one backward that takes per-edge ``shifts``).

    Residuals: the inputs, ``den`` and the per-head numerators ``num`` that
    K6 flushes when a gradient is wanted. With a ``payload`` dtype
    (bfloat16) every kernel of the engine reads the column table x cast to
    it, recast in the backward rather than kept; ax and den are float32
    and x's gradient comes back in x's dtype."""

    @staticmethod
    def forward(ctx, qw, qb, kw, kb, x, gmax, var, ls, shifts, g, engine,
                heads, square_plus, score, payload):
        want = any(ctx.needs_input_grad)
        ax, den, num = fused_rhs_fwd(
            g.rowptr, g.row, g.col, x, qw, qb, kw, kb, gmax, heads=heads,
            score=score, var=var, ls=ls, shifts=shifts,
            square_plus=square_plus, want_num=want,
            xcol=column_table(x, payload), pieces=g.row_pieces)
        ctx.save_for_backward(qw, qb, kw, kb, x, gmax, var, ls, shifts, den,
                              num)
        ctx.g = g
        ctx.opts = (engine, heads, square_plus, score, payload)
        return ax, den

    @staticmethod
    def backward(ctx, ct_ax, ct_den_in):
        qw, qb, kw, kb, x, gmax, var, ls, shifts, den, num = ctx.saved_tensors
        g = ctx.g
        engine, heads, square_plus, score, payload = ctx.opts
        ct_ax = ct_ax.contiguous()
        recip_p, ct_den = _node_cotangents(ct_ax, ct_den_in, num, den, heads)
        csr = (g.rowptr, g.row, g.col)
        kwargs = dict(heads=heads, score=score, var=var, ls=ls,
                      square_plus=square_plus)
        if engine == "sym":
            dq, dx, dkw, dkb, dgmax, dvar, dls = fused_rhs_bwd_sym(
                *csr, x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den,
                xcol=column_table(x, payload), pieces=g.row_pieces,
                **kwargs)
        elif engine == "col":
            xcol = column_table(x, payload)
            tabs = node_tables(x, qw.shape[1])   # K8 fills, K17 reuses
            dq, _, _, _, dgmax, dvar, dls = fused_rhs_bwd(
                *csr, x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den,
                want_dxg=False, xcol=xcol, pieces=g.row_pieces, tabs=tabs,
                **kwargs)
            dx, dkw, dkb = fused_rhs_bwd_col(
                g.colptr, g.col_by_col, g.row_by_col, x, qw, qb, kw, kb,
                gmax, ct_ax, recip_p, ct_den, xcol=xcol,
                pieces=g.col_pieces, tabs=tabs, **kwargs)
        else:
            dq, dxg, dkw, dkb, dgmax, dvar, dls = fused_rhs_bwd(
                *csr, x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den,
                shifts=shifts, xcol=column_table(x, payload),
                pieces=g.row_pieces, **kwargs)
            dx = column_sum(g, dxg)
        dx = dx + dq @ qw.T
        return (x.float().T @ dq, torch.sum(dq, dim=0), dkw, dkb,
                dx.to(x.dtype), dgmax.reshape(gmax.shape), dvar,
                dls) + (None,) * 7


def column_table(x: torch.Tensor, payload) -> Optional[torch.Tensor]:
    """The kernels' column table: None for the float32 path, else x cast
    to the payload dtype (which the kernels' checks hold to bfloat16)."""
    return None if payload is None else x.to(payload).contiguous()


def _check_sorted(g, name: str) -> None:
    if not g.rows_sorted or g.rowptr is None:
        raise ValueError(f"{name} needs a row-sorted graph (sort_by_row)")


def fused_rhs_ax(g, heads: int, square_plus: bool, score: str, qw, qb, kw,
                 kb, x, gmax, shifts=None, score_params=(),
                 payload_dtype: torch.dtype = None):
    """(ax [N, D], den [N, H]) over the prepared graph ``g``, directed or
    not, differentiable in qw, qb, kw, kb, x, gmax and the exp_kernel
    scalars through K8 and the column sum of its per-edge dxg. ``shifts``
    [E_pad, H] carry no gradient (ax is invariant to per-row shifts).
    ``payload_dtype`` as :func:`make_fused_ax_sym` takes it."""
    _check_sorted(g, "fused_rhs_ax")
    var, ls = score_scalars(score, score_params)
    return _FusedAx.apply(qw, qb, kw, kb, x.contiguous(), gmax, var, ls,
                          shifts, g, "dxg", heads, square_plus, score,
                          payload_dtype)


def make_fused_ax_sym(g, heads: int, square_plus: bool, score: str,
                      payload_dtype: torch.dtype = None):
    """``op(qw, qb, kw, kb, x, gmax, score_params) -> (ax, den)`` for a
    SYMMETRIC edge multiset, whose backward (K9) returns x's total gradient
    with no reverse-edge map and no per-edge array. ``payload_dtype``
    (None or ``torch.bfloat16``, the JAX package's ``pay_dt``) is the dtype
    of the column table K6 and K9 read; x is float32, or bfloat16 under the
    bf16 ODE state."""
    _check_sorted(g, "make_fused_ax_sym")
    if g.rev is None:
        raise ValueError(
            "make_fused_ax_sym: the edge multiset is not symmetric (K9 reaches "
            "x's gradient through reverse edges); a directed graph takes "
            "make_fused_ax_colplan")

    def op(qw, qb, kw, kb, x, gmax, score_params=()):
        var, ls = score_scalars(score, score_params)
        return _FusedAx.apply(qw, qb, kw, kb, x.contiguous(), gmax, var, ls,
                              None, g, "sym", heads, square_plus, score,
                              payload_dtype)

    return op


def make_fused_ax_colplan(g, heads: int, square_plus: bool, score: str,
                          payload_dtype: torch.dtype = None):
    """``op(qw, qb, kw, kb, x, gmax, score_params) -> (ax, den)`` over ANY
    prepared graph (directed included), whose backward never forms a
    per-edge array: K8 without dxg for dq, dgmax and the exp_kernel
    scalars, K17 over the CSC view for x's gradient and dkw, dkb (the JAX
    package's column-plan backward, with the dkw reduction moved from the
    edges of P11 to K17's per-column sums). ``payload_dtype`` as
    :func:`make_fused_ax_sym` takes it: K6, K8 and K17 read the bfloat16
    column table."""
    _check_sorted(g, "make_fused_ax_colplan")

    def op(qw, qb, kw, kb, x, gmax, score_params=()):
        var, ls = score_scalars(score, score_params)
        return _FusedAx.apply(qw, qb, kw, kb, x.contiguous(), gmax, var, ls,
                              None, g, "col", heads, square_plus, score,
                              payload_dtype)

    return op


def den_guard(den: torch.Tensor, rowptr: torch.Tensor, per_row: bool):
    """True where the unshifted softmax left float32's range: a row with
    edges whose ``den`` is 0 (every exp underflowed) or any non-finite
    ``den`` (an exp overflowed). One flag per row, or one for all rows."""
    deg = (rowptr[1:] - rowptr[:-1])[:, None]
    bad = ((den <= 0.0) & (deg > 0)) | ~torch.isfinite(den)
    return torch.any(bad, dim=1, keepdim=True) if per_row else torch.any(bad)


def fused_rhs_f(g, heads: int, score: str, qw, qb, kw, kb, x, alpha,
                score_params=(), payload_dtype: torch.dtype = None):
    """f [N, D] = alpha (ax - x) with the per-row guard, folded into K6's
    final write: the no-grad solves' RHS. Under autograd it is the unfolded
    composition with the same per-row guard, so a stray gradient through an
    eval-mode model is K8's (on the column table of ``payload_dtype`` too),
    on any graph. f is float32."""
    _check_sorted(g, "fused_rhs_f")
    rowptr, row, col = g.rowptr, g.row, g.col
    gmax = torch.zeros((1,), dtype=torch.float32, device=x.device)
    tensors = (qw, qb, kw, kb, x, alpha, *score_params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        ax, den = fused_rhs_ax(g, heads, False, score, qw, qb, kw, kb, x,
                               gmax, None, score_params, payload_dtype)
        bad = den_guard(den, rowptr, per_row=True)
        return alpha * (torch.where(bad, torch.full_like(ax, torch.nan), ax)
                        - x)
    var, ls = score_scalars(score, score_params)
    x = x.contiguous()
    f, _, _ = fused_rhs_fwd(rowptr, row, col, x, qw, qb, kw, kb,
                            gmax, heads=heads, score=score, var=var, ls=ls,
                            alpha=alpha.reshape(1),
                            xcol=column_table(x, payload_dtype),
                            pieces=g.row_pieces)
    return f


class _FusedAggregate(torch.autograd.Function):
    """(num, den) = K18, whose backward is K8's per-head mode followed by
    the node-level products dqw = x_n^T dq, dqb = sum dq and dx_n = dq
    Qw^T (plain matmuls, as the JAX package computes them outside its
    kernel). Residuals: the inputs. Under the payload's bfloat16 mode the
    gradients of x_n and x_g come back in their dtypes, each cast once
    from its float32 sum, as the JAX package's ``_fused_bwd`` casts them."""

    @staticmethod
    def forward(ctx, qw, qb, kw, kb, x_n, x_g, gmax, var, ls, g, heads,
                square_plus, score):
        num, den = fused_aggregate(
            g.rowptr, g.row, x_n, x_g, qw, qb, kw, kb, gmax, heads=heads,
            score=score, var=var, ls=ls, square_plus=square_plus,
            pieces=g.scatter_pieces)
        ctx.save_for_backward(qw, qb, kw, kb, x_n, x_g, gmax, var, ls)
        ctx.g = g
        ctx.opts = (heads, square_plus, score)
        return num, den

    @staticmethod
    def backward(ctx, ct_num, ct_den):
        qw, qb, kw, kb, x_n, x_g, gmax, var, ls = ctx.saved_tensors
        heads, square_plus, score = ctx.opts
        dq, dxg, dkw, dkb, dgmax, dvar, dls = fused_rhs_bwd_heads(
            ctx.g.rowptr, ctx.g.row, x_n, x_g, qw, qb, kw, kb, gmax,
            ct_num.contiguous(), ct_den.contiguous(), heads=heads,
            score=score, var=var, ls=ls, square_plus=square_plus,
            pieces=ctx.g.scatter_pieces)
        return (x_n.to(dq.dtype).T @ dq, torch.sum(dq, dim=0), dkw, dkb,
                (dq @ qw.T).to(x_n.dtype), dxg.to(x_g.dtype),
                dgmax.reshape(gmax.shape), dvar, dls) + (None,) * 4


def fused_rhs_aggregate(g, heads: int, square_plus: bool, score: str, qw, qb,
                        kw, kb, x_n, x_g, gmax, score_params=()):
    """(num [N, H·D], den [N, H]) of the fused attention RHS over the
    row-sorted graph ``g`` and the per-edge payload ``x_g`` [E_pad, D] (see
    :func:`fused_aggregate_plain`), differentiable in qw, qb, kw, kb, x_n,
    x_g, gmax and the score's scalars (``score_params`` as
    :func:`score_scalars` takes them): K18 forward, K8's per-head mode
    backward. The JAX package's op of the same name returns den padded to
    max(8, H) columns; this one returns its H columns. ``x_g`` may be
    bfloat16 (the payload dtype) beside a float32 or bfloat16 ``x_n``: num
    and den are float32, and the gradients of x_n and x_g come back in
    their dtypes (see the module docstring)."""
    _check_sorted(g, "fused_rhs_aggregate")
    var, ls = score_scalars(score, score_params)
    return _FusedAggregate.apply(qw, qb, kw, kb, x_n.contiguous(),
                                 x_g.contiguous(), gmax, var, ls, g, heads,
                                 square_plus, score)


def _scores_u(g, q, kw, kb, x_g, gmax, heads, square_plus, shifts=None):
    """The forward's per-edge quantities for the composition below, per
    head: (src [E, ATT], k_e [E, ATT], u, du/ds), u and du/ds lists of [E]
    (scaled-dot scores; the JAX package's ``_scores_u``)."""
    nv = int(g.rowptr[-1])
    att = q.shape[1]
    d_k = att // heads
    src = q[g.row[:nv].long()]
    k_e = x_g[:nv].to(kw.dtype) @ kw + kb
    us, dudsms = [], []
    for h in range(heads):
        sl = slice(h * d_k, (h + 1) * d_k)
        sm = torch.sum(src[:, sl] * k_e[:, sl], dim=1) / math.sqrt(d_k) - gmax
        if shifts is not None:
            sm = sm - shifts[:nv, h]
        if square_plus:
            root = torch.sqrt(sm * sm + 4.0)
            us.append((sm + root) * 0.5)
            dudsms.append((1.0 + sm / root) * 0.5)
        else:
            us.append(torch.exp(sm))
            dudsms.append(us[-1])
    return src, k_e, us, dudsms


def fused_bwd_composition(g, heads: int, square_plus: bool, res, cts):
    """The hand-derived backward of :func:`fused_rhs_aggregate` for the
    scaled-dot score in plain torch ops, head by head: the independent
    oracle K8's per-head mode is held to (the JAX package's
    ``_fused_bwd_composition``). ``res`` is (qw, qb, kw, kb, x_n, x_g,
    gmax[, shifts]) and ``cts`` (ct_num [N, H·D], ct_den [N, H]). Returns
    (dqw, dqb, dkw, dkb, dx_n, dx_g, dgmax). A bfloat16 x_n or x_g is
    widened to the weights' type, and dx_n and dx_g are cast back to their
    inputs' dtypes, as the JAX composition casts them."""
    qw, qb, kw, kb, x_n_in, x_g_in, gmax = res[:7]
    x_n, x_g = x_n_in.to(qw.dtype), x_g_in.to(qw.dtype)
    shifts = res[7] if len(res) > 7 else None
    ct_num, ct_den = cts
    n, d = x_n.shape
    att = qw.shape[1]
    d_k = att // heads
    nv = int(g.rowptr[-1])
    r = g.row[:nv].long()
    q = x_n @ qw + qb
    src, k_e, us, dudsms = _scores_u(g, q, kw, kb, x_g, gmax, heads,
                                     square_plus, shifts)
    xf = x_g[:nv]
    dgmax = torch.zeros((), dtype=x_n.dtype, device=x_n.device)
    dsrc_cols, dke_cols = [], []
    dxg_acc = torch.zeros_like(xf)
    for h in range(heads):
        sl = slice(h * d_k, (h + 1) * d_k)
        dv_h = ct_num[r, h * d:(h + 1) * d]                      # [E, D]
        ds = (torch.sum(dv_h * xf, dim=1) + ct_den[r, h]) * dudsms[h]
        dgmax = dgmax - torch.sum(ds)
        c = (ds / math.sqrt(d_k))[:, None]
        dsrc_cols.append(c * k_e[:, sl])
        dke_cols.append(c * src[:, sl])
        dxg_acc = dxg_acc + us[h][:, None] * dv_h
    dsrc = torch.cat(dsrc_cols, dim=1)
    dk_e = torch.cat(dke_cols, dim=1)
    dq = torch.zeros_like(q).index_add(0, r, dsrc)
    dx_g = torch.zeros_like(x_g)
    dx_g[:nv] = dxg_acc + dk_e @ kw.T
    return (x_n.T @ dq, torch.sum(dq, dim=0), xf.T @ dk_e,
            torch.sum(dk_e, dim=0), (dq @ qw.T).to(x_n_in.dtype),
            dx_g.to(x_g_in.dtype), dgmax)
