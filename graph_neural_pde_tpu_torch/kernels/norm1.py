"""K12-K14: the fused attention right-hand side of GRAND-nl with the
softmax normalised over COLUMNS (``attention_norm_idx = 1``).

The aggregation reduces by row while the softmax groups by column
(``n`` a node, ``e = (r, c)`` an edge, ``u_eh = exp(score_h(q_r, k_c) -
gmax)`` or squareplus of the same, with q, k and the five score families of
``kernels.fused_rhs``):

    den[n, h] = sum_{e: c = n} u_eh
    ax[r]     = (1/H) sum_h sum_{e in row r} u_eh / (den[c, h] + 1e-16) x_c

so the denominators do not come out of the aggregation's row walk. On a
SYMMETRIC edge multiset they come out of another row walk: the edges into
``n`` are the reverses of row ``n``'s edges ``(n, c)``, hence
``den[n, h] = sum_{(n, c)} u(score_h(q_c, k_n) - gmax)``.

* K12 ``norm1_den`` -> that sum [N, H]; with ``ct`` [N, D] each term is
  weighted by ``ct_c . x_n``, the numerator of ``den``'s cotangent in the
  backward. Replaces ``ops/pallas/fused_rhs.py`` ``_norm1_rev_kernel`` /
  ``_norm1_rev_call`` (both of its modes).
* K13 ``norm1_fwd``  -> ``ax`` [N, D] from ``recip = 1 / (den + 1e-16)``;
  replaces ``_norm1_fwd_kernel`` / ``_norm1_fwd_call``.
* K14 ``norm1_bwd``  -> (dq, dxrow, dkw, dkb, dgmax, dvar, dls) with
  ``dxrow`` the whole x[col] cotangent, each edge also evaluating its
  reverse; replaces ``_norm1_bwd_kernel`` / ``_norm1_bwd_call``.

The TPU engine's bf16 pair packing, its 128-lane ``x | recip`` gather rows
and its column permutation are not carried over: the kernels take any
width and head count within the walks' register tiles
(``csrc/norm1_den.cu``, ``csrc/norm1.cu``). The JAX package runs its
norm-1 kernels only under its bfloat16 payload; the three wrappers take
it as K6-K9 do
(``kernels.fused_rhs``): a bfloat16 column table ``xcol`` (x cast once a
call) beside the row side ``x`` (float32, or bfloat16 under the bf16 ODE
state). q comes from x, the gathered values and the bfloat16 k table
(:func:`~graph_neural_pde_tpu_torch.kernels.fused_rhs.bf16_k_table`) from
``xcol``, in K12 and K13 alike, so that K12's reverse-edge scores are
K13's scores; K12's weight ``ct_c . x_n`` reads x_n from ``xcol``. Every
cotangent, sum and output stays float32. On a CUDA tensor a wrapper
launches its kernel or raises; on a CPU tensor it runs the plain PyTorch
version beside it, which defines the semantics (float32, or float64 when
every operand is but the bfloat16 table). ``make_fused_ax_norm1`` keeps the
JAX package's name: the differentiable op the transformer function calls.
"""

from __future__ import annotations

import torch

from graph_neural_pde_tpu_torch.kernels import build
from graph_neural_pde_tpu_torch.kernels.dense import count_fused
from graph_neural_pde_tpu_torch.kernels.fused_rhs import (
    EPS, _aligned, _bwd_extra, _bwd_plain, _check, _check_sorted, _col_side,
    _col_projection, _edges, _flags, _node_sum, _ptr, _row_pieces, _sym_walk,
    _tables, _u_duds, column_table, edge_scores, head_slices, node_tables,
    score_scalars)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def norm1_den_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, *, heads: int,
                    score: str, var=None, ls=None, square_plus: bool = False,
                    ct=None, xcol=None):
    """Plain version of K12, the same row walk: every edge (n, c) of row n
    contributes ``u(score(q_c, k_n) - gmax)`` to ``out[n]``, times
    ``ct_c . x_n`` when ``ct`` is given. Equal to the sum of ``u`` over the
    edges into n only on a symmetric edge multiset. With ``xcol`` (the
    bfloat16 column table, see ``fused_rhs._col_side``) k_n and x_n are
    read on that table's side, as K13 reads them at its columns."""
    nv, r, c = _edges(rowptr, row, col)
    slices = head_slices(score, heads)
    x, x_n, k_n, _ = _col_side(x, xcol, kw, kb, r)
    q_rev = (x @ qw + qb)[c].reshape(nv, slices, -1)
    u, _ = _u_duds(edge_scores(q_rev, k_n.reshape(nv, slices, -1), score,
                               var, ls) - gmax, square_plus)
    if ct is not None:
        u = u * torch.sum(ct[c] * x_n, dim=1, keepdim=True)
    return _node_sum(x.shape[0], r, u)


def norm1_fwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, recip, *,
                    heads: int, score: str, var=None, ls=None,
                    square_plus: bool = False, xcol=None):
    """Plain version of K13: gathers, the per-edge weight
    ``(1/H) sum_h u_eh recip[c, h]`` and one ``index_add`` over rows (with
    ``xcol`` the values and k from that bfloat16 column table)."""
    nv, r, c = _edges(rowptr, row, col)
    x, xe, ke, _ = _col_side(x, xcol, kw, kb, c)
    slices = head_slices(score, heads)
    src = (x @ qw + qb)[r].reshape(nv, slices, -1)
    u, _ = _u_duds(edge_scores(src, ke.reshape(nv, slices, -1), score, var,
                               ls) - gmax, square_plus)
    w = torch.sum(u * recip[c], dim=1, keepdim=True) / heads
    return _node_sum(x.shape[0], r, w * xe)


def norm1_bwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p,
                    ct_den, *, heads: int, score: str, var=None, ls=None,
                    square_plus: bool = False, xcol=None):
    """Plain version of K14. With ``recip_p = 1 / (H (den + 1e-16))`` and
    ``ct_den`` the total cotangent of ``den``, per edge (r, c):

        ds_eh  = ((ct_ax[r] . x_c) recip_p[c, h] + ct_den[c, h]) du/ds
        dq[r]  = sum_e ds . ds/dq,   dk_e = ds . ds/dk
        dxrow[n] = sum_{e: c = n} (sum_h u_eh recip_p[c, h]) ct_ax[r]
                   + dk_e Kw^T
        dkw = sum_e x_c^T dk_e,  dkb = sum_e dk_e,  dgmax = -sum ds

    the backward of K8/K9 with ``recip_p`` and ``ct_den`` read at the
    edge's column. Returns (dq [N, ATT], dxrow [N, D], dkw, dkb, dgmax,
    dvar, dls); the last two are None but for ``exp_kernel`` and
    ``exp_kernel_beltrami``. With ``xcol`` x_c and k_e come from that
    bfloat16 column table, Kw is its bf16-rounded self, and dxrow, dkw and
    dkb are the table's."""
    dq, dxg, dkw, dkb, dgmax, dvar, dls = _bwd_plain(
        rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den,
        heads=heads, score=score, var=var, ls=ls, shifts=None,
        square_plus=square_plus, by_col=True, xcol=xcol)
    nv, _, c = _edges(rowptr, row, col)
    return dq, _node_sum(x.shape[0], c, dxg[:nv]), dkw, dkb, dgmax, dvar, dls


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def norm1_den(rowptr, row, col, x, qw, qb, kw, kb, gmax, *, heads: int,
              score: str, var=None, ls=None, square_plus: bool = False,
              ct=None, tabs=None, xcol=None, pieces=None):
    """K12: [N, H] column denominators of a SYMMETRIC edge multiset (the
    caller checks ``Graph.rev is not None``), or with ``ct`` [N, D] the
    same sum weighted by ``ct_c . x_n``. ``gmax`` is a one-element tensor.
    The kernel walks the row ``pieces`` (``Graph.row_pieces``; as
    :func:`norm1_fwd` takes them) and scores each edge as K13 scores its
    reverse, bit for bit. ``row`` is only read by the plain version. Two
    calls agree bit for bit. Not differentiable.

    ``xcol`` (all three wrappers): the bfloat16 column table, x cast to
    bfloat16 (see the module docstring); x is then float32 or bfloat16.
    ``tabs`` (all three wrappers; CUDA only): the q and k tables a
    :func:`node_tables` call allocated. The first launch that is handed
    them fills them, a later one on the same x, xcol, Qw, qb, Kw, kb reads
    them instead of projecting every node again."""
    extra = [("gmax", gmax, None)]
    if ct is not None:
        extra.append(("ct", ct, x.shape))
    _check("norm1_den", rowptr, row, col, x, qw, qb, kw, kb, heads, score,
           var, ls, extra, xcol)
    if x.device.type == "cpu":
        return norm1_den_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                               heads=heads, score=score, var=var, ls=ls,
                               square_plus=square_plus, ct=ct, xcol=xcol)
    n, d = x.shape
    att = qw.shape[1]
    dev = x.device
    pc = _row_pieces(norm1_den, rowptr, pieces, n, dev)
    out = torch.empty((n, heads), dtype=torch.float32, device=dev)
    # scratch: the pieces' partial sums
    part = (torch.empty((pc.n_slots, heads), dtype=torch.float32, device=dev)
            if pc.n_multi else None)
    tabs = tabs or node_tables(x, att)
    kw, kb = _col_projection(kw, kb, xcol)
    table = x if xcol is None else xcol
    project = tabs.project()
    build.launch("norm1_den", dev, pc.ptr.data_ptr(), pc.col.data_ptr(),
                 pc.slot.data_ptr(), pc.multi_col.data_ptr(),
                 pc.multi_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                 _ptr(xcol), qw.data_ptr(), qb.data_ptr(), kw.data_ptr(),
                 kb.data_ptr(), gmax.data_ptr(), _ptr(var), _ptr(ls),
                 _ptr(ct), tabs.q.data_ptr(), tabs.k.data_ptr(),
                 out.data_ptr(), _ptr(part), n, pc.n_pieces, pc.n_multi, d,
                 att, heads, _flags(score, square_plus),
                 _aligned(d, table, ct), project, _tables(x, xcol))
    norm1_den.launches += 1
    count_fused(_tables(x, xcol), project)
    norm1_den.bf16_launches += xcol is not None
    return out


def norm1_fwd(rowptr, row, col, x, qw, qb, kw, kb, gmax, recip, *, heads: int,
              score: str, var=None, ls=None, square_plus: bool = False,
              tabs=None, xcol=None, pieces=None):
    """K13: ``ax`` [N, D] from ``recip = 1 / (den + 1e-16)`` [N, H], K6's
    walk over the row ``pieces`` (``Graph.row_pieces``; as
    :func:`~graph_neural_pde_tpu_torch.kernels.fused_rhs.fused_rhs_fwd`
    takes them). Two calls agree bit for bit. Not differentiable by itself
    (see :func:`make_fused_ax_norm1`)."""
    n, d = x.shape
    _check("norm1_fwd", rowptr, row, col, x, qw, qb, kw, kb, heads, score,
           var, ls, [("gmax", gmax, None), ("recip", recip, (n, heads))],
           xcol)
    if x.device.type == "cpu":
        return norm1_fwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                               recip, heads=heads, score=score, var=var,
                               ls=ls, square_plus=square_plus, xcol=xcol)
    att = qw.shape[1]
    dev = x.device
    pc = _row_pieces(norm1_fwd, rowptr, pieces, n, dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    # scratch: the pieces' partial sums
    part = (torch.empty((pc.n_slots, d), dtype=torch.float32, device=dev)
            if pc.n_multi else None)
    tabs = tabs or node_tables(x, att)
    kw, kb = _col_projection(kw, kb, xcol)
    project = tabs.project()
    build.launch("norm1_fwd", dev, pc.ptr.data_ptr(), pc.col.data_ptr(),
                 pc.slot.data_ptr(), pc.multi_col.data_ptr(),
                 pc.multi_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                 _ptr(xcol), qw.data_ptr(), qb.data_ptr(), kw.data_ptr(),
                 kb.data_ptr(), gmax.data_ptr(), _ptr(var), _ptr(ls),
                 recip.data_ptr(), tabs.q.data_ptr(), tabs.k.data_ptr(),
                 out.data_ptr(), _ptr(part), n, pc.n_pieces, pc.n_multi, d,
                 att, heads, _flags(score, square_plus),
                 _aligned(d, x, xcol, out), project, _tables(x, xcol))
    norm1_fwd.launches += 1
    count_fused(_tables(x, xcol), project)
    norm1_fwd.bf16_launches += xcol is not None
    return out


def norm1_bwd(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p,
              ct_den, *, heads: int, score: str, var=None, ls=None,
              square_plus: bool = False, tabs=None, xcol=None, pieces=None):
    """K14: the backward over a SYMMETRIC edge multiset (see
    :func:`norm1_bwd_plain` for the formulas and the return value): K9's
    walk with the softmax groups swapped. With ``xcol``, ``dxrow`` is the
    cotangent of that table's values and k (through the bf16-rounded Kw),
    taken as x's, and dkw is reduced over the table. ``pieces`` as
    :func:`~graph_neural_pde_tpu_torch.kernels.fused_rhs.fused_rhs_bwd_sym`
    takes them. The reductions over all edges take two
    passes with fixed orders, so two calls agree bit for bit."""
    _check("norm1_bwd", rowptr, row, col, x, qw, qb, kw, kb, heads, score,
           var, ls, _bwd_extra(x, heads, gmax, ct_ax, recip_p, ct_den, None,
                               0), xcol)
    kwargs = dict(heads=heads, score=score, var=var, ls=ls,
                  square_plus=square_plus)
    if x.device.type == "cpu":
        return norm1_bwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                               ct_ax, recip_p, ct_den, xcol=xcol, **kwargs)
    tabs = tabs or node_tables(x, qw.shape[1])
    out = _sym_walk(norm1_bwd, rowptr, col, x, qw, qb, kw, kb, gmax, ct_ax,
                    recip_p, ct_den, tabs.q, tabs.k, tabs.project(),
                    xcol=xcol, pieces=pieces, **kwargs)
    norm1_bwd.launches += 1
    norm1_bwd.bf16_launches += xcol is not None
    return out


norm1_den.launches = 0
norm1_fwd.launches = 0
norm1_bwd.launches = 0
# the launches on a bfloat16 column table, among each one's own
norm1_den.bf16_launches = 0
norm1_fwd.bf16_launches = 0
norm1_bwd.bf16_launches = 0
# the row pieces K12-K14 built from rowptr because their caller handed
# none (0 on every model path)
norm1_den.piece_builds = 0
norm1_fwd.piece_builds = 0
norm1_bwd.piece_builds = 0


# ---------------------------------------------------------------------------
# the differentiable op (the JAX package's name)
# ---------------------------------------------------------------------------

class _FusedAxNorm1(torch.autograd.Function):
    """(ax, den) = K12 then K13. Backward: K12 again, weighted by the
    cotangent, gives den's cotangent through ``recip`` (``-m recip^2 / H``
    on top of the incoming one); K14 does the rest. Residuals: the inputs
    and ``den``. With a ``payload`` dtype (bfloat16) every launch reads
    the column table x cast to it, recast in the backward rather than
    kept; ax and den are float32, and x's gradient (the column table's
    cotangent taken as x's, plus the row side's through q) comes back in
    x's dtype."""

    @staticmethod
    def forward(ctx, qw, qb, kw, kb, x, gmax, var, ls, csr, heads,
                square_plus, score, payload, pieces):
        kwargs = dict(heads=heads, score=score, var=var, ls=ls,
                      square_plus=square_plus, xcol=column_table(x, payload))
        tabs = node_tables(x, qw.shape[1])       # K12 fills, K13 reuses
        den = norm1_den(*csr, x, qw, qb, kw, kb, gmax, tabs=tabs,
                        pieces=pieces, **kwargs)
        recip = 1.0 / (den + EPS)
        ax = norm1_fwd(*csr, x, qw, qb, kw, kb, gmax, recip, tabs=tabs,
                       pieces=pieces, **kwargs)
        ctx.save_for_backward(qw, qb, kw, kb, x, gmax, var, ls, den, *csr)
        ctx.opts = (heads, square_plus, score, payload)
        ctx.pieces = pieces
        return ax, den

    @staticmethod
    def backward(ctx, ct_ax, ct_den_in):
        qw, qb, kw, kb, x, gmax, var, ls, den, *csr = ctx.saved_tensors
        heads, square_plus, score, payload = ctx.opts
        kwargs = dict(heads=heads, score=score, var=var, ls=ls,
                      square_plus=square_plus, xcol=column_table(x, payload))
        ct_ax = ct_ax.contiguous()
        recip = 1.0 / (den + EPS)
        tabs = node_tables(x, qw.shape[1])       # K12 fills, K14 reuses
        m = norm1_den(*csr, x, qw, qb, kw, kb, gmax, ct=ct_ax, tabs=tabs,
                      pieces=ctx.pieces, **kwargs)
        ct_den = (ct_den_in - m * recip * recip / heads).contiguous()
        dq, dx, dkw, dkb, dgmax, dvar, dls = norm1_bwd(
            *csr, x, qw, qb, kw, kb, gmax, ct_ax,
            (recip / heads).contiguous(), ct_den, tabs=tabs,
            pieces=ctx.pieces, **kwargs)
        dx = dx + dq @ qw.T
        return (x.to(dq.dtype).T @ dq, torch.sum(dq, dim=0), dkw, dkb,
                dx.to(x.dtype), dgmax.reshape(gmax.shape), dvar,
                dls) + (None,) * 6


def make_fused_ax_norm1(g, heads: int, square_plus: bool, score: str,
                        payload_dtype: torch.dtype = None):
    """``op(qw, qb, kw, kb, x, gmax, score_params) -> (ax [N, D], den
    [N, H])`` with ``den`` the per-COLUMN score mass, over the prepared
    graph ``g``, differentiable in qw, qb, kw, kb, x, gmax and the
    score scalars. ``g`` must hold a symmetric edge multiset: both the
    denominators and x's gradient reach an edge's column through its
    reverse edge. The softmax over the columns of a directed graph is the
    composition over the CSC view (``models.functions.make_rhs``).
    ``payload_dtype`` (None or ``torch.bfloat16``, the JAX package's
    ``pay_dt``) is the dtype of the column table K12-K14 read; x is
    float32, or bfloat16 under the bf16 ODE state."""
    _check_sorted(g, "make_fused_ax_norm1")
    if g.rev is None:
        raise ValueError(
            "make_fused_ax_norm1: the edge multiset is not symmetric (K12-K14 "
            "reach an edge's column through its reverse edge); a directed "
            "graph composes the column softmax over its CSC view")
    csr = (g.rowptr, g.row, g.col)

    def op(qw, qb, kw, kb, x, gmax, score_params=()):
        var, ls = score_scalars(score, score_params)
        return _FusedAxNorm1.apply(qw, qb, kw, kb, x.contiguous(), gmax, var,
                                   ls, csr, heads, square_plus, score,
                                   payload_dtype, g.row_pieces)

    return op
