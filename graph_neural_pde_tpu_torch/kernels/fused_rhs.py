"""K6-K9: the fused attention right-hand side of GRAND-nl, its row maxima
and its two backward passes.

One evaluation of the transformer ODE function recomputes multihead
attention and aggregates with it. With row-normalised softmax the softmax
groups are the aggregation's output rows, so one walk over a row's edges
gives everything (``n`` a row, ``e`` its edges, ``c = col[e]``):

    q_n  = x_n Qw + qb                       [ATT]
    k_e  = x_c Kw + kb                       [ATT]
    s_eh = score_h(q_n, k_e)                 (four families, below)
    u_eh = exp(s_eh - gmax - shift_eh)       (or squareplus of the same)
    den[n, h] = sum_e u_eh
    ax[n]     = (1/H) sum_h (sum_e u_eh x_c) / (den[n, h] + 1e-16)

* K6 ``fused_rhs_fwd``     -> (ax, den[, num]) or, folded, the guarded
  ``f = alpha (ax - x)``; replaces ``ops/pallas/fused_rhs.py``
  ``_rhs_kernel_ax`` / ``_fused_ax_call``.
* K7 ``fused_rowmax``      -> per-row, per-head maxima of the scaled-dot
  scores (edgeless rows 0); replaces ``_rowmax_kernel`` / ``fused_rowmax``.
* K8 ``fused_rhs_bwd``     -> (dq, per-edge dxg, dkw, dkb, dgmax, dvar, dls)
  from the cotangents; replaces ``_bwd_kernel`` / ``_fused_bwd_mega_call``.
* K9 ``fused_rhs_bwd_sym`` -> the same with x[col]'s cotangent reduced into
  ``dxrow[n]`` through each edge's reverse edge, for symmetric edge
  multisets; replaces ``_bwd_sym_kernel`` / ``_fused_bwd_mega_sym_call``.

The graph is the row-sorted CSR prefix ``Graph.sort_by_row`` leaves; the
kernels gather ``x[col]`` themselves (see ``csrc/fused_rhs.cu`` for what
bounds them on the H100). On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs the plain PyTorch version beside it, which
defines the semantics. ``fused_rhs_ax``, ``make_fused_ax_sym``,
``fused_rhs_f`` keep the JAX package's names: the differentiable ops the
models call.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from graph_neural_pde_tpu_torch.kernels import build
from graph_neural_pde_tpu_torch.kernels.csr_spmm import csr_spmm

SCORES = {"scaled_dot": 0, "cosine_sim": 1, "pearson": 2, "exp_kernel": 3}
EPS = 1e-16
EPS_NORM = 1e-5         # the reference's cosine / pearson norm floor
MAX_DIM, MAX_ATT, MAX_HEADS = 256, 256, 32
MAX_SHARED_BYTES = 227 * 1024
WARPS_PER_BLOCK = 4


def edge_scores(src: torch.Tensor, dst: torch.Tensor, score: str,
                var: Optional[torch.Tensor] = None,
                ls: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge, per-head raw scores [E, H] from q/k rows [E, H, d_k]: the
    four reference score families (``exp_kernel`` takes its ``output_var``
    and ``lengthscale``)."""
    d_k = src.shape[-1]
    if score == "exp_kernel":
        sq = torch.sum((src - dst) ** 2, dim=-1)
        return var ** 2 * torch.exp(-sq / (2.0 * ls ** 2))
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


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_rhs_fwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, *,
                        heads: int, score: str, var=None, ls=None,
                        shifts=None, square_plus: bool = False, alpha=None,
                        want_num: bool = False):
    """Plain version of K6: gathers, a per-head loop of ``index_add`` sums
    and the head-mean divide, in float32."""
    nv, r, c = _edges(rowptr, row, col)
    n, d = x.shape
    xe = x[c]
    src = (x @ qw + qb)[r].reshape(nv, heads, -1)
    ke = (xe @ kw + kb).reshape(nv, heads, -1)
    sm = edge_scores(src, ke, score, var, ls) - gmax
    if shifts is not None:
        sm = sm - shifts[:nv]
    u, _ = _u_duds(sm, square_plus)
    den = _node_sum(n, r, u)
    num = torch.stack([_node_sum(n, r, u[:, h, None] * xe)
                       for h in range(heads)], dim=1)          # [N, H, D]
    out = torch.sum(num * (1.0 / (den + EPS))[:, :, None], dim=1) / heads
    if alpha is not None:
        out = torch.where(den_guard(den, rowptr, per_row=True),
                          torch.full_like(out, torch.nan), alpha * (out - x))
    return out, den, (num.reshape(n, heads * d) if want_num else None)


def fused_rowmax_plain(rowptr, row, col, x, qw, qb, kw, kb, *, heads: int):
    """Plain version of K7: scaled-dot scores and a scatter max per row."""
    nv, r, c = _edges(rowptr, row, col)
    n = x.shape[0]
    src = (x @ qw + qb)[r].reshape(nv, heads, -1)
    ke = (x[c] @ kw + kb).reshape(nv, heads, -1)
    s = edge_scores(src, ke, "scaled_dot")
    m = torch.full((n, heads), -torch.inf, dtype=x.dtype, device=x.device)
    m = m.scatter_reduce(0, r[:, None].expand_as(s), s, "amax",
                         include_self=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def fused_rhs_bwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax,
                        recip_p, ct_den, *, heads: int, score: str, var=None,
                        ls=None, shifts=None, square_plus: bool = False):
    """Plain version of K8. With ``recip_p = 1 / (H (den + 1e-16))`` and
    ``ct_den`` the total cotangent of ``den``:

        du_eh = (ct_ax[n] . x_c) recip_p[n, h] + ct_den[n, h]
        ds_eh = du_eh  du/ds
        dq[n] = sum_e ds . ds/dq,   dk_e = ds . ds/dk
        dxg[e] = (sum_h u_eh recip_p[n, h]) ct_ax[n] + dk_e Kw^T
        dkw = sum_e x_c^T dk_e,  dkb = sum_e dk_e,  dgmax = -sum ds

    The score's own derivative comes from autograd over
    :func:`edge_scores`. Returns (dq [N, ATT], dxg [E_pad, D], dkw, dkb,
    dgmax, dvar, dls); the last two are None but for ``exp_kernel``."""
    nv, r, c = _edges(rowptr, row, col)
    n, d = x.shape
    att = qw.shape[1]
    xe = x[c]
    with torch.enable_grad():
        src = (x @ qw + qb)[r].detach().requires_grad_(True)
        ke = (xe @ kw + kb).detach().requires_grad_(True)
        wrt = [src, ke]
        if score == "exp_kernel":
            var = var.detach().requires_grad_(True)
            ls = ls.detach().requires_grad_(True)
            wrt += [var, ls]
        s = edge_scores(src.reshape(nv, heads, -1), ke.reshape(nv, heads, -1),
                        score, var, ls)
    sm = s.detach() - gmax
    if shifts is not None:
        sm = sm - shifts[:nv]
    u, duds = _u_duds(sm, square_plus)
    rg = recip_p[r]
    dot = torch.sum(ct_ax[r] * xe, dim=1, keepdim=True)
    ds = (rg * dot + ct_den[r]) * duds
    dsrc, dke, *dextra = torch.autograd.grad(s, wrt, ds)
    dq = _node_sum(n, r, dsrc)
    dxg = torch.zeros((row.shape[0], d), dtype=x.dtype, device=x.device)
    dxg[:nv] = (torch.sum(u * rg, dim=1, keepdim=True) * ct_ax[r]
                + dke @ kw.T)
    dvar, dls = dextra if dextra else (None, None)
    return (dq, dxg, xe.T @ dke, torch.sum(dke, dim=0), -torch.sum(ds), dvar,
            dls)


def fused_rhs_bwd_sym_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax,
                            recip_p, ct_den, *, heads: int, score: str,
                            var=None, ls=None, square_plus: bool = False):
    """Plain version of K9: K8's outputs with the per-edge ``dxg`` summed
    over columns into ``dxrow`` [N, D] (on a symmetric edge multiset the
    kernel reaches the same sum through each edge's reverse edge)."""
    dq, dxg, dkw, dkb, dgmax, dvar, dls = fused_rhs_bwd_plain(
        rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den,
        heads=heads, score=score, var=var, ls=ls, square_plus=square_plus)
    nv, _, c = _edges(rowptr, row, col)
    return dq, _node_sum(x.shape[0], c, dxg[:nv]), dkw, dkb, dgmax, dvar, dls


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, rowptr, row, col, x, qw, qb, kw, kb, heads, score,
           var=None, ls=None, extra=()):
    """Device, type, shape and contiguity of what the kernels read.
    ``extra`` is (name, tensor, shape) for the call's own float operands."""
    dev = x.device
    if score not in SCORES:
        if score == "exp_kernel_beltrami":
            raise NotImplementedError(
                f"{name}: the split-space exp_kernel_beltrami score is not "
                "ported (ROADMAP Queue 1 slice 4 item 15)")
        raise ValueError(f"{name}: unknown score family '{score}'")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [N, D]")
    n, d = x.shape
    att = qw.shape[-1]
    if (heads < 1 or heads > MAX_HEADS or att % heads or att > MAX_ATT
            or d > MAX_DIM):
        raise ValueError(f"{name}: state width {d}, attention_dim {att}, "
                         f"heads {heads} outside the kernel's range (width "
                         f"<= {MAX_DIM}, heads <= {MAX_HEADS} dividing "
                         f"attention_dim <= {MAX_ATT})")
    ints = (("rowptr", rowptr, (n + 1,)), ("row", row, None),
            ("col", col, row.shape))
    floats = [("x", x, (n, d)), ("qw", qw, (d, att)), ("qb", qb, (att,)),
              ("kw", kw, (d, att)), ("kb", kb, (att,)), *extra]
    if score == "exp_kernel":
        if var is None or ls is None:
            raise ValueError(f"{name}: exp_kernel needs var and ls")
        floats += [("var", var, None), ("ls", ls, None)]
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
    for t_name, t, _ in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t_name} must be float32")
    for t_name, t in (("var", var), ("ls", ls)):
        if score == "exp_kernel" and t.numel() != 1:
            raise ValueError(f"{name}: {t_name} must hold one element")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name}: no kernel for {dev}")


def _shared_bytes(name: str, floats_per_warp: int) -> None:
    if floats_per_warp * 4 * WARPS_PER_BLOCK > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: state width, attention_dim and heads "
                         "need more shared memory than a block has")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _node_tables(x: torch.Tensor, att: int) -> torch.Tensor:
    """Scratch for a kernel's first pass: every node's q and k projections
    [2, N, ATT], which the row walk then gathers per edge. The caller holds
    it in a variable across the launch: a temporary would hand its memory
    to the next allocation."""
    return torch.empty((2, x.shape[0], att), dtype=torch.float32,
                       device=x.device)


def _flags(score: str, square_plus: bool) -> int:
    return SCORES[score] | (4 if square_plus else 0)


def fused_rhs_fwd(rowptr, row, col, x, qw, qb, kw, kb, gmax, *, heads: int,
                  score: str, var=None, ls=None, shifts=None,
                  square_plus: bool = False, alpha=None,
                  want_num: bool = False):
    """K6. Returns ``(ax [N, D], den [N, H], num)``; ``num`` [N, H·D], the
    per-head numerators the backward reads, only when ``want_num``. With
    ``alpha`` (a one-element tensor) the first output is instead the folded
    ``alpha (ax - x)``, NaN on every row whose ``den`` under- or overflowed
    (``den <= 0`` with edges, or non-finite). ``gmax`` is a one-element
    tensor, ``shifts`` optional per-edge score shifts [E_pad, H]. ``row`` is
    only read by the plain version. Not differentiable by itself."""
    n, d = x.shape
    extra = [("gmax", gmax, None)]
    if shifts is not None:
        extra.append(("shifts", shifts, (row.shape[0], heads)))
    if alpha is not None:
        extra.append(("alpha", alpha, None))
    _check("fused_rhs_fwd", rowptr, row, col, x, qw, qb, kw, kb, heads,
           score, var, ls, extra)
    kwargs = dict(heads=heads, score=score, var=var, ls=ls, shifts=shifts,
                  square_plus=square_plus, alpha=alpha, want_num=want_num)
    if x.device.type == "cpu":
        return fused_rhs_fwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                                   **kwargs)
    att = qw.shape[1]
    _shared_bytes("fused_rhs_fwd", 2 * d + 2 * att + heads * d)
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    den = torch.empty((n, heads), dtype=torch.float32, device=x.device)
    num = (torch.empty((n, heads * d), dtype=torch.float32, device=x.device)
           if want_num else None)
    tabs = _node_tables(x, att)
    build.launch("fused_rhs_fwd", x.device, rowptr.data_ptr(),
                 col.data_ptr(), x.data_ptr(), qw.data_ptr(), qb.data_ptr(),
                 kw.data_ptr(), kb.data_ptr(), gmax.data_ptr(), _ptr(var),
                 _ptr(ls), _ptr(shifts), _ptr(alpha), tabs[0].data_ptr(),
                 tabs[1].data_ptr(), out.data_ptr(), den.data_ptr(),
                 _ptr(num), n, d, att, heads, _flags(score, square_plus))
    fused_rhs_fwd.launches += 1
    return out, den, num


def fused_rowmax(rowptr, row, col, x, qw, qb, kw, kb, *, heads: int):
    """K7: [N, H] per-row maxima of the scaled-dot scores, 0 on edgeless
    rows: the shifts of the exact softmax. Not differentiable."""
    _check("fused_rowmax", rowptr, row, col, x, qw, qb, kw, kb, heads,
           "scaled_dot")
    if x.device.type == "cpu":
        return fused_rowmax_plain(rowptr, row, col, x, qw, qb, kw, kb,
                                  heads=heads)
    n, d = x.shape
    att = qw.shape[1]
    _shared_bytes("fused_rowmax", 2 * att)
    smax = torch.empty((n, heads), dtype=torch.float32, device=x.device)
    tabs = _node_tables(x, att)
    build.launch("fused_rowmax", x.device, rowptr.data_ptr(), col.data_ptr(),
                 x.data_ptr(), qw.data_ptr(), qb.data_ptr(), kw.data_ptr(),
                 kb.data_ptr(), tabs[0].data_ptr(), tabs[1].data_ptr(),
                 smax.data_ptr(), n, d, att, heads)
    fused_rowmax.launches += 1
    return smax


def _bwd_extra(x, heads, gmax, ct_ax, recip_p, ct_den, shifts, cap):
    n = x.shape[0]
    extra = [("gmax", gmax, None), ("ct_ax", ct_ax, x.shape),
             ("recip_p", recip_p, (n, heads)), ("ct_den", ct_den, (n, heads))]
    if shifts is not None:
        extra.append(("shifts", shifts, (cap, heads)))
    return extra


def _finish_bwd(partials, row_sums, d, score, var, ls):
    """Second pass of the reductions over all edges: the per-block partial
    sums of [x_c | 1]^T dk, and the per-row sums of ds and of the
    exp_kernel scalars' terms, each summed in a fixed order."""
    dk_sum = torch.sum(partials, dim=0)                   # [D + 1, ATT]
    tot = torch.sum(row_sums, dim=0)                      # [3]
    dvar = dls = None
    if score == "exp_kernel":
        dvar = tot[1].reshape(var.shape)
        dls = tot[2].reshape(ls.shape)
    return dk_sum[:d].contiguous(), dk_sum[d], -tot[0], dvar, dls


def _reduce_blocks(rows: int) -> int:
    """Blocks over the rows of the [x_c | 1]^T dk reduction (their partial
    sums are the second pass's input): short row ranges, so that enough
    blocks are in flight to hide the gathers' latency."""
    return max(1, min(2048, -(-rows // 64)))


def fused_rhs_bwd(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p,
                  ct_den, *, heads: int, score: str, var=None, ls=None,
                  shifts=None, square_plus: bool = False):
    """K8: the general backward (see :func:`fused_rhs_bwd_plain` for the
    formulas and the return value). The reductions over all edges take two
    passes with fixed orders, so two calls agree bit for bit."""
    cap = row.shape[0]
    _check("fused_rhs_bwd", rowptr, row, col, x, qw, qb, kw, kb, heads,
           score, var, ls,
           _bwd_extra(x, heads, gmax, ct_ax, recip_p, ct_den, shifts, cap))
    kwargs = dict(heads=heads, score=score, var=var, ls=ls, shifts=shifts,
                  square_plus=square_plus)
    if x.device.type == "cpu":
        return fused_rhs_bwd_plain(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                                   ct_ax, recip_p, ct_den, **kwargs)
    n, d = x.shape
    att = qw.shape[1]
    _shared_bytes("fused_rhs_bwd", 3 * d + 4 * att + 5 * heads)
    dev = x.device
    dq = torch.empty((n, att), dtype=torch.float32, device=dev)
    dxg = torch.zeros((cap, d), dtype=torch.float32, device=dev)
    # scratch: every slot's dk_e (0 on padding, which the reduction also
    # walks: the valid count stays on the device), and each row's sums of
    # ds and of the exp_kernel scalars' terms
    dke = torch.zeros((cap, att), dtype=torch.float32, device=dev)
    row_sums = torch.empty((n, 3), dtype=torch.float32, device=dev)
    blocks = _reduce_blocks(cap)
    tabs, kw_t = _node_tables(x, att), kw.t().contiguous()
    partials = torch.zeros((blocks, d + 1, att), dtype=torch.float32,
                           device=dev)
    build.launch("fused_rhs_bwd", dev, rowptr.data_ptr(), col.data_ptr(),
                 x.data_ptr(), qw.data_ptr(), qb.data_ptr(), kw.data_ptr(),
                 kb.data_ptr(), gmax.data_ptr(), _ptr(var), _ptr(ls),
                 _ptr(shifts), ct_ax.data_ptr(), recip_p.data_ptr(),
                 ct_den.data_ptr(), kw_t.data_ptr(), tabs[0].data_ptr(),
                 tabs[1].data_ptr(), dq.data_ptr(), dxg.data_ptr(),
                 dke.data_ptr(), row_sums.data_ptr(), partials.data_ptr(),
                 n, d, att, heads, _flags(score, square_plus), cap, blocks)
    fused_rhs_bwd.launches += 1
    return (dq, dxg) + _finish_bwd(partials, row_sums, d, score, var, ls)


def fused_rhs_bwd_sym(rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax,
                      recip_p, ct_den, *, heads: int, score: str, var=None,
                      ls=None, square_plus: bool = False):
    """K9: the backward over a SYMMETRIC edge multiset (the caller checks
    ``Graph.rev is not None``): returns (dq, dxrow [N, D], dkw, dkb, dgmax,
    dvar, dls) with ``dxrow`` the whole x[col] cotangent. No per-edge array
    is written and no reverse-edge map is read: each edge (n, c) also
    evaluates its reverse edge (c, n) from node rows gathered at c."""
    _check("fused_rhs_bwd_sym", rowptr, row, col, x, qw, qb, kw, kb, heads,
           score, var, ls,
           _bwd_extra(x, heads, gmax, ct_ax, recip_p, ct_den, None, 0))
    kwargs = dict(heads=heads, score=score, var=var, ls=ls,
                  square_plus=square_plus)
    if x.device.type == "cpu":
        return fused_rhs_bwd_sym_plain(rowptr, row, col, x, qw, qb, kw, kb,
                                       gmax, ct_ax, recip_p, ct_den, **kwargs)
    n, d = x.shape
    att = qw.shape[1]
    _shared_bytes("fused_rhs_bwd_sym", 5 * d + 6 * att + 10 * heads)
    dev = x.device
    dq = torch.empty((n, att), dtype=torch.float32, device=dev)
    dxrow = torch.empty((n, d), dtype=torch.float32, device=dev)
    # scratch: dk summed per NODE (each row's reverse edges), and each
    # row's sums of ds and of the exp_kernel scalars' terms
    dkn = torch.empty((n, att), dtype=torch.float32, device=dev)
    row_sums = torch.empty((n, 3), dtype=torch.float32, device=dev)
    blocks = _reduce_blocks(n)
    tabs, kw_t = _node_tables(x, att), kw.t().contiguous()
    partials = torch.zeros((blocks, d + 1, att), dtype=torch.float32,
                           device=dev)
    build.launch("fused_rhs_bwd_sym", dev, rowptr.data_ptr(), col.data_ptr(),
                 x.data_ptr(), qw.data_ptr(), qb.data_ptr(), kw.data_ptr(),
                 kb.data_ptr(), gmax.data_ptr(), _ptr(var), _ptr(ls),
                 ct_ax.data_ptr(), recip_p.data_ptr(), ct_den.data_ptr(),
                 kw_t.data_ptr(), tabs[0].data_ptr(), tabs[1].data_ptr(),
                 dq.data_ptr(), dxrow.data_ptr(), dkn.data_ptr(),
                 row_sums.data_ptr(), partials.data_ptr(), n, d, att, heads,
                 _flags(score, square_plus), blocks)
    fused_rhs_bwd_sym.launches += 1
    return (dq, dxrow) + _finish_bwd(partials, row_sums, d, score, var, ls)


fused_rhs_fwd.launches = 0
fused_rowmax.launches = 0
fused_rhs_bwd.launches = 0
fused_rhs_bwd_sym.launches = 0


# ---------------------------------------------------------------------------
# differentiable ops (the JAX package's names)
# ---------------------------------------------------------------------------

def _score_params(score: str, score_params) -> Tuple:
    if score == "exp_kernel":
        var, ls = score_params
        return var, ls
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
    """(ax, den) = K6; its backward is K9 (``rev is None`` in the call:
    symmetric, x's whole gradient from the kernel) or K8 followed by the sum
    of the per-edge ``dxg`` over columns, taken through the reverse-edge map
    with K1's row walk. Residuals: the inputs, ``den`` and the per-head
    numerators ``num`` that K6 flushes when a gradient is wanted."""

    @staticmethod
    def forward(ctx, qw, qb, kw, kb, x, gmax, var, ls, shifts, csr, rev,
                heads, square_plus, score):
        rowptr, row, col = csr
        want = any(ctx.needs_input_grad)
        ax, den, num = fused_rhs_fwd(
            rowptr, row, col, x, qw, qb, kw, kb, gmax, heads=heads,
            score=score, var=var, ls=ls, shifts=shifts,
            square_plus=square_plus, want_num=want)
        ctx.save_for_backward(qw, qb, kw, kb, x, gmax, var, ls, shifts, den,
                              num, rowptr, row, col, rev)
        ctx.opts = (heads, square_plus, score)
        return ax, den

    @staticmethod
    def backward(ctx, ct_ax, ct_den_in):
        (qw, qb, kw, kb, x, gmax, var, ls, shifts, den, num, rowptr, row,
         col, rev) = ctx.saved_tensors
        heads, square_plus, score = ctx.opts
        ct_ax = ct_ax.contiguous()
        recip_p, ct_den = _node_cotangents(ct_ax, ct_den_in, num, den, heads)
        kwargs = dict(heads=heads, score=score, var=var, ls=ls,
                      square_plus=square_plus)
        if rev is None:
            dq, dx, dkw, dkb, dgmax, dvar, dls = fused_rhs_bwd_sym(
                rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p,
                ct_den, **kwargs)
        else:
            dq, dxg, dkw, dkb, dgmax, dvar, dls = fused_rhs_bwd(
                rowptr, row, col, x, qw, qb, kw, kb, gmax, ct_ax, recip_p,
                ct_den, shifts=shifts, **kwargs)
            # dx[n] = sum_{e: col[e] = n} dxg[e] = sum_{e in row n} dxg[rev[e]]
            dx = csr_spmm(rowptr, row, rev, torch.ones_like(dxg[:, 0]), dxg,
                          table=True)
        dx = dx + dq @ qw.T
        return (x.T @ dq, torch.sum(dq, dim=0), dkw, dkb, dx,
                dgmax.reshape(gmax.shape), dvar, dls) + (None,) * 6


def _graph_csr(g, name: str):
    if not g.rows_sorted or g.rowptr is None:
        raise ValueError(f"{name} needs a row-sorted graph (sort_by_row)")
    return g.rowptr, g.row, g.col


def _need_symmetric(g, name: str) -> None:
    if g.rev is None:
        raise NotImplementedError(
            f"{name}: x's gradient on a directed (non-symmetric) edge "
            "multiset needs the column-side transpose kernel, ROADMAP "
            "Queue 2 K5 / P12 (_bwd_dx_col_call)")


def fused_rhs_ax(g, heads: int, square_plus: bool, score: str, qw, qb, kw,
                 kb, x, gmax, shifts=None, score_params=()):
    """(ax [N, D], den [N, H]) over the prepared graph ``g``, differentiable
    in qw, qb, kw, kb, x, gmax and the exp_kernel scalars through K8.
    ``shifts`` [E_pad, H] carry no gradient (ax is invariant to per-row
    shifts)."""
    csr = _graph_csr(g, "fused_rhs_ax")
    _need_symmetric(g, "fused_rhs_ax")
    var, ls = _score_params(score, score_params)
    return _FusedAx.apply(qw, qb, kw, kb, x.contiguous(), gmax, var, ls,
                          shifts, csr, g.rev, heads, square_plus, score)


def make_fused_ax_sym(g, heads: int, square_plus: bool, score: str):
    """``op(qw, qb, kw, kb, x, gmax, score_params) -> (ax, den)`` for a
    SYMMETRIC edge multiset, whose backward (K9) returns x's total gradient
    with no reverse-edge map and no per-edge array."""
    csr = _graph_csr(g, "make_fused_ax_sym")
    _need_symmetric(g, "make_fused_ax_sym")

    def op(qw, qb, kw, kb, x, gmax, score_params=()):
        var, ls = _score_params(score, score_params)
        return _FusedAx.apply(qw, qb, kw, kb, x.contiguous(), gmax, var, ls,
                              None, csr, None, heads, square_plus, score)

    return op


def den_guard(den: torch.Tensor, rowptr: torch.Tensor, per_row: bool):
    """True where the unshifted softmax left float32's range: a row with
    edges whose ``den`` is 0 (every exp underflowed) or any non-finite
    ``den`` (an exp overflowed). One flag per row, or one for all rows."""
    deg = (rowptr[1:] - rowptr[:-1])[:, None]
    bad = ((den <= 0.0) & (deg > 0)) | ~torch.isfinite(den)
    return torch.any(bad, dim=1, keepdim=True) if per_row else torch.any(bad)


def fused_rhs_f(g, heads: int, score: str, qw, qb, kw, kb, x, alpha,
                score_params=()):
    """f [N, D] = alpha (ax - x) with the per-row guard, folded into K6's
    final write: the no-grad solves' RHS. Under autograd it is the unfolded
    composition with the same per-row guard, so a stray gradient through an
    eval-mode model is K8's."""
    rowptr, row, col = _graph_csr(g, "fused_rhs_f")
    gmax = torch.zeros((1,), dtype=torch.float32, device=x.device)
    tensors = (qw, qb, kw, kb, x, alpha, *score_params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        ax, den = fused_rhs_ax(g, heads, False, score, qw, qb, kw, kb, x,
                               gmax, None, score_params)
        bad = den_guard(den, rowptr, per_row=True)
        return alpha * (torch.where(bad, torch.full_like(ax, torch.nan), ax)
                        - x)
    var, ls = _score_params(score, score_params)
    f, _, _ = fused_rhs_fwd(rowptr, row, col, x.contiguous(), qw, qb, kw, kb,
                            gmax, heads=heads, score=score, var=var, ls=ls,
                            alpha=alpha.reshape(1))
    return f
