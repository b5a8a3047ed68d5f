"""K10 ``dual_scatter`` and K11 ``dual_gather``: the aggregation of the
composed attention right-hand side and its gradient.

With ``u`` [E, H] unnormalised positive attention (0 on padding and on
masked edges) over a row-sorted graph and ``x`` [N, D] the node state:

* K10: ``num[n, h*D + d] = sum_{e in row n} u[e, h] x[col[e], d]`` and
  ``den[n, h] = sum_{e in row n} u[e, h]``: per-head numerators and
  denominators of the row-normalised aggregation in one pass.
* K11: given the cotangents ``ct_num`` [N, H*D] and ``ct_den`` [N, H],
  ``du[e, h] = ct_num[row[e], h, :] . x[col[e], :] + ct_den[row[e], h]`` and
  ``dx[c, :] = sum_{e: col[e] = c} sum_h u[e, h] ct_num[row[e], h, :]``. On
  a symmetric edge multiset ``dx`` is a row walk through the reverse-edge
  map ``rev``; on a directed one K11 writes ``du`` only and ``dx`` is K1
  ``csr_spmm`` over the CSC view in table mode (:func:`column_head_sum`).

K10 replaces the TPU kernel ``graph_neural_pde_tpu/ops/pallas/stripe.py``
``_scatter2_kernel`` / ``_stripe_scatter2_call``, K11 its gradient
``_gather2_kernel`` / ``_stripe_gather2_call`` with the products XLA forms
around them (see the source note in ``csrc/dual_scatter.cu``). Both walk
the rows cut into pieces (K10 ``Graph.scatter_pieces``, K11
``Graph.row_pieces``) on groups of lanes sized by the row width
(``kernels.lanes``). On a CUDA tensor a wrapper launches
its kernel or raises; on a CPU tensor it runs the plain PyTorch version
beside it, which defines the semantics.
:func:`dual_scatter_add` is the differentiable op the models call.

The table ``x`` is float32 or bfloat16 (the JAX package's bf16 payload,
``rhs_payload_dtype``: its ``x.astype(bf16)[col]``): a bf16 row is widened
to float32 as it is gathered. ``u``, the cotangents, the sums and every
output stay float32, as the JAX package's XLA composition keeps them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from graph_neural_pde_tpu_torch.kernels import build
from graph_neural_pde_tpu_torch.kernels.csr_spmm import TABLE_DTYPES, csr_spmm
from graph_neural_pde_tpu_torch.kernels.fused_rhs import _row_pieces
from graph_neural_pde_tpu_torch.kernels.lanes import lanes
from graph_neural_pde_tpu_torch.ops.graph import SCATTER_WHOLE, ColPieces

MAX_DIM, MAX_HEADS = 256, 32


def _edges(rowptr, row, col):
    n_valid = int(rowptr[-1])
    return n_valid, row[:n_valid].long(), col[:n_valid].long()


def _gathered(x, c, dtype):
    """x[c], a bfloat16 table's rows widened to ``dtype`` (u's)."""
    return x[c].to(dtype)


def dual_scatter_plain(rowptr: torch.Tensor, row: torch.Tensor,
                       col: torch.Tensor, u: torch.Tensor, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10: gather, broadcast product and ``index_add``
    over the valid prefix ``[0, rowptr[-1])``."""
    nv, r, c = _edges(rowptr, row, col)
    n, (h, d) = rowptr.shape[0] - 1, (u.shape[1], x.shape[1])
    vals = u[:nv, :, None] * _gathered(x, c, u.dtype)[:, None, :]  # [E, H, D]
    num = torch.zeros((n, h, d), dtype=u.dtype, device=x.device).index_add(
        0, r, vals)
    den = torch.zeros((n, h), dtype=u.dtype, device=x.device).index_add(
        0, r, u[:nv])
    return num.reshape(n, h * d), den


def dual_gather_plain(rowptr: torch.Tensor, row: torch.Tensor,
                      col: torch.Tensor, u: torch.Tensor, x: torch.Tensor,
                      ct_num: torch.Tensor, ct_den: torch.Tensor,
                      want_dx: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K11: gathers, two contractions and an ``index_add``
    over columns. Returns (du [E_pad, H], dx [N, D] or None without
    ``want_dx``); ``du`` is 0 on the padding slots."""
    nv, r, c = _edges(rowptr, row, col)
    h, d = u.shape[1], x.shape[1]
    cte = ct_num[r].reshape(nv, h, d)
    du = torch.zeros_like(u)
    du[:nv] = (torch.einsum("ehd,ed->eh", cte, _gathered(x, c, u.dtype))
               + ct_den[r])
    if not want_dx:
        return du, None
    dx = torch.zeros(x.shape, dtype=u.dtype, device=x.device).index_add(
        0, c, torch.einsum("eh,ehd->ed", u[:nv], cte))
    return du, dx


def _check(name, rowptr, row, col, u, x, extra=(), rev=None):
    """Device, type, shape and contiguity of what the kernels read.
    ``extra`` is (name, tensor, shape) for the call's own float operands."""
    dev = x.device
    if x.dim() != 2 or u.dim() != 2:
        raise ValueError(f"{name}: x must be [N, D] and u [E, H]")
    n, d = x.shape
    h = u.shape[1]
    if not (1 <= h <= MAX_HEADS and 1 <= d <= MAX_DIM):
        raise ValueError(f"{name}: state width {d} and heads {h} outside "
                         f"the kernel's range (width <= {MAX_DIM}, heads "
                         f"<= {MAX_HEADS})")
    ints = [("rowptr", rowptr, (n + 1,)), ("row", row, (u.shape[0],)),
            ("col", col, (u.shape[0],))]
    if rev is not None:
        ints.append(("rev", rev, (u.shape[0],)))
    floats = [("u", u, None), ("x", x, None), *extra]
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
    # the kernels are float32 beside a float32 or bfloat16 table; the plain
    # versions also take float64 throughout
    allowed = ((torch.float32,) if dev.type != "cpu"
               else (torch.float32, torch.float64))
    if u.dtype not in allowed:
        raise TypeError(f"{name}: u is {u.dtype}; it must be float32")
    if x.dtype != u.dtype and not (x.dtype == torch.bfloat16
                                   and u.dtype == torch.float32):
        raise TypeError(f"{name}: the table x is {x.dtype}; it must be "
                        f"float32 or bfloat16 beside a float32 u")
    for t_name, t, _ in extra:
        if t.dtype != u.dtype:
            raise TypeError(f"{name}: {t_name} is {t.dtype}; it must be "
                            f"u's {u.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name}: no kernel for {dev}")


def _piece_ptrs(pc: ColPieces):
    return (pc.ptr.data_ptr(), pc.col.data_ptr(), pc.slot.data_ptr(),
            pc.multi_col.data_ptr(), pc.multi_ptr.data_ptr())


def scatter_part_floats(d: int, h: int) -> int:
    """The floats of one partial row of K10 (H*D num, then H den), rounded
    up to 16 bytes (``csrc/dual_scatter.cu``, ``scatter_part_stride``)."""
    return -(-h * (d + 1) // 4) * 4


def dual_scatter(rowptr: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                 u: torch.Tensor, x: torch.Tensor,
                 pieces: Optional[ColPieces] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: ``(num [N, H*D], den [N, H])`` over a row-sorted graph whose
    valid edges are the prefix ``[0, rowptr[-1])``; ``u`` is [E_pad, H].
    ``row`` is only read by the plain version. ``pieces``: the rows longer
    than ``SCATTER_WHOLE`` edges cut into pieces of ``COL_PIECE``, the
    rest whole (``Graph.scatter_pieces``), which the kernel's lane groups
    walk; built from ``rowptr`` when None.
    ``x`` float32 or bfloat16; the outputs are float32. Every sum has a
    fixed order: two calls agree bit for bit. Not differentiable by itself
    (see :func:`dual_scatter_add`)."""
    _check("dual_scatter", rowptr, row, col, u, x)
    if x.device.type == "cpu":
        return dual_scatter_plain(rowptr, row, col, u, x)
    n, d = x.shape
    h = u.shape[1]
    dev = x.device
    pc = _row_pieces(dual_scatter, rowptr, pieces, n, dev, SCATTER_WHOLE)
    num = torch.empty((n, h * d), dtype=torch.float32, device=dev)
    den = torch.empty((n, h), dtype=torch.float32, device=dev)
    # scratch: the pieces' partial sums of the rows of several pieces
    part = (torch.empty((pc.n_slots, scatter_part_floats(d, h)),
                        dtype=torch.float32, device=dev)
            if pc.n_multi else None)
    group, vec = lanes("dual_scatter", d, x, heads=h)
    build.launch("dual_scatter", dev, *_piece_ptrs(pc), col.data_ptr(),
                 u.data_ptr(), x.data_ptr(), num.data_ptr(), den.data_ptr(),
                 _ptr(part), n, pc.n_pieces, pc.n_multi, d, h, group, vec,
                 TABLE_DTYPES[x.dtype])
    dual_scatter.launches += 1
    dual_scatter.bf16_launches += x.dtype == torch.bfloat16
    return num, den


def dual_gather(rowptr: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                rev: Optional[torch.Tensor], u: torch.Tensor, x: torch.Tensor,
                ct_num: torch.Tensor, ct_den: torch.Tensor,
                pieces: Optional[ColPieces] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K11: ``(du [E_pad, H], dx [N, D])``, the gradient of K10 given its
    outputs' cotangents (two walks behind one launch call: du, then dx on
    a symmetric graph), with ``dx`` reached through the reverse-edge map
    ``rev`` (``Graph.rev``) of a SYMMETRIC edge multiset. With ``rev=None``
    (a directed graph) it returns ``(du, None)``: see
    :func:`column_head_sum` for that ``dx``. ``row`` is only read by the
    plain version; ``pieces``: the rows cut into pieces of at most
    ``COL_PIECE`` edges (``Graph.row_pieces``), built from ``rowptr`` when
    None. ``x``
    float32 or bfloat16; ``du`` and ``dx`` are float32, ``du`` 0 on the
    padding slots (the kernel writes them)."""
    n, d = x.shape
    h = u.shape[1]
    _check("dual_gather", rowptr, row, col, u, x,
           (("ct_num", ct_num, (n, h * d)), ("ct_den", ct_den, (n, h))), rev)
    if x.device.type == "cpu":
        return dual_gather_plain(rowptr, row, col, u, x, ct_num, ct_den,
                                 want_dx=rev is not None)
    dev = x.device
    pc = _row_pieces(dual_gather, rowptr, pieces, n, dev)
    du = torch.empty_like(u)                   # the kernel writes every slot
    dx = None if rev is None else torch.empty((n, d), dtype=torch.float32,
                                              device=dev)
    # scratch: the partial rows of dx of the rows of several pieces
    part = (torch.empty((pc.n_slots, d), dtype=torch.float32, device=dev)
            if pc.n_multi and rev is not None else None)
    # the du walk's lanes read x beside ct_num, the dx walk's ct_num alone
    group, vec = lanes("dual_gather", d, x, ct_num)
    dx_group, dx_vec = lanes("dual_gather", d, ct_num)
    build.launch("dual_gather", dev, *_piece_ptrs(pc), col.data_ptr(),
                 _ptr(rev), u.data_ptr(), x.data_ptr(), ct_num.data_ptr(),
                 ct_den.data_ptr(), du.data_ptr(), _ptr(dx), _ptr(part), n,
                 pc.n_pieces, pc.n_multi, u.shape[0], d, h, group, vec,
                 dx_group, dx_vec, TABLE_DTYPES[x.dtype])
    dual_gather.launches += 1
    dual_gather.bf16_launches += x.dtype == torch.bfloat16
    return du, dx


_ptr = build.ptr


def column_head_sum(g, u: torch.Tensor, ct_num: torch.Tensor
                    ) -> torch.Tensor:
    """K11's ``dx`` on any row-sorted graph: ``dx[n] = sum_{e: col[e]=n}
    sum_h u[e, h] ct_num[row[e], h, :]``, one K1 launch over the CSC view
    in table mode. ``ct_num`` [N, H*D] is read as the table [N*H, D] whose
    row ``r*H + h`` is head h of node r, and node n's segment lists, for
    each of its column's edges in order, the H rows ``row_by_col*H + h``
    weighted by ``u[col_perm, h]``. ``u`` must be 0 on dropped slots."""
    h = u.shape[1]
    n, hd = ct_num.shape
    heads = torch.arange(h, dtype=torch.int32, device=u.device)
    idx = (g.row_by_col[:, None] * h + heads).reshape(-1)
    seg = g.col_by_col.repeat_interleave(h)
    w = u[g.col_perm.long()].reshape(-1).contiguous()
    return csr_spmm(g.colptr * h, seg, idx, w, ct_num.view(n * h, hd // h),
                    table=True, n_edges=g.num_valid * h)


dual_scatter.launches = 0
dual_gather.launches = 0
dual_scatter.bf16_launches = 0  # the launches on a bfloat16 table, among them
dual_gather.bf16_launches = 0
# the calls that built the row pieces from rowptr because none were handed
# over
dual_scatter.piece_builds = 0
dual_gather.piece_builds = 0


class _DualScatter(torch.autograd.Function):
    """(num, den) = K10 with K11 as its backward, over the table ``x`` cast
    to ``payload`` (None: x as it is). The cast is the identity in the
    gradient: x's gradient is summed in float32 and cast once to x's dtype.
    Residuals: u and the table."""

    @staticmethod
    def forward(ctx, u, x, g, payload):
        table = x if payload is None else x.to(payload).contiguous()
        ctx.save_for_backward(u, table)
        ctx.g, ctx.x_dtype = g, x.dtype
        return dual_scatter(g.rowptr, g.row, g.col, u, table,
                            pieces=g.scatter_pieces)

    @staticmethod
    def backward(ctx, ct_num, ct_den):
        u, table = ctx.saved_tensors
        g = ctx.g
        ct_num = ct_num.contiguous()
        du, dx = dual_gather(g.rowptr, g.row, g.col, g.rev, u, table, ct_num,
                             ct_den.contiguous(), pieces=g.row_pieces)
        if dx is None:
            dx = column_head_sum(g, u, ct_num)
        return du, dx.to(ctx.x_dtype), None, None


def dual_scatter_add(g, u: torch.Tensor, x: torch.Tensor,
                     payload_dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(num [N, H*D], den [N, H])`` over the prepared graph ``g``,
    directed or not, differentiable in ``u`` and ``x`` through K11 (and, on
    a directed graph, K1 over the CSC view for ``dx``): the JAX package's
    ``stripe_scatter_add2`` with the x[col] gather and the outer product
    folded in. ``payload_dtype`` (None or ``torch.bfloat16``) is the dtype
    the gathered table is read in, as ``kernels.fused_rhs.column_table``
    casts it (a bfloat16 x is read as it is)."""
    if not g.rows_sorted or g.rowptr is None:
        raise ValueError("dual_scatter_add needs a row-sorted graph "
                         "(sort_by_row)")
    if payload_dtype not in (None, torch.bfloat16):
        raise TypeError(f"dual_scatter_add: payload {payload_dtype}; the "
                        f"kernels read a float32 or bfloat16 table")
    return _DualScatter.apply(u.contiguous(), x.contiguous(), g,
                              payload_dtype)
