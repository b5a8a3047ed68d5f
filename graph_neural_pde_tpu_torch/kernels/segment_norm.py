"""K3 ``segment_norm`` and K4 ``segment_norm_bwd``: per-segment softmax or
normalisation of per-edge, per-head values, and its gradient.

``s`` is [E, H] float32 over a row-sorted edge list. The segments are given
by a pointer ``segptr`` [N + 1] over positions ``[0, segptr[-1])``, the
segment id ``seg[i]`` of each position (read only by the plain version) and
an optional permutation ``perm`` [E] from positions to slots: segment n's
members are the slots ``perm[i]`` for ``i`` in ``[segptr[n], segptr[n+1])``
(``i`` itself without ``perm``). Three layouts occur:

* rows: ``(rowptr, row, None)``;
* columns of a symmetric edge multiset: ``(rowptr, row, rev)``, node n's
  column segment read through the reverse edges of its row;
* columns of any graph: ``(colptr, col_by_col, col_perm)``, the CSC view.

* ``mode="softmax"``:   ``out = exp(s - max_seg s) / (den + 1e-16)`` with
  ``den = sum_seg exp(s - max_seg s)``;
* ``mode="normalise"``: ``out = s / (den + 1e-16)`` with ``den = sum_seg s``.

Both return ``(out [E, H], den [N, H])``; slots outside the segments are 0.
K4 takes ``out``, the cotangent ``g`` and ``den`` and returns ``ds``.

On the card both walk the segments cut into pieces of 32 or 64 members
(``pieces``: ``ops.graph.ColPieces`` of ``segptr``, ``Graph.row_segments``
or ``Graph.col_segments``, which ``ops.scatter.segment_pieces`` picks), a
group of lanes a piece, with the lanes and vector width of
``lanes.segment_design``; they write the padding
slots themselves, so the outputs are allocated without a memset.

Replaces the TPU kernel ``graph_neural_pde_tpu/ops/pallas/stripe.py``
``_scatter_kernel`` / ``_stripe_scatter_call`` (P3) where it forms, with
P2's row gather, ``stripe_segment_softmax`` / ``_squareplus`` and the
norm_idx=0 frozen attention (see the source note in
``csrc/segment_norm.cu``); over the CSC view it is P3 over the JAX
package's column plan. On a CUDA tensor a wrapper launches its kernel
or raises; on a CPU tensor it runs the plain PyTorch version, which defines
the semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from graph_neural_pde_tpu_torch.kernels import build
from graph_neural_pde_tpu_torch.kernels.lanes import (SEGMENT_PIECES,
                                                      segment_design)

MODES = {"softmax": 0, "normalise": 1}
EPS = 1e-16


def _members(segptr, seg, perm):
    """(slot of each segment member, its segment), in position order."""
    n_valid = int(segptr[-1])
    ids = seg[:n_valid].long()
    if perm is None:
        return torch.arange(n_valid, device=seg.device), ids
    return perm[:n_valid].long(), ids


def segment_norm_plain(segptr: torch.Tensor, seg: torch.Tensor,
                       perm: Optional[torch.Tensor], s: torch.Tensor,
                       mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: gather the members, a scatter max (softmax), exp,
    ``index_add`` sums, divide, and scatter back to their slots."""
    idx, seg = _members(segptr, seg, perm)
    n, h = segptr.shape[0] - 1, s.shape[1]
    t = s[idx]
    if mode == "softmax":
        m = torch.full((n, h), -torch.inf, dtype=s.dtype, device=s.device)
        m = m.scatter_reduce(0, seg[:, None].expand_as(t), t, "amax",
                             include_self=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        t = torch.exp(t - m[seg])
    den = torch.zeros((n, h), dtype=s.dtype, device=s.device).index_add(
        0, seg, t)
    out = torch.zeros_like(s)
    out[idx] = t / (den[seg] + EPS)
    return out, den


def segment_norm_bwd_plain(segptr: torch.Tensor, seg: torch.Tensor,
                           perm: Optional[torch.Tensor], out: torch.Tensor,
                           g: torch.Tensor, den: torch.Tensor,
                           mode: str) -> torch.Tensor:
    """Plain version of the gradient: ``index_add`` of g·out per segment,
    then the per-member formula."""
    idx, seg = _members(segptr, seg, perm)
    o, gg = out[idx], g[idx]
    dot = torch.zeros(den.shape, dtype=g.dtype, device=g.device).index_add(
        0, seg, gg * o)[seg]
    ds = torch.zeros_like(g)
    if mode == "softmax":
        ds[idx] = o * (gg - dot)
    else:
        ds[idx] = (gg - dot) / (den[seg] + EPS)
    return ds


def _check(name, segptr, seg, perm, vals, mode, den=None):
    dev = vals.device
    if mode not in MODES:
        raise ValueError(f"{name}: mode {mode!r} not in {sorted(MODES)}")
    if vals.dim() != 2:
        raise ValueError(f"{name}: values must be [E, H]")
    idx = {"segptr": segptr, "seg": seg}
    if perm is not None:
        idx["perm"] = perm
    for t_name, t in idx.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {t_name} must be int32")
    tensors = dict(idx, values=vals)
    if den is not None:
        tensors["den"] = den
    for t_name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {t_name} on {t.device}, values on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
    if vals.dtype != torch.float32:
        raise TypeError(f"{name}: values must be float32")
    if seg.shape != (vals.shape[0],) or (perm is not None
                                         and perm.shape != seg.shape):
        raise ValueError(f"{name}: seg/perm must be [E] for values "
                         f"{tuple(vals.shape)}")
    if den is not None and den.shape != (segptr.shape[0] - 1,
                                         vals.shape[1]):
        raise ValueError(f"{name}: den {tuple(den.shape)} is not [N, H]")


_ptr = build.ptr


def _launch_args(name, segptr, pieces, n_heads, tables):
    """The pieces' arguments of a launch (after checking that they cut
    ``segptr``'s segments as the kernel was built to walk them) and
    ``segment_design``'s (G, V) for the float32 ``tables``."""
    n = segptr.shape[0] - 1
    if pieces is None:
        raise ValueError(f"{name}: a launch needs the segments' pieces "
                         "(ops.scatter.segment_pieces)")
    if pieces.piece not in SEGMENT_PIECES or pieces.ptr.shape[0] != \
            pieces.n_pieces + 1 or pieces.ptr.device != segptr.device:
        raise ValueError(f"{name}: pieces of {pieces.piece} members on "
                         f"{pieces.ptr.device}; the kernel walks pieces of "
                         f"{SEGMENT_PIECES} on {segptr.device}")
    group, vec = segment_design(n_heads, pieces.n_edges / max(n, 1),
                                *(t for t in tables if t is not None),
                                piece=pieces.piece)
    return (pieces.ptr.data_ptr(), pieces.col.data_ptr(),
            pieces.slot.data_ptr(), pieces.multi_piece.data_ptr()), \
        (pieces.n_pieces, pieces.n_slots, pieces.piece), (group, vec)


def segment_norm(segptr: torch.Tensor, seg: torch.Tensor,
                 perm: Optional[torch.Tensor], s: torch.Tensor,
                 mode: str, pieces=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment softmax or normalisation of ``s`` [E, H]; returns
    ``(out, den)``. ``seg`` is only read by the plain version, ``pieces``
    (``ColPieces`` of ``segptr``) only by the kernel. Not differentiable by
    itself (see ``ops.scatter``)."""
    _check("segment_norm", segptr, seg, perm, s, mode)
    if s.device.type == "cpu":
        return segment_norm_plain(segptr, seg, perm, s, mode)
    if s.device.type != "cuda":
        raise NotImplementedError(f"segment_norm: no kernel for {s.device}")
    n, h = segptr.shape[0] - 1, s.shape[1]
    out = torch.empty_like(s)
    den = torch.empty((n, h), dtype=torch.float32, device=s.device)
    part = (torch.empty((pieces.n_slots, 2 * h), dtype=torch.float32,
                        device=s.device) if pieces is not None and pieces.n_slots
            else None)
    pc, counts, design = _launch_args("segment_norm", segptr, pieces, h,
                                      (s, out, den, part))
    build.launch("segment_norm", s.device, *pc, segptr.data_ptr(),
                 _ptr(perm), s.data_ptr(), out.data_ptr(), den.data_ptr(),
                 _ptr(part), n, *counts, s.shape[0], h, MODES[mode], *design)
    segment_norm.launches += 1
    return out, den


def segment_norm_bwd(segptr: torch.Tensor, seg: torch.Tensor,
                     perm: Optional[torch.Tensor], out: torch.Tensor,
                     g: torch.Tensor, den: torch.Tensor,
                     mode: str, pieces=None) -> torch.Tensor:
    """Gradient of :func:`segment_norm` with respect to ``s``, given its
    ``out`` and ``den`` and the cotangent ``g`` of ``out``."""
    _check("segment_norm_bwd", segptr, seg, perm, g, mode, den)
    if out.shape != g.shape or out.device != g.device \
            or not out.is_contiguous():
        raise ValueError("segment_norm_bwd: out must be a contiguous tensor "
                         "like g")
    if g.device.type == "cpu":
        return segment_norm_bwd_plain(segptr, seg, perm, out, g, den, mode)
    if g.device.type != "cuda":
        raise NotImplementedError(
            f"segment_norm_bwd: no kernel for {g.device}")
    n, h = segptr.shape[0] - 1, g.shape[1]
    ds = torch.empty_like(g)
    part = (torch.empty((pieces.n_slots, h), dtype=torch.float32,
                        device=g.device) if pieces is not None and pieces.n_slots
            else None)
    pc, counts, design = _launch_args("segment_norm_bwd", segptr, pieces, h,
                                      (out, g, den, ds, part))
    build.launch("segment_norm_bwd", g.device, *pc, segptr.data_ptr(),
                 _ptr(perm), out.data_ptr(), g.data_ptr(), den.data_ptr(),
                 ds.data_ptr(), _ptr(part), n, *counts, g.shape[0], h,
                 MODES[mode], *design)
    segment_norm_bwd.launches += 1
    return ds


segment_norm.launches = 0
segment_norm_bwd.launches = 0
