"""K3 ``segment_norm`` and K4 ``segment_norm_bwd``: per-segment softmax or
normalisation of per-edge, per-head values, and its gradient.

``s`` is [E, H] float32 over a row-sorted edge list whose valid edges are
the prefix ``[0, rowptr[-1])``. A segment is a row's edge range; with a
``perm`` (the reverse-edge bijection ``Graph.rev`` of a symmetric edge
multiset) it is the matching column segment, whose members are the slots
``perm[e]`` for ``e`` in the row's range.

* ``mode="softmax"``:   ``out = exp(s - max_seg s) / (den + 1e-16)`` with
  ``den = sum_seg exp(s - max_seg s)``;
* ``mode="normalise"``: ``out = s / (den + 1e-16)`` with ``den = sum_seg s``.

Both return ``(out [E, H], den [N, H])``; slots outside the segments are 0.
K4 takes ``out``, the cotangent ``g`` and ``den`` and returns ``ds``.

Replaces the TPU kernel ``graph_neural_pde_tpu/ops/pallas/stripe.py``
``_scatter_kernel`` / ``_stripe_scatter_call`` (P3) where it forms, with
P2's row gather, ``stripe_segment_softmax`` / ``_squareplus`` and the
norm_idx=0 frozen attention (see the source note in
``csrc/segment_norm.cu``). On a CUDA tensor a wrapper launches its kernel
or raises; on a CPU tensor it runs the plain PyTorch version, which defines
the semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from graph_neural_pde_tpu_torch.kernels import build

MODES = {"softmax": 0, "normalise": 1}
EPS = 1e-16


def _members(rowptr, row, perm):
    """(slot of each segment member, its segment), in row-sorted order."""
    n_valid = int(rowptr[-1])
    seg = row[:n_valid].long()
    if perm is None:
        return torch.arange(n_valid, device=row.device), seg
    return perm[:n_valid].long(), seg


def segment_norm_plain(rowptr: torch.Tensor, row: torch.Tensor,
                       perm: Optional[torch.Tensor], s: torch.Tensor,
                       mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: gather the members, a scatter max (softmax), exp,
    ``index_add`` sums, divide, and scatter back to their slots."""
    idx, seg = _members(rowptr, row, perm)
    n, h = rowptr.shape[0] - 1, s.shape[1]
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


def segment_norm_bwd_plain(rowptr: torch.Tensor, row: torch.Tensor,
                           perm: Optional[torch.Tensor], out: torch.Tensor,
                           g: torch.Tensor, den: torch.Tensor,
                           mode: str) -> torch.Tensor:
    """Plain version of the gradient: ``index_add`` of g·out per segment,
    then the per-member formula."""
    idx, seg = _members(rowptr, row, perm)
    o, gg = out[idx], g[idx]
    dot = torch.zeros(den.shape, dtype=g.dtype, device=g.device).index_add(
        0, seg, gg * o)[seg]
    ds = torch.zeros_like(g)
    if mode == "softmax":
        ds[idx] = o * (gg - dot)
    else:
        ds[idx] = (gg - dot) / (den[seg] + EPS)
    return ds


def _check(name, rowptr, row, perm, vals, mode, den=None):
    dev = vals.device
    if mode not in MODES:
        raise ValueError(f"{name}: mode {mode!r} not in {sorted(MODES)}")
    if vals.dim() != 2:
        raise ValueError(f"{name}: values must be [E, H]")
    idx = {"rowptr": rowptr, "row": row}
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
    if row.shape != (vals.shape[0],) or (perm is not None
                                          and perm.shape != row.shape):
        raise ValueError(f"{name}: row/perm must be [E] for values "
                         f"{tuple(vals.shape)}")
    if den is not None and den.shape != (rowptr.shape[0] - 1,
                                         vals.shape[1]):
        raise ValueError(f"{name}: den {tuple(den.shape)} is not [N, H]")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def segment_norm(rowptr: torch.Tensor, row: torch.Tensor,
                 perm: Optional[torch.Tensor], s: torch.Tensor,
                 mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment softmax or normalisation of ``s`` [E, H]; returns
    ``(out, den)``. ``row`` is only read by the plain version. Not
    differentiable by itself (see ``ops.scatter``)."""
    _check("segment_norm", rowptr, row, perm, s, mode)
    if s.device.type == "cpu":
        return segment_norm_plain(rowptr, row, perm, s, mode)
    if s.device.type != "cuda":
        raise NotImplementedError(f"segment_norm: no kernel for {s.device}")
    n, h = rowptr.shape[0] - 1, s.shape[1]
    out = torch.zeros_like(s)
    den = torch.empty((n, h), dtype=torch.float32, device=s.device)
    build.launch("segment_norm", s.device, rowptr.data_ptr(), _ptr(perm),
                 s.data_ptr(), out.data_ptr(), den.data_ptr(), n, h,
                 MODES[mode])
    segment_norm.launches += 1
    return out, den


def segment_norm_bwd(rowptr: torch.Tensor, row: torch.Tensor,
                     perm: Optional[torch.Tensor], out: torch.Tensor,
                     g: torch.Tensor, den: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Gradient of :func:`segment_norm` with respect to ``s``, given its
    ``out`` and ``den`` and the cotangent ``g`` of ``out``."""
    _check("segment_norm_bwd", rowptr, row, perm, g, mode, den)
    if out.shape != g.shape or out.device != g.device \
            or not out.is_contiguous():
        raise ValueError("segment_norm_bwd: out must be a contiguous tensor "
                         "like g")
    if g.device.type == "cpu":
        return segment_norm_bwd_plain(rowptr, row, perm, out, g, den, mode)
    if g.device.type != "cuda":
        raise NotImplementedError(
            f"segment_norm_bwd: no kernel for {g.device}")
    ds = torch.zeros_like(g)
    build.launch("segment_norm_bwd", g.device, rowptr.data_ptr(), _ptr(perm),
                 out.data_ptr(), g.data_ptr(), den.data_ptr(), ds.data_ptr(),
                 rowptr.shape[0] - 1, g.shape[1], MODES[mode])
    segment_norm_bwd.launches += 1
    return ds


segment_norm.launches = 0
segment_norm_bwd.launches = 0
