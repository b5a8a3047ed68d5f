"""The dense products of the fused attention kernels: the node projections
that fill the q and k tables, and the first pass of the dKw / dKb
reduction ``[x | 1]^T dk`` (``csrc/dense.cuh``, entry points in
``csrc/dense.cu``).

Every fused kernel (K6-K9, K12-K14, K17 and K8's per-head mode) runs them
inside its own C entry point: the projections first, into the scratch
tables its walk gathers from (unless an earlier launch on the same
operands filled them: ``NodeTables``), and the reduction after the
backward walks, over the dk they leave per node, slot or edge. The TPU
kernels compute both inside their Pallas bodies (``q_blk``, ``k_e`` and
``dkw_ref[:] +=`` in ``graph_neural_pde_tpu/ops/pallas/fused_rhs.py``).
The wrappers here call the same device code alone, for the checks and the
probes:

* ``node_project(x, qw, qb, kw, kb, xcol=None)`` -> (q [N, ATT] float32,
  k [N, ATT]): ``q = x Qw + qb``, ``k = x Kw + kb`` in float32, one launch
  for both tables when they project the same x (float32, or the bf16 ODE
  state's bfloat16 x); beside a bfloat16 column table ``xcol`` k is the
  bfloat16 table :func:`bf16_k_table` rounds, from ``xcol`` (two launches
  with a float32 x).
* ``outer_reduce(x, idx, dk, blocks=None)`` -> (dkw [D, ATT], dkb [ATT]):
  ``sum_r [x[idx[r]] | 1]^T dk[r]`` over the rows of dk (``idx`` None:
  x's rows), x float32 or bfloat16, in two passes: ``blocks`` contiguous
  row ranges (:func:`reduce_blocks`: about two blocks an SM), each
  writing its whole [D + 1, ATT] partial tile, then their sum in a fixed
  order. Two calls agree bit for bit.

Launch counts: ``node_project.launches`` and ``outer_reduce.launches``
count every launch of the two kernels, alone or inside a fused entry
point (:func:`count_fused`, which the fused wrappers call where they
launch); on the CPU the wrappers run the plain versions and count none.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_neural_pde_tpu_torch.kernels import build

PROJ_DEPTH = 32          # columns of x a stage of node_project_kernel holds
PROJ_STAGES = 3          # its stages (GNPDE_PROJ_STAGES)
MMA_COLS, MMA_ROWS = 64, 128     # a float32 x on the tensor cores
SMALL_LC, SMALL_DEPTH = 16, 128  # a float32 x of few nodes (SIMT)
PROJ_TM_BF16 = 4         # nodes a lane over a bfloat16 x (kBf16TM)
DENSE_THREADS = 256      # threads of a block of either kernel
REDUCE_ROWS = 32         # rows a stage of outer_reduce_kernel holds
REDUCE_D = 128           # output rows a tile of outer_reduce_kernel
REDUCE_WAVES = 2         # outer_reduce blocks an SM


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even), back in its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_k_table(xcol: torch.Tensor, kw: torch.Tensor,
                 kb: torch.Tensor) -> torch.Tensor:
    """k [N, ATT] of a bfloat16 column table, rounded as the JAX package's
    bf16 payload rounds ``x[col] @ Kw.astype(bf16) + kb.astype(bf16)``:
    the product of the bf16 rows with the bf16-rounded Kw, rounded to
    bfloat16, then its sum with the bf16-rounded kb rounded again. The
    product is summed in float64 (exact for products of bfloat16 values at
    these widths, as the kernels sum it), so its rounding does not hang on
    the order of a float32 sum. The values in Kw's dtype (float64 for a
    float64 reference: the same values)."""
    prod = (xcol.double() @ bf16_round(kw).double()).float()
    k = bf16_round(bf16_round(prod) + bf16_round(kb).float())
    return k.to(kw.dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def node_tables_plain(x, xcol, qw, qb, kw, kb):
    """Plain version of the node projections: (q, k) with ``q = x Qw + qb``
    in the weights' float type and ``k = x Kw + kb`` likewise, or, beside
    a bfloat16 column table ``xcol``, the bfloat16 k table of
    :func:`bf16_k_table` (as bfloat16: its values are bfloat16's)."""
    q = x.to(qw.dtype) @ qw + qb
    if xcol is None:
        return q, x.to(kw.dtype) @ kw + kb
    return q, bf16_k_table(xcol, kw, kb).to(torch.bfloat16)


def outer_reduce_plain(x, idx, dk):
    """Plain version of the reduction: ``(dkw, dkb) = ([x_r]^T dk,
    sum_r dk)`` over the rows r of dk, x_r = x[idx[r]] (``idx`` None:
    x[r]), in dk's float type."""
    xe = x[:dk.shape[0]] if idx is None else x[idx.long()]
    return xe.to(dk.dtype).T @ dk, torch.sum(dk, dim=0)


# ---------------------------------------------------------------------------
# the designs (csrc/dense.cuh: launch_project, launch_outer_reduce)
# ---------------------------------------------------------------------------

_SMS = {}


def sm_count(dev) -> int:
    """The streaming multiprocessors of a CUDA device (cached)."""
    dev = torch.device(dev)
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


def tables_design(n: int, d: int, att: int, tables: int, sms: int) -> list:
    """What ``launch_tables`` launches for the TABLES code ``tables`` (0
    float32; 1 a float32 x beside a bfloat16 column table; 2 both
    bfloat16) at N = n, D = d, ATT = att on a card of ``sms`` SMs: one
    launch (both tables from x) or, with code 1, two (q from x, k from
    xcol). A float32 x goes to the tensor cores (``route`` "mma"): its
    tables side by side (``cols``), cut into ``tasks`` groups of MMA_COLS
    columns, node tiles of MMA_ROWS; each block keeps its group's
    weights for all of D and walks ``n_tiles`` / ``step`` node tiles,
    ``step`` blocks a group (two blocks an SM in all, one where two do not
    fit). Where those tiles would leave fewer than two blocks an SM, and
    over a bfloat16 x (whose k table sums in float64), the SIMT tile
    (``route`` "simt"): ``lc`` lanes over a column group of 4 lc columns
    (up to SMALL_LC over a float32 x, 32 over a bfloat16 x, as ATT asks),
    its column ``groups`` a table, ``tasks`` (tables x groups), ``tm``
    nodes a lane and stages of ``depth`` columns (a float32 x: TM = 8, or
    4 where its tiles end sooner, the blocks of the busiest SM times the
    nodes a block; SMALL_DEPTH; a bfloat16 x PROJ_TM_BF16 and
    PROJ_DEPTH). Each also
    gives the nodes a block, the blocks (node tiles x tasks; the tasks of
    a tile are neighbours) and the dynamic shared memory of its stages."""
    launches = ([("x", ("q", "k"), 4 if tables == 0 else 2)] if tables != 1
                else [("x", ("q",), 4), ("xcol", ("k",), 2)])
    out = []
    for src, tabs, esz in launches:
        cols = len(tabs) * att
        tasks = -(-cols // MMA_COLS)
        if esz == 4 and -(-n // MMA_ROWS) * tasks >= 2 * sms:
            n_tiles = -(-n // MMA_ROWS)
            shared = 4 * (-(-d // PROJ_DEPTH) * PROJ_DEPTH * (MMA_COLS + 8)
                          + PROJ_STAGES * MMA_ROWS * (PROJ_DEPTH + 4))
            per_sm = 2 if 2 * (shared + 1024) <= 228 * 1024 else 1
            step = min(n_tiles, -(-per_sm * sms // tasks))
            out.append(dict(route="mma", cols=cols, x=src, tables=tabs,
                            tasks=tasks, nodes_per_block=MMA_ROWS,
                            n_tiles=n_tiles, step=step, blocks=step * tasks,
                            shared_bytes=shared))
            continue
        lc = 8
        while lc < (SMALL_LC if esz == 4 else 32) and 4 * lc < att:
            lc *= 2
        groups = -(-att // (4 * lc))
        tasks = len(tabs) * groups

        def nodes(tm_):
            return (DENSE_THREADS // 32) * (32 // lc) * tm_

        def cost(tm_):
            return -(-(-(-n // nodes(tm_)) * tasks) // sms) * nodes(tm_)
        if esz == 4:
            tm, depth = (4 if cost(4) < cost(8) else 8), SMALL_DEPTH
        else:
            tm, depth = PROJ_TM_BF16, PROJ_DEPTH
        bm = nodes(tm)
        shared = min(PROJ_STAGES, -(-d // depth)) * (
            esz * bm * (depth + 16 // esz) + 4 * depth * 4 * lc)
        out.append(dict(route="simt", lc=lc, groups=groups, tm=tm,
                        depth=depth, x=src, tables=tabs, tasks=tasks,
                        nodes_per_block=bm, blocks=-(-n // bm) * tasks,
                        shared_bytes=shared))
    return out


def reduce_tiles(d: int, att: int) -> int:
    """Output tiles of ``outer_reduce_kernel``: 128 rows of [D, ATT] by 32
    columns (ATT <= 32) or 64."""
    cols = 32 if att <= 32 else 64
    return -(-d // REDUCE_D) * -(-att // cols)


def reduce_blocks(rows: int, d: int, att: int, sms: int) -> int:
    """The row ranges of the reduction's first pass: about REDUCE_WAVES
    blocks an SM over all output tiles, none of fewer than a stage of
    rows, at least one."""
    waves = -(-REDUCE_WAVES * sms // reduce_tiles(d, att))
    return max(1, min(-(-rows // REDUCE_ROWS), waves))


def block_rows(rows: int, blocks: int) -> list:
    """Each block's contiguous row range [r0, r1) (empty past the rows):
    ``ceil(rows / blocks)`` rows a block, as the kernel splits them."""
    per = -(-rows // blocks)
    return [(min(rows, p * per), min(rows, (p + 1) * per))
            for p in range(blocks)]


def dk_sums(partials: torch.Tensor, d: int):
    """Second pass of the reduction: the blocks' partial tiles [blocks,
    D + 1, ATT] added up in a fixed order; (dkw [D, ATT], dkb [ATT])."""
    dk_sum = torch.sum(partials, dim=0)                   # [D + 1, ATT]
    return dk_sum[:d].contiguous(), dk_sum[d]


def table_launches(tables: int) -> int:
    """Launches of node_project_kernel that one projection of both tables
    takes: two for a float32 x beside a bfloat16 column table, else one."""
    return 2 if tables == 1 else 1


def count_fused(tables: int, project: int, reduce: bool = False) -> None:
    """Count the launches a fused entry point made of the two kernels: the
    projections when it ``project``-ed, the reduction's first pass when
    it formed dKw."""
    node_project.launches += table_launches(tables) if project else 0
    outer_reduce.launches += int(reduce)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, x, floats, xcol=None):
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name}: no kernel for {dev}")
    wide = dev.type == "cpu" and floats[0][1].dtype == torch.float64
    for t_name, t in floats:
        if t.device != dev:
            raise ValueError(f"{name}: {t_name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.dtype != (torch.float64 if wide else torch.float32):
            raise TypeError(f"{name}: {t_name} must be float32")
    allowed = (torch.float32, torch.bfloat16) + ((torch.float64,)
                                                 if wide else ())
    if x.dim() != 2 or x.dtype not in allowed or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [N, D] float32 "
                         "or bfloat16 table")
    if xcol is not None and (xcol.dtype != torch.bfloat16
                             or xcol.shape != x.shape
                             or xcol.device != dev
                             or not xcol.is_contiguous()):
        raise ValueError(f"{name}: the column table must be a contiguous "
                         f"bfloat16 table of x's shape {tuple(x.shape)}")


def node_project(x, qw, qb, kw, kb, xcol=None):
    """The node projections (see the module docstring); on a CPU tensor
    :func:`node_tables_plain`. With ``xcol`` the k table is projected from
    it with Kw and kb rounded to bfloat16, and is bfloat16."""
    n, d = x.shape
    att = qw.shape[-1]
    _check("node_project", x, [("qw", qw), ("qb", qb), ("kw", kw),
                               ("kb", kb)], xcol)
    for t_name, t, shape in (("qw", qw, (d, att)), ("qb", qb, (att,)),
                             ("kw", kw, (d, att)), ("kb", kb, (att,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"node_project: {t_name} is {tuple(t.shape)}, "
                             f"expected {shape}")
    if x.device.type == "cpu":
        return node_tables_plain(x, xcol, qw, qb, kw, kb)
    tables = 0 if xcol is None else (1 if x.dtype == torch.float32 else 2)
    if xcol is None and x.dtype != torch.float32:
        raise TypeError("node_project: a bfloat16 x needs its column table "
                        "(x itself)")
    dev = x.device
    q = torch.empty((n, att), dtype=torch.float32, device=dev)
    k = torch.empty((n, att), dtype=torch.float32 if xcol is None
                    else torch.bfloat16, device=dev)
    if xcol is not None:
        kw, kb = bf16_round(kw).contiguous(), bf16_round(kb).contiguous()
    build.launch("node_tables", dev, x.data_ptr(), build.ptr(xcol),
                 qw.data_ptr(), qb.data_ptr(), kw.data_ptr(), kb.data_ptr(),
                 q.data_ptr(), k.data_ptr(), n, d, att, tables)
    node_project.launches += table_launches(tables)
    return q, k


def outer_reduce(x, idx, dk, blocks: Optional[int] = None):
    """The reduction (see the module docstring) over the rows of ``dk``
    [R, ATT] float32: x [*, D] float32 or bfloat16, ``idx`` [R] int32 rows
    of x or None (x's first R rows). ``blocks``: the first pass's row
    ranges, :func:`reduce_blocks` by default. On a CPU tensor
    :func:`outer_reduce_plain`."""
    _check("outer_reduce", x, [("dk", dk)])
    rows, att = dk.shape
    d = x.shape[1]
    if idx is not None and (idx.dtype != torch.int32 or idx.shape != (rows,)
                            or idx.device != x.device):
        raise ValueError("outer_reduce: idx must be [R] int32 on x's device")
    if idx is None and x.shape[0] < rows:
        raise ValueError("outer_reduce: x has fewer rows than dk")
    if x.device.type == "cpu":
        return outer_reduce_plain(x, idx, dk)
    dev = x.device
    blocks = blocks or reduce_blocks(rows, d, att, sm_count(dev))
    partials = torch.empty((blocks, d + 1, att), dtype=torch.float32,
                           device=dev)
    build.launch("outer_reduce", dev, x.data_ptr(), build.ptr(idx),
                 dk.data_ptr(), partials.data_ptr(), rows, d, att, blocks,
                 int(x.dtype == torch.bfloat16))
    outer_reduce.launches += 1
    return dk_sums(partials, d)


def project(x, w, b):
    """One table on the node projections' tile: ``out = x W + b`` [N, C]
    float32 for x [N, K] float32 or bfloat16, W [K, C] and b [C] float32
    (the q of the per-edge payload kernels' scaled-dot walks). On a CPU
    tensor the plain product. Counted in ``node_project.launches``."""
    n, k = x.shape
    c = w.shape[1]
    _check("project", x, [("w", w), ("b", b)])
    if tuple(w.shape) != (k, c) or tuple(b.shape) != (c,):
        raise ValueError(f"project: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} for x of {k} columns")
    if x.device.type == "cpu":
        return x.to(w.dtype) @ w + b
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    build.launch("dense_project", x.device, x.data_ptr(), w.data_ptr(),
                 b.data_ptr(), out.data_ptr(), n, k, c,
                 int(x.dtype == torch.bfloat16))
    node_project.launches += 1
    return out


node_project.launches = 0
outer_reduce.launches = 0
