"""Edge-sharded aggregation with explicit collectives (PyTorch port of
``parallel/shard_spmm.py``).

Each rank owns a shard of the edge list, computes per-node partial sums
from its edges, and the partials meet in one all-reduce
(``collectives.psum_replicated``); or, in the streaming schedules, rows are
block-sharded and the feature blocks travel a ring. Every factory takes a
:class:`~.mesh.Mesh` and the whole graph, as every rank holds it, and
returns a function of replicated inputs; each rank's work is a plain
function of its shard and those inputs (``*_body``, ``*_bucket``), kept
apart from the collectives, so that a split mesh runs the same bodies rank
by rank in one process.

* :func:`make_sharded_spmm` — the rank's slice of the padded edge arrays,
  row-sorted into a sub-graph with its own ``rowptr`` and CSC view, runs
  the port's engine (``ops.spmm.make_spmm``: K1 forward and dx over the CSC
  view, never the reverse-edge map, K2 for dw).
* :func:`make_sharded_stripe_spmm` — the rank's contiguous slice of the
  row-sorted valid edges (``np.linspace`` bounds), its payload
  ``x[col] * w`` summed per row by the P6 pair
  (``kernels.shard_scatter``: K1 in table mode, K20 as its VJP).
* :func:`make_sharded_fused_rhs` — GRAND-nl's attention RHS: per rank the
  (num, den) of the rank's edges by K18 ``fused_aggregate`` with gmax = 0
  (K8's per-head mode in the backward), psum'd, then divided.
* :func:`make_sharded_spmm_stream`, :func:`make_sharded_fused_rhs_stream` —
  the ring schedules over column-block buckets, in torch ops as the JAX
  package has them in XLA ops; x and the output are row-sharded (each
  rank returns its own rows), so on more than one rank they are not an
  ``spmm_fn`` by themselves.
* :func:`make_sharded_spmm_for`, :func:`make_sharded_fused_rhs_for` — the
  ``Config.shard_spmm_mode`` dispatchers. Both modes take the whole inputs
  and return the whole result, replicated (the stream mode all-gathers
  its rows, ``collectives.gather_rows``), as the JAX dispatchers return
  one global array in both modes.

Slot order: a per-edge ``w`` is in the slot order of the graph handed to
the factory (the port's row-sorted order for a prepared graph). The JAX
package's ``block_n``, ``chunk``, the last-chunk padding and the ``axis_name``
arguments are TPU or ``shard_map`` artifacts and have no counterpart.

Precision. The JAX functions read no payload dtype but the stripe spmm's:
the dispatchers ignore ``rhs_payload_dtype`` (the bfloat16 payload beside
a float32 state runs float32 here too), and a bfloat16 x (the bf16 ODE
state) meets float32 weights, which JAX's type promotion widens at each
use. So here: K1 reads the bfloat16 x as its table, K18 and K8's per-head
mode read the bfloat16 x and its gathered payload x[col], and the ring
buckets widen x where JAX widens it (its projections; the products with w
and u promote by themselves); every sum, partial and output is float32.
The gradient of a bfloat16 x comes back in bfloat16. The JAX package's
autodiff rounds each edge's cotangent of x[col] to bfloat16 and sums it
there (ROADMAP R10); K1 and K8's per-head mode sum it in float32 and
round once, the ring buckets' autograd as JAX does.
:func:`make_sharded_stripe_spmm` takes the JAX function's
``payload_dtype``: with bfloat16 each rank's payload is the bf16 product
``x_b[col] * w_b`` (the JAX ``_shard_body``'s casts), K1 sums it in table
mode in float32, and K20 hands back its gradient as the float32
cotangent's rows rounded to bfloat16 once (what P6's gather returns).
From there every cast is the identity and every product and sum of the
gradient float32, as the bf16 payload's kernels take it elsewhere; the
JAX package's autodiff forms the products of x's and w's gradients in
bfloat16 and sums them there (ROADMAP, "Deliberate differences").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from graph_neural_pde_tpu_torch.kernels.fused_rhs import (bf16_round_st,
                                                          fused_rhs_aggregate)
from graph_neural_pde_tpu_torch.kernels.shard_scatter import (ScatterPlan,
                                                              shard_scatter)
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
from graph_neural_pde_tpu_torch.parallel.collectives import (enter_replicated,
                                                             gather_rows,
                                                             psum_replicated,
                                                             ring_shift)
from graph_neural_pde_tpu_torch.parallel.mesh import Mesh, edge_ranges

MODES = ("allreduce", "stream")


# ---------------------------------------------------------------------------
# the edge-slice shards of the all-reduce schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeShard:
    """A rank's slice of the padded edge arrays as a row-sorted sub-graph
    over all N nodes (``graph``, without a reverse-edge map, so its dx
    walks its CSC view); ``order`` maps its slots to the slice's, ``col``
    is its column index as int64."""

    order: torch.Tensor
    graph: Graph
    col: torch.Tensor


def edge_shards(mesh: Mesh, g: Graph) -> List[EdgeShard]:
    """The :class:`EdgeShard` of each rank this process runs."""
    n = g.num_nodes
    shards = []
    for lo, hi in edge_ranges(mesh, g.capacity):
        row, col = g.row[lo:hi].cpu(), g.col[lo:hi].cpu()
        weight, mask = g.weight[lo:hi].cpu(), g.mask[lo:hi].cpu()
        key = torch.where(mask, row, torch.full_like(row, n))
        order = torch.argsort(key, stable=True)
        sub = Graph(row=row[order], col=col[order], weight=weight[order],
                    mask=mask[order], num_nodes=n).sort_by_row()
        sub = dataclasses.replace(sub, rev=None).to(mesh.device)
        shards.append(EdgeShard(order=order.to(mesh.device), graph=sub,
                                col=sub.col.long()))
    return shards


def _edge_parts(mesh: Mesh, w: torch.Tensor, capacity: int
                ) -> List[torch.Tensor]:
    """Per-rank slices of a per-edge array: ``w`` is either the whole
    [capacity] array, replicated (its gradient is summed over the ranks),
    or the slices of the ranks this process runs, concatenated (spec
    ``P(axis)``: each rank's gradient stays with it)."""
    s = capacity // mesh.size
    if w.shape[0] == s * len(mesh.ranks):
        return list(torch.split(w, s))
    if w.shape[0] == capacity:
        w = enter_replicated(mesh, w)
        return [w[lo:hi] for lo, hi in edge_ranges(mesh, capacity)]
    raise ValueError(f"per-edge array of {w.shape[0]} slots: expected the "
                     f"whole {capacity} or {s * len(mesh.ranks)} sharded")


def spmm_body(shard: EdgeShard, x: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """A rank's partial ``A_w x`` [N, D] over its edges; ``w`` is its slice
    in the slice's slot order."""
    return make_spmm(shard.graph)(x, w[shard.order])


def make_sharded_spmm(mesh: Mesh, g: Graph) -> Callable:
    """``spmm_fn(x, w) -> A_w x`` [N, D] with the edges sharded over the
    mesh: each rank's slice through the port's engine, one all-reduce. x is
    replicated; w is the whole array or the ranks' own slices (see
    ``_edge_parts``). Drop-in for ``models.blocks.block_forward``'s
    ``spmm_fn``."""
    shards = edge_shards(mesh, g)

    def spmm_fn(x, w):
        ws = _edge_parts(mesh, w, g.capacity)
        x = enter_replicated(mesh, x)
        return psum_replicated(mesh, [spmm_body(s, x, w_r)
                                      for s, w_r in zip(shards, ws)])

    return spmm_fn


# ---------------------------------------------------------------------------
# the stripe schedule: P6 per rank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StripeShard:
    """A rank's contiguous slice [lo, hi) of the row-sorted valid edges:
    the P6 pair's plan (whose ``rowptr`` is the graph's ``clamp(rowptr,
    lo, hi) - lo``) and the slice's column index as int64."""

    lo: int
    hi: int
    plan: ScatterPlan
    col: torch.Tensor


def stripe_shards(mesh: Mesh, g: Graph) -> List[StripeShard]:
    """The :class:`StripeShard` of each rank this process runs: the valid
    edges cut at ``np.linspace`` bounds, wherever they fall (a row may
    straddle two ranks)."""
    if not g.rows_sorted:
        raise ValueError("make_sharded_stripe_spmm needs a row-sorted graph "
                         "(prepare_graph or Graph.sort_by_row)")
    bounds = np.linspace(0, g.num_valid, mesh.size + 1).astype(int)
    row = g.row.cpu().numpy()
    col = g.col.cpu().numpy().astype(np.int64)
    return [StripeShard(lo=int(bounds[r]), hi=int(bounds[r + 1]),
                        plan=ScatterPlan.from_rows(
                            row[bounds[r]:bounds[r + 1]], g.num_nodes,
                            mesh.device),
                        col=torch.from_numpy(
                            col[bounds[r]:bounds[r + 1]]).to(mesh.device))
            for r in mesh.ranks]


def stripe_body(shard: StripeShard, x: torch.Tensor, w: torch.Tensor,
                payload_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A rank's partial ``A_w x`` [N, D]: the payload ``x[col] * w`` of its
    edges, summed per row by the P6 pair. ``w`` is the whole array. With
    ``payload_dtype`` (bfloat16, the one payload the JAX function takes
    beside float32) the payload is the product of x and w cast to it,
    rounded to it (the JAX ``_shard_body``'s bf16 product; a
    product of two bf16 values is exact in float32, so rounding it once
    gives that value), and the casts are the identity in the gradient;
    the partial is float32."""
    w = w[shard.lo:shard.hi, None]
    if payload_dtype is None:
        vals = torch.index_select(x, 0, shard.col) * w
    else:
        vals = (torch.index_select(bf16_round_st(x.float()), 0, shard.col)
                * bf16_round_st(w.float())).to(payload_dtype)
    return shard_scatter(shard.plan, vals)


_PAYLOADS = {None: None, "float32": None, torch.float32: None,
             "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def make_sharded_stripe_spmm(mesh: Mesh, g: Graph, *, payload_dtype=None
                             ) -> Callable:
    """``spmm_fn(x, w) -> A_w x`` [N, D] over a row-sorted graph, each rank
    summing its slice of the valid edges with the P6 pair, one all-reduce.
    x and w (the whole [capacity] array in ``g``'s slot order) are
    replicated. ``payload_dtype`` None or float32, or bfloat16 (see
    :func:`stripe_body`). The shards are ``spmm_fn.shards``."""
    if payload_dtype not in _PAYLOADS:
        raise TypeError(f"payload_dtype {payload_dtype}: float32 or "
                        f"bfloat16")
    pay = _PAYLOADS[payload_dtype]
    shards = stripe_shards(mesh, g)

    def spmm_fn(x, w):
        if w.shape[0] != g.capacity:
            raise ValueError(f"w of {w.shape[0]} slots for a graph of "
                             f"{g.capacity}")
        x, w = enter_replicated(mesh, x), enter_replicated(mesh, w)
        return psum_replicated(mesh, [stripe_body(s, x, w, pay)
                                      for s in shards])

    spmm_fn.shards = shards
    return spmm_fn


# ---------------------------------------------------------------------------
# GRAND-nl's attention RHS, all-reduce schedule
# ---------------------------------------------------------------------------

def fused_rhs_body(shard: EdgeShard, x, qw, qb, kw, kb, *, heads: int,
                   square_plus: bool) -> torch.Tensor:
    """A rank's partial ``[num | den]`` [N, H·D + H] of the attention RHS
    over its edges: K18 with gmax = 0 over the payload ``x[col]`` (in x's
    dtype; the partial is float32)."""
    x_g = torch.index_select(x, 0, shard.col)
    gmax = torch.zeros(1, dtype=qw.dtype, device=x.device)
    num, den = fused_rhs_aggregate(shard.graph, heads, square_plus,
                                   "scaled_dot", qw, qb, kw, kb, x, x_g, gmax)
    return torch.cat([num, den], dim=1)


def _normalised_mean(num_den: torch.Tensor, heads: int, d: int
                     ) -> torch.Tensor:
    n = num_den.shape[0]
    num = num_den[:, :heads * d].reshape(n, heads, d)
    den = num_den[:, heads * d:]
    return torch.mean(num / (den[:, :, None] + 1e-16), dim=1)


def make_sharded_fused_rhs(mesh: Mesh, g: Graph, *, heads: int,
                           square_plus: bool = False) -> Callable:
    """``rhs_ax(qw, qb, kw, kb, x) -> [N, D]``: the head-averaged,
    normalised attention aggregate of GRAND-nl (scaled-dot scores, the
    softmax with one shift gmax = 0, or squareplus) with the edges sharded
    over the mesh. The per-node (num, den) partials are sum-decomposable:
    one all-reduce of [N, H·D + H], then the division. Every input is
    replicated."""
    shards = edge_shards(mesh, g)

    def rhs_ax(qw, qb, kw, kb, x):
        qw, qb, kw, kb, x = (enter_replicated(mesh, t)
                             for t in (qw, qb, kw, kb, x))
        parts = [fused_rhs_body(s, x, qw, qb, kw, kb, heads=heads,
                                square_plus=square_plus) for s in shards]
        return _normalised_mean(psum_replicated(mesh, parts), heads,
                                x.shape[1])

    return rhs_ax


# ---------------------------------------------------------------------------
# the ring schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Buckets:
    """The streaming schedules' edge buckets, [nd, nd, cap] each: bucket
    (d, k) holds the valid edges whose row lies in row block d and whose
    column lies in block (d + k) mod nd, in the graph's slot order:
    ``rowl`` the row within its block, ``coll`` the column within its
    block, ``slot`` the edge's slot (for w), ``mask`` the filled entries.
    ``blk`` is the block size ceil(N / nd)."""

    rowl: np.ndarray
    coll: np.ndarray
    slot: np.ndarray
    mask: np.ndarray
    blk: int


def stream_buckets(g: Graph, nd: int) -> Buckets:
    """Bucket the valid edges by (row block, ring offset of the column
    block), at the largest bucket's capacity: the JAX package's arrays,
    filled by a stable lexsort and per-bucket offsets from cumulative
    counts instead of its per-edge Python loop."""
    blk = -(-g.num_nodes // nd)
    m = g.mask.cpu().numpy()
    r = g.row.cpu().numpy()[m].astype(np.int64)
    c = g.col.cpu().numpy()[m].astype(np.int64)
    slot = np.where(m)[0].astype(np.int32)
    d_of = r // blk
    k_of = (c // blk - d_of) % nd
    counts = np.bincount(d_of * nd + k_of, minlength=nd * nd)
    cap = max(int(counts.max()), 1)
    order = np.lexsort((k_of, d_of))
    bucket = (d_of * nd + k_of)[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j = np.arange(order.shape[0]) - starts[bucket]
    d, k = d_of[order], k_of[order]
    rowl = np.zeros((nd, nd, cap), np.int32)
    coll = np.zeros((nd, nd, cap), np.int32)
    slots = np.zeros((nd, nd, cap), np.int32)
    mask = np.zeros((nd, nd, cap), bool)
    rowl[d, k, j] = r[order] - d * blk
    coll[d, k, j] = c[order] - (d + k) % nd * blk
    slots[d, k, j] = slot[order]
    mask[d, k, j] = True
    return Buckets(rowl=rowl, coll=coll, slot=slots, mask=mask, blk=blk)


@dataclasses.dataclass(frozen=True)
class StreamShard:
    """A rank's buckets on the device, [nd, cap] each (int64 indices)."""

    rank: int
    rowl: torch.Tensor
    coll: torch.Tensor
    slot: torch.Tensor
    mask: torch.Tensor


def _stream_shards(mesh: Mesh, b: Buckets) -> List[StreamShard]:
    def dev(a, r):
        a = torch.from_numpy(a[r])
        return (a if a.dtype == torch.bool else a.long()).to(mesh.device)
    return [StreamShard(rank=r, rowl=dev(b.rowl, r), coll=dev(b.coll, r),
                        slot=dev(b.slot, r), mask=dev(b.mask, r))
            for r in mesh.ranks]


def _block_rows(mesh: Mesh, n: int, blk: int) -> List[int]:
    return [max(0, min(blk, n - r * blk)) for r in mesh.ranks]


def _row_blocks(mesh: Mesh, x: torch.Tensor, n: int, blk: int
                ) -> List[torch.Tensor]:
    """Each rank's row block [blk, D], zero-padded: ``x`` is either the
    rows of the ranks this process runs (row-sharded; on a split mesh, all
    N) or the whole [N, D], replicated (its gradient summed over the
    ranks)."""
    rows = _block_rows(mesh, n, blk)
    if x.shape[0] == sum(rows):
        parts = list(torch.split(x, rows))
    elif x.shape[0] == n:
        x = enter_replicated(mesh, x)
        parts = [x[r * blk:r * blk + c] for r, c in zip(mesh.ranks, rows)]
    else:
        raise ValueError(f"x of {x.shape[0]} rows: expected the whole {n} "
                         f"or the ranks' {sum(rows)}")
    return [torch.nn.functional.pad(p, (0, 0, 0, blk - p.shape[0]))
            for p in parts]


def _local_rows(mesh: Mesh, outs: List[torch.Tensor], n: int, blk: int
                ) -> torch.Tensor:
    return torch.cat([o[:c] for o, c in zip(outs, _block_rows(mesh, n, blk))])


def _stream(mesh: Mesh, x: torch.Tensor, n: int, blk: int, shards,
            first: Callable, step: Callable) -> List[torch.Tensor]:
    """The ring: each rank takes its own block's bucket (``first(shard,
    x_blk)``), then nd - 1 times shifts the blocks one hop and adds the
    next bucket (``step(shard, k, x_blk, acc)``)."""
    xbs = _row_blocks(mesh, x, n, blk)
    accs = [first(s, xb) for s, xb in zip(shards, xbs)]
    for k in range(1, mesh.size):
        xbs = ring_shift(mesh, xbs)
        accs = [step(s, k, xb, acc) for s, xb, acc in zip(shards, xbs, accs)]
    return accs


def stream_bucket(shard: StreamShard, k: int, x_blk: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """A rank's bucket k: ``sum_e w[slot e] x_blk[coll e]`` into its local
    rows [blk, D], in the product's dtype (float32 for a bfloat16 block, as
    JAX promotes it)."""
    wk = w[shard.slot[k]]
    wv = torch.where(shard.mask[k], wk, torch.zeros_like(wk))
    vals = torch.index_select(x_blk, 0, shard.coll[k]) * wv[:, None]
    return vals.new_zeros(x_blk.shape).index_add(0, shard.rowl[k], vals)


def make_sharded_spmm_stream(mesh: Mesh, g: Graph) -> Callable:
    """``spmm_fn(x, w)``: the ring schedule of ``A_w x``. Rows are
    block-sharded (rank d owns rows [d·blk, (d+1)·blk)); a rank's edges are
    bucketed by column block; at ring step k rank d holds block (d + k) mod
    nd, adds its bucket, and passes the block one hop: nd - 1 shifts of
    [blk, D]. x is row-sharded (the ranks' rows) or the whole array
    (replicated); the result is row-sharded: the rows of the ranks this
    process runs. w is the whole [capacity] array. The buckets are
    ``spmm_fn.buckets``."""
    n = g.num_nodes
    b = stream_buckets(g, mesh.size)
    shards = _stream_shards(mesh, b)

    def spmm_fn(x, w):
        w = enter_replicated(mesh, w)
        outs = _stream(
            mesh, x, n, b.blk, shards,
            lambda s, xb: stream_bucket(s, 0, xb, w),
            lambda s, k, xb, acc: acc + stream_bucket(s, k, xb, w))
        return _local_rows(mesh, outs, n, b.blk)

    spmm_fn.buckets = b
    return spmm_fn


def _scores_u(q_rows, k_cols, square_plus: bool):
    d_k = q_rows.shape[-1]
    s = torch.sum(q_rows * k_cols, dim=-1) / math.sqrt(d_k)
    if square_plus:
        return (s + torch.sqrt(s * s + 4.0)) * 0.5
    return torch.exp(s)


def fused_rhs_bucket(shard: StreamShard, k: int, q: torch.Tensor,
                     x_blk: torch.Tensor, kw, kb, *, heads: int,
                     square_plus: bool) -> torch.Tensor:
    """A rank's bucket k of the attention RHS: ``[num | den]`` [blk, H·D +
    H] over its resident queries ``q`` [blk, H, d_k] and the keys of the
    block it holds, projected once for the block (a bfloat16 block widened
    to the weights' dtype there, as JAX promotes it)."""
    blk, d = x_blk.shape
    kproj = (x_blk.to(kw.dtype) @ kw + kb).reshape(blk, heads, -1)
    rl, cl = shard.rowl[k], shard.coll[k]
    u = _scores_u(q[rl], kproj[cl], square_plus)
    u = torch.where(shard.mask[k][:, None], u, torch.zeros_like(u))
    x_g = torch.index_select(x_blk, 0, cl)
    vals = torch.cat([(u[:, :, None] * x_g[:, None, :]).reshape(-1, heads * d),
                      u], dim=1)
    return vals.new_zeros((blk, heads * d + heads)).index_add(0, rl, vals)


def make_sharded_fused_rhs_stream(mesh: Mesh, g: Graph, *, heads: int,
                                  square_plus: bool = False) -> Callable:
    """``rhs_ax(qw, qb, kw, kb, x) -> [N, D]``: the ring schedule of the
    attention RHS. A row's edges all live with its owner, so the softmax
    segments are local: each rank projects its resident queries once, and
    at ring step k scores its bucket against the keys of the block it
    holds, projected once a block. The raw feature block is the only
    traffic. x and the result are row-sharded as in
    :func:`make_sharded_spmm_stream`; the parameters are replicated."""
    n = g.num_nodes
    b = stream_buckets(g, mesh.size)
    shards = _stream_shards(mesh, b)

    def rhs_ax(qw, qb, kw, kb, x):
        qw, qb, kw, kb = (enter_replicated(mesh, t) for t in (qw, qb, kw, kb))
        d = x.shape[1]
        qs = {}

        def first(s, xb):
            qs[s.rank] = (xb.to(qw.dtype) @ qw + qb).reshape(b.blk, heads,
                                                             -1)
            return fused_rhs_bucket(s, 0, qs[s.rank], xb, kw, kb,
                                    heads=heads, square_plus=square_plus)

        def step(s, k, xb, acc):
            return acc + fused_rhs_bucket(s, k, qs[s.rank], xb, kw, kb,
                                          heads=heads,
                                          square_plus=square_plus)

        outs = _stream(mesh, x, n, b.blk, shards, first, step)
        return _local_rows(mesh, [_normalised_mean(o, heads, d)
                                  for o in outs], n, b.blk)

    return rhs_ax


# ---------------------------------------------------------------------------
# Config.shard_spmm_mode dispatchers
# ---------------------------------------------------------------------------

def _mode(cfg) -> str:
    """``cfg.shard_spmm_mode``, the one field the dispatchers read (see
    the module docstring on precision)."""
    mode = getattr(cfg, "shard_spmm_mode", "allreduce")
    if mode not in MODES:
        raise ValueError(f"shard_spmm_mode={mode!r} not in {MODES}")
    return mode


def _replicated_out(mesh: Mesh, n: int, fn: Callable) -> Callable:
    """``fn`` of a ring schedule, its row-sharded result all-gathered:
    whole inputs in, the whole [N, D] out, replicated."""
    blk = -(-n // mesh.size)

    def whole(*args):
        return gather_rows(mesh, fn(*args), n, blk)

    return whole


def make_sharded_spmm_for(cfg, mesh: Mesh, g: Graph) -> Callable:
    """The laplacian aggregation for ``cfg.shard_spmm_mode``: 'allreduce'
    → :func:`make_sharded_spmm`, 'stream' →
    :func:`make_sharded_spmm_stream` with its rows all-gathered. Either
    way ``spmm_fn(x, w)`` takes the whole x and w and returns the whole
    ``A_w x`` [N, D], replicated (the JAX package's dispatchers return
    the same global array in both modes): a drop-in ``spmm_fn`` for
    ``models.blocks.block_forward``."""
    if _mode(cfg) == "stream":
        return _replicated_out(mesh, g.num_nodes,
                               make_sharded_spmm_stream(mesh, g))
    return make_sharded_spmm(mesh, g)


def make_sharded_fused_rhs_for(cfg, mesh: Mesh, g: Graph, *, heads: int,
                               square_plus: bool = False) -> Callable:
    """The attention RHS for ``cfg.shard_spmm_mode``: 'allreduce' →
    :func:`make_sharded_fused_rhs`, 'stream' →
    :func:`make_sharded_fused_rhs_stream` with its rows all-gathered; the
    whole [N, D], replicated, in both modes."""
    if _mode(cfg) == "stream":
        return _replicated_out(mesh, g.num_nodes,
                               make_sharded_fused_rhs_stream(
                                   mesh, g, heads=heads,
                                   square_plus=square_plus))
    return make_sharded_fused_rhs(mesh, g, heads=heads,
                                  square_plus=square_plus)
