"""The lane groups of K1 ``csr_spmm`` and K2 ``edge_dot`` on the CPU, where
the kernels cannot run: numpy mirrors of the order in which each kernel
visits and sums its operands, held against the plain versions that define
them, and the chooser (``kernels.lanes``) held to what the kernels were
built for.

* K1 gives an output row to a group of G lanes, reads x rows as vectors of
  V elements, stages the row's (col, w) pairs a round at a time, loads a
  batch of edges' rows before it adds them, and sums every feature of the
  row in one lane, in edge order (``csrc/csr_spmm.cu``): rounds and
  batches change when a row is loaded, not the order of its sums. The
  mirror does that at D = 1, 3, 10, 64, 80, 128 and 162, on float32 and
  bfloat16
  tables, in node mode and in table mode (a per-edge table summed over
  each row's reverse edges, and K11's dx over the CSC view), over a graph
  with a hub row and one with empty rows.
* K2 gives an edge to a group of L lanes; lane l sums the vectors l, l + L,
  ... in order and the group reduces by an xor butterfly of log2(L)
  levels; the padding slots get zeros (``csrc/edge_dot.cu``).
* One case each against the TPU kernels: P1 through ``make_stripe_spmm``
  in Pallas interpret mode (2e-2: it rounds to bf16), and P2's dw (its
  float32 gather in interpret mode, and ``jax.grad`` of the XLA spmm;
  1e-5).

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.models.blocks import (build_stripe_engine,
                                                prepare_graph as j_prepare)
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.pallas.stripe import _stripe_gather_call
from graph_neural_pde_tpu.ops.spmm import make_stripe_spmm, spmm as j_spmm
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.kernels import lanes as L
from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
from graph_neural_pde_tpu_torch.ops.graph import make_graph

BF16 = torch.bfloat16
F32 = torch.float32
# row widths the port hands K1 / K2: the image paths (1, 3), K11's dx on
# Cora (80 / 8 heads) and at arxiv (128 / 2), the Cora row (80), bench
# (128) and the arxiv stand-in (162)
DIMS = (1, 3, 10, 64, 80, 128, 162)


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    """Largest error relative to the reference array's largest entry."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.detach().numpy() if torch.is_tensor(want) else np.asarray(
        want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _fma(a, b, c):
    """float32 fused multiply-add: the product of two float32s is exact in
    float64, and the sum is rounded once to float32."""
    return (np.asarray(c, np.float64) + np.asarray(a, np.float64)
            * np.asarray(b, np.float64)).astype(np.float32)


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

def _hub_graph(seed, n=120, e=300, hub_degree=90):
    """A symmetric random graph whose node 0 is joined both ways to
    ``hub_degree`` others (a row of ~3 staging rounds of a warp), row
    sorted, padded."""
    rng = np.random.default_rng(seed)
    r = rng.integers(1, n, e)
    c = rng.integers(1, n, e)
    keep = r != c
    r, c = r[keep], c[keep]
    peers = rng.choice(np.arange(1, n), hub_degree, replace=False)
    hub = np.zeros(hub_degree, np.int64)
    row = np.concatenate([r, c, hub, peers])
    col = np.concatenate([c, r, peers, hub])
    return make_graph(row, col, num_nodes=n, pad_multiple=64).sort_by_row()


def _sparse_graph(seed, n=90, live=50, e=120):
    """A symmetric graph whose last ``n - live`` nodes have no edges: empty
    rows, which K1 writes as zeros."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, live, e)
    c = rng.integers(0, live, e)
    keep = r != c
    r, c = r[keep], c[keep]
    return make_graph(np.concatenate([r, c]), np.concatenate([c, r]),
                      num_nodes=n, pad_multiple=64).sort_by_row()


GRAPHS = {"hub": lambda: _hub_graph(3), "empty rows": lambda: _sparse_graph(4)}


def _weights(g, seed):
    """Positive weights on the valid slots, 0 on padding."""
    rng = np.random.default_rng(seed)
    w = rng.random(g.capacity).astype(np.float32)
    return torch.tensor(w) * g.mask


# ---------------------------------------------------------------------------
# K1: rows over lane groups
# ---------------------------------------------------------------------------

def _k1_lanes_of_features(dim, group, vec):
    """For each feature, the lane of the group that sums it and the pass in
    which it does (csrc/csr_spmm.cu): the lanes split each pass of G * V *
    VECS_PER_LANE features into vectors, lane l taking the vectors v0 + l
    + G k. Every feature belongs to exactly one lane."""
    vecs = dim // vec
    per_pass = group * L.VECS_PER_LANE
    lane = np.full(dim, -1)
    passes = np.full(dim, -1)
    for v0 in range(0, vecs, per_pass):
        for ln in range(group):
            for k in range(L.VECS_PER_LANE):
                v = v0 + ln + group * k
                if v < vecs:
                    f = slice(v * vec, (v + 1) * vec)
                    assert (lane[f] == -1).all()
                    lane[f], passes[f] = ln, v0 // per_pass
    assert (lane >= 0).all()
    return lane, passes


def k1_walk(rowptr, col, w, x, group, vec):
    """K1's loop in numpy: each group of G lanes walks its row's edges in
    order, in rounds of G staged (col, w) pairs, once per pass; every
    feature is summed by its one lane with a fused multiply-add an edge.
    Returns the output and the number of passes over each row's edges."""
    rowptr, col, w = (t.numpy() for t in (rowptr, col, w))
    xf = x.float().numpy()
    n, d = rowptr.shape[0] - 1, xf.shape[1]
    assert d % vec == 0 and group in (1, 2, 4, 8, 16, 32)
    _, passes = _k1_lanes_of_features(d, group, vec)
    out = np.full((n, d), np.nan, np.float32)
    for r in range(n):
        start, end = rowptr[r], rowptr[r + 1]
        for p in range(passes.max() + 1):
            feats = passes == p
            acc = np.zeros(int(feats.sum()), np.float32)
            for e0 in range(start, end, group):
                staged = [(col[e], w[e]) for e in
                          range(e0, min(e0 + group, end))]
                for c, wj in staged:
                    acc = _fma(wj, xf[c, feats], acc)
            out[r, feats] = acc
    return out, passes.max() + 1


def _node_inputs(g, dim, table, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(g.num_nodes, dim)).astype(np.float32))
    return g.rowptr, g.row, g.col, _weights(g, seed + 1), x.to(table)


def _table_inputs(g, dim, table, seed):
    """``column_sum``'s launch: a per-edge table [E_pad, D] summed over each
    row's reverse edges, weighted by the mask."""
    rng = np.random.default_rng(seed)
    t = torch.tensor(rng.normal(size=(g.capacity, dim)).astype(np.float32))
    w = g.mask.float()
    return g.rowptr, g.row, g.rev, w[g.rev.long()], t.to(table)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["node", "table"])
@pytest.mark.parametrize("table", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", DIMS)
def test_k1_walk_equals_plain(dim, table, mode, graph):
    """The mirror over the chooser's (G, V) against ``csr_spmm_plain``
    (1e-6 of scale), in one pass over each row's edges at every width the
    port runs; empty rows come out 0."""
    g = GRAPHS[graph]()
    make = _node_inputs if mode == "node" else _table_inputs
    args = make(g, dim, table, seed=dim)
    group, vec = L.lanes("csr_spmm", dim, (0, table))
    got, passes = k1_walk(args[0], args[2], args[3], args[4], group, vec)
    want = kernels.csr_spmm_plain(*args)
    assert passes == 1
    assert _rel(got, want) < 1e-6
    empty = (args[0][1:] == args[0][:-1]).numpy()
    assert (got[empty] == 0).all()
    if mode == "table" and table == F32:
        assert torch.equal(kernels.column_sum(g, args[4]), want)


@pytest.mark.parametrize("heads,dim", [(8, 80), (2, 128)])
def test_k1_walk_as_k11_dx(heads, dim):
    """K11's dx (``column_head_sum``: the [N*H, D/H] table over the CSC
    view, width 10 at Cora's H=8, 64 at arxiv's H=2) walked by the mirror
    against the plain launch (1e-6 of scale)."""
    g = _hub_graph(5)
    rng = np.random.default_rng(6)
    u = torch.tensor(rng.random((g.capacity, heads)).astype(np.float32)
                     + 0.05) * g.mask[:, None]
    ct_num = torch.tensor(rng.normal(size=(g.num_nodes, dim))
                          .astype(np.float32))
    want = kernels.column_head_sum(g, u, ct_num)
    hs = torch.arange(heads, dtype=torch.int32)
    idx = (g.row_by_col[:, None] * heads + hs).reshape(-1)
    w = u[g.col_perm.long()].reshape(-1)
    x = ct_num.view(g.num_nodes * heads, dim // heads)
    group, vec = L.lanes("csr_spmm", dim // heads, x)
    got, passes = k1_walk(g.colptr * heads, idx, w, x, group, vec)
    assert passes == 1 and _rel(got, want) < 1e-6


# ---------------------------------------------------------------------------
# K2: edges over lane groups
# ---------------------------------------------------------------------------

def k2_walk(row, col, a, b, n_valid, lanes, vec):
    """K2's loop in numpy: lane l of an edge's group sums a . b over the
    vectors l, l + L, ... in order, the group adds its partial sums by an
    xor butterfly (off = L/2, ..., 1), lane 0 writes; every slot is
    written, the padding ones 0. Vectorised over the edges."""
    row, col = row.numpy(), col.numpy()
    af, bf = a.float().numpy(), b.float().numpy()
    cap, d = row.shape[0], af.shape[1]
    assert d % vec == 0 and lanes in (1, 2, 4, 8, 16, 32)
    ar, bc = af[row[:n_valid]], bf[col[:n_valid]]
    part = np.zeros((lanes, n_valid), np.float32)
    seen = np.zeros(d, int)
    for ln in range(lanes):
        for v in range(ln, d // vec, lanes):
            for f in range(v * vec, (v + 1) * vec):
                part[ln] = _fma(ar[:, f], bc[:, f], part[ln])
                seen[f] += 1
    assert (seen == 1).all()
    off = lanes // 2
    while off:
        part = (part + part[np.arange(lanes) ^ off]).astype(np.float32)
        off //= 2
    out = np.full(cap, np.nan, np.float32)          # torch.empty
    out[:n_valid] = part[0] if n_valid else 0
    out[n_valid:] = 0.0
    return out


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("table", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", DIMS)
def test_k2_walk_equals_plain(dim, table, graph):
    """The mirror over the chooser's (L, V) against ``edge_dot_plain``
    (1e-6 of scale), with every padding slot written 0."""
    g = GRAPHS[graph]()
    rng = np.random.default_rng(dim + 40)
    a = torch.tensor(rng.normal(size=(g.num_nodes, dim)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(g.num_nodes, dim))
                     .astype(np.float32)).to(table)
    nv = g.num_valid
    assert nv < g.capacity                          # padding to write
    lanes, vec = L.lanes("edge_dot", dim, (0, F32), (0, table))
    got = k2_walk(g.row, g.col, a, b, nv, lanes, vec)
    want = kernels.edge_dot_plain(g.row, g.col, a, b, nv)
    assert not np.isnan(got).any()
    assert (got[nv:] == 0).all()
    assert _rel(got, want) < 1e-6


# ---------------------------------------------------------------------------
# the chooser
# ---------------------------------------------------------------------------

# (kernel, D, table dtypes, address offset in bytes) -> (lanes, V)
CHOICES = [
    # K1 on float32 tables: a lane a row of at most 16 bytes, a lane a
    # vector up to 24 vectors, two vectors a lane above
    ("csr_spmm", 1, (F32,), 0, (1, 1)),
    ("csr_spmm", 3, (F32,), 0, (1, 1)),
    ("csr_spmm", 10, (F32,), 0, (8, 2)),        # K11's dx on Cora
    ("csr_spmm", 16, (F32,), 0, (4, 4)),
    ("csr_spmm", 64, (F32,), 0, (16, 4)),       # K11's dx at arxiv
    ("csr_spmm", 80, (F32,), 0, (32, 4)),
    ("csr_spmm", 128, (F32,), 0, (16, 4)),
    ("csr_spmm", 162, (F32,), 0, (32, 2)),
    ("csr_spmm", 258, (F32,), 0, (32, 2)),      # probe 1's table mode
    # ... on a bfloat16 table: 16 bytes are 8 elements
    ("csr_spmm", 1, (BF16,), 0, (1, 1)),
    ("csr_spmm", 3, (BF16,), 0, (1, 1)),
    ("csr_spmm", 10, (BF16,), 0, (8, 2)),
    ("csr_spmm", 80, (BF16,), 0, (16, 8)),
    ("csr_spmm", 128, (BF16,), 0, (16, 8)),
    ("csr_spmm", 162, (BF16,), 0, (32, 2)),
    ("csr_spmm", 8, (BF16,), 2, (8, 1)),        # 8 vectors: not one lane
    # odd addresses narrow the vector
    ("csr_spmm", 128, (F32,), 8, (32, 2)),
    ("csr_spmm", 80, (F32,), 4, (32, 1)),
    ("csr_spmm", 128, (BF16,), 4, (32, 2)),
    ("csr_spmm", 10, (F32,), 40, (8, 2)),       # row 1 of a width-10 table
    ("csr_spmm", 10, (F32,), 20, (16, 1)),
    # K2: a float32 a beside a float32 or bfloat16 b; at least 64 bytes of
    # a[row] a lane
    ("edge_dot", 1, (F32, F32), 0, (1, 1)),
    ("edge_dot", 3, (F32, F32), 0, (1, 1)),
    ("edge_dot", 10, (F32, F32), 0, (1, 2)),
    ("edge_dot", 80, (F32, F32), 0, (4, 4)),
    ("edge_dot", 128, (F32, F32), 0, (8, 4)),
    ("edge_dot", 162, (F32, F32), 0, (8, 2)),
    ("edge_dot", 80, (F32, BF16), 0, (4, 4)),
    ("edge_dot", 128, (F32, BF16), 0, (8, 4)),
    ("edge_dot", 128, (F32, BF16), 8, (8, 2)),
    ("edge_dot", 16, (F32, F32), 4, (1, 1)),
    # K15 as before (blocked_spmm: one lane a vector)
    ("blocked_spmm", 80, (F32,), 0, (32, 4)),
    ("blocked_spmm", 128, (F32,), 0, (32, 4)),
    ("blocked_spmm", 3, (F32,), 0, (4, 1)),
]


@pytest.mark.parametrize("kernel,dim,dtypes,offset,want", CHOICES)
def test_lane_choices(kernel, dim, dtypes, offset, want):
    """The chooser's (lanes, V) at the port's widths and alignments, odd
    row pitches among them (a width-10 table's row 1 starts 40 bytes in)."""
    tables = [(4096 + offset, t) for t in dtypes]
    assert L.lanes(kernel, dim, *tables) == want


@pytest.mark.parametrize("kernel,dtype", [
    ("csr_spmm", F32), ("csr_spmm", BF16), ("edge_dot", F32),
    ("edge_dot", BF16), ("blocked_spmm", F32)])
def test_lane_choices_fit_the_kernels(kernel, dtype):
    """At every width up to 300 and every 2-byte-aligned offset: V is a
    power of two dividing D, at most 16 bytes, on whose boundary each table
    lies; the lanes a power of two of at most a warp; K1 and K15 cover
    every row of up to 4 * 32 vectors in one pass, and K2 leaves no lane of
    its group without a vector."""
    dtypes = (F32, dtype) if kernel == "edge_dot" else (dtype,)
    sizes = [torch.empty((), dtype=t).element_size() for t in dtypes]
    for dim in range(1, 301):
        for offset in range(0, 32, max(sizes) // 2 * 2):
            tables = [((1 << 20) + offset, t) for t in dtypes]
            group, vec = L.lanes(kernel, dim, *tables)
            assert vec & (vec - 1) == 0 and dim % vec == 0
            assert vec * max(sizes) <= 16
            assert all(a % (vec * s) == 0 for (a, _), s in zip(tables, sizes))
            assert group in (1, 2, 4, 8, 16, 32)
            vecs = dim // vec
            if kernel == "edge_dot":
                assert group <= vecs
            elif vecs <= 32 * L.VECS_PER_LANE:
                assert group * L.VECS_PER_LANE >= vecs


def test_lane_chooser_reads_tensors():
    """A tensor is read by its address and element size: a table's view
    one row of width 10 in starts 40 bytes after the table."""
    t = torch.zeros((4, 10))
    assert L.lanes("csr_spmm", 10, t[1:]) == L.lanes(
        "csr_spmm", 10, (t.data_ptr() + 40, F32))
    with pytest.raises(ValueError):
        L.lanes("segment_norm", 10, t)


# ---------------------------------------------------------------------------
# the TPU kernels P1, P2
# ---------------------------------------------------------------------------

def _both_graphs(seed, n=40, e=70):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e).astype(np.int32)
    c = rng.integers(0, n, e).astype(np.int32)
    keep = r != c
    r, c = r[keep], c[keep]
    row, col = np.concatenate([r, c]), np.concatenate([c, r])
    kw = dict(function="laplacian", block="constant", stripe_fused=True,
              stripe_block_n=8, stripe_chunk=16, self_loop_weight=1.0)
    jg = j_prepare(JConfig(**kw), j_make_graph(row, col, None, num_nodes=n,
                                               pad_multiple=16))
    tg = prepare_graph(Config(**kw), make_graph(row, col, num_nodes=n,
                                                pad_multiple=16))
    return jg, tg, JConfig(**kw), n


def test_k1_walk_against_p1_interpret():
    """The mirror of K1 at the chooser's lanes for D = 80 against P1,
    ``make_stripe_spmm`` on a stripe-fused engine in Pallas interpret
    mode: within 2e-2 of scale, because P1 rounds its weighted one-hot and
    its payload to bf16 (stripe.py:523-526)."""
    jg, tg, jcfg, n = _both_graphs(1)
    g2, plan = build_stripe_engine(jcfg, jg)
    rng = np.random.default_rng(2)
    d = 80
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.random(tg.capacity).astype(np.float32)
         * tg.mask.numpy().astype(np.float32))
    idx = np.where(tg.mask.numpy())[0]
    slots = np.asarray(plan.slot_of_edge)[idx]
    w_s = np.zeros(plan.capacity, np.float32)
    w_s[slots] = w[idx]
    x_s = np.zeros((g2.num_nodes, d), np.float32)
    x_s[:n] = x
    want = np.asarray(make_stripe_spmm(g2, plan)(jnp.asarray(x_s),
                                                 jnp.asarray(w_s)))[:n]
    group, vec = L.lanes("csr_spmm", d, (0, F32))
    got, _ = k1_walk(tg.rowptr, tg.col, torch.tensor(w), torch.tensor(x),
                     group, vec)
    assert _rel(got, want) < 2e-2


def test_k2_walk_against_p2_dw():
    """The mirror of K2 at the chooser's lanes for D = 24 against P2's dw:
    its float32 gather ``_stripe_gather_call`` (Pallas interpret mode)
    dotted with x[col] as ``ops/spmm.py:128-133`` does, and ``jax.grad``
    of the XLA spmm in w; 1e-5 of scale."""
    jg, tg, jcfg, n = _both_graphs(7)
    g2, plan = build_stripe_engine(jcfg, jg)
    rng = np.random.default_rng(8)
    d = 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    ct = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.random(tg.capacity).astype(np.float32)
    lanes, vec = L.lanes("edge_dot", d, (0, F32), (0, F32))
    got = k2_walk(tg.row, tg.col, torch.tensor(ct), torch.tensor(x),
                  tg.num_valid, lanes, vec)
    m = tg.mask.numpy()
    rw = jax.grad(lambda w_: jnp.sum(j_spmm(jg, jnp.asarray(x), weight=w_)
                                     * ct))(jnp.asarray(w))
    assert _rel(got[m], np.asarray(rw)[m]) < 1e-5
    # P2 in plan slot order: ct[row] gathered by the kernel, x[col] by XLA
    ct_s = np.zeros((g2.num_nodes, d), np.float32)
    x_s = np.zeros((g2.num_nodes, d), np.float32)
    ct_s[:n], x_s[:n] = ct, x
    g_ct = _stripe_gather_call(plan, jnp.asarray(ct_s), dtype=jnp.float32)
    dw_p2 = np.asarray(jnp.sum(g_ct * jnp.asarray(x_s)[g2.col], axis=1))
    idx = np.where(m)[0]
    slots = np.asarray(plan.slot_of_edge)[idx]
    assert _rel(got[idx], dw_p2[slots]) < 1e-5
