"""K1's staged rounds and K16's slot walk on the CPU, where the kernels
cannot run: numpy mirrors of the order in which each kernel visits and
sums its operands, held against the plain versions that define them, and
K1's chooser (``kernels.lanes.csr_design``) held to what the kernel was
built for.

* K1 (``csrc/csr_spmm.cu``): a group of G lanes a row stages S (col, w)
  pairs a lane a round (S = 4 where the rows hold more edges than the
  group has lanes on average, ``csr_design``; else 1, or as many as the
  batch needs) and adds a round's edges in batches of U. Every feature is
  still summed by one lane, in edge order, with one fused multiply-add an
  edge, so the output is the row walk's of rounds of G pairs
  (``test_torch_port_lanes.py``'s mirror) bit for bit, whatever S: over a
  directed graph's CSC view with empty columns and a hub column (the
  column sum dx = A_w^T ct), over ``column_head_sum``'s table (K11's dx)
  and over a bfloat16 table.
* K16 (``csrc/blocked.cu``): a group of L lanes (K2's, ``edge_dot``'s
  chooser) a valid slot, K2's sums and butterfly; then one warp a chunk
  computes the chunk's padding value a[rb B] . b[cb B] once and writes it
  to the chunk's padding slots, the suffix after its ``chunk_valid``
  valid ones.
* One case against the TPU kernel: P18 (``_sddmm_call``) in Pallas
  interpret mode against K16's plain version.

Inputs are made with numpy from a seed.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.ops.pallas.plan import (
    build_block_plan as j_build_plan)
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.kernels import blocked
from graph_neural_pde_tpu_torch.kernels import lanes as L
from graph_neural_pde_tpu_torch.ops import spmm as ops_spmm
from graph_neural_pde_tpu_torch.ops.graph import make_graph
from graph_neural_pde_tpu_torch.ops.plan import build_block_plan
from test_torch_port_lanes import _fma, k1_walk, k2_walk

# the module, not the function of the same name that ops.pallas exports
jblocked = importlib.import_module(
    "graph_neural_pde_tpu.ops.pallas.spmm_blocked")

BF16 = torch.bfloat16
F32 = torch.float32
CSRC = (Path(kernels.__file__).resolve().parent.parent / "csrc")
DIMS = (1, 3, 10, 64, 80, 128, 162)


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _define(name: str) -> int:
    """A ``#define`` default of ``csrc/csr_spmm.cu``."""
    text = (CSRC / "csr_spmm.cu").read_text()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = (want.detach().numpy() if torch.is_tensor(want)
            else np.asarray(want))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# K1's staged rounds
# ---------------------------------------------------------------------------

def _directed_graph(seed, n=150, live=110, e=500, hub_degree=120):
    """Uniform pairs one way only among the first ``live`` nodes (the
    last columns empty), node 0's column a hub of ``hub_degree`` edges,
    self loops on the live nodes, row sorted with its CSC view."""
    rng = np.random.default_rng(seed)
    r = rng.integers(1, live, e)
    c = rng.integers(1, live, e)
    peers = rng.choice(np.arange(1, n), hub_degree, replace=False)
    loops = np.arange(live)
    row = np.concatenate([r, peers, loops])
    col = np.concatenate([c, np.zeros(hub_degree, np.int64), loops])
    return make_graph(row, col, num_nodes=n, pad_multiple=64).sort_by_row()


def _batch(dim, group, vec, size):
    """U: the edges whose x rows a lane loads at once, from the source's
    register budget at K vectors of V elements a lane."""
    vecs = dim // vec
    k = min(-(-vecs // group), L.VECS_PER_LANE)
    regs = k * -(-(vec * size) // 4)
    return max(1, min(_define("GNPDE_CSR_BATCH"),
                      _define("GNPDE_CSR_BATCH_REGS") // regs))


def k1_staged_walk(rowptr, col, w, x, group, vec, stage):
    """K1 in numpy with its rounds and batches: each row's edges in rounds
    of G R staged (col, w) pairs (R = max(U / G, S, 1)), each round added U
    edges at a time, each feature by its one lane with a fused multiply-add
    an edge. Returns the output, the edges each row added in the order it
    added them, and the rounds each row took."""
    rowptr, col, w = (t.numpy() for t in (rowptr, col, w))
    xf = x.float().numpy()
    n, d = rowptr.shape[0] - 1, xf.shape[1]
    assert d // vec <= group * L.VECS_PER_LANE          # one pass
    u = _batch(d, group, vec, x.element_size())
    p = group * max(1 if group >= u else u // group, stage)
    out = np.full((n, d), np.nan, np.float32)
    added = [[] for _ in range(n)]
    rounds = np.zeros(n, int)
    for row in range(n):
        start, end = rowptr[row], rowptr[row + 1]
        acc = np.zeros(d, np.float32)
        for e0 in range(start, end, p):
            staged = [(e, col[e], w[e]) for e in range(e0, min(e0 + p, end))]
            rounds[row] += 1
            for j in range(0, len(staged), u):
                for e, c, wj in staged[j:j + u]:   # loaded, then added
                    acc = _fma(wj, xf[c], acc)
                    added[row].append(e)
        out[row] = acc
    return out, added, rounds


def _check_staged_walk(rowptr, seg, col, w, x, dim):
    """The mirror at the chooser's (G, V, S) and at both depths, over rows
    ``rowptr`` (``seg``: each edge's row): bit for bit the row walk of
    rounds of G pairs, within 1e-6 of ``csr_spmm_plain`` in float64, every
    row's edges added in edge order; S = 4 takes a quarter of the rounds
    (rounded up) of S = 1 where the batch does not stage more."""
    n = rowptr.shape[0] - 1
    group, vec, stage = L.csr_design(dim, int(rowptr[-1]) / n, x)
    assert (group, vec) == L.lanes("csr_spmm", dim, x)
    walk, passes = k1_walk(rowptr, col, w, x, group, vec)
    assert passes == 1
    want = kernels.csr_spmm_plain(rowptr, seg, col, w.double(),
                                  x.float().double())
    rounds = {}
    for s in sorted({stage, 1, L.CSR_LONG_STAGE}):
        got, added, rounds[s] = k1_staged_walk(rowptr, col, w, x, group,
                                               vec, s)
        for r, edges in enumerate(added):
            assert edges == list(range(int(rowptr[r]), int(rowptr[r + 1])))
        np.testing.assert_array_equal(got, walk)
        assert _rel(got, want) < 1e-6
    u = _batch(dim, group, vec, x.element_size())
    if u <= group:
        assert (rounds[4] == -(-rounds[1] // 4)).all()
    return walk


@pytest.mark.parametrize("table", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", DIMS)
def test_staged_walk_column_sum(dim, table):
    """dx = A_w^T ct over a directed graph's CSC view, empty columns and a
    hub column among them, on a float32 and a bfloat16 cotangent."""
    g = _directed_graph(dim)
    rng = np.random.default_rng(dim + 1)
    w = torch.tensor(rng.random(g.capacity).astype(np.float32)) * g.mask
    ct = torch.tensor(rng.normal(size=(g.num_nodes, dim))
                      .astype(np.float32)).to(table)
    lengths = (g.colptr[1:] - g.colptr[:-1]).numpy()
    assert lengths.max() >= 120 and (lengths == 0).any()
    got = _check_staged_walk(g.colptr, g.col_by_col, g.row_by_col,
                             w[g.col_perm.long()], ct, dim)
    assert (got[lengths == 0] == 0).all()
    if table == F32:
        want = ops_spmm.transpose_matvec(g, w, ct)
        assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("heads,dim", [(8, 80), (2, 128)])
def test_staged_walk_head_sum(heads, dim):
    """K11's dx as ``column_head_sum`` lays it out (the [N*H, D/H] table
    over the CSC view, every column's edges H table rows each): at H = 8
    the rows hold more edges than the group's lanes, and S = 4."""
    g = _directed_graph(heads)
    rng = np.random.default_rng(heads + 2)
    u = (torch.tensor(rng.random((g.capacity, heads)).astype(np.float32)
                      + 0.05) * g.mask[:, None])
    ct_num = torch.tensor(rng.normal(size=(g.num_nodes, dim))
                          .astype(np.float32))
    hs = torch.arange(heads, dtype=torch.int32)
    idx = (g.row_by_col[:, None] * heads + hs).reshape(-1)
    w = u[g.col_perm.long()].reshape(-1)
    x = ct_num.view(g.num_nodes * heads, dim // heads)
    seg = g.col_by_col.repeat_interleave(heads)
    if heads == 8:
        mean = g.num_valid * heads / g.num_nodes
        assert L.csr_design(dim // heads, mean, x)[2] == L.CSR_LONG_STAGE
    got = _check_staged_walk(g.colptr * heads, seg, idx, w, x, dim // heads)
    assert _rel(got, kernels.column_head_sum(g, u, ct_num)) < 1e-6


def test_batches_at_the_column_sums_width():
    """At D = 128 in float32 the chooser's G = 16, V = 4 give each lane
    K = 2 vectors an edge and a batch of 2 edges in 16 registers; a row of
    the directed stand-in (about 8 edges) stays at S = 1."""
    group, vec, stage = L.csr_design(128, 7.89, (0, F32))
    assert (group, vec, stage) == (16, 4, 1)
    assert _batch(128, group, vec, 4) == 2


# ---------------------------------------------------------------------------
# the K1 chooser
# ---------------------------------------------------------------------------

# mean row lengths: empty, the image grids (4.9, 9), arxiv dir.'s columns
# (7.9), the symmetric arxiv rows (14.6), K11's dx table at arxiv (29.2),
# GDC Cora's columns (64), K11's dx table on Cora (72), a hub
MEAN_ROWS = (0.0, 4.86, 7.89, 9.0, 14.58, 29.16, 63.98, 72.0, 400.0)


@pytest.mark.parametrize("mean_row", MEAN_ROWS)
def test_csr_design_at_every_width(mean_row):
    """At every width up to 300, both dtypes and every 2-byte-aligned
    offset: (G, V) are ``lanes``'s (unchanged), and a round stages
    ``CSR_LONG_STAGE`` pairs a lane exactly where the rows hold more edges
    than the group has lanes on average, else 1."""
    for dtype in (F32, BF16):
        for dim in range(1, 301):
            for offset in (0, 2, 4, 8):
                table = ((1 << 20) + offset, dtype)
                group, vec, stage = L.csr_design(dim, mean_row, table)
                assert (group, vec) == L.lanes("csr_spmm", dim, table)
                assert stage == (L.CSR_LONG_STAGE if mean_row > group
                                 else 1)


def test_csr_spmm_reads_the_callers_edge_count(monkeypatch):
    """The edge count reaches the chooser from the caller (a graph's
    ``num_valid``), not from ``rowptr``: the CPU wrapper runs the plain
    version and counts no launch, and the column-side callers hand
    ``num_valid`` (times the heads in table mode) down."""
    g = _directed_graph(9)
    rng = np.random.default_rng(10)
    w = torch.tensor(rng.random(g.capacity).astype(np.float32)) * g.mask
    ct = torch.tensor(rng.normal(size=(g.num_nodes, 16)).astype(np.float32))
    before = kernels.csr_spmm.launches
    got = kernels.csr_spmm(g.colptr, g.col_by_col, g.row_by_col,
                           w[g.col_perm.long()], ct, n_edges=g.num_valid)
    assert kernels.csr_spmm.launches == before
    seen = []
    real = ops_spmm.csr_spmm

    def spy(*args, **kw):
        seen.append(kw.get("n_edges"))
        return real(*args, **kw)

    monkeypatch.setattr(ops_spmm, "csr_spmm", spy)
    assert torch.equal(ops_spmm.transpose_matvec(g, w, ct), got)
    dual_scatter = importlib.import_module(
        "graph_neural_pde_tpu_torch.kernels.dual_scatter")
    monkeypatch.setattr(dual_scatter, "csr_spmm", spy)
    u = torch.ones((g.capacity, 2)) * g.mask[:, None]
    dual_scatter.column_head_sum(g, u, ct)
    assert seen == [g.num_valid, 2 * g.num_valid]


# ---------------------------------------------------------------------------
# K16's slot walk and its padding
# ---------------------------------------------------------------------------

def _plan(seed, n=600, e=2500, band=120, block_n=128, chunk=128,
          empty_block=False):
    """A banded random graph's block plan: several buckets per row block,
    chunks with padding; ``empty_block`` leaves the last row block without
    edges (a chunk all padding)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e)
    c = np.clip(r + rng.integers(-band, band, e), 0, n - 1)
    if empty_block:
        keep = r < (n - 1) // block_n * block_n
        r, c = r[keep], c[keep]
    return build_block_plan(r, c, num_nodes=n, block_n=block_n, chunk=chunk)


def k16_walk(lay, a, b, lanes, vec):
    """K16 in numpy: a group of L lanes a valid slot in plan order (K2's
    sums and butterfly over a[rb B + row_local] and b[cb B + col_local]),
    then one warp a chunk with padding: its value a[rb B] . b[cb B] once
    (32 lanes in K2's order), written to the chunk's padding slots.
    Returns the output and the padding values computed, per chunk."""
    chunk = lay.chunk
    cap = lay.capacity
    cr, cc = lay.chunk_rows.numpy(), lay.chunk_cols.numpy()
    cv = lay.chunk_valid.numpy()
    rl, cl = lay.row_local.numpy(), lay.col_local.numpy()
    s = np.arange(cap)
    c = s // chunk
    live = s - c * chunk < cv[c]
    rows = (cr[c] * lay.block_n + rl)[live]
    cols = (cc[c] * lay.block_n + cl)[live]
    out = np.full(cap, np.nan, np.float32)                # torch.empty
    n = int(live.sum())
    out[live] = k2_walk(torch.tensor(rows, dtype=torch.int32),
                        torch.tensor(cols, dtype=torch.int32), a, b, n,
                        lanes, vec)
    computed = np.zeros(len(cv), int)
    af, bf = a.numpy(), b.numpy()
    for ci in range(len(cv)):
        if cv[ci] == chunk:
            continue                                    # the warp leaves
        ar, br = af[cr[ci] * lay.block_n], bf[cc[ci] * lay.block_n]
        part = np.zeros(32, np.float32)
        for ln in range(32):
            for f in range(ln, ar.shape[0], 32):
                part[ln] = _fma(ar[f], br[f], part[ln])
        off = 16
        while off:
            part = (part + part[np.arange(32) ^ off]).astype(np.float32)
            off //= 2
        computed[ci] += 1
        out[ci * chunk + cv[ci]:(ci + 1) * chunk] = part[0]
    return out, computed


K16_CASES = [  # (D, block_n, chunk, empty row block)
    (1, 128, 128, False), (3, 128, 128, False), (16, 128, 128, False),
    (80, 128, 128, False), (128, 128, 128, False), (162, 128, 128, False),
    (80, 64, 32, True), (3, 64, 32, True)]


@pytest.mark.parametrize("dim,block_n,chunk,empty", K16_CASES)
def test_k16_slot_walk_equals_plain(dim, block_n, chunk, empty):
    """The mirror at the chooser's (L, V) against ``blocked_sddmm_plain``
    in float64 (1e-6 of scale), padding slots included; each chunk's
    padding computed once, none for a chunk without padding."""
    plan = _plan(dim, block_n=block_n, chunk=chunk, empty_block=empty)
    lay = blocked.blocked_layout(plan)
    rng = np.random.default_rng(dim + 3)
    a = torch.tensor(rng.normal(size=(lay.num_nodes, dim))
                     .astype(np.float32))
    b = torch.tensor(rng.normal(size=(lay.num_nodes, dim))
                     .astype(np.float32))
    lanes, vec = L.lanes("edge_dot", dim, a, b)      # K16's: K2's
    got, computed = k16_walk(lay, a, b, lanes, vec)
    assert not np.isnan(got).any()
    padded = lay.chunk_valid.numpy() < chunk
    assert padded.any() and (computed == padded).all()
    if empty:
        assert (lay.chunk_valid.numpy() == 0).any()
    want = blocked.blocked_sddmm_plain(lay, a.double(), b.double())
    assert _rel(got, want) < 1e-6
    assert _rel(got, blocked.blocked_sddmm(lay, a, b)) < 1e-6


def test_k16_padding_is_each_chunks_suffix():
    """``chunk_valid`` counts each chunk's valid slots, which come first
    (the plan puts a bucket's edges before its padding); every padding
    slot of a chunk holds one value, a[rb B] . b[cb B]."""
    plan = _plan(20, block_n=64, chunk=32, empty_block=True)
    lay = blocked.blocked_layout(plan)
    valid = plan.valid.reshape(-1, plan.chunk)
    cv = lay.chunk_valid.numpy()
    assert (valid.sum(1) == cv).all()
    assert (valid == (np.arange(plan.chunk) < cv[:, None])).all()
    rng = np.random.default_rng(21)
    a = torch.tensor(rng.normal(size=(lay.num_nodes, 5)).astype(np.float64))
    b = torch.tensor(rng.normal(size=(lay.num_nodes, 5)).astype(np.float64))
    out = blocked.blocked_sddmm_plain(lay, a, b).numpy()
    for ci in np.nonzero(cv < plan.chunk)[0]:
        pad = out[ci * plan.chunk + cv[ci]:(ci + 1) * plan.chunk]
        want = float(a[int(plan.chunk_rows[ci]) * plan.block_n]
                     @ b[int(plan.chunk_cols[ci]) * plan.block_n])
        assert np.allclose(pad, want, rtol=0, atol=1e-12)


def test_k16_plain_against_p18_interpret():
    """K16's plain version against P18 (``_sddmm_call``) in float32
    interpret mode on the same plan, padding slots included: 1e-5 of the
    largest entry."""
    rng = np.random.default_rng(30)
    n, e = 300, 1200
    r = rng.integers(0, n, e)
    c = np.clip(r + rng.integers(-60, 60, e), 0, n - 1)
    kw = dict(num_nodes=n, block_n=128, chunk=128)
    jplan, plan = j_build_plan(r, c, **kw), build_block_plan(r, c, **kw)
    lay = blocked.blocked_layout(plan)
    d = 8
    a = rng.normal(size=(lay.num_nodes, d)).astype(np.float32)
    b = rng.normal(size=(lay.num_nodes, d)).astype(np.float32)
    want = np.asarray(jblocked._sddmm_call(jplan, jnp.asarray(a),
                                           jnp.asarray(b)))
    got = blocked.blocked_sddmm_plain(lay, torch.tensor(a), torch.tensor(b))
    assert (lay.chunk_valid.numpy() < plan.chunk).any()
    assert _rel(got, want) < 1e-5
