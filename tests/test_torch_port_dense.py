"""The node projections and the dKw / dKb reduction of the fused attention
kernels (``csrc/dense.cuh``, ``kernels/dense.py``) on the CPU, where the
kernels cannot run.

* The plain versions against the JAX package's own products: both tables
  against ``jnp.dot`` at ``HIGHEST`` precision (1e-5 of scale), the
  bfloat16 k table against the JAX package's bf16 composition ``x_b @
  Kw.astype(bf16) + kb.astype(bf16)`` (within one bf16 step, nearly every
  entry the same bits: that composition sums its product in float32, the
  port in float64), and ``[x | 1]^T dk`` (over nodes, gathered through an
  index, over a bfloat16 table) against ``jnp.dot``.
* A numpy mirror of the reduction's split-K partition: ``reduce_blocks``
  contiguous row ranges (``block_rows``), stages of 32 rows a block, each
  stage summed in row order and added to the block's total, the blocks'
  partial tiles then added in order. Every row counts once, for ragged row
  counts, with and without the index; the mirror agrees with the plain
  version.
* The tile and block chooser (``tables_design``, ``reduce_blocks``): every
  column of every table in exactly one column group, every node in one
  tile, shared memory within a block's, the block counts at the port's
  shapes.
* The wrappers on CPU tensors: the plain versions, no launch counted.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu_torch.kernels import dense

HIGHEST = jax.lax.Precision.HIGHEST
BF16 = jnp.bfloat16
# (N, D, ATT): a toy width, and the Cora GRAND-nl, arxiv, BLEND and kNN
# Cora BLEND widths at small N
WIDTHS = ((37, 16, 16), (50, 80, 128), (70, 128, 32), (40, 128, 64),
          (30, 96, 256))


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _operands(n, d, att, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    qw, kw = ((rng.normal(size=(d, att)) / np.sqrt(d)).astype(np.float32)
              for _ in range(2))
    qb, kb = (0.1 * rng.normal(size=(att,)).astype(np.float32)
              for _ in range(2))
    return x, qw, qb, kw, kb


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,att", WIDTHS)
def test_tables_plain_against_jnp(n, d, att):
    x, qw, qb, kw, kb = _operands(n, d, att, 0)
    q, k = dense.node_tables_plain(torch.tensor(x), None,
                                   *(torch.tensor(a) for a in
                                     (qw, qb, kw, kb)))
    for got, w, b in ((q, qw, qb), (k, kw, kb)):
        want = jnp.dot(jnp.asarray(x), jnp.asarray(w), precision=HIGHEST) + b
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("row_bf16", (False, True))
@pytest.mark.parametrize("n,d,att", WIDTHS[1:4])
def test_bf16_k_table_against_jax(n, d, att, row_bf16):
    """Beside a bfloat16 column table: q from the row side (float32, or the
    bf16 state's bfloat16 x) in float32, k the bf16 table, against the JAX
    package's bf16 composition of k_e."""
    x, qw, qb, kw, kb = _operands(n, d, att, 1)
    xcol = torch.tensor(x).to(torch.bfloat16)
    xrow = xcol if row_bf16 else torch.tensor(x)
    q, k = dense.node_tables_plain(xrow, xcol, *(torch.tensor(a) for a in
                                                 (qw, qb, kw, kb)))
    assert q.dtype == torch.float32 and k.dtype == torch.bfloat16
    xr = jnp.asarray(x).astype(BF16).astype(jnp.float32) if row_bf16 \
        else jnp.asarray(x)
    want_q = jnp.dot(xr, jnp.asarray(qw), precision=HIGHEST) + qb
    assert _rel(q.numpy(), want_q) < 1e-5
    xb = jnp.asarray(x).astype(BF16)
    k_e = (jnp.dot(xb, jnp.asarray(kw).astype(BF16), precision=HIGHEST)
           + jnp.asarray(kb).astype(BF16))
    assert k_e.dtype == BF16
    got = k.float().numpy()
    want = np.asarray(k_e.astype(jnp.float32))
    step = np.abs(want) * 2.0 ** -7 + 1e-30          # one bf16 step
    assert np.all(np.abs(got - want) <= step)
    assert np.mean(got == want) > 0.98


@pytest.mark.parametrize("form,d,att", (("nodes", 80, 128),
                                         ("gathered", 128, 32),
                                         ("edges", 128, 64),
                                         ("bf16", 96, 256)))
def test_outer_reduce_plain_against_jnp(form, d, att):
    """[x | 1]^T dk over the nodes (K9, K14, K17), over slots gathered
    through the column index (K8 with dxg), over a per-edge payload (K8's
    per-head mode) and over a bfloat16 table, against ``jnp.dot``."""
    rng = np.random.default_rng(2)
    nx, rows = 60, (60 if form in ("nodes", "bf16") else 150)
    x = rng.normal(size=(nx if form != "edges" else rows, d)).astype(
        np.float32)
    dk = rng.normal(size=(rows, att)).astype(np.float32)
    idx = rng.integers(0, nx, rows).astype(np.int32) if form == "gathered" \
        else None
    xt = torch.tensor(x)
    if form == "bf16":
        xt = xt.to(torch.bfloat16)
        x = np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))
    dkw, dkb = dense.outer_reduce_plain(
        xt, None if idx is None else torch.tensor(idx), torch.tensor(dk))
    xe = x[idx] if idx is not None else x[:rows]
    x1 = jnp.concatenate([jnp.asarray(xe), jnp.ones((rows, 1))], axis=1)
    want = jnp.dot(x1.T, jnp.asarray(dk), precision=HIGHEST)
    assert _rel(dkw.numpy(), want[:d]) < 1e-5
    assert _rel(dkb.numpy(), want[d]) < 1e-5


# ---------------------------------------------------------------------------
# the split-K partition, mirrored
# ---------------------------------------------------------------------------

def _mirror_reduce(x, idx, dk, blocks):
    """outer_reduce_kernel and the second pass in numpy float32: each
    block's rows in stages of REDUCE_ROWS, a stage summed in row order and
    added to the block's total; the partials added in block order. Also
    returns how often each row was read."""
    rows, att = dk.shape
    d = x.shape[1]
    seen = np.zeros(rows, np.int64)
    partials = np.zeros((blocks, d + 1, att), np.float32)
    for p, (r0, r1) in enumerate(dense.block_rows(rows, blocks)):
        tot = np.zeros((d + 1, att), np.float32)
        for s0 in range(r0, r1, dense.REDUCE_ROWS):
            acc = np.zeros((d + 1, att), np.float32)
            for r in range(s0, min(r1, s0 + dense.REDUCE_ROWS)):
                seen[r] += 1
                xr = np.append(x[r if idx is None else idx[r]], 1.0)
                acc += np.outer(xr, dk[r]).astype(np.float32)
            tot += acc
        partials[p] = tot
    out = np.zeros((d + 1, att), np.float32)
    for p in range(blocks):
        out += partials[p]
    return out, seen


@pytest.mark.parametrize("gathered", (False, True))
@pytest.mark.parametrize("rows,sms", ((1, 132), (33, 2), (1000, 3)))
def test_split_k_mirror(rows, sms, gathered):
    rng = np.random.default_rng(rows)
    d, att = 12, 8
    nx = 50 if gathered else rows
    x = rng.normal(size=(nx, d)).astype(np.float32)
    dk = rng.normal(size=(rows, att)).astype(np.float32)
    idx = rng.integers(0, nx, rows).astype(np.int32) if gathered else None
    blocks = dense.reduce_blocks(rows, d, att, sms)
    got, seen = _mirror_reduce(x, idx, dk, blocks)
    assert np.all(seen == 1)
    dkw, dkb = dense.outer_reduce_plain(
        torch.tensor(x).double(), None if idx is None else torch.tensor(idx),
        torch.tensor(dk).double())
    assert _rel(got[:d], dkw.numpy()) < 1e-5
    assert _rel(got[d], dkb.numpy()) < 1e-5


@pytest.mark.parametrize("rows,blocks", ((5, 8), (169_343, 264)))
def test_block_rows_cover_once(rows, blocks):
    ranges = dense.block_rows(rows, blocks)
    assert len(ranges) == blocks
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a0 <= a1 == b0


# ---------------------------------------------------------------------------
# the chooser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,att,want", (
    (169_343, 128, 32, 264),         # arxiv, K9's nodes: two blocks an SM
    (169_343, 128, 64, 264),         # BLEND: one tile of 64 columns
    (2_708, 80, 128, 85),            # Cora: a stage of rows a block
    (2_708, 96, 256, 66),            # kNN Cora BLEND: four tiles
    (1_335_579, 128, 32, 264),       # arxiv dir. slots (K8 with dxg)
    (4_096, 128, 64, 128)))          # the bench oracle's edges
def test_reduce_blocks(rows, d, att, want):
    blocks = dense.reduce_blocks(rows, d, att, 132)
    assert blocks == want
    tiles = dense.reduce_tiles(d, att)
    assert blocks * tiles <= dense.REDUCE_WAVES * 132 + tiles
    assert blocks <= -(-rows // dense.REDUCE_ROWS)


@pytest.mark.parametrize("n,d,att", ((169_343, 128, 32), (2_708, 80, 128),
                                     (2_708, 96, 256), (100, 16, 16),
                                     (169_343, 128, 64)))
def test_tables_design_covers(n, d, att):
    """In the three TABLES modes: every column of every table in exactly
    one column group (a float32 x of many nodes: a group of the tables
    side by side on the tensor cores, 4 x 2 warps of m16 x n8 tiles; a
    bfloat16 x or few nodes: a SIMT lane tile of one table), every node in
    one node tile, within a block's shared memory; the tensor cores
    exactly where their tiles give at least two blocks an SM."""
    for tables in (0, 1, 2):
        _design_covers(n, d, att, tables)


def _design_covers(n, d, att, tables):
    launches = dense.tables_design(n, d, att, tables, 132)
    assert len(launches) == (2 if tables == 1 else 1)
    assert sum(len(lau["tables"]) for lau in launches) == 2
    for lau in launches:
        ntab = len(lau["tables"])
        float_x = lau["x"] == "x" and tables != 2
        cols = np.zeros(ntab * att, np.int64)
        wide = -(-n // 128) * -(-ntab * att // 64) >= 2 * 132
        assert (lau["route"] == "mma") == (float_x and wide)
        if lau["route"] == "mma":
            assert lau["nodes_per_block"] == 128
            for task in range(lau["tasks"]):
                for warp_n in range(2):
                    for tile_n in range(4):
                        for lane_t in range(4):
                            for e in range(2):
                                c = (task * 64 + 32 * warp_n
                                     + 8 * tile_n + 2 * lane_t + e)
                                if c < ntab * att:
                                    cols[c] += 1
            # each group's blocks walk every node tile once
            tiles = [first + j * lau["step"] for first in range(lau["step"])
                     for j in range(-(-(lau["n_tiles"] - first)
                                      // lau["step"]))]
            assert sorted(tiles) == list(range(lau["n_tiles"]))
            assert lau["blocks"] == lau["step"] * lau["tasks"]
        else:
            lc = lau["lc"]
            for tab in range(ntab):
                for g in range(lau["groups"]):
                    for lane in range(lc):
                        for j in range(4):
                            c = g * 4 * lc + 4 * lane + j
                            if c < att:
                                cols[tab * att + c] += 1
            assert lau["tasks"] == lau["groups"] * ntab
            if float_x:
                assert lau["depth"] == 128 and lau["tm"] in (4, 8)
            else:
                assert (lau["tm"], lau["depth"]) == (4, 32)
            bm = lau["nodes_per_block"]
            assert bm == 8 * (32 // lc) * lau["tm"]
            assert lau["blocks"] == -(-n // bm) * lau["tasks"]
        assert np.all(cols == 1)
        assert lau["shared_bytes"] <= 227 * 1024
    if (n, d, att, tables) == (169_343, 128, 32, 0):
        (lau,) = launches
        assert (lau["tasks"], lau["n_tiles"], lau["blocks"]) == (1, 1323, 264)


def test_tables_design_shared_bytes_in_range():
    """Every width the kernels take fits a block's shared memory."""
    for att in range(1, 257, 7):
        for d in (1, 16, 80, 128, 255, 256):
            for tables in (0, 1, 2):
                for lau in dense.tables_design(169_343, d, att, tables, 132):
                    assert lau["shared_bytes"] <= 227 * 1024


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_run_the_plain_versions_on_the_cpu():
    x, qw, qb, kw, kb = (torch.tensor(a) for a in _operands(20, 16, 8, 3))
    before = (dense.node_project.launches, dense.outer_reduce.launches)
    q, k = dense.node_project(x, qw, qb, kw, kb)
    q0, k0 = dense.node_tables_plain(x, None, qw, qb, kw, kb)
    assert torch.equal(q, q0) and torch.equal(k, k0)
    xcol = x.to(torch.bfloat16)
    q, k = dense.node_project(x, qw, qb, kw, kb, xcol=xcol)
    assert k.dtype == torch.bfloat16
    assert torch.equal(k, dense.node_tables_plain(x, xcol, qw, qb, kw,
                                                  kb)[1])
    idx = torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32)
    dk = torch.randn(5, 8)
    got = dense.outer_reduce(x, idx, dk)
    want = dense.outer_reduce_plain(x, idx, dk)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (dense.node_project.launches,
            dense.outer_reduce.launches) == before


def test_wrappers_refuse_bad_operands():
    x, qw, qb, kw, kb = (torch.tensor(a) for a in _operands(20, 16, 8, 4))
    with pytest.raises(ValueError):
        dense.node_project(x, qw[:8], qb, kw, kb)
    with pytest.raises(TypeError):
        dense.node_project(x, qw.half(), qb, kw, kb)
    with pytest.raises(ValueError):
        dense.node_project(x, qw, qb, kw, kb, xcol=x)
    with pytest.raises(ValueError):
        dense.outer_reduce(x, torch.zeros(3, dtype=torch.int64),
                           torch.randn(3, 8))


def test_count_fused():
    before = (dense.node_project.launches, dense.outer_reduce.launches)
    dense.count_fused(1, 1, reduce=True)
    dense.count_fused(0, 0)
    dense.count_fused(2, 1)
    assert (dense.node_project.launches - before[0],
            dense.outer_reduce.launches - before[1]) == (3, 1)
    dense.node_project.launches, dense.outer_reduce.launches = before
