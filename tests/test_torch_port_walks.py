"""The walks of K15 ``blocked_spmm`` and K17 ``fused_rhs_bwd_col`` on the
CPU, where the kernels cannot run: numpy mirrors of the order in which each
kernel visits and sums its operands, held against the plain versions that
define them, and the layouts they walk held to their contracts.

* K15 walks rows: ``blocked_layout`` turns a block plan into a CSR over its
  valid slots, each row's slots in plan order. The mirror sums each row in
  that order, at the image paths' D = 1 and D = 3 and the Cora row's D = 80,
  on the forward and the transposed plans; ``spmm_lanes`` picks the lanes
  and the vector width of each row's group.
* K17 walks the CSC view cut into pieces of at most ``COL_PIECE`` edges of
  one column (``column_pieces``): pass 1 sums each piece, finishing the
  columns of one piece and writing the partial sums of longer ones; pass 2
  adds a column's partials in piece order. The mirror runs both passes on
  a graph with a hub column of in-degree far above the piece length, in
  float32 and on the bfloat16 column table, and the plain version on that
  graph is held against the JAX package's column-plan VJP (Pallas in
  interpret mode).

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.kernels import blocked
from graph_neural_pde_tpu_torch.kernels.fused_rhs import (bf16_k_table,
                                                          bf16_round)
from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
from graph_neural_pde_tpu_torch.ops.graph import (COL_PIECE, column_pieces,
                                                  make_graph)
from graph_neural_pde_tpu_torch.ops.plan import (build_block_plan,
                                                 transpose_plan)

BELTRAMI = "exp_kernel_beltrami"


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


# ---------------------------------------------------------------------------
# K15: rows over the blocked plan
# ---------------------------------------------------------------------------

def _banded_plan(seed, n=700, e=3000, band=150, block_n=128, chunk=64):
    """A plan over a random graph whose edges stay near the diagonal (a few
    buckets per row block, several chunks in some), with weights."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e)
    c = np.clip(r + rng.integers(-band, band, e), 0, n - 1)
    w = rng.random(e).astype(np.float32)
    return build_block_plan(r, c, w, num_nodes=n, block_n=block_n,
                            chunk=chunk)


def _row_walk(lay, plan, w, x):
    """K15's loop in numpy: each row sums its slots in the layout's order
    (csrc/blocked.cu); checks on the way that the slots are the row's own,
    valid and in plan order."""
    rowptr, slot, col = (getattr(lay, k).numpy() for k in
                         ("rowptr", "slot", "col"))
    out = np.zeros_like(x)
    for r in range(lay.num_nodes):
        ks = slot[rowptr[r]:rowptr[r + 1]]
        assert plan.valid[ks].all() and (plan.row[ks] == r).all()
        assert (np.diff(ks) > 0).all()                  # plan order
        acc = np.zeros(x.shape[1], x.dtype)
        for k, c in zip(ks, col[rowptr[r]:rowptr[r + 1]]):
            assert c == plan.col[k]
            acc += w[k] * x[c]
        out[r] = acc
    return out


@pytest.mark.parametrize("dim", [1, 3, 80])
@pytest.mark.parametrize("side", ["fwd", "bwd"])
def test_k15_row_walk_equals_plain(dim, side):
    """Every valid slot visited once, each row's slots in plan order, and
    the row sums equal to ``blocked_spmm_plain`` (1e-6 of scale)."""
    plan = _banded_plan(8)
    if side == "bwd":
        plan = transpose_plan(plan)[0]
    lay = blocked.blocked_layout(plan)
    np.testing.assert_array_equal(np.sort(lay.slot.numpy()),
                                  np.nonzero(plan.valid)[0])
    assert lay.rowptr.shape[0] == plan.num_nodes + 1
    rng = np.random.default_rng(9)
    x = rng.normal(size=(plan.num_nodes, dim)).astype(np.float32)
    w = plan.weight
    want = blocked.blocked_spmm_plain(lay, torch.tensor(w), torch.tensor(x))
    assert _rel(_row_walk(lay, plan, w, x), want) < 1e-6


@pytest.mark.parametrize("block_n", [64, 4096])
def test_k15_layout_takes_any_block_n(block_n):
    """The row walk keeps no tile in shared memory: a plan of any block
    size gives a layout, and its rows cover the padded nodes."""
    plan = _banded_plan(12, block_n=block_n, chunk=32)
    lay = blocked.blocked_layout(plan)
    assert lay.num_nodes == plan.num_nodes and lay.num_nodes % block_n == 0
    assert int(lay.rowptr[-1]) == int(plan.valid.sum())


@pytest.mark.parametrize("dim,address,lanes,vec", [
    (1, 0, 1, 1), (3, 0, 4, 1), (16, 0, 4, 4), (64, 0, 16, 4),
    (80, 0, 32, 4), (128, 0, 32, 4), (162, 0, 32, 2), (128, 8, 32, 2),
    (80, 4, 32, 1), (512, 0, 32, 4)])
def test_k15_lanes(dim, address, lanes, vec):
    """A row's group: the widest vector that divides D and the table's
    address (16-byte loads where D % 4 == 0), and the smallest power of two
    of lanes covering D / V vectors, at most a warp."""
    assert blocked.spmm_lanes(dim, address) == (lanes, vec)


# ---------------------------------------------------------------------------
# K17: column pieces
# ---------------------------------------------------------------------------

N_HUB, HUB, HUB_DEG = 300, 7, 230


def _hub_edges(seed, n=N_HUB, extra=900, hub_deg=HUB_DEG):
    """Random directed edges plus a hub column ``HUB`` with at least
    ``hub_deg`` distinct in-edges (far above COL_PIECE), and node 0 without
    in-edges; no self loops, no duplicates."""
    rng = np.random.default_rng(seed)
    hub_rows = rng.choice(np.delete(np.arange(1, n), HUB - 1), hub_deg,
                          replace=False)
    r = np.concatenate([hub_rows, rng.integers(0, n, extra)])
    c = np.concatenate([np.full(hub_deg, HUB), rng.integers(1, n, extra)])
    keep = r != c
    pairs = np.unique(np.stack([r[keep], c[keep]], 1), axis=0)
    pairs = pairs[rng.permutation(pairs.shape[0])]
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), n


def _hub_graph(seed=21):
    r, c, n = _hub_edges(seed)
    return make_graph(r, c, num_nodes=n, pad_multiple=16).sort_by_row()


@pytest.mark.parametrize("piece", [1, 4, COL_PIECE, 1000])
def test_column_pieces_cover_the_csc_view(piece):
    """Every CSC edge in exactly one piece, each piece within one column
    and at most ``piece`` long, pieces in column order, every column at
    least one piece; the partial rows of the columns of several pieces
    numbered in piece order."""
    g = _hub_graph()
    colptr = g.colptr.numpy().astype(np.int64)
    pc = column_pieces(g.colptr, piece)
    ptr, col, slot = (getattr(pc, k).numpy() for k in ("ptr", "col", "slot"))
    assert ptr[0] == 0 and ptr[-1] == colptr[-1] and (np.diff(ptr) >= 0).all()
    lengths = np.diff(ptr)
    assert lengths.max() <= piece
    assert (np.diff(col) >= 0).all()                  # column order
    np.testing.assert_array_equal(np.unique(col), np.arange(g.num_nodes))
    # within its column: the piece's range lies in the column's edges
    assert (ptr[:-1] >= colptr[col]).all() and (ptr[1:] <= colptr[col + 1]).all()
    # an empty piece only for an empty column
    assert (colptr[col + 1][lengths == 0] == colptr[col][lengths == 0]).all()
    count = np.bincount(col, minlength=g.num_nodes)
    deg = np.diff(colptr)
    np.testing.assert_array_equal(count, np.maximum(1, -(-deg // piece)))
    multi = count[col] > 1
    np.testing.assert_array_equal(slot[~multi], -1)
    np.testing.assert_array_equal(slot[multi], np.arange(multi.sum()))
    np.testing.assert_array_equal(pc.multi_col.numpy(),
                                  np.nonzero(count > 1)[0])
    np.testing.assert_array_equal(pc.multi_ptr.numpy(),
                                  np.append(0, np.cumsum(count[count > 1])))
    assert (pc.n_pieces, pc.n_multi, pc.n_slots, pc.longest) == (
        col.shape[0], int((count > 1).sum()), int(multi.sum()),
        int(deg.max()))
    assert deg[HUB] >= HUB_DEG and (piece >= deg.max() or pc.n_multi > 0)


def test_graph_carries_its_column_pieces():
    """``sort_by_row`` builds the pieces of its CSC view at COL_PIECE, and
    ``Graph.to`` moves them with the graph."""
    g = _hub_graph()
    want = column_pieces(g.colptr)
    assert g.col_pieces.piece == COL_PIECE
    for k in ("ptr", "col", "slot", "multi_col", "multi_ptr"):
        assert torch.equal(getattr(g.col_pieces, k), getattr(want, k))
    moved = g.to("cpu").col_pieces
    assert moved.n_slots == want.n_slots and torch.equal(moved.ptr, want.ptr)


def _operands(g, score, seed, d=12, heads=4):
    """One backward's inputs over ``g`` (exp_kernel_beltrami's packed ATT
    2 x 16, its projections block-structured: 8 feature columns of x to the
    first half, 4 position columns to the second)."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    att = 32 if score == BELTRAMI else 16

    def t(*shape, scale=1.0):
        return torch.tensor((scale * rng.normal(size=shape)).astype(
            np.float32))

    x, ct_ax = t(n, d), t(n, d)
    qw, kw = t(d, att, scale=0.3), t(d, att, scale=0.3)
    if score == BELTRAMI:
        for w in (qw, kw):
            w[8:, :att // 2] = 0.0
            w[:8, att // 2:] = 0.0
    qb, kb = t(att, scale=0.1), t(att, scale=0.1)
    recip_p, ct_den = t(n, heads).abs() + 0.1, t(n, heads)
    gmax = torch.tensor([0.25])
    sp = (dict(var=torch.tensor([1.3, 0.9]), ls=torch.tensor([0.8, 1.4]))
          if score == BELTRAMI else {})
    return (x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den), dict(
        heads=heads, score=score, **sp)


def _edge_terms(q_r, k_n, score, heads, var, ls, gmax, dot, rg, ctd):
    """One edge's (sum_h u_h recip_p[r, h], dk_e) as K17's head lanes form
    them (csrc/fused_common.cuh head_score and head_backward), float64."""
    att = q_r.shape[0]
    dk = np.zeros(att)
    wsum = 0.0
    if score == BELTRAMI:
        d_k = att // (2 * heads)
        half = att // 2
    else:
        d_k = att // heads
    for h in range(heads):
        f = slice(h * d_k, (h + 1) * d_k)
        if score == "scaled_dot":
            s = q_r[f] @ k_n[f] / np.sqrt(d_k)
        else:
            p = slice(half + h * d_k, half + (h + 1) * d_k)
            dist = np.sum((q_r[f] - k_n[f]) ** 2)
            dist_p = np.sum((q_r[p] - k_n[p]) ** 2)
            s = (var[0] ** 2 * np.exp(-dist / (2 * ls[0] ** 2))
                 * var[1] ** 2 * np.exp(-dist_p / (2 * ls[1] ** 2)))
        u = np.exp(s - gmax)
        ds = (rg[h] * dot + ctd[h]) * u
        if score == "scaled_dot":
            dk[f] = ds / np.sqrt(d_k) * q_r[f]
        else:
            dk[f] = s / ls[0] ** 2 * ds * (q_r[f] - k_n[f])
            dk[p] = s / ls[1] ** 2 * ds * (q_r[p] - k_n[p])
        wsum += u * rg[h]
    return wsum, dk


def _k17_passes(g, pieces, ops, kw_f, xcol):
    """K17's two passes in numpy (float64): pass 1 sums each piece's edges
    in CSC order, finishing a column of one piece and writing a partial
    row (D + ATT) for a piece of a longer column; pass 2 adds a column's
    partial rows in piece order. Returns (dx, dkw, dkb)."""
    x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den = ops
    heads, score = kw_f["heads"], kw_f["score"]
    var = kw_f["var"].double().numpy() if "var" in kw_f else None
    ls = kw_f["ls"].double().numpy() if "ls" in kw_f else None
    if xcol is None:
        xc, k, kw_eff = x.double(), (x @ kw + kb).double(), kw.double()
    else:
        xc = xcol.double()
        k, kw_eff = bf16_k_table(xcol, kw, kb).double(), bf16_round(kw).double()
    xc, k, kw_eff = xc.numpy(), k.numpy(), kw_eff.numpy()
    q = (x @ qw + qb).double().numpy()
    cta, rp, cd = (t.double().numpy() for t in (ct_ax, recip_p, ct_den))
    rows = g.row_by_col.numpy()
    n, d = x.shape
    att = q.shape[1]
    ptr, col, slot = (getattr(pieces, k_).numpy() for k_ in
                      ("ptr", "col", "slot"))
    dx, dkn = np.zeros((n, d)), np.zeros((n, att))
    part = np.zeros((pieces.n_slots, d + att))
    for pi in range(pieces.n_pieces):                       # pass 1
        c = col[pi]
        dxa, dka = np.zeros(d), np.zeros(att)
        for j in range(ptr[pi], ptr[pi + 1]):
            r = rows[j]
            wsum, dk = _edge_terms(q[r], k[c], score, heads, var, ls,
                                   float(gmax[0]), cta[r] @ xc[c], rp[r],
                                   cd[r])
            dka += dk
            dxa += wsum * cta[r]
        if slot[pi] < 0:
            dkn[c], dx[c] = dka, dxa + dka @ kw_eff.T
        else:
            part[slot[pi]] = np.concatenate([dxa, dka])
    mp = pieces.multi_ptr.numpy()
    for m, c in enumerate(pieces.multi_col.numpy()):         # pass 2
        summed = np.zeros(d + att)
        for s in range(mp[m], mp[m + 1]):
            summed += part[s]
        dkn[c] = summed[d:]
        dx[c] = summed[:d] + summed[d:] @ kw_eff.T
    return dx, xc.T @ dkn, dkn.sum(0)


@pytest.mark.parametrize("piece", [4, COL_PIECE])
@pytest.mark.parametrize("table", ["float32", "bfloat16"])
@pytest.mark.parametrize("score", ["scaled_dot", BELTRAMI])
def test_k17_two_passes_equal_plain(score, table, piece):
    """The mirror of K17's two passes over a hub graph equals
    ``fused_rhs_bwd_col_plain`` (dx, dkw, dkb within 1e-5 of scale), in
    float32 and on the bfloat16 column table."""
    g = _hub_graph()
    ops, kw_f = _operands(g, score, 22)
    xcol = ops[0].to(torch.bfloat16) if table == "bfloat16" else None
    pieces = column_pieces(g.colptr, piece)
    assert pieces.n_multi > 0 and pieces.longest >= HUB_DEG
    want = kernels.fused_rhs_bwd_col_plain(
        g.colptr, g.col_by_col, g.row_by_col, *ops, xcol=xcol, **kw_f)
    got = _k17_passes(g, pieces, ops, kw_f, xcol)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


def test_k17_plain_on_the_hub_graph_matches_jax_colplan(monkeypatch):
    """On the hub graph the port's column-plan backward (K8 without dxg and
    K17's plain version) against the JAX package's make_fused_ax_colplan,
    Pallas in interpret mode on a stripe plan with its column plan: the
    gradient of sum(ax * ct) in Q, K, x and gmax, at that engine's bf16
    tolerance, 5e-2 of the largest gradient."""
    calls = []
    real = kernels.fused_rhs.fused_rhs_bwd_col
    monkeypatch.setattr(kernels.fused_rhs, "fused_rhs_bwd_col",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    row, col, n = _hub_edges(23, n=128, extra=300, hub_deg=100)
    d, att, heads = 8, 16, 4
    kw = dict(function="transformer", block="constant", attention_norm_idx=0,
              square_plus=False, self_loop_weight=1.0, hidden_dim=d,
              attention_dim=att, heads=heads)
    jcfg = JConfig(**kw).replace(stripe_fused=True, stripe_block_n=32,
                                 stripe_chunk=64, stripe_chunk_auto=False)
    jg = jblocks.prepare_graph(jcfg, j_make_graph(row, col, None,
                                                  num_nodes=n))
    jg2, plan = jblocks.build_stripe_engine(jcfg, jg)
    assert plan.col_plan is not None and not plan.symmetric
    tg = prepare_graph(Config(**kw), make_graph(row, col, num_nodes=n))
    assert tg.col_pieces.n_multi > 0
    rng = np.random.default_rng(24)
    f32 = np.float32
    x = rng.normal(size=(n, d)).astype(f32)
    qw, kw_ = ((0.3 * rng.normal(size=(d, att))).astype(f32)
               for _ in range(2))
    qb, kb = ((0.1 * rng.normal(size=att)).astype(f32) for _ in range(2))
    ct = rng.normal(size=(n, d)).astype(f32)
    gmax = np.array([0.25], f32)
    op = jfused.make_fused_ax_colplan(plan, heads, False, "scaled_dot",
                                      jg2.col, None)

    def jloss(*a):
        return jnp.sum(op(*a, ())[0] * ct)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (qw, qb, kw_, kb, x)), jnp.asarray(gmax[0]))
    ops = [torch.tensor(a, requires_grad=True)
           for a in (qw, qb, kw_, kb, x, gmax)]
    ax, _ = kernels.make_fused_ax_colplan(tg, heads, False, "scaled_dot")(
        *ops, ())
    got = torch.autograd.grad(torch.sum(ax * torch.tensor(ct)), ops)
    assert calls
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g_, w in zip(got, want):
        err = np.abs(g_.numpy().reshape(-1) - np.asarray(w).reshape(-1))
        assert err.max() / scale < 5e-2
