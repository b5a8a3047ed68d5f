"""The forward walk of K6 ``fused_rhs_fwd`` and K13 ``norm1_fwd`` on the
CPU, where the kernel cannot run: a numpy mirror of the order in which it
visits and sums its operands (``csrc/fused_common.cuh``,
``fwd_walk_piece``, ``fwd_score`` and ``fwd_merge_rows``), held against
the plain versions that define the two kernels.

* The mirror keeps the kernel's lane layout (``Lanes`` of
  ``test_torch_port_sym_walk.py``): a warp walks an edge, lane l owning
  columns 4 (32 t + l) .. + 3 of a D-wide row and column 32 j + l of a q
  or k row. Each head's terms are summed by the segmented butterfly over
  its d_k lanes (over d_k / 32 tiles and then the lanes when d_k > 32, in
  column order through the warp's buffer when d_k is not a power of two or
  a beltrami half sits neither a tile nor a lane offset away); lane h then
  takes head h's sums from its slice (its feature and its position half's
  for exp_kernel_beltrami) and forms the score and u. K6 sums den and
  each head's numerator in lane order of edges, K13 weights each edge by
  the butterfly over the head lanes of u_h recip[c, h]; a row sums its
  edges in order within each piece, then the pieces in order, and K6
  finishes with ax = 1/H sum_h num_h recip_h in head order.
* It runs K6 (with its numerators, shifted, folded with the per-row NaN
  guard on a row forced to den = 0) over a directed hub graph, and K13
  over a symmetric one, for every score family, squareplus, float32 and
  the bfloat16 column table beside a bfloat16 row side, whole rows and
  pieces of 4 edges, and the three ways of summing a head, at 1e-5 of
  scale against ``fused_rhs_fwd_plain`` and ``norm1_fwd_plain``.
* One case each against the TPU kernels P7 (``make_fused_ax_sym``'s
  forward) and P15 (``_norm1_fwd_call``), Pallas in interpret mode, at
  their bfloat16 tolerance, 3e-2 of scale.
* ``Graph.row_pieces`` is ``column_pieces(rowptr)``, equal to the CSC
  view's ``col_pieces`` on a symmetric graph only.

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.kernels import fused_rhs as F
from graph_neural_pde_tpu_torch.kernels.fused_rhs import bf16_k_table
from graph_neural_pde_tpu_torch.ops.graph import (COL_PIECE, column_pieces,
                                                  make_graph)
from test_torch_port_sym_walk import (BELTRAMI, HEAD_MODES, SCORES, Lanes,
                                      _hub_graph, _rel, _sbm_graphs, _t_ops)

MODES = ("num", "shifted", "folded", "norm1")
EPS_NORM = np.float32(1e-5)
f32 = np.float32
G = 32


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _directed_hub_graph(n=24, seed=1):
    """A directed random graph whose row 0 is a hub of out-degree n - 1,
    far above the pieces of 4 edges the tests cut, and whose last rows may
    have no edge at all (no self-loops there)."""
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n - 4, 3 * n), rng.integers(0, n, 3 * n)
    loops = np.arange(n - 4)
    return make_graph(np.concatenate([u, np.zeros(n - 1, int), loops]),
                      np.concatenate([v, np.arange(1, n), loops]),
                      num_nodes=n).sort_by_row()


def _operands(g, d, att, heads, score, seed):
    """One forward's inputs over ``g`` as float32 tensors, with a recip
    table for K13 and per-edge shifts for K6's exact mode."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes

    def t(*shape, scale=1.0):
        return torch.tensor((scale * rng.normal(size=shape)).astype(f32))

    x = t(n, d)
    qw, kw = t(d, att, scale=d ** -0.5), t(d, att, scale=d ** -0.5)
    qb, kb = t(att, scale=0.1), t(att, scale=0.1)
    recip = torch.tensor(rng.uniform(0.05, 0.5, (n, heads)).astype(f32))
    shifts = t(g.capacity, heads, scale=0.5)
    sp = {}
    if score == "exp_kernel":
        sp = dict(var=torch.tensor([1.3]), ls=torch.tensor([0.8]))
    elif score == BELTRAMI:
        sp = dict(var=torch.tensor([1.3, 0.9]), ls=torch.tensor([0.8, 1.4]))
    ops = (x, qw, qb, kw, kb, torch.tensor([0.25]))
    return ops, recip, shifts, dict(heads=heads, score=score, **sp)


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def _gather(v, tile, src):
    """lane_gather: lane l reads v[tile[l], src[l]]."""
    return v[tile, src]


def _head_lanes(ln, att, heads):
    """head_lane: each lane's (tile, src) of its head's feature slice and
    position half (lanes >= H read head 0's)."""
    a = np.where(np.arange(G) < heads, np.arange(G), 0) * ln.d_k
    ap = att // 2 + a
    return (a // G, a % G), (ap // G, ap % G)


def _scores(ln, score, var, ls, qn, kc, hl):
    """fwd_score: every lane's score of head `lane` (valid at lanes < H),
    float32 in the kernel's order."""
    (tf, sf), (tp, spos) = hl
    if score in ("cosine_sim", "pearson"):
        mq = mk = np.zeros_like(qn)
        if score == "pearson":
            inv = f32(1) / f32(ln.d_k)
            mq = ln.slice_sums(qn) * inv
            mk = ln.slice_sums(kc) * inv
        a, b = qn - mq, kc - mk
        sp, ss, kk = (_gather(ln.slice_sums(t), tf, sf)
                      for t in (a * b, a * a, b * b))
        ns = np.maximum(np.sqrt(ss), EPS_NORM)
        nk = np.maximum(np.sqrt(kk), EPS_NORM)
        return sp * (f32(1) / (ns * nk))
    dot = score == "scaled_dot"
    t = ln.slice_sums(qn * kc if dot else (qn - kc) ** 2)
    own = _gather(t, tf, sf)
    if dot:
        return own * (f32(1) / np.sqrt(f32(ln.d_k)))
    s = f32(var[0] * var[0]) * np.exp(own * f32(-1 / (2 * ls[0] * ls[0])))
    if score == BELTRAMI:
        other = _gather(t, tp, spos)
        s = s * f32(var[1] * var[1]) * np.exp(
            other * f32(-1 / (2 * ls[1] * ls[1])))
    return s.astype(f32)


def _u(sm, square_plus):
    if square_plus:
        return (sm + np.sqrt(sm * sm + 4)) * f32(0.5)
    return np.exp(sm)


def _head_lanes_sum(v, heads):
    """head_lanes_sum: the xor butterfly over the first power of two >=
    H lanes, read from lane 0."""
    o, lanes = 1, np.arange(G)
    while o < heads:
        v = v + v[lanes ^ o]
        o *= 2
    return v[0]


def _walk(mode, g, ops, recip, shifts, kw_f, xcol, pieces, square_plus,
          alpha=None):
    """K6's (``mode`` num, shifted, folded) or K13's (norm1) walk in numpy,
    lane by lane in the kernel's layout and order (float32): returns what
    the wrapper returns."""
    x, qw, qb, kw, kb, gmax = ops
    heads, score = kw_f["heads"], kw_f["score"]
    var = kw_f["var"].numpy() if "var" in kw_f else np.ones(2, f32)
    ls = kw_f["ls"].numpy() if "ls" in kw_f else np.ones(2, f32)
    n, d = x.shape
    att = qw.shape[1]
    q = (x.float() @ qw + qb).numpy()
    if xcol is None:
        xc, k = x.numpy(), (x @ kw + kb).numpy()
    else:
        xc = xcol.float().numpy()
        k = bf16_k_table(xcol, kw, kb).float().numpy()
    xr = x.float().numpy()
    ln = Lanes(att, heads, score)
    hl = _head_lanes(ln, att, heads)
    kd = -(-d // (4 * G))
    gm = f32(gmax[0])
    col, rp = g.col.numpy(), g.rowptr.numpy()
    rc = recip.numpy()
    sh = shifts.numpy() if mode in ("shifted", "folded") else None
    head = np.arange(G) < heads

    def drow(table, r):                      # [KD * G * 4], zero beyond D
        out = np.zeros(kd * G * 4, f32)
        out[:d] = table[r]
        return out

    def arow(table, r):                      # [KA, G], zero beyond A
        out = np.zeros(ln.ka * G, f32)
        out[:att] = table[r]
        return out.reshape(ln.ka, G)

    out, den_o = np.zeros((n, d), f32), np.zeros((n, heads), f32)
    num_o = np.zeros((n, heads, d), f32)
    ptr, prow, slot = (getattr(pieces, k_).numpy() for k_ in
                       ("ptr", "col", "slot"))
    width = d if mode == "norm1" else heads * (d + 1)
    part = np.zeros((pieces.n_slots, width), f32)

    def finish(r, num, den):                 # fwd_finish_rhs
        recip_h = f32(1) / (den + f32(1e-16))
        ax = np.zeros(kd * G * 4, f32)
        for h in range(heads):
            ax = num[h] * recip_h[h] + ax
        v = ax[:d] * (f32(1) / f32(heads))
        if alpha is not None:
            edges = rp[r + 1] > rp[r]
            bad = np.any(((den <= 0) & edges) | ~np.isfinite(den))
            v = np.full(d, np.nan, f32) if bad else alpha * (v - xr[r])
        out[r], den_o[r], num_o[r] = v, den, num[:, :d]

    for pi in range(pieces.n_pieces):
        r = prow[pi]
        qn = arow(q, r)
        acc = np.zeros((heads, kd * G * 4), f32)
        den = np.zeros(G, f32)
        for e in range(ptr[pi], ptr[pi + 1]):
            c = col[e]
            x_c, kc = drow(xc, c), arow(k, c)
            s = _scores(ln, score, var, ls, qn, kc, hl)
            if mode == "norm1":
                u = np.where(head, _u(s - gm, square_plus), 0)
                hv = np.where(head, np.pad(rc[c], (0, G - heads)), 0)
                w = _head_lanes_sum((u * hv).astype(f32), heads)
                acc[0] = w * x_c + acc[0]
                continue
            hv = np.zeros(G, f32) if sh is None else np.pad(
                sh[e], (0, G - heads))
            u = np.where(head, _u((s - gm) - hv, square_plus), 0)
            den = den + u
            for h in range(heads):
                acc[h] = u[h] * x_c + acc[h]
        if mode == "norm1":
            if slot[pi] >= 0:
                part[slot[pi]] = acc[0][:d]
            else:
                out[r] = acc[0][:d] * (f32(1) / f32(heads))
        elif slot[pi] >= 0:
            part[slot[pi]] = np.concatenate([acc[:, :d].reshape(-1),
                                             den[:heads]])
        else:
            finish(r, acc, den[:heads])
    mp = pieces.multi_ptr.numpy()
    for m, r in enumerate(pieces.multi_col.numpy()):   # the second pass
        s = np.zeros(width, f32)
        for j in range(mp[m], mp[m + 1]):
            s = s + part[j]
        if mode == "norm1":
            out[r] = s * (f32(1) / f32(heads))
        else:
            num = np.zeros((heads, kd * G * 4), f32)
            num[:, :d] = s[:heads * d].reshape(heads, d)
            finish(r, num, s[heads * d:])
    if mode == "norm1":
        return (out,)
    return out, den_o, num_o.reshape(n, heads * d)


def _plain(mode, g, ops, recip, shifts, kw_f, xcol, square_plus,
           alpha=None):
    """The plain version in float64 beside the same tables."""
    x = ops[0]
    wide = [x if x.dtype == torch.bfloat16 else x.double(),
            *(t.double() for t in ops[1:])]
    kw = {k: (v.double() if torch.is_tensor(v) else v)
          for k, v in kw_f.items()}
    csr = (g.rowptr, g.row, g.col)
    if mode == "norm1":
        return (kernels.norm1_fwd_plain(*csr, *wide, recip.double(),
                                        xcol=xcol, square_plus=square_plus,
                                        **kw),)
    extra = {}
    if mode in ("shifted", "folded"):
        extra["shifts"] = shifts.double()
    if alpha is not None:
        extra["alpha"] = torch.tensor([float(alpha)], dtype=torch.float64)
    return kernels.fused_rhs_fwd_plain(*csr, *wide, xcol=xcol,
                                       square_plus=square_plus,
                                       want_num=True, **extra, **kw)


def _check(mode, g, ops, recip, shifts, kw_f, xcol, pieces,
           square_plus=False):
    alpha = f32(0.37) if mode == "folded" else None
    if mode == "folded" and not square_plus:
        # row 1's scores far below its shifts: every exp underflows (a
        # squareplus stays positive, and in float32 cancels there)
        shifts = shifts.clone()
        rp = g.rowptr
        shifts[int(rp[1]):int(rp[2])] = 1e3
    got = _walk(mode, g, ops, recip, shifts, kw_f, xcol, pieces, square_plus,
                alpha)
    want = _plain(mode, g, ops, recip, shifts, kw_f, xcol, square_plus,
                  alpha)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = b.numpy()
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan)
        assert _rel(np.where(nan, 0, a).astype(np.float64).reshape(-1),
                    np.where(nan, 0, b).reshape(-1)) < 1e-5
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("table", ["float32", "bfloat16"])
@pytest.mark.parametrize("piece", [4, None])
def test_walk_mirror_equals_plain(mode, score, square_plus, table, piece):
    """The mirror of the walk (pieces of 4 edges, whose hub row takes the
    second pass, or whole rows) equals the plain version, every output
    within 1e-5 of scale: D = 12, ATT = 16 (32 packed for
    exp_kernel_beltrami), 4 heads; K6 over a directed hub graph, K13 over
    a symmetric one; float32, and the bfloat16 column table beside a
    bfloat16 row side (the bf16 ODE state)."""
    g = _hub_graph() if mode == "norm1" else _directed_hub_graph()
    att = 32 if score == BELTRAMI else 16
    ops, recip, shifts, kw_f = _operands(g, 12, att, 4, score, 5)
    xcol = None
    if table == "bfloat16":
        xcol = ops[0].to(torch.bfloat16)
        ops = (xcol,) + ops[1:]
    pieces = column_pieces(g.rowptr, piece or 1 << 30)
    assert (pieces.n_multi > 0) == (piece is not None)
    got = _check(mode, g, ops, recip, shifts, kw_f, xcol, pieces,
                 square_plus)
    if mode == "folded" and not square_plus:   # the guard's row is NaN
        assert np.isnan(got[0][1]).all() and not np.isnan(got[0][2]).any()


@pytest.mark.parametrize("mode", ["num", "norm1"])
@pytest.mark.parametrize("score", ["scaled_dot", "pearson", BELTRAMI])
@pytest.mark.parametrize("head_sum", sorted(HEAD_MODES))
def test_walk_mirror_head_modes(mode, score, head_sum):
    """Each way the walk sums a head (``make_heads``) through the mirror
    against the plain version (1e-5 of scale), pieces of 8 edges."""
    d, att, heads = HEAD_MODES[head_sum]
    g = _hub_graph() if mode == "norm1" else _directed_hub_graph()
    ops, recip, shifts, kw_f = _operands(g, d, att, heads, score, 6)
    ln = Lanes(att, heads, score)
    if head_sum != "beltrami buffer" or score == BELTRAMI:
        assert ln.mode == head_sum.split()[-1]
    _check(mode, g, ops, recip, shifts, kw_f, None,
           column_pieces(g.rowptr, 8))


def test_exact_shifts_give_unit_den_on_one_edge_rows():
    """The satellite's exactness in the mirror: with gmax = 0 and K7's row
    maxima (taken in fwd_score's order) as the shifts, a graph of one-edge
    rows gets den exactly 1 in every head."""
    n, heads = 20, 4
    rng = np.random.default_rng(7)
    g = make_graph(np.arange(n), rng.permutation(n),
                   num_nodes=n).sort_by_row()
    ops, recip, _, kw_f = _operands(g, 12, 16, heads, "scaled_dot", 8)
    ops = ops[:5] + (torch.zeros(1),)
    x, qw, qb, kw, kb, _ = ops
    ln = Lanes(16, heads, "scaled_dot")
    hl = _head_lanes(ln, 16, heads)
    q, k = (x @ qw + qb).numpy(), (x @ kw + kb).numpy()

    def arow(t, r):
        return np.pad(t[r], (0, ln.ka * G - 16)).reshape(ln.ka, G)

    smax = np.stack([_scores(ln, "scaled_dot", None, None, arow(q, r),
                             arow(k, int(g.col[r])), hl)[:heads]
                     for r in range(n)])
    shifts = torch.tensor(smax)[g.row.long()]
    _, den, _ = _walk("shifted", g, ops, recip, shifts, kw_f, None,
                      g.row_pieces, False)
    assert np.array_equal(den, np.ones((n, heads), f32))


def test_fwd_design():
    """``fwd_design``: K9's tiles and way of summing a head, and the heads
    whose numerators K6 keeps in registers (2, or 8 at D <= 128 beyond 2
    heads), as csrc/fused_common.cuh's launch_fwd_heads picks them."""
    cases = {(128, 32, 2, "scaled_dot"): (1, 1, "lanes", 2),
             (80, 128, 8, "scaled_dot"): (1, 4, "lanes", 8),
             (96, 256, 8, BELTRAMI): (1, 8, "lanes", 8),
             (256, 64, 8, "exp_kernel"): (2, 2, "lanes", 2),
             (16, 16, 4, "cosine_sim"): (1, 2, "lanes", 8),
             (12, 24, 2, "scaled_dot"): (1, 1, "buffer", 2)}
    for (d, att, h, score), (kd, ka, mode, kh) in cases.items():
        assert F.fwd_design(d, att, h, score) == dict(kd=kd, ka=ka,
                                                      head_sum=mode, kh=kh)


# ---------------------------------------------------------------------------
# the row pieces
# ---------------------------------------------------------------------------

def test_graph_row_pieces():
    """``Graph.row_pieces`` is ``column_pieces(rowptr)`` (every edge once,
    in CSR order, in a piece of at most ``COL_PIECE`` edges of its row),
    moves with the graph, and equals the CSC view's ``col_pieces`` on a
    symmetric graph, not on a directed one."""
    for g, symmetric in ((_hub_graph(40), True),
                         (_directed_hub_graph(40), False)):
        assert (g.rev is not None) == symmetric
        pc, want = g.row_pieces, column_pieces(g.rowptr)
        for k in ("ptr", "col", "slot", "multi_col", "multi_ptr"):
            assert torch.equal(getattr(pc, k), getattr(want, k))
            assert torch.equal(getattr(g.to("cpu").row_pieces, k),
                               getattr(pc, k))
        assert pc.piece == COL_PIECE and pc.n_multi > 0
        ptr, row = pc.ptr.numpy(), pc.col.numpy()
        rowptr = g.rowptr.numpy()
        assert (ptr[:-1] >= rowptr[row]).all()
        assert (ptr[1:] <= rowptr[row + 1]).all()
        assert ptr[0] == 0 and ptr[-1] == rowptr[-1]
        same = all(torch.equal(getattr(pc, k), getattr(g.col_pieces, k))
                   for k in ("ptr", "col", "slot"))
        assert same == symmetric


# ---------------------------------------------------------------------------
# against the TPU kernels (Pallas in interpret mode)
# ---------------------------------------------------------------------------

def test_walk_mirror_matches_p7():
    """K6's walk (the mirror, float32) against P7: ``make_fused_ax_sym``'s
    ax, Pallas in interpret mode over a stripe plan, within 3e-2 of scale
    (the TPU kernel's bfloat16 gathers)."""
    d, att, heads = 12, 16, 4
    kw = dict(function="transformer", block="constant", attention_norm_idx=0,
              square_plus=False, self_loop_weight=1.0, add_source=True,
              hidden_dim=d, attention_dim=att, heads=heads)
    jcfg = JConfig(**kw).replace(stripe_fused=True, stripe_block_n=8,
                                 stripe_chunk=16)
    jg, plan, tg = _sbm_graphs(jcfg, Config(**kw))
    (x, qw, qb, kw_, kb), _ = _t_ops(np.random.default_rng(4),
                                     tg.num_nodes, d, att)
    op = jfused.make_fused_ax_sym(plan, heads, False, "scaled_dot", jg.col,
                                  None)
    want = op(*map(jnp.asarray, (qw, qb, kw_, kb, x)), jnp.float32(0.25),
              ())[0]
    t = tuple(torch.tensor(a) for a in (x, qw, qb, kw_, kb,
                                        np.array([0.25], f32)))
    n = tg.num_nodes
    got = _walk("num", tg, t, torch.ones(n, heads),
                torch.zeros(tg.capacity, heads),
                dict(heads=heads, score="scaled_dot"), None, tg.row_pieces,
                False)
    assert _rel(got[0], np.asarray(want)) < 3e-2


def test_walk_mirror_matches_p15():
    """K13's walk (the mirror, float32) against P15 ``_norm1_fwd_call``,
    Pallas in interpret mode with its operands packed as
    ``make_fused_ax_norm1`` packs them (x and the projections padded to
    128 columns in the pair-decode order, bf16 pairs), from the same 1/den:
    within 3e-2 of scale."""
    d, att, heads = 8, 8, 2
    kw = dict(function="transformer", block="constant", attention_norm_idx=1,
              square_plus=False, add_source=True, attention_dim=att,
              attention_type="scaled_dot", heads=heads, hidden_dim=d)
    jcfg = JConfig(**kw).replace(stripe_fused=True, stripe_block_n=8,
                                 stripe_chunk=16, stripe_chunk_auto=False,
                                 rhs_payload_dtype="bfloat16")
    jg, plan, tg = _sbm_graphs(jcfg, Config(**kw))
    (x, qw, qb, kw_, kb), _ = _t_ops(np.random.default_rng(3),
                                     tg.num_nodes, d, att)
    gmax = np.array([0.25], f32)
    t = tuple(torch.tensor(a) for a in (x, qw, qb, kw_, kb, gmax))
    csr = (tg.rowptr, tg.row, tg.col)
    den = kernels.norm1_den_plain(*csr, *t, heads=heads, score="scaled_dot")
    recip = (1.0 / (den + 1e-16)).float()
    got = _walk("norm1", tg, t, recip, torch.zeros(tg.capacity, heads),
                dict(heads=heads, score="scaled_dot"), None, tg.row_pieces,
                False)
    pm = jnp.asarray(jfused._norm1_perm(128))
    pad = ((0, 0), (0, 128 - d))
    x_e = jnp.pad(jnp.asarray(x), pad) @ pm
    qw_e = pm.T @ jnp.pad(jnp.asarray(qw), ((0, 128 - d), (0, 0)))
    kw_e = pm.T @ jnp.pad(jnp.asarray(kw_), ((0, 128 - d), (0, 0)))
    pack = jfused._pack_x_recip(jnp.asarray(x), jnp.asarray(recip.numpy()),
                                max(8, heads))[jg.col]
    ax_e = jfused._norm1_fwd_call(
        plan, qw_e, jnp.asarray(qb), kw_e, jnp.asarray(kb), x_e, pack,
        jnp.asarray(gmax[0]), heads=heads, square_plus=False,
        score="scaled_dot", score_params=(), interpret=True)
    assert _rel(got[0], np.asarray((ax_e @ pm.T)[:, :d])) < 3e-2
