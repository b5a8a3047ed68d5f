"""The exact re-solve's own kernels on the CPU, where they cannot run: K8
``fused_rhs_bwd`` with its per-edge dxg and K7 ``fused_rowmax``, as numpy
mirrors of the order in which they visit and sum their operands
(``csrc/fused_bwd_rows.cuh``, ``csrc/fused_bwd_edges.cu``,
``csrc/fused_fwd.cu``), held against the plain versions that define them.

* K8 with dxg in three passes. The walk over row pieces (K9's lane
  layout, ``Lanes`` of ``test_torch_port_sym_walk.py``) writes each edge's
  dk_e, lane by lane from the coefficients of ``sym_backward_piece``
  (K9's mirror's ``_coefs``), and w_e = sum_h u_eh recip_p[n, h], summed a
  lane over its tiles and folded over the head groups; dq, dgmax and the
  score scalars are the walk of K8 without dxg
  (``test_torch_port_den_walk.py``'s ``_rows_walk``). The dxg pass forms
  dk_e Kw^T as the tensor cores do: each float32 operand split into two
  TF32 values (rounded big part, truncated rest), three products a k8
  step, two k8 steps a partial sum, the partials added in float32; the
  epilogue adds w_e ct_ax[row_e] in one fused multiply-add and writes
  zeros past the valid edges. dkw and dkb from the mirrored dk_e. Every
  score family, squareplus, float32 and the bfloat16 column table beside
  a bfloat16 row side, the exact mode's per-edge shifts, the three ways of
  summing a head, and a graph with padding slots, against
  ``fused_rhs_bwd_plain`` (1e-5 of scale).
* K7 over row pieces: the column indices of a piece, its edges in batches
  of ``ROWMAX_BATCH`` (the last batch's index clamped, its extra edges
  masked), each piece's maxima, the partials of multi-piece rows merged in
  piece order, 0 on edgeless rows. Fed the plain version's own scores it
  equals ``fused_rowmax_plain`` exactly (a maximum is exact) on a hub
  graph, pieces of 4 edges and whole rows, float32 and the bf16 k table;
  fed the kernel's lane-order scores (``fwd_score``, the forward walk's
  mirror) it is within 1e-6 of it.
* One case each against the TPU kernels P10 (``fused_rowmax``) and P11
  (``_fused_bwd_mega_call`` with dxg, ``recip_p`` and per-head shifts),
  Pallas in interpret mode in float32 (1e-4 of scale), through the plain
  versions, as ``test_torch_port_fused.py`` calls them.

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.kernels import fused_rhs as F
from graph_neural_pde_tpu_torch.ops.graph import column_pieces, make_graph
from test_torch_port_den_walk import (_kw64, _operands, _rows_walk, _Tables,
                                      _tables_of, _wide)
from test_torch_port_fused import Case
from test_torch_port_fwd_walk import _directed_hub_graph, _scores
from test_torch_port_sym_walk import (BELTRAMI, HEAD_MODES, SCORES, Lanes,
                                      _coefs, _rel, _u_duds)

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


# ---------------------------------------------------------------------------
# K8 with dxg
# ---------------------------------------------------------------------------

def _edge_terms(g, ops, cts, kw_f, xcol, square_plus, shifts=None):
    """The walk's per-edge outputs in numpy, lane by lane in the kernel's
    layout and order (float32): dk_e [E_pad, ATT] and w_e [E_pad], zero on
    the padding (the dxg pass zeroes dk_e there)."""
    tb = _Tables(ops, kw_f, xcol)
    ln, score, var, ls, att = tb.ln, tb.score, tb.var, tb.ls, tb.att
    cta = cts[0].numpy()
    rp, cd = cts[1].numpy(), cts[2].numpy()
    sh = None if shifts is None else shifts.numpy()
    row, col = g.row.numpy(), g.col.numpy()
    dke = np.zeros((g.capacity, att), f32)
    w = np.zeros(g.capacity, f32)
    for e in range(g.num_valid):
        r, c = row[e], col[e]
        qn, kc = tb.arow(tb.q, r), tb.arow(tb.k, c)
        rg, ctd = rp[r][ln.head], cd[r][ln.head]            # [KA, G]
        hv = np.zeros_like(qn) if sh is None else np.where(
            ln.valid, sh[e][ln.head], 0).astype(f32)
        dot = tb.dot(tb.drow(cta, r), tb.drow(tb.xc, c))
        cf = _coefs(ln, score, var, ls, qn, kc)
        u, duds = _u_duds((cf[0] - tb.gm) - hv, square_plus)
        ds = (rg * dot + ctd) * duds
        dk = cf[1] * ds * (qn - cf[4]) - cf[3] * ds * (kc - cf[5])
        dke[e] = dk.reshape(-1)[:att]
        wl = np.zeros(G, f32)
        for j in range(ln.ka):                # the lane's tiles, in order
            wl = wl + np.where(ln.once[j], rg[j] * u[j], 0).astype(f32)
        w[e] = ln.fold_heads(wl)[0]
    return dke, w


def _tf32_split(v):
    """tf32_split: v = big + small, big rounded to TF32 (an integer add and
    a mask), small the rest, whose low 13 bits the tensor cores drop."""
    v = np.ascontiguousarray(v, f32)
    big = ((v.view(np.uint32) + np.uint32(0x1000))
           & np.uint32(0xffffe000)).view(f32)
    small = (v - big).astype(f32)
    return big, (small.view(np.uint32) & np.uint32(0xffffe000)).view(f32)


def _mma(c, a, b):
    """c + a b of one m16n8k8 step, the products summed exactly and the
    sum rounded once to float32."""
    return (c.astype(np.float64) + a.astype(np.float64)
            @ b.astype(np.float64)).astype(f32)


def _dxg_pass(dke, w, row, valid, ct_ax, kw_t):
    """The dxg pass in numpy (edge_project_kernel over project_mma): dk Kw^T
    on the split operands, two k8 steps a partial sum (their six products
    small terms first), the partials added in float32 in column order,
    then dxg = fmaf(w_e, ct_ax[row_e], sum); zeros past the valid edges."""
    cap, att = dke.shape
    kpad = -(-att // 32) * 32                  # a stage's 32 columns
    a = np.zeros((cap, kpad), f32)
    a[:, :att] = dke
    b = np.zeros((kpad, kw_t.shape[1]), f32)
    b[:att] = kw_t
    (ab, as_), (bb, bs) = _tf32_split(a), _tf32_split(b)
    acc = np.zeros((cap, b.shape[1]), f32)
    for k in range(0, kpad, 16):
        part = np.zeros_like(acc)
        for k8 in (k, k + 8):
            s = slice(k8, k8 + 8)
            part = _mma(part, as_[:, s], bb[s])
            part = _mma(part, ab[:, s], bs[s])
            part = _mma(part, ab[:, s], bb[s])
        acc = (acc + part).astype(f32)
    out = np.zeros_like(acc)
    out[:valid] = (w[:valid, None].astype(np.float64) * ct_ax[row[:valid]]
                   + acc[:valid]).astype(f32)
    return out


def _dxg_mirror(g, ops, cts, kw_f, xcol, square_plus, shifts=None):
    """K8 with dxg's three passes in numpy: the wrapper's tuple (dq, dxg,
    dkw, dkb, dgmax, dvar, dls)."""
    dq, _, _, _, dgmax, dvar, dls = _rows_walk(
        g, ops, cts, kw_f, xcol, g.row_pieces, square_plus, shifts)
    dke, w = _edge_terms(g, ops, cts, kw_f, xcol, square_plus, shifts)
    kw = ops[3] if xcol is None else F.bf16_round(ops[3])
    dxg = _dxg_pass(dke, w, g.row.numpy(), g.num_valid, cts[0].numpy(),
                    kw.numpy().T)
    xc = (ops[0] if xcol is None else xcol).double().numpy()
    xe = xc[g.col.numpy()]
    dkw = xe.T @ dke.astype(np.float64)
    return dq, dxg, dkw, dke.sum(0, dtype=np.float64), dgmax, dvar, dls


def _check_dxg(g, ops, cts, kw_f, xcol, square_plus, shifts):
    got = _dxg_mirror(g, ops, cts, kw_f, xcol, square_plus, shifts)
    want = kernels.fused_rhs_bwd_plain(
        g.rowptr, g.row, g.col, *_wide(ops), *(t.double() for t in cts),
        xcol=xcol, square_plus=square_plus,
        shifts=None if shifts is None else shifts.double(), **_kw64(kw_f))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None)
        if b is not None:
            assert _rel(np.asarray(a, np.float64).reshape(-1),
                        b.reshape(-1)) < 1e-5, i
    return got


@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("table", ["float32", "bfloat16"])
def test_dxg_mirror_equals_plain(score, table):
    """K8 with dxg, mirrored over a directed hub graph (its pieces of 32
    edges, rows without edges at its end), with the exact mode's per-edge
    shifts, equals the plain version in every output within 1e-5 of
    scale: D = 12, ATT = 16 (32 packed for exp_kernel_beltrami), 4
    heads."""
    g = _directed_hub_graph(n=48)
    att = 32 if score == BELTRAMI else 16
    ops, cts, shifts, kw_f = _operands(g, 12, att, 4, score, 11)
    ops, xcol = _tables_of(ops, table)
    assert g.row_pieces.n_multi > 0
    _check_dxg(g, ops, cts, kw_f, xcol, False, shifts)


@pytest.mark.parametrize("shifted", [False, True])
def test_dxg_mirror_squareplus(shifted):
    """The same with squareplus in place of exp, with and without
    shifts."""
    g = _directed_hub_graph()
    ops, cts, shifts, kw_f = _operands(g, 12, 16, 4, "scaled_dot", 12)
    _check_dxg(g, ops, cts, kw_f, None, True, shifts if shifted else None)


@pytest.mark.parametrize("head_sum", ["lanes", "tiles", "buffer"])
def test_dxg_mirror_head_modes(head_sum):
    """Each way the walk sums a head (``make_heads``), and ATT past one
    stage of the dxg pass (128 columns: four stages of 32), within 1e-5
    of scale."""
    d, att, heads = HEAD_MODES[head_sum]
    g = _directed_hub_graph()
    ops, cts, shifts, kw_f = _operands(g, d, att, heads, "scaled_dot", 13)
    assert Lanes(att, heads, "scaled_dot").mode == head_sum
    _check_dxg(g, ops, cts, kw_f, None, False, shifts)


def test_dxg_pass_writes_the_padding():
    """On a graph whose capacity passes its valid edges, dxg is zero on
    the padding slots (the kernel writes every slot, no memset) and the
    valid slots hold the plain version's."""
    rng = np.random.default_rng(14)
    n = 30
    u, v = rng.integers(0, n, 90), rng.integers(0, n, 90)
    g = make_graph(np.concatenate([u, np.arange(n)]),
                   np.concatenate([v, np.arange(n)]), num_nodes=n,
                   pad_multiple=64).sort_by_row()
    assert g.capacity > g.num_valid
    ops, cts, shifts, kw_f = _operands(g, 12, 16, 4, "scaled_dot", 15)
    got = _check_dxg(g, ops, cts, kw_f, None, False, shifts)
    assert not got[1][g.num_valid:].any()


def test_dxg_pass_split_holds_float32():
    """The dxg pass alone at a width where the split matters (ATT = 256,
    D = 96, values of mixed size): within 1e-6 of the float64 product,
    and the TF32 rounding alone (the big parts' product) is not."""
    rng = np.random.default_rng(16)
    dke = (rng.normal(size=(200, 256)) * np.exp(rng.normal(size=(200, 1)))
           ).astype(f32)
    kw_t = rng.normal(size=(256, 96)).astype(f32)
    w = rng.normal(size=200).astype(f32)
    ct = rng.normal(size=(10, 96)).astype(f32)
    row = np.sort(rng.integers(0, 10, 200))
    got = _dxg_pass(dke, w, row, 200, ct, kw_t)
    want = (w[:, None].astype(np.float64) * ct[row]
            + dke.astype(np.float64) @ kw_t.astype(np.float64))
    assert _rel(got, want) < 1e-6
    big = _tf32_split(dke)[0].astype(np.float64) @ _tf32_split(kw_t)[0]
    assert _rel(w[:, None] * ct[row] + big, want) > 1e-5


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _rowmax_walk(g, pieces, heads, scores):
    """K7's walk in numpy: ``scores(e)`` is edge e's [H] scores. Each piece
    takes its edges in batches of ``ROWMAX_BATCH`` (an index past the
    piece clamped to its last edge, the extra scores dropped), fmaxf over
    them; a row of one piece writes its maxima, non-finite ones 0; the
    partials of a longer row are merged in piece order."""
    n = g.num_nodes
    smax = np.zeros((n, heads), f32)
    ptr, prow, slot = (getattr(pieces, k).numpy() for k in
                       ("ptr", "col", "slot"))
    part = np.zeros((pieces.n_slots, heads), f32)
    batch = F.ROWMAX_BATCH
    for pi in range(pieces.n_pieces):
        m = np.full(heads, -np.inf, f32)
        start, end = ptr[pi], ptr[pi + 1]
        for base in range(start, end, G):
            cnt = min(G, end - base)
            for i in range(0, cnt, batch):
                got = [scores(base + min(i + b, cnt - 1))
                       for b in range(batch)]
                for b in range(batch):
                    if i + b < cnt:
                        m = np.fmax(m, got[b])
        if slot[pi] >= 0:
            part[slot[pi]] = m
        else:
            smax[prow[pi]] = np.where(np.isfinite(m), m, 0)
    mp = pieces.multi_ptr.numpy()
    for mi, r in enumerate(pieces.multi_col.numpy()):   # the merge
        m = np.full(heads, -np.inf, f32)
        for s in range(mp[mi], mp[mi + 1]):
            m = np.fmax(m, part[s])
        smax[r] = np.where(np.isfinite(m), m, 0)
    return smax


def _plain_scores(g, ops, heads, xcol):
    """The plain version's own scores [E, H] (``edge_scores`` over the
    same gathered rows)."""
    x, qw, qb, kw, kb = ops[:5]
    nv, r, c = F._edges(g.rowptr, g.row, g.col)
    xw, _, ke, _ = F._col_side(x, xcol, kw, kb, c)
    src = (xw @ qw + qb)[r].reshape(nv, heads, -1)
    return F.edge_scores(src, ke.reshape(nv, heads, -1),
                         "scaled_dot").numpy()


@pytest.mark.parametrize("table", ["float32", "bfloat16"])
@pytest.mark.parametrize("piece", [4, None])
def test_rowmax_mirror_equals_plain_exactly(table, piece):
    """K7's pieces, batches and merge, fed the plain version's scores,
    equal ``fused_rowmax_plain`` bit for bit over a directed hub graph
    (pieces of 4 edges, whose hub row takes the merge, or whole rows;
    rows without edges give 0)."""
    g = _directed_hub_graph()
    ops, _, _, kw_f = _operands(g, 12, 16, 4, "scaled_dot", 17)
    ops, xcol = _tables_of(ops, table)
    pieces = column_pieces(g.rowptr, piece or 1 << 30)
    assert (pieces.n_multi > 0) == (piece is not None)
    s = _plain_scores(g, ops, 4, xcol)
    got = _rowmax_walk(g, pieces, 4, lambda e: s[e])
    want = kernels.fused_rowmax_plain(g.rowptr, g.row, g.col, *ops[:5],
                                      heads=4, xcol=xcol).numpy()
    assert np.array_equal(got, want)
    assert (got[-1] == 0).all()                # an edgeless row


@pytest.mark.parametrize("att, heads", [(16, 4), (128, 8), (256, 2)])
def test_rowmax_mirror_lane_scores(att, heads):
    """K7 fed the kernel's lane-order scores (``fwd_score``: the products
    rounded, each head's segmented butterfly, lane h reading head h)
    within 1e-6 of ``fused_rowmax_plain``, at one tile of ATT, four and
    eight."""
    g = _directed_hub_graph()
    ops, _, _, kw_f = _operands(g, 12, att, heads, "scaled_dot", 18)
    tb = _Tables(ops, kw_f, None)
    row, col = g.row.numpy(), g.col.numpy()

    def scores(e):
        s = _scores(tb.ln, "scaled_dot", tb.var, tb.ls, tb.arow(tb.q, row[e]),
                    tb.arow(tb.k, col[e]), tb.hl)
        return s[:heads]
    got = _rowmax_walk(g, g.row_pieces, heads, scores)
    want = kernels.fused_rowmax_plain(g.rowptr, g.row, g.col, *ops[:5],
                                      heads=heads).numpy()
    assert _rel(got, want) < 1e-6


# ---------------------------------------------------------------------------
# the wrappers and the designs on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_take_the_row_pieces_on_the_cpu():
    """On CPU tensors K7 and K8 with dxg run their plain versions: handed
    the graph's row pieces they return what the plain versions return,
    build no pieces and count no launch."""
    g = _directed_hub_graph()
    ops, cts, shifts, kw_f = _operands(g, 12, 16, 4, "scaled_dot", 19)
    csr = (g.rowptr, g.row, g.col)
    before = (kernels.fused_rowmax.launches, kernels.fused_rhs_bwd.launches,
              kernels.fused_rowmax.piece_builds)
    assert torch.equal(
        kernels.fused_rowmax(*csr, *ops[:5], heads=4, pieces=g.row_pieces),
        kernels.fused_rowmax_plain(*csr, *ops[:5], heads=4))
    got = kernels.fused_rhs_bwd(*csr, *ops, *cts, shifts=shifts,
                                pieces=g.row_pieces, **kw_f)
    want = kernels.fused_rhs_bwd_plain(*csr, *ops, *cts, shifts=shifts,
                                       **kw_f)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, want))
    assert (kernels.fused_rowmax.launches, kernels.fused_rhs_bwd.launches,
            kernels.fused_rowmax.piece_builds) == before
    assert kernels.fused_rowmax in kernels.ROW_WALKS


@pytest.mark.parametrize("d, att, heads, score, want", [
    (80, 128, 8, "scaled_dot",
     dict(kd=1, ka=4, head_sum="lanes", rows=128, cols=64, groups=2,
          ksteps=4)),
    (128, 32, 2, "scaled_dot",
     dict(kd=1, ka=1, head_sum="lanes", rows=128, cols=64, groups=2,
          ksteps=1)),
    (96, 256, 8, BELTRAMI,
     dict(kd=1, ka=8, head_sum="lanes", rows=128, cols=64, groups=2,
          ksteps=8))])
def test_designs(d, att, heads, score, want):
    """What ``chip_smoke.py`` prints for K8 with dxg (the walk's tiles and
    the dxg pass's tile) and K7 (K6's tiles and its batch) at the Cora,
    arxiv and kNN Cora BLEND widths."""
    assert F.dxg_design(d, att, heads, score) == want
    assert F.rowmax_design(att, heads) == dict(
        ka=want["ka"], head_sum="lanes", batch=F.ROWMAX_BATCH)


# ---------------------------------------------------------------------------
# against the TPU kernels (Pallas in interpret mode)
# ---------------------------------------------------------------------------

def test_rowmax_plain_matches_p10():
    """``fused_rowmax_plain`` against P10 ``fused_rowmax`` in interpret mode
    (float32) on ``test_torch_port_fused.py``'s SBM case: within 1e-5 of
    scale."""
    c = Case("scaled_dot", seed=20)
    qw, qb, kw_, kb, x = c.j_ops()
    want = jfused.fused_rowmax(c.plan, x @ qw + qb, kw_, kb, heads=4,
                               x_g=x[c.jg.col], dtype=jnp.float32,
                               interpret=True)[:, :4]
    ops = c.t_ops()
    got = kernels.fused_rowmax_plain(*c.t_csr(), ops[4], *ops[:4], heads=4)
    assert _rel(got, np.asarray(want)) < 1e-5


def test_dxg_plain_matches_p11():
    """``fused_rhs_bwd_plain`` with the exact mode's shifts (K7's maxima of
    each side) against P11 ``_fused_bwd_mega_call`` with dxg, ``recip_p``
    and per-head shift arrays in interpret mode (the exact mode runs in
    float32): dq, dxg summed per column (the two graphs order their slots
    differently), dkw, dkb and dgmax within 1e-4 of scale."""
    c = Case("scaled_dot", seed=21)
    n, h = c.tg.num_nodes, 4
    qw, qb, kw_, kb, x = c.j_ops()
    rng = np.random.default_rng(22)
    recip_p = rng.uniform(0.05, 0.5, (n, h)).astype(f32)
    ct_den = (1.0 + 0.1 * rng.normal(size=(n, h))).astype(f32)
    pad = ((0, 0), (0, 8 - h))
    smax_j = jfused.fused_rowmax(c.plan, x @ qw + qb, kw_, kb, heads=h,
                                 x_g=x[c.jg.col], dtype=jnp.float32,
                                 interpret=True)
    dq_j, dxg_j, dkw_j, dkb_j, dgmax_j, _ = jfused._fused_bwd_mega_call(
        c.plan, qw, qb, kw_, kb, x, x[c.jg.col], jnp.asarray(c.gmax[0]),
        jnp.asarray(c.ct), jnp.pad(jnp.asarray(ct_den), pad), heads=h,
        square_plus=False, interpret=True, want_dxg=True,
        shifts=tuple(smax_j[:, k][c.jg.row] for k in range(h)),
        recip_p=jnp.pad(jnp.asarray(recip_p), pad))
    ops = c.t_ops()
    t_ops = (ops[4], *ops[:4], torch.tensor(c.gmax))
    smax = kernels.fused_rowmax_plain(*c.t_csr(), *t_ops[:5], heads=h)
    got = kernels.fused_rhs_bwd_plain(
        *c.t_csr(), *t_ops, torch.tensor(c.ct), torch.tensor(recip_p),
        torch.tensor(ct_den), heads=h, score="scaled_dot",
        shifts=smax[c.tg.row.long()].contiguous())

    def per_column(dxg, graph):
        out = np.zeros((n, dxg.shape[1]))
        valid = np.asarray(graph.mask, bool)
        np.add.at(out, np.asarray(graph.col)[valid], np.asarray(dxg)[valid])
        return out
    assert _rel(got[0], np.asarray(dq_j)) < 1e-4
    assert _rel(per_column(got[1].numpy(), c.tg),
                per_column(dxg_j, c.jg)) < 1e-4
    assert _rel(got[2], np.asarray(dkw_j)) < 1e-4
    assert _rel(got[3], np.asarray(dkb_j)) < 1e-4
    assert abs(float(got[4]) - float(dgmax_j)) < 1e-4 * abs(float(dgmax_j))
