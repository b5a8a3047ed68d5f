"""The row walks of K12 ``norm1_den`` and of K8 ``fused_rhs_bwd`` without
its per-edge dxg on the CPU, where the kernels cannot run: numpy mirrors of
the order in which they visit and sum their operands
(``csrc/norm1_den.cu`` and ``csrc/fused_bwd_rows.cu``), held against the
plain versions that define the two kernels.

* The mirrors keep the kernels' lane layout (``Lanes`` of
  ``test_torch_port_sym_walk.py``): a warp walks an edge, lane l owning
  columns 4 (32 t + l) .. + 3 of a D-wide row and column 32 j + l of a q
  or k row. A D-wide dot is summed a lane's groups first, then over the
  warp by a butterfly; each head's terms are summed by the segmented
  butterfly over its lanes (the three ways of ``make_heads``).
* K12 scores the reverse edge (c, n) of each edge of row n as K13 does,
  q from the gathered node and k from the resident one (K13's mirror's
  ``_scores``), lane h keeping den_h, each term weighted by ct[c] . x[n]
  in the weighted mode. K8 without dxg scores each edge at every column
  (the coefficients of ``sym_backward_piece``, K9's mirror's ``_coefs``),
  sums dq[n] column by column and the row's scalar sums a lane, folded
  over the head groups at the end of a piece. A row sums its edges in
  order within each piece, then the pieces in order.
* Both modes of K12 over a symmetric hub graph, K8 without dxg (with and
  without the exact mode's per-edge shifts) over a directed one, every
  score family, squareplus, float32 and the bfloat16 column table beside
  a bfloat16 row side, pieces of 4 edges and whole rows, and the three
  ways of summing a head, at 1e-5 of scale against ``norm1_den_plain`` and
  ``fused_rhs_bwd_plain``.
* One case each against the TPU kernels P14 (``_norm1_rev_call``, both
  modes) and P11 (``_fused_bwd_mega_call`` with ``want_dxg=False``),
  Pallas in interpret mode, at their bfloat16 tolerance, 3e-2 of scale.
* K12's mirror gives each edge the u that K13's gives its reverse, bit
  for bit.

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
from graph_neural_pde_tpu_torch.ops.graph import column_pieces
from test_torch_port_fwd_walk import (_directed_hub_graph, _head_lanes,
                                      _scores, _u)
from test_torch_port_sym_walk import (BELTRAMI, HEAD_MODES, SCORES, Lanes,
                                      _coefs, _hub_graph, _rel, _sbm_graphs,
                                      _t_ops, _u_duds)

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


def _operands(g, d, att, heads, score, seed):
    """One call's inputs over ``g`` as float32 tensors: the forward's
    operands, and the cotangents K12's weighted mode and K8 read."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes

    def t(*shape, scale=1.0):
        return torch.tensor((scale * rng.normal(size=shape)).astype(f32))

    x, ct_ax = t(n, d), t(n, d)
    qw, kw = t(d, att, scale=d ** -0.5), t(d, att, scale=d ** -0.5)
    qb, kb = t(att, scale=0.1), t(att, scale=0.1)
    recip_p = torch.tensor(rng.uniform(0.05, 0.5, (n, heads)).astype(f32))
    ct_den = 1.0 + t(n, heads, scale=0.1)
    shifts = t(g.capacity, heads, scale=0.5)
    sp = {}
    if score == "exp_kernel":
        sp = dict(var=torch.tensor([1.3]), ls=torch.tensor([0.8]))
    elif score == BELTRAMI:
        sp = dict(var=torch.tensor([1.3, 0.9]), ls=torch.tensor([0.8, 1.4]))
    ops = (x, qw, qb, kw, kb, torch.tensor([0.25]))
    return ops, (ct_ax, recip_p, ct_den), shifts, dict(heads=heads,
                                                       score=score, **sp)


class _Tables:
    """The walks' node tables and row layouts: q from the row side, the
    values and k from the column table (the bfloat16 one rounded as the
    kernels' k table is)."""

    def __init__(self, ops, kw_f, xcol):
        x, qw, qb, kw, kb, gmax = ops
        self.heads, self.score = kw_f["heads"], kw_f["score"]
        self.var = kw_f["var"].numpy() if "var" in kw_f else np.ones(2, f32)
        self.ls = kw_f["ls"].numpy() if "ls" in kw_f else np.ones(2, f32)
        self.d, self.att = x.shape[1], qw.shape[1]
        self.q = (x.float() @ qw + qb).numpy()
        if xcol is None:
            self.xc, self.k = x.numpy(), (x @ kw + kb).numpy()
        else:
            self.xc = xcol.float().numpy()
            self.k = bf16_k_table(xcol, kw, kb).float().numpy()
        self.ln = Lanes(self.att, self.heads, self.score)
        self.hl = _head_lanes(self.ln, self.att, self.heads)
        self.kd = -(-self.d // (4 * G))
        self.gm = f32(gmax[0])

    def drow(self, table, r):                 # [KD, G, 4], zero beyond D
        out = np.zeros(self.kd * G * 4, f32)
        out[:self.d] = table[r]
        return out.reshape(self.kd, G, 4)

    def arow(self, table, r):                 # [KA, G], zero beyond A
        out = np.zeros(self.ln.ka * G, f32)
        out[:self.att] = table[r]
        return out.reshape(self.ln.ka, G)

    def dot(self, a, b):
        """A D-wide dot: each lane's float4 groups in order, then the
        warp's butterfly (the same in every lane)."""
        return self.ln.group_sum((a * b).sum(-1, dtype=f32).sum(
            0, dtype=f32).astype(f32))[0]


# ---------------------------------------------------------------------------
# the mirrors
# ---------------------------------------------------------------------------

def _den_walk(g, ops, kw_f, xcol, pieces, square_plus, ct=None, u_out=None):
    """K12's walk in numpy, lane by lane in the kernel's layout and order
    (float32): [N, H] column denominators, weighted by ct[c] . x[n] when
    ``ct`` is given. ``u_out`` (a dict) takes each edge's u [G]."""
    tb = _Tables(ops, kw_f, xcol)
    n, h = g.num_nodes, tb.heads
    col = g.col.numpy()
    ctn = None if ct is None else ct.numpy()
    out = np.zeros((n, h), f32)
    ptr, prow, slot = (getattr(pieces, k).numpy() for k in
                       ("ptr", "col", "slot"))
    part = np.zeros((pieces.n_slots, h), f32)
    for pi in range(pieces.n_pieces):
        r = prow[pi]
        kn, xn = tb.arow(tb.k, r), tb.drow(tb.xc, r)
        den = np.zeros(G, f32)
        for e in range(ptr[pi], ptr[pi + 1]):
            c = col[e]
            # the reverse edge (c, n): q gathered, k resident
            s = _scores(tb.ln, tb.score, tb.var, tb.ls, tb.arow(tb.q, c), kn,
                        tb.hl)
            u = _u(s - tb.gm, square_plus).astype(f32)
            if u_out is not None:
                u_out[e] = u
            if ctn is None:
                den = den + u
            else:
                den = den + u * tb.dot(tb.drow(ctn, c), xn)
        if slot[pi] >= 0:
            part[slot[pi]] = den[:h]
        else:
            out[r] = den[:h]
    mp = pieces.multi_ptr.numpy()
    for m, r in enumerate(pieces.multi_col.numpy()):   # the second pass
        s = np.zeros(h, f32)
        for j in range(mp[m], mp[m + 1]):
            s = s + part[j]
        out[r] = s
    return out


def _rows_walk(g, ops, cts, kw_f, xcol, pieces, square_plus, shifts=None):
    """K8 without dxg in numpy, lane by lane in the kernel's layout and
    order (float32): returns (dq, None, None, None, dgmax, dvar, dls) as
    the wrapper does."""
    tb = _Tables(ops, kw_f, xcol)
    ln, score, var, ls = tb.ln, tb.score, tb.var, tb.ls
    n, att = g.num_nodes, tb.att
    cta = cts[0].numpy()
    rp, cd = cts[1].numpy(), cts[2].numpy()
    sh = None if shifts is None else shifts.numpy()
    col = g.col.numpy()
    dq, row_sums = np.zeros((n, att), f32), np.zeros((n, 5), f32)
    ptr, prow, slot = (getattr(pieces, k).numpy() for k in
                       ("ptr", "col", "slot"))
    part = np.zeros((pieces.n_slots, att + 5), f32)
    for pi in range(pieces.n_pieces):
        r = prow[pi]
        qn, ctn = tb.arow(tb.q, r), tb.drow(cta, r)
        rg, ctd = rp[r][ln.head], cd[r][ln.head]          # [KA, G]
        dqa, sums = np.zeros_like(qn), np.zeros((5, G), f32)
        for e in range(ptr[pi], ptr[pi + 1]):
            c = col[e]
            kc = tb.arow(tb.k, c)
            hv = np.zeros_like(qn) if sh is None else np.where(
                ln.valid, sh[e][ln.head], 0).astype(f32)
            dot = tb.dot(ctn, tb.drow(tb.xc, c))
            cf = _coefs(ln, score, var, ls, qn, kc)
            _, duds = _u_duds((cf[0] - tb.gm) - hv, square_plus)
            ds = (rg * dot + ctd) * duds
            dqa = dqa + (cf[1] * ds * (kc - cf[5]) - cf[2] * ds * (qn - cf[4]))
            terms = [ds]
            if score in ("exp_kernel", BELTRAMI):
                terms += [ds * (2 * cf[0] / var[0]),
                          ds * cf[0] * cf[6] / (ls[0] ** 3)]
            if score == BELTRAMI:
                terms += [ds * (2 * cf[0] / var[1]),
                          ds * cf[0] * cf[7] / (ls[1] ** 3)]
            for t, term in enumerate(terms):
                sums[t] += np.where(ln.once, term, 0).sum(0, dtype=f32)
        tot = np.stack([ln.fold_heads(s)[0] for s in sums])
        if slot[pi] >= 0:
            part[slot[pi]] = np.concatenate([dqa.reshape(-1)[:att], tot])
        else:
            dq[r], row_sums[r] = dqa.reshape(-1)[:att], tot
    mp = pieces.multi_ptr.numpy()
    for m, r in enumerate(pieces.multi_col.numpy()):   # the second pass
        s = np.zeros(att + 5, f32)
        for j in range(mp[m], mp[m + 1]):
            s = s + part[j]
        dq[r], row_sums[r] = s[:att], s[att:]
    tot = row_sums.sum(0, dtype=np.float64)
    dvar = dls = None
    if score in F.SCALARS:
        k = F.SCALARS[score]
        dvar, dls = tot[1:1 + 2 * k:2], tot[2:2 + 2 * k:2]
    return dq, None, None, None, -tot[0], dvar, dls


def _wide(ops):
    """The operands in float64 beside the same bfloat16 tables."""
    x = ops[0]
    return [x if x.dtype == torch.bfloat16 else x.double(),
            *(t.double() for t in ops[1:])]


def _kw64(kw_f):
    return {k: (v.double() if torch.is_tensor(v) else v)
            for k, v in kw_f.items()}


def _check_den(g, ops, ct, kw_f, xcol, pieces, square_plus):
    got = _den_walk(g, ops, kw_f, xcol, pieces, square_plus, ct)
    want = kernels.norm1_den_plain(
        g.rowptr, g.row, g.col, *_wide(ops), xcol=xcol,
        square_plus=square_plus, ct=None if ct is None else ct.double(),
        **_kw64(kw_f))
    assert _rel(got.astype(np.float64), want) < 1e-5
    return got


def _check_rows(g, ops, cts, kw_f, xcol, pieces, square_plus, shifts):
    got = _rows_walk(g, ops, cts, kw_f, xcol, pieces, square_plus, shifts)
    want = kernels.fused_rhs_bwd_plain(
        g.rowptr, g.row, g.col, *_wide(ops), *(t.double() for t in cts),
        xcol=xcol, square_plus=square_plus, want_dxg=False,
        shifts=None if shifts is None else shifts.double(), **_kw64(kw_f))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert _rel(np.asarray(a, np.float64).reshape(-1),
                        b.reshape(-1)) < 1e-5
    return got


def _tables_of(ops, table):
    """float32 operands, or the bfloat16 column table beside a bfloat16
    row side (the bf16 ODE state)."""
    if table == "float32":
        return ops, None
    xcol = ops[0].to(torch.bfloat16)
    return (xcol,) + ops[1:], xcol


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("table", ["float32", "bfloat16"])
@pytest.mark.parametrize("piece", [4, None])
def test_den_mirror_equals_plain(weighted, score, square_plus, table, piece):
    """K12's mirror over a symmetric hub graph (pieces of 4 edges, whose hub
    row takes the second pass, or whole rows) equals the plain version
    within 1e-5 of scale, plain and weighted by the cotangent: D = 12,
    ATT = 16 (32 packed for exp_kernel_beltrami), 4 heads."""
    g = _hub_graph()
    att = 32 if score == BELTRAMI else 16
    ops, cts, _, kw_f = _operands(g, 12, att, 4, score, 5)
    ops, xcol = _tables_of(ops, table)
    pieces = column_pieces(g.rowptr, piece or 1 << 30)
    assert (pieces.n_multi > 0) == (piece is not None)
    _check_den(g, ops, cts[0] if weighted else None, kw_f, xcol, pieces,
               square_plus)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("table", ["float32", "bfloat16"])
@pytest.mark.parametrize("piece", [4, None])
def test_rows_mirror_equals_plain(shifted, score, square_plus, table, piece):
    """K8 without dxg, mirrored over a directed hub graph (pieces of 4
    edges or whole rows; rows without edges at its end), equals the plain
    version in dq, dgmax and the score scalars within 1e-5 of scale, with
    and without the exact mode's per-edge shifts."""
    g = _directed_hub_graph()
    att = 32 if score == BELTRAMI else 16
    ops, cts, shifts, kw_f = _operands(g, 12, att, 4, score, 6)
    ops, xcol = _tables_of(ops, table)
    pieces = column_pieces(g.rowptr, piece or 1 << 30)
    assert (pieces.n_multi > 0) == (piece is not None)
    _check_rows(g, ops, cts, kw_f, xcol, pieces, square_plus,
                shifts if shifted else None)


@pytest.mark.parametrize("walk", ["den", "rows"])
@pytest.mark.parametrize("score", ["scaled_dot", "pearson", BELTRAMI])
@pytest.mark.parametrize("head_sum", sorted(HEAD_MODES))
def test_mirror_head_modes(walk, score, head_sum):
    """Each way the walks sum a head (``make_heads``) through the mirrors
    against the plain versions (1e-5 of scale), pieces of 8 edges, K12
    weighted."""
    d, att, heads = HEAD_MODES[head_sum]
    g = _hub_graph() if walk == "den" else _directed_hub_graph()
    ops, cts, shifts, kw_f = _operands(g, d, att, heads, score, 7)
    ln = Lanes(att, heads, score)
    if head_sum != "beltrami buffer" or score == BELTRAMI:
        assert ln.mode == head_sum.split()[-1]
    pieces = column_pieces(g.rowptr, 8)
    if walk == "den":
        _check_den(g, ops, cts[0], kw_f, None, pieces, False)
    else:
        _check_rows(g, ops, cts, kw_f, None, pieces, False, shifts)


@pytest.mark.parametrize("score", SCORES)
def test_den_u_is_k13_u_of_the_reverse_edge(score):
    """The mirror trick, bit for bit: the u K12's walk forms for each edge
    (n, c) of row n (q gathered at c, k resident at n) is the u K13's walk
    forms for the reverse edge (c, n) of row c (q resident at c, k
    gathered at n), on the bfloat16 column table too."""
    g = _hub_graph()
    att = 32 if score == BELTRAMI else 16
    ops, _, _, kw_f = _operands(g, 12, att, 4, score, 8)
    for xcol in (None, ops[0].to(torch.bfloat16)):
        u12 = {}
        _den_walk(g, ops, kw_f, xcol, g.row_pieces, False, u_out=u12)
        tb = _Tables(ops, kw_f, xcol)
        rev, row, col = (t.numpy() for t in (g.rev, g.row, g.col))
        heads = np.arange(G) < tb.heads
        for e in range(g.num_valid):
            r, c = row[rev[e]], col[rev[e]]           # K13's row and column
            s = _scores(tb.ln, tb.score, tb.var, tb.ls, tb.arow(tb.q, r),
                        tb.arow(tb.k, c), tb.hl)
            u13 = _u(s - tb.gm, False).astype(f32)
            assert np.array_equal(u12[e][heads], u13[heads])


def test_wrappers_take_the_row_pieces_on_the_cpu():
    """On CPU tensors K12 and K8 without dxg run their plain versions:
    handed the graph's row pieces (and K8 its node tables: none on the
    CPU), they return what the plain versions return, and count no
    launch."""
    g = _hub_graph()
    ops, cts, _, kw_f = _operands(g, 12, 16, 4, "scaled_dot", 9)
    csr = (g.rowptr, g.row, g.col)
    before = (kernels.norm1_den.launches, kernels.fused_rhs_bwd.launches,
              kernels.fused_rhs_bwd.rows_launches)
    for ct in (None, cts[0]):
        assert torch.equal(
            kernels.norm1_den(*csr, *ops, ct=ct, pieces=g.row_pieces,
                              **kw_f),
            kernels.norm1_den_plain(*csr, *ops, ct=ct, **kw_f))
    got = kernels.fused_rhs_bwd(*csr, *ops, *cts, want_dxg=False,
                                pieces=g.row_pieces,
                                tabs=F.node_tables(ops[0], 16), **kw_f)
    want = kernels.fused_rhs_bwd_plain(*csr, *ops, *cts, want_dxg=False,
                                       **kw_f)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, want))
    assert (kernels.norm1_den.launches, kernels.fused_rhs_bwd.launches,
            kernels.fused_rhs_bwd.rows_launches) == before
    assert F.node_tables(ops[0], 16) is None


# ---------------------------------------------------------------------------
# against the TPU kernels (Pallas in interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_den_mirror_matches_p14(weighted):
    """K12's mirror (float32) against P14 ``_norm1_rev_call``, Pallas in
    interpret mode with its operands packed as ``make_fused_ax_norm1``
    packs them (x and the projections padded to 128 columns in the
    pair-decode order, bf16 pairs, the cotangent's too): within 3e-2 of
    scale, in both of its modes."""
    d, att, heads = 8, 8, 2
    kw = dict(function="transformer", block="constant", attention_norm_idx=1,
              square_plus=False, add_source=True, attention_dim=att,
              attention_type="scaled_dot", heads=heads, hidden_dim=d)
    jcfg = JConfig(**kw).replace(stripe_fused=True, stripe_block_n=8,
                                 stripe_chunk=16, stripe_chunk_auto=False,
                                 rhs_payload_dtype="bfloat16")
    jg, plan, tg = _sbm_graphs(jcfg, Config(**kw))
    (x, qw, qb, kw_, kb), ct = _t_ops(np.random.default_rng(2),
                                      tg.num_nodes, d, att)
    gmax = np.array([0.25], f32)
    t = tuple(torch.tensor(a) for a in (x, qw, qb, kw_, kb, gmax))
    got = _den_walk(tg, t, dict(heads=heads, score="scaled_dot"), None,
                    tg.row_pieces, False,
                    torch.tensor(ct) if weighted else None)
    pm = jnp.asarray(jfused._norm1_perm(128))
    pad = ((0, 0), (0, 128 - d))
    x_e = jnp.pad(jnp.asarray(x), pad) @ pm
    qw_e = pm.T @ jnp.pad(jnp.asarray(qw), ((0, 128 - d), (0, 0)))
    kw_e = pm.T @ jnp.pad(jnp.asarray(kw_), ((0, 128 - d), (0, 0)))
    pack = jfused._pack_x_recip(jnp.asarray(x), None, max(8, heads))[jg.col]
    ct_g = None
    if weighted:
        ct_g = jfused._pack_pairs64(jnp.pad(jnp.asarray(ct), pad))[jg.col]
    want = jfused._norm1_rev_call(
        plan, qw_e, jnp.asarray(qb), kw_e, jnp.asarray(kb), x_e, pack,
        jnp.asarray(gmax[0]), ct_g=ct_g, heads=heads, square_plus=False,
        score="scaled_dot", score_params=(), interpret=True)[:, :heads]
    assert _rel(got, np.asarray(want)) < 3e-2


def test_rows_mirror_matches_p11():
    """K8 without dxg, mirrored (float32), against P11
    ``_fused_bwd_mega_call`` with ``want_dxg=False`` and ``recip_p`` (the
    separable mode of the column-plan backward), Pallas in interpret mode
    over a stripe plan: dq and dgmax within 3e-2 of scale."""
    d, att, heads = 12, 16, 4
    kw = dict(function="transformer", block="constant", attention_norm_idx=0,
              square_plus=False, self_loop_weight=1.0, add_source=True,
              hidden_dim=d, attention_dim=att, heads=heads)
    jcfg = JConfig(**kw).replace(stripe_fused=True, stripe_block_n=8,
                                 stripe_chunk=16)
    jg, plan, tg = _sbm_graphs(jcfg, Config(**kw))
    n = tg.num_nodes
    rng = np.random.default_rng(4)
    (x, qw, qb, kw_, kb), ct = _t_ops(rng, n, d, att)
    gmax = np.array([0.25], f32)
    recip_p = rng.uniform(0.05, 0.5, (n, heads)).astype(f32)
    ct_den = (1.0 + 0.1 * rng.normal(size=(n, heads))).astype(f32)
    t = tuple(torch.tensor(a) for a in (x, qw, qb, kw_, kb, gmax))
    cts = tuple(torch.tensor(a) for a in (ct, recip_p, ct_den))
    got = _rows_walk(tg, t, cts, dict(heads=heads, score="scaled_dot"), None,
                     tg.row_pieces, False)
    hp = max(8, heads)
    padh = ((0, 0), (0, hp - heads))
    xj = jnp.asarray(x)
    dq, dxg, _, _, dgmax, _ = jfused._fused_bwd_mega_call(
        plan, *map(jnp.asarray, (qw, qb, kw_, kb)), xj, xj[jg.col],
        jnp.asarray(gmax[0]), jnp.asarray(ct),
        jnp.pad(jnp.asarray(ct_den), padh), heads=heads, square_plus=False,
        interpret=True, score="scaled_dot", want_dxg=False,
        recip_p=jnp.pad(jnp.asarray(recip_p), padh))
    assert dxg is None
    assert _rel(got[0], np.asarray(dq)) < 3e-2
    assert abs(float(got[4]) - float(dgmax)) < 3e-2 * abs(float(dgmax))
