"""The symmetric backward walk of K9 ``fused_rhs_bwd_sym`` and K14
``norm1_bwd`` on the CPU, where the kernel cannot run: a numpy mirror of
the order in which it visits and sums its operands
(``csrc/fused_common.cuh``, ``sym_backward_piece``), held against the
plain versions that define the two kernels, and the host-side layouts the
wrappers build held to their contracts.

* The mirror keeps the kernel's lane layout: a warp walks an edge, lane l
  owning columns 4 (32 t + l) .. + 3 of a D-wide row and column 32 j + l
  of a q or k row. Each head's terms are summed by the segmented
  butterfly over its d_k lanes (over d_k / 32 tiles and then the lanes
  when d_k > 32, in column order through the warp's buffer when d_k is
  not a power of two or a beltrami half sits neither a tile nor a lane
  offset away), the heads' sums by the fold over head groups, and the
  row's sums in edge order within each piece, then over the pieces in
  order.
* It runs every score family, squareplus, the float32 tables and the
  bfloat16 column table, whole rows and pieces of 4 edges, over a
  symmetric graph with a hub row, and the three ways of summing a head,
  at 1e-5 of scale against ``fused_rhs_bwd_sym_plain`` and
  ``norm1_bwd_plain``.
* One case each against the TPU kernels P13 (``make_fused_ax_sym``'s
  gradient) and P16 (``_norm1_bwd_call``), Pallas in interpret mode, at
  their bfloat16 tolerance, 3e-2 of scale.
* ``sym_node_table`` packs (recip_p, ct_den) per node and head; the row
  pieces of a symmetric graph are its CSC view's ``col_pieces``.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.kernels import fused_rhs as F
from graph_neural_pde_tpu_torch.kernels.fused_rhs import (bf16_k_table,
                                                          bf16_round)
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.ops.graph import (COL_PIECE, column_pieces,
                                                  make_graph)

BELTRAMI = "exp_kernel_beltrami"
SCORES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel", BELTRAMI)
KINDS = ("fused_rhs_bwd_sym", "norm1_bwd")
EPS_NORM = np.float32(1e-5)
f32 = np.float32


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


def _hub_graph(n=24, seed=0):
    """A symmetric random graph with self-loops whose node 0 is a hub of
    degree n, far above the pieces of 4 edges the tests cut."""
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    u = np.concatenate([u, np.zeros(n - 1, int)])
    v = np.concatenate([v, np.arange(1, n)])
    return make_graph(np.concatenate([u, v, np.arange(n)]),
                      np.concatenate([v, u, np.arange(n)]),
                      num_nodes=n).sort_by_row()


def _operands(g, d, att, heads, score, seed):
    """One backward's inputs over ``g`` as float32 tensors."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes

    def t(*shape, scale=1.0):
        return torch.tensor((scale * rng.normal(size=shape)).astype(f32))

    x, ct_ax = t(n, d), t(n, d)
    qw, kw = t(d, att, scale=d ** -0.5), t(d, att, scale=d ** -0.5)
    qb, kb = t(att, scale=0.1), t(att, scale=0.1)
    recip_p = torch.tensor(rng.uniform(0.05, 0.5, (n, heads)).astype(f32))
    ct_den = 1.0 + t(n, heads, scale=0.1)
    sp = {}
    if score == "exp_kernel":
        sp = dict(var=torch.tensor([1.3]), ls=torch.tensor([0.8]))
    elif score == BELTRAMI:
        sp = dict(var=torch.tensor([1.3, 0.9]), ls=torch.tensor([0.8, 1.4]))
    ops = (x, qw, qb, kw, kb, torch.tensor([0.25]), ct_ax, recip_p, ct_den)
    return ops, dict(heads=heads, score=score, **sp)


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

class Lanes:
    """The kernel's view of the heads (``make_heads``): columns a = 32 j +
    l of KA tiles, each column's slice and head, how the warp sums a head
    (``mode``) and where the fold over head groups starts."""

    def __init__(self, att, heads, score, g=32):
        self.g, self.att, self.h = g, att, heads
        belt = score == BELTRAMI
        self.d_k = d_k = att // (2 * heads if belt else heads)
        self.ka = -(-att // g)
        self.a = g * np.arange(self.ka)[:, None] + np.arange(g)[None, :]
        self.valid = self.a < att
        slice_ = self.a // d_k
        self.feat = self.valid & (slice_ < heads)
        self.head = np.where(self.valid, slice_ % heads, 0)
        pow2 = d_k & (d_k - 1) == 0
        paired = not belt or (att // 2) % g == 0 or att <= g
        self.mode = ("buffer" if not pow2 or not paired
                     else "lanes" if d_k <= g else "tiles")
        self.span = d_k // g if self.mode == "tiles" else 1
        self.fold = {"lanes": d_k, "tiles": g, "buffer": 1}[self.mode]
        first = {"lanes": np.ones_like(self.valid),
                 "tiles": (np.arange(self.ka) % self.span == 0)[:, None]
                 & np.ones((1, g), bool),
                 "buffer": self.a % d_k == 0}[self.mode]
        self.once = self.feat & first

    def slice_sums(self, v):
        """v [KA, G] float32 -> each lane's slice sum (``slice_sums``)."""
        v = v.astype(f32)
        if self.mode == "buffer":                 # serial, column order
            flat = v.reshape(-1)[:self.att]
            out = np.zeros_like(v)
            for j in range(self.ka):
                for l in range(self.g):
                    a = self.a[j, l]
                    if a < self.att:
                        s = f32(0)
                        base = (a // self.d_k) * self.d_k
                        for t in range(self.d_k):
                            s = f32(s + flat[base + t])
                        out[j, l] = s
            return out
        if self.mode == "tiles":                  # a head's tiles in the lane
            w = np.zeros_like(v)
            for j in range(self.ka):
                for t in range(self.ka):
                    if t // self.span == j // self.span:
                        w[j] = w[j] + v[t]
            v = w
        o = self.g // 2
        lanes = np.arange(self.g)
        while o:
            t = v[:, lanes ^ o]
            if o < self.d_k:
                v = v + t
            o //= 2
        return v

    def partner(self, s):
        """The beltrami partner half's slice sums (``partner``)."""
        half = self.att // 2
        flat = np.zeros(self.ka * self.g, f32)
        flat[:s.size] = s.reshape(-1)
        idx = np.where(self.feat, self.a + half, self.a - half)
        return np.where(self.valid, flat[np.clip(idx, 0, flat.size - 1)], 0)

    def fold_heads(self, v):
        """``head_fold``: v [G] -> the sum over the group's head slices."""
        o, lanes = 1, np.arange(self.g)
        while o < self.g:
            t = v[lanes ^ o]
            if o >= self.fold:
                v = v + t
            o *= 2
        return v

    def group_sum(self, v):
        o, lanes = self.g // 2, np.arange(self.g)
        while o:
            v = v + v[lanes ^ o]
            o //= 2
        return v


def _coefs(ln, score, var, ls, qf, kf):
    """One direction of an edge tile by tile (``score_tiles``): s and the
    coefficients (P, Q, R, mq, mk) and the distances, each [KA, G]."""
    z = np.zeros_like(qf)
    if score == "scaled_dot":
        root = np.sqrt(f32(ln.d_k)).astype(f32)
        s = ln.slice_sums(qf * kf) / root
        p = np.full_like(qf, f32(1) / root)
        return s, p, z, z, z, z, z, z
    if score in ("exp_kernel", BELTRAMI):
        own = ln.slice_sums((qf - kf) ** 2)
        if score == "exp_kernel":
            s = (var[0] * var[0] * np.exp(-own / (2 * ls[0] * ls[0]))
                 ).astype(f32)
            c = s / (ls[0] * ls[0])
            return s, c, c, c, z, z, own, z
        other = ln.partner(own)
        dist = np.where(ln.feat, own, other)
        dist_p = np.where(ln.feat, other, own)
        s = (var[0] * var[0] * np.exp(-dist / (2 * ls[0] * ls[0]))
             * (var[1] * var[1])
             * np.exp(-dist_p / (2 * ls[1] * ls[1]))).astype(f32)
        c = np.where(ln.feat, s / (ls[0] * ls[0]), s / (ls[1] * ls[1]))
        return s, c, c, c, z, z, dist, dist_p
    mq = mk = z
    if score == "pearson":
        mq = ln.slice_sums(qf) / f32(ln.d_k)
        mk = ln.slice_sums(kf) / f32(ln.d_k)
    a, b = qf - mq, kf - mk
    sp, ss, kk = (ln.slice_sums(t) for t in (a * b, a * a, b * b))
    rs, rk = np.sqrt(ss), np.sqrt(kk)
    ns, nk = np.maximum(rs, EPS_NORM), np.maximum(rk, EPS_NORM)
    s = sp / (ns * nk)
    p = f32(1) / (ns * nk)
    q = np.where(rs > EPS_NORM, s / np.maximum(ss, EPS_NORM ** 2), 0)
    r = np.where(rk > EPS_NORM, s / np.maximum(kk, EPS_NORM ** 2), 0)
    return s, p, q, r, mq, mk, z, z


def _u_duds(sm, square_plus):
    if square_plus:
        r = np.sqrt(sm * sm + 4)
        return (sm + r) * f32(0.5), (1 + sm / r) * f32(0.5)
    u = np.exp(sm)
    return u, u


def _walk(kind, g, ops, kw_f, xcol, pieces, square_plus=False):
    """K9 / K14's walk in numpy, lane by lane in the kernel's layout and
    order (float32): returns (dq, dxrow, dkw, dkb, dgmax, dvar, dls) as
    the wrapper does."""
    x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den = ops
    heads, score = kw_f["heads"], kw_f["score"]
    var = kw_f["var"].numpy() if "var" in kw_f else np.ones(2, f32)
    ls = kw_f["ls"].numpy() if "ls" in kw_f else np.ones(2, f32)
    n, d = x.shape
    att = qw.shape[1]
    q = (x.float() @ qw + qb).numpy()
    if xcol is None:
        xc, k, kw_eff = x.numpy(), (x @ kw + kb).numpy(), kw.numpy()
    else:
        xc = xcol.float().numpy()
        k = bf16_k_table(xcol, kw, kb).float().numpy()
        kw_eff = bf16_round(kw).numpy()
    cta, rc = ct_ax.numpy(), F.sym_node_table(recip_p, ct_den).numpy()
    G = 32
    ln = Lanes(att, heads, score)
    kd = -(-d // (4 * G))
    gm = f32(gmax[0])
    col = g.col.numpy()

    def drow(table, r):                      # [KD, G, 4], zero beyond D
        out = np.zeros(kd * G * 4, f32)
        out[:d] = table[r]
        return out.reshape(kd, G, 4)

    def arow(table, r):                      # [KA, G], zero beyond A
        out = np.zeros(ln.ka * G, f32)
        out[:att] = table[r]
        return out.reshape(ln.ka, G)

    dq, dkn, dxrow = (np.zeros((n, att), f32), np.zeros((n, att), f32),
                      np.zeros((n, d), f32))
    row_sums = np.zeros((n, 5), f32)
    ptr, prow, slot = (getattr(pieces, k_).numpy() for k_ in
                       ("ptr", "col", "slot"))
    part = np.zeros((pieces.n_slots, d + 2 * att + 5), f32)

    def finish(r, dxa, dqa, dka, sums):
        dq[r], dkn[r] = dqa.reshape(-1)[:att], dka.reshape(-1)[:att]
        acc = np.zeros(kd * G * 4, f32)
        for a in range(att):                 # (sum dk) Kw^T, a in order
            w = np.zeros(kd * G * 4, f32)
            w[:d] = kw_eff.T[a]
            acc = acc + dka.reshape(-1)[a] * w
        dxrow[r] = (dxa.reshape(-1) + acc)[:d]
        row_sums[r] = sums

    for pi in range(pieces.n_pieces):
        r = prow[pi]
        xn, ctn = drow(xc, r), drow(cta, r)
        qn, kn = arow(q, r), arow(k, r)
        rn = rc[r][ln.head]                   # [KA, G, 2]
        a_ = dict(dx=np.zeros((kd, G, 4), f32), dq=np.zeros_like(qn),
                  dk=np.zeros_like(qn), sums=np.zeros((5, G), f32))
        for e in range(ptr[pi], ptr[pi + 1]):
            c = col[e]
            xc_c, ct_c = drow(xc, c), drow(cta, c)
            kc, qc = arow(k, c), arow(q, c)
            rcc = rc[c][ln.head]
            dot = ln.group_sum((ctn * xc_c).sum(-1, dtype=f32).sum(0)
                               .astype(f32))[0]
            dot_r = ln.group_sum((ct_c * xn).sum(-1, dtype=f32).sum(0)
                                 .astype(f32))[0]
            cf = _coefs(ln, score, var, ls, qn, kc)
            cr = _coefs(ln, score, var, ls, qc, kn)
            rf = rcc if kind == "norm1_bwd" else rn
            rr = rn if kind == "norm1_bwd" else rcc
            u, duds = _u_duds(cf[0] - gm, square_plus)
            ds = (rf[..., 0] * dot + rf[..., 1]) * duds
            ur, dudr = _u_duds(cr[0] - gm, square_plus)
            dr = (rr[..., 0] * dot_r + rr[..., 1]) * dudr
            a_["dq"] += (cf[1] * ds * (kc - cf[5])
                         - cf[2] * ds * (qn - cf[4]))
            a_["dk"] += (cr[1] * dr * (qc - cr[4])
                         - cr[3] * dr * (kn - cr[5]))
            once = ln.once
            terms = [ds]
            if score in ("exp_kernel", BELTRAMI):
                terms += [ds * (2 * cf[0] / var[0]),
                          ds * cf[0] * cf[6] / (ls[0] ** 3)]
            if score == BELTRAMI:
                terms += [ds * (2 * cf[0] / var[1]),
                          ds * cf[0] * cf[7] / (ls[1] ** 3)]
            for t_, term in enumerate(terms):
                a_["sums"][t_] += np.where(once, term, 0).sum(0, dtype=f32)
            w = ln.fold_heads(np.where(once, rr[..., 0] * ur, 0)
                              .sum(0, dtype=f32))[0]
            a_["dx"] += w * ct_c
        tot = np.stack([ln.fold_heads(s_)[0] for s_ in a_["sums"]])
        dxa, dqa, dka = a_["dx"], a_["dq"], a_["dk"]
        if slot[pi] < 0:
            finish(r, dxa, dqa, dka, tot)
        else:
            part[slot[pi]] = np.concatenate([
                dxa.reshape(-1)[:d], dqa.reshape(-1)[:att],
                dka.reshape(-1)[:att], tot])
    mp = pieces.multi_ptr.numpy()
    for m, r in enumerate(pieces.multi_col.numpy()):   # the second pass
        s = np.zeros(d + 2 * att + 5, f32)
        for j in range(mp[m], mp[m + 1]):
            s = s + part[j]
        pad = lambda v, w: np.pad(v, (0, w - v.size))  # noqa: E731
        finish(r, pad(s[:d], kd * G * 4), pad(s[d:d + att], ln.ka * G),
               pad(s[d + att:d + 2 * att], ln.ka * G), s[d + 2 * att:])
    dkw = xc.T.astype(np.float64) @ dkn
    tot = row_sums.sum(0, dtype=np.float64)
    dvar = dls = None
    if score in F.SCALARS:
        nsc = F.SCALARS[score]
        dvar, dls = tot[1:1 + 2 * nsc:2], tot[2:2 + 2 * nsc:2]
    return dq, dxrow, dkw, dkn.sum(0), -tot[0], dvar, dls


def _plain(kind, g, ops, kw_f, xcol, square_plus):
    """The plain version in float64 beside the same tables."""
    fn = (kernels.fused_rhs_bwd_sym_plain if kind == "fused_rhs_bwd_sym"
          else kernels.norm1_bwd_plain)
    x = ops[0]
    wide = [x if x.dtype == torch.bfloat16 else x.double(),
            *(t.double() for t in ops[1:])]
    kw = {k: (v.double() if torch.is_tensor(v) else v)
          for k, v in kw_f.items()}
    return fn(g.rowptr, g.row, g.col, *wide, xcol=xcol,
              square_plus=square_plus, **kw)


def _check(kind, g, ops, kw_f, xcol, pieces, square_plus=False):
    got = _walk(kind, g, ops, kw_f, xcol, pieces, square_plus)
    want = _plain(kind, g, ops, kw_f, xcol, square_plus)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert _rel(np.asarray(a, np.float64).reshape(-1),
                        b.reshape(-1)) < 1e-5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("table", ["float32", "bfloat16"])
@pytest.mark.parametrize("piece", [4, None])
def test_walk_mirror_equals_plain(kind, score, square_plus, table, piece):
    """The mirror of the walk over a hub graph (pieces of 4 edges, whose
    hub row takes the second pass, or whole rows) equals the plain
    version, every output within 1e-5 of scale: D = 12, ATT = 16 (32
    packed for exp_kernel_beltrami), 4 heads; float32, and the bfloat16
    column table beside a float32 row side."""
    g = _hub_graph()
    att = 32 if score == BELTRAMI else 16
    ops, kw_f = _operands(g, 12, att, 4, score, 5)
    xcol = ops[0].to(torch.bfloat16) if table == "bfloat16" else None
    pieces = column_pieces(g.rowptr, piece or 1 << 30)
    assert (pieces.n_multi > 0) == (piece is not None)
    _check(kind, g, ops, kw_f, xcol, pieces, square_plus)


# (D, ATT, H): each way of summing a head, for both score shapes
HEAD_MODES = {
    "lanes": (8, 16, 2),          # d_k 8 (beltrami 4): lanes of one tile
    "tiles": (12, 128, 1),        # d_k 128 (64): the lanes of 4 (2) tiles
    "buffer": (10, 24, 2),        # d_k 12 (6), D % 4 != 0: the buffer
    "beltrami buffer": (8, 96, 3),  # beltrami's half 48 columns on
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("score", ["scaled_dot", "pearson", BELTRAMI])
@pytest.mark.parametrize("mode", sorted(HEAD_MODES))
def test_walk_mirror_head_modes(kind, score, mode):
    """Each way the walk sums a head (``make_heads``) through the mirror
    against the plain version (1e-5 of scale), on a row side of bf16
    values (the bf16 ODE state)."""
    d, att, heads = HEAD_MODES[mode]
    g = _hub_graph()
    ops, kw_f = _operands(g, d, att, heads, score, 6)
    ln = Lanes(att, heads, score)
    if mode != "beltrami buffer" or score == BELTRAMI:
        assert ln.mode == mode.split()[-1]
    design = F.sym_design(d, att, heads, score)
    assert design["head_sum"] == ln.mode and design["ka"] >= ln.ka
    assert design["kd"] * 128 >= d
    xcol = ops[0].to(torch.bfloat16)
    ops = (xcol,) + ops[1:]
    _check(kind, g, ops, kw_f, xcol, column_pieces(g.rowptr, 8))


# ---------------------------------------------------------------------------
# the host-side layouts
# ---------------------------------------------------------------------------

def test_sym_node_table_packs_each_head():
    """[N, H, 2]: recip_p then ct_den of each node and head, float32 and
    contiguous, so that one 8-byte load a lane reads both."""
    rng = np.random.default_rng(1)
    rp, cd = (torch.tensor(rng.normal(size=(7, 3)).astype(f32))
              for _ in range(2))
    t = F.sym_node_table(rp, cd)
    assert t.shape == (7, 3, 2) and t.is_contiguous()
    assert t.dtype == torch.float32
    assert torch.equal(t[..., 0], rp) and torch.equal(t[..., 1], cd)


def test_symmetric_graph_row_pieces_are_its_column_pieces():
    """On a symmetric edge multiset ``colptr`` is ``rowptr``, so the CSC
    view's pieces (``Graph.col_pieces``, which the fused ops hand K9 and
    K14) cut the rows: each piece's edges lie in its row, in CSR order."""
    g = _hub_graph()
    assert g.rev is not None and torch.equal(g.colptr, g.rowptr)
    want = column_pieces(g.rowptr)
    for k in ("ptr", "col", "slot", "multi_col", "multi_ptr"):
        assert torch.equal(getattr(g.col_pieces, k), getattr(want, k))
    ptr, row = g.col_pieces.ptr.numpy(), g.col_pieces.col.numpy()
    rowptr = g.rowptr.numpy()
    assert (ptr[:-1] >= rowptr[row]).all() and (ptr[1:] <= rowptr[row + 1]).all()
    assert g.col_pieces.piece == COL_PIECE


def test_sym_design():
    """``sym_design`` picks the kernel's tiles: one 16-byte group of 4
    columns a lane per 128 of D, KA columns of ATT a lane rounded up to 1,
    2, 4 or 8 (2 or 8 for cosine_sim and pearson), as
    csrc/fused_common.cuh's launch_walk does, and the way a head is
    summed, as make_heads picks it."""
    cases = {(128, 32, 2, "scaled_dot"): (1, 1, "lanes"),
             (128, 64, 2, BELTRAMI): (1, 2, "lanes"),
             (80, 128, 8, "scaled_dot"): (1, 4, "lanes"),
             (256, 256, 1, "exp_kernel"): (2, 8, "tiles"),
             (16, 16, 4, "cosine_sim"): (1, 2, "lanes"),
             (96, 96, 3, "pearson"): (1, 8, "lanes"),
             (12, 24, 2, "scaled_dot"): (1, 1, "buffer"),
             (8, 96, 3, BELTRAMI): (1, 4, "buffer")}
    for (d, att, h, score), (kd, ka, mode) in cases.items():
        assert F.sym_design(d, att, h, score) == dict(kd=kd, ka=ka,
                                                      head_sum=mode)


# ---------------------------------------------------------------------------
# against the TPU kernels (Pallas in interpret mode)
# ---------------------------------------------------------------------------

SBM = dict(num_nodes=40, num_classes=3, num_features=8, seed=3)


def _sbm_graphs(jcfg, tcfg):
    jg = jblocks.prepare_graph(jcfg, j_sbm(**SBM).graph)
    jg, plan = jblocks.build_stripe_engine(jcfg, jg)
    assert plan is not None and plan.symmetric
    tg = tblocks.prepare_graph(tcfg, make_sbm_dataset(**SBM).graph)
    assert jg.num_nodes == tg.num_nodes
    return jg, plan, tg


def _t_ops(rng, n, d, att):
    t = [(s * rng.normal(size=shape)).astype(f32) for shape, s in
         (((n, d), 1.0), ((d, att), 0.3), ((att,), 0.1), ((d, att), 0.3),
          ((att,), 0.1))]
    return t, rng.normal(size=(n, d)).astype(f32)


def test_walk_mirror_matches_p13():
    """K9's walk (the mirror, float32) against P13: the gradient of
    sum(ax * ct) in Q, K, x and gmax from ``make_fused_ax_sym``'s custom
    VJP, Pallas in interpret mode over a stripe plan, within 3e-2 of the
    largest gradient (the TPU kernel's bfloat16 gathers)."""
    d, att, heads = 12, 16, 4
    kw = dict(function="transformer", block="constant", attention_norm_idx=0,
              square_plus=False, self_loop_weight=1.0, add_source=True,
              hidden_dim=d, attention_dim=att, heads=heads)
    jcfg = JConfig(**kw).replace(stripe_fused=True, stripe_block_n=8,
                                 stripe_chunk=16)
    jg, plan, tg = _sbm_graphs(jcfg, Config(**kw))
    (x, qw, qb, kw_, kb), ct = _t_ops(np.random.default_rng(4),
                                      tg.num_nodes, d, att)
    gmax = np.array([0.25], f32)
    op = jfused.make_fused_ax_sym(plan, heads, False, "scaled_dot", jg.col,
                                  None)
    want = jax.grad(lambda *a: jnp.sum(op(*a, ())[0] * ct),
                    argnums=tuple(range(6)))(
        *map(jnp.asarray, (qw, qb, kw_, kb, x)), jnp.asarray(gmax[0]))
    t = [torch.tensor(a) for a in (x, qw, qb, kw_, kb, gmax)]
    csr = (tg.rowptr, tg.row, tg.col)
    _, den, num = kernels.fused_rhs_fwd_plain(*csr, *t, heads=heads,
                                              score="scaled_dot",
                                              want_num=True)
    ct_t = torch.tensor(ct)
    recip_p, ct_den = F._node_cotangents(ct_t, torch.zeros_like(den), num,
                                         den, heads)
    dq, dxrow, dkw, dkb, dgmax, _, _ = _walk(
        "fused_rhs_bwd_sym", tg, (*t, ct_t, recip_p, ct_den),
        dict(heads=heads, score="scaled_dot"), None, tg.col_pieces)
    got = [x.T @ dq, dq.sum(0), dkw, dkb, dxrow + dq @ qw.T, dgmax]
    # dkb and dgmax vanish (the softmax is shift-invariant): the scale is
    # the largest gradient's, as in the port's other tests of P13
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g_, w in zip(got, want):
        err = np.abs(np.reshape(g_, -1) - np.reshape(np.asarray(w), -1))
        assert err.max() / scale < 3e-2


def test_walk_mirror_matches_p16():
    """K14's walk (the mirror, float32) against P16 ``_norm1_bwd_call``,
    Pallas in interpret mode with its operands packed as
    ``make_fused_ax_norm1`` packs them (x and the projections padded to 128
    columns in the pair-decode order, bf16 pairs), from the same 1/den and
    den cotangent: every output within 3e-2 of its scale."""
    d, att, heads = 8, 8, 2
    kw = dict(function="transformer", block="constant", attention_norm_idx=1,
              square_plus=False, add_source=True, attention_dim=att,
              attention_type="scaled_dot", heads=heads, hidden_dim=d)
    jcfg = JConfig(**kw).replace(stripe_fused=True, stripe_block_n=8,
                                 stripe_chunk=16, stripe_chunk_auto=False,
                                 rhs_payload_dtype="bfloat16")
    jg, plan, tg = _sbm_graphs(jcfg, Config(**kw))
    n = tg.num_nodes
    rng = np.random.default_rng(3)
    (x, qw, qb, kw_, kb), ct = _t_ops(rng, n, d, att)
    gmax = np.array([0.25], f32)
    t = [torch.tensor(a) for a in (x, qw, qb, kw_, kb, gmax)]
    csr = (tg.rowptr, tg.row, tg.col)
    den = kernels.norm1_den_plain(*csr, *t, heads=heads, score="scaled_dot")
    recip = 1.0 / (den + 1e-16)
    ctd = (0.5 + 0.1 * rng.normal(size=(n, heads))).astype(f32)
    got = _walk("norm1_bwd", tg, (*t, torch.tensor(ct),
                                  (recip / heads).contiguous(),
                                  torch.tensor(ctd)),
                dict(heads=heads, score="scaled_dot"), None, tg.col_pieces)
    hp = max(8, heads)
    pm = jnp.asarray(jfused._norm1_perm(128))
    pad = ((0, 0), (0, 128 - d))
    x_e = jnp.pad(jnp.asarray(x), pad) @ pm
    qw_e = pm.T @ jnp.pad(jnp.asarray(qw), ((0, 128 - d), (0, 0)))
    kw_e = pm.T @ jnp.pad(jnp.asarray(kw_), ((0, 128 - d), (0, 0)))
    jrecip = jnp.asarray(recip.numpy())
    pack = jfused._pack_x_recip(jnp.asarray(x), jrecip, hp)[jg.col]
    ct128 = jnp.pad(jnp.asarray(ct), pad)
    ctd_p = jnp.pad(jnp.asarray(ctd), ((0, 0), (0, hp - heads)))
    rcp_p = jnp.pad(jrecip / heads, ((0, 0), (0, hp - heads)))
    dq, dxr_e, dkw_e, dkb, dgmax, _ = jfused._norm1_bwd_call(
        plan, qw_e, jnp.asarray(qb), kw_e, jnp.asarray(kb), x_e, pack,
        jfused._pack_pairs64(ct128)[jg.col], ctd_p[jg.col],
        jnp.asarray(gmax[0]), ct128 @ pm, rcp_p, ctd_p, heads=heads,
        square_plus=False, score="scaled_dot", score_params=(),
        interpret=True)
    want = [dq, (dxr_e @ pm.T)[:, :d], (pm @ dkw_e)[:d], dkb, dgmax]
    for g_, w in zip(got[:5], want):
        assert _rel(np.reshape(g_, -1), np.reshape(np.asarray(w), -1)) < 3e-2
