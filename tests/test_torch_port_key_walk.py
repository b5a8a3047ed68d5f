"""K19 ``fused_score_max`` on the scaled-dot fold (``csrc/payload_fwd.cu``)
and K18 ``fused_aggregate`` for the four score families that need each
edge's key (``csrc/fused_payload.cu``, ``payload_keys_kernel``) in numpy
mirrors of the kernels' order, on the CPU.

K19: each row piece (``Graph.scatter_pieces``) on a group of G lanes (the
chooser's ``payload_walk`` entry) folds its row's q with Kw^T as K18's
scaled-dot walk does (the payload-walk file's ``Walk`` and ``_fold``),
scores each edge through the transposed butterfly, and keeps the largest
score of the lanes that hold one of the row's heads; each block of 128
threads writes its maximum, one block the blocks' maximum, 0 unless
finite (a NaN score wins, then is not finite). Held against
``fused_score_max_plain`` and the Pallas ``_fused_score_max_impl`` at
float32 in interpret mode: a hub row cut into pieces, a NaN score, an
edgeless graph.

K18's key families: the key tile (every payload row's key K = x Kw + kb
from Kw's high and low TF32 parts, 3xTF32 products, two k8 steps a partial
sum rounded toward zero as each mma.sync rounds its sum; a bfloat16 row
is a TF32 value: two products) against the float64 key; then windows of
row pieces (the pieces starting in W edges), tiles of CAP staged rows,
each (edge, head) scored by ``head_score``'s arithmetic, and a column of
[num | den] a thread summed in edge order, written when its piece ends,
carried past a tile, the rows of several pieces merged in piece order;
against ``fused_aggregate_plain`` in float64 (1e-5 of scale) and the
Pallas ``_fused_call`` (what ``fused_rhs_aggregate`` runs) at float32 in
interpret mode, for each family, float32 and bfloat16 payloads, shifts
and squareplus, the design's tile and a small one that makes every window
span tiles. Also: ``key_design``'s shared-memory sums and what the new
wrappers raise.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu.ops.pallas.stripe import build_stripe_plan
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.kernels import fused_rhs as F
from graph_neural_pde_tpu_torch.kernels.lanes import lanes
from graph_neural_pde_tpu_torch.ops.graph import SCATTER_WHOLE, make_graph
from test_torch_port_aggregate import SCALARS
from test_torch_port_dual_lanes import _add, _fma, group_head_sums
from test_torch_port_payload_walk import Walk, _fold, _lanes_of

F32 = np.float32
BF16 = torch.bfloat16
KEY_FAMILIES = ("cosine_sim", "pearson", "exp_kernel", "exp_kernel_beltrami")
THREADS = F.SCORE_MAX_THREADS
N, D, ATT, H = 40, 24, 24, 2
HUB, EDGELESS = 0, 2


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


class HubCase:
    """A graph of N nodes in both packages: node 0 a hub of 300 edges (cut
    into pieces of ``COL_PIECE``), node 1 a row of 40, node 2 edgeless,
    the rest random; the JAX stripe plan over the same sorted rows and the
    port's row-sorted graph (padded), a per-edge payload and projections
    (packed to 2 ATT for exp_kernel_beltrami) and the score's scalars."""

    def __init__(self, score="cosine_sim", seed=0, d=D, att=ATT, heads=H):
        rng = np.random.default_rng(seed)
        row = np.sort(np.concatenate([np.full(300, HUB), np.full(40, 1),
                                      rng.integers(3, N, 260)]))
        col = rng.integers(0, N, row.shape[0])
        self.score, self.heads, self.row = score, heads, row
        self.e = row.shape[0]
        self.plan = build_stripe_plan(row, num_nodes=N, block_n=8, chunk=16)
        self.slot = np.asarray(self.plan.slot_of_edge)
        self.g = make_graph(row, col, num_nodes=N,
                            pad_multiple=64).sort_by_row()
        assert self.g.capacity > self.g.num_valid
        self.att = 2 * att if score == "exp_kernel_beltrami" else att
        self.x_n = (0.5 * rng.normal(size=(N, d))).astype(F32)
        self.x_g = (0.5 * rng.normal(size=(self.g.capacity, d))).astype(F32)
        self.qw = (rng.normal(size=(d, self.att)) / math.sqrt(d)).astype(F32)
        self.kw = (rng.normal(size=(d, self.att)) / math.sqrt(d)).astype(F32)
        self.qb = (0.1 * rng.normal(size=self.att)).astype(F32)
        self.kb = (0.1 * rng.normal(size=self.att)).astype(F32)
        self.gmax = np.array([0.2], F32)
        self.shifts = (0.3 * rng.normal(size=(self.g.capacity,
                                              heads))).astype(F32)
        self.sp = np.array(SCALARS.get(score, ()), F32)

    def slots(self, a):
        out = np.zeros((self.plan.capacity,) + a.shape[1:], a.dtype)
        out[self.slot] = a[:self.e]
        return jnp.asarray(out)

    def t_ops(self, payload=torch.float32):
        """(qw, qb, kw, kb, x_n, x_g, gmax) as the port takes them."""
        qw, qb, kw, kb, x_n, x_g, gmax = (
            torch.tensor(a) for a in (self.qw, self.qb, self.kw, self.kb,
                                      self.x_n, self.x_g, self.gmax))
        return qw, qb, kw, kb, x_n, x_g.to(payload), gmax

    def t_scalars(self):
        sp = tuple(torch.tensor([v]) for v in self.sp)
        return F.score_scalars(self.score, sp)


# ---------------------------------------------------------------------------
# K19
# ---------------------------------------------------------------------------

def _max_nan(a, b):
    return np.where(np.isnan(a) | np.isnan(b), np.nan, np.maximum(a, b))


def score_max_mirror(pc, x_g, q, kw, kb, heads, walk):
    """K19's walk: (each block's maximum, the result). The scores as K18's
    scaled-dot walk forms them; the lanes past the row's heads hold
    none."""
    r, c = _fold(q, kw, kb, heads)
    ptr, prow = pc.ptr.numpy(), pc.col.numpy()
    per_block = THREADS // walk.g
    blocks = max(1, -(-pc.n_pieces // per_block))
    part = np.full(blocks, -np.inf, F32)
    for p in range(pc.n_pieces):
        row, start, end = prow[p], ptr[p], ptr[p + 1]
        m = F32(-np.inf)
        for h0, nh in walk.passes():
            rl = walk.held(r[row], h0, nh)
            cl = np.zeros(walk.hp, F32)
            cl[:nh] = c[row, h0:h0 + nh]
            for e in range(start, end):
                xv = _lanes_of(x_g[e], walk.pos)
                s = group_head_sums(walk.dots(rl, xv)[None])[0][:, 0]
                score = (s + cl[walk.hl]).astype(F32)
                for v in score[walk.hl < nh]:
                    m = _max_nan(m, v)
        part[p // per_block] = _max_nan(part[p // per_block], m)
    out = F32(-np.inf)
    for v in part:
        out = _max_nan(out, v)
    return part, (out if np.isfinite(out) else F32(0.0))


def _k19_inputs(case, payload=torch.float32, nan_edge=None):
    x_g = case.x_g.copy()
    if nan_edge is not None:
        x_g[nan_edge, 3] = np.nan
    q = (case.x_n @ case.qw + case.qb).astype(F32)
    return q, torch.tensor(x_g).to(payload)


def _k19_jax(case, q, x_g):
    return float(jfused._fused_score_max_impl(
        case.plan, jnp.asarray(q), jnp.asarray(case.kw),
        jnp.asarray(case.kb), heads=case.heads,
        x_g=case.slots(x_g.float().numpy()), dtype=jnp.float32,
        interpret=True))


class TestScoreMax:
    @pytest.mark.parametrize("payload", [torch.float32, BF16])
    def test_hub_pieces(self, payload):
        """The hub row in pieces: mirror, plain version (float64) and
        Pallas (float32, interpret) agree within 1e-5; the hub is cut."""
        case = HubCase("scaled_dot", seed=1, d=16, att=16, heads=4)
        pc = case.g.scatter_pieces
        assert pc.n_multi >= 1 and pc.longest > SCATTER_WHOLE
        q, x_g = _k19_inputs(case, payload)
        g_, v = lanes("payload_walk", 16, x_g, heads=4)
        walk = Walk(16, 4, g_, v)
        parts, got = score_max_mirror(pc, x_g.float().numpy(), q,
                                      torch.tensor(case.kw),
                                      torch.tensor(case.kb), 4, walk)
        assert parts.shape == (max(1, -(-pc.n_pieces * g_ // THREADS)),)
        want = kernels.fused_score_max_plain(
            case.g.rowptr, case.g.row, torch.tensor(q).double(), x_g,
            torch.tensor(case.kw).double(), torch.tensor(case.kb).double(),
            heads=4)
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        jm = _k19_jax(case, q, x_g)
        assert abs(float(got) - jm) <= 1e-5 * abs(jm)
        port = kernels.fused_score_max(
            case.g.rowptr, case.g.row, torch.tensor(q), x_g,
            torch.tensor(case.kw), torch.tensor(case.kb), heads=4,
            pieces=pc)
        assert abs(float(port) - float(want)) <= 1e-6 * abs(float(want))

    def test_nan_score(self):
        """A NaN payload element: its edge's scores are NaN, the NaN wins
        its block's maximum and the total, which is then not finite: 0, as
        the plain version and the Pallas kernel give."""
        case = HubCase("scaled_dot", seed=2, d=16, att=16, heads=4)
        pc = case.g.scatter_pieces
        nan_edge = int(case.g.rowptr[5])
        q, x_g = _k19_inputs(case, nan_edge=nan_edge)
        g_, v = lanes("payload_walk", 16, x_g, heads=4)
        parts, got = score_max_mirror(pc, x_g.numpy(), q,
                                      torch.tensor(case.kw),
                                      torch.tensor(case.kb), 4,
                                      Walk(16, 4, g_, v))
        assert np.isnan(parts).sum() == 1 and got == 0.0
        plain = kernels.fused_score_max(
            case.g.rowptr, case.g.row, torch.tensor(q), x_g,
            torch.tensor(case.kw), torch.tensor(case.kb), heads=4)
        assert plain.tolist() == [0.0]
        assert _k19_jax(case, q, x_g) == 0.0

    def test_edgeless_graph(self):
        """No edge: every block's maximum is -inf, the result 0, as the
        plain version gives."""
        g = make_graph(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       num_nodes=6, pad_multiple=8).sort_by_row()
        pc = g.scatter_pieces
        assert pc.n_pieces == 6 and pc.n_edges == 0
        walk = Walk(8, 2, *lanes("payload_walk", 8, heads=2))
        parts, got = score_max_mirror(
            pc, np.ones((g.capacity, 8), F32), np.ones((6, 4), F32),
            torch.ones(8, 4), torch.ones(4), 2, walk)
        assert np.all(parts == -np.inf) and got == 0.0
        out = kernels.fused_score_max(
            g.rowptr, g.row, torch.ones(6, 4), torch.ones(g.capacity, 8),
            torch.ones(8, 4), torch.ones(4), heads=2, pieces=pc)
        assert out.tolist() == [0.0]

    def test_rejects(self):
        case = HubCase("scaled_dot", seed=3, d=16, att=16, heads=4)
        q, x_g = _k19_inputs(case)
        args = (case.g.rowptr, case.g.row, torch.tensor(q))
        kw, kb = torch.tensor(case.kw), torch.tensor(case.kb)
        with pytest.raises(TypeError):
            kernels.fused_score_max(*args, x_g.half(), kw, kb, heads=4)
        with pytest.raises(ValueError):
            kernels.fused_score_max(*args, x_g[:-1].contiguous(), kw, kb,
                                    heads=4)
        with pytest.raises(ValueError):
            kernels.fused_score_max(*args, x_g, kw, kb, heads=3)


# ---------------------------------------------------------------------------
# K18's key families: the key tile
# ---------------------------------------------------------------------------

def _tf32_split(v):
    """dense.cuh's tf32_split: big = v rounded to TF32 (an integer add
    and a mask), small = v - big (exact in float32)."""
    v = np.asarray(v, F32)
    big = ((v.view(np.uint32).astype(np.uint64) + 0x1000) & 0xffffe000) \
        .astype(np.uint32).view(F32)
    return big, (v - big).astype(F32)


def _tf32_operand(v):
    """What the tensor cores read of a register: its TF32 bits, the low 13
    dropped."""
    return (np.asarray(v, F32).view(np.uint32) & np.uint32(0xffffe000)) \
        .view(F32)


def _rtz(acc64):
    """float64 sums to float32, rounded toward zero (mma.sync's sum)."""
    r = acc64.astype(F32)
    over = np.abs(r.astype(np.float64)) > np.abs(acc64)
    return np.where(over, np.nextafter(r, F32(0)), r).astype(F32)


def key_tile(x, kw, kb, exact=False):
    """The keys [E, ATT] of payload rows x [E, D] as the tile forms them:
    from kb, per pair of k8 steps two partial sums of the 3xTF32 products,
    the small terms (small a x big b, then big a x small b per step; a
    bfloat16 row (``exact``) is a TF32 value, its small part 0: one) and
    big a x big b, each mma.sync adding its 8 products to its sum rounded
    toward zero; then big + small added to the sum in float32."""
    x, kw = np.asarray(x, F32), np.asarray(kw, F32)
    e, d = x.shape
    att = kw.shape[1]
    d8 = -(-d // 8) * 8
    xp = np.zeros((e, d8), F32)
    xp[:, :d] = x
    wp = np.zeros((d8, att), F32)
    wp[:d] = kw
    ab, as_ = _tf32_split(xp)
    if exact:
        assert not as_.any(), "a bfloat16 row is a TF32 value"
    bb, bs = _tf32_split(wp)
    small_ops = [(ab, bs)] if exact else [(as_, bb), (ab, bs)]
    acc = np.broadcast_to(np.asarray(kb, F32), (e, att)).astype(F32)
    steps = d8 // 8

    def mma(c, a_, b_, sl):
        prod = (_tf32_operand(a_[:, sl]).astype(np.float64)
                @ _tf32_operand(b_[sl]).astype(np.float64))
        return _rtz(c.astype(np.float64) + prod)

    for k0 in range(0, steps, 2):
        big = np.zeros((e, att), F32)
        small = np.zeros((e, att), F32)
        for ks in range(k0, min(k0 + 2, steps)):
            sl = slice(8 * ks, 8 * ks + 8)
            for a_, b_ in small_ops:
                small = mma(small, a_, b_, sl)
            big = mma(big, ab, bb, sl)
        acc = _add(acc, _add(big, small))
    return acc


class TestKeyTile:
    @pytest.mark.parametrize("d,att", [(24, 24), (80, 128), (128, 64)])
    def test_against_float64(self, d, att):
        """The tile's keys within 1e-6 of the float64 key's scale (and the
        plain version's float32 key as close)."""
        rng = np.random.default_rng(d + att)
        x = rng.normal(size=(50, d)).astype(F32)
        kw = (rng.normal(size=(d, att)) / math.sqrt(d)).astype(F32)
        kb = (0.1 * rng.normal(size=att)).astype(F32)
        want = x.astype(np.float64) @ kw.astype(np.float64) + kb
        assert _rel(key_tile(x, kw, kb), want) < 1e-6
        assert _rel(x @ kw + kb, want) < 1e-6

    def test_split_parts(self):
        """big holds 10 mantissa bits, rounded to nearest; big + small is
        v exactly; small is at most half a TF32 step of v."""
        v = np.random.default_rng(0).normal(size=1000).astype(F32)
        big, small = _tf32_split(v)
        assert not (big.view(np.uint32) & 0x1fff).any()
        assert np.array_equal((big + small).astype(F32), v)
        assert np.all(np.abs(small) <= np.abs(v) * 2.0 ** -11)

    def test_bf16_payload_exact(self):
        """A bfloat16 row widened is a TF32 value: its small part is 0, and
        two products give the keys three would."""
        rng = np.random.default_rng(1)
        x = torch.tensor(rng.normal(size=(40, 32)).astype(F32)).to(BF16)
        xw = x.float().numpy()
        assert not _tf32_split(xw)[1].any()
        kw = (rng.normal(size=(32, 16)) / 6).astype(F32)
        kb = (0.1 * rng.normal(size=16)).astype(F32)
        assert np.array_equal(key_tile(xw, kw, kb, exact=True),
                              key_tile(xw, kw, kb))
        want = xw.astype(np.float64) @ kw.astype(np.float64) + kb
        assert _rel(key_tile(xw, kw, kb, exact=True), want) < 1e-6


# ---------------------------------------------------------------------------
# K18's key families: the walk over windows of row pieces
# ---------------------------------------------------------------------------

def head_scores(q, k, heads, score, sp):
    """[E, H] scores of q, k rows [E, ATT] in ``head_score``'s float32
    arithmetic and order (the serial sums over a head's d_k columns)."""
    e, att = q.shape
    belt = score == "exp_kernel_beltrami"
    dk = att // (2 * heads if belt else heads)
    out = np.zeros((e, heads), F32)
    for h in range(heads):
        qh, kh = q[:, h * dk:(h + 1) * dk], k[:, h * dk:(h + 1) * dk]
        if score in ("exp_kernel", "exp_kernel_beltrami"):
            var, ls = F32(sp[0]), F32(sp[1])
            dist = np.zeros(e, F32)
            for j in range(dk):
                df = (qh[:, j] - kh[:, j]).astype(F32)
                dist = _fma(df, df, dist)
            s = (var * var * np.exp(-dist / (F32(2) * ls * ls))).astype(F32)
            if belt:
                var_p, ls_p = F32(sp[2]), F32(sp[3])
                off = heads * dk
                qp = q[:, off + h * dk:off + (h + 1) * dk]
                kp = k[:, off + h * dk:off + (h + 1) * dk]
                dp = np.zeros(e, F32)
                for j in range(dk):
                    df = (qp[:, j] - kp[:, j]).astype(F32)
                    dp = _fma(df, df, dp)
                s = (s * (var_p * var_p) * np.exp(
                    -dp / (F32(2) * ls_p * ls_p))).astype(F32)
            out[:, h] = s
            continue
        mq = np.zeros(e, F32)
        mk = np.zeros(e, F32)
        if score == "pearson":
            sq, sk = np.zeros(e, F32), np.zeros(e, F32)
            for j in range(dk):
                sq, sk = _add(sq, qh[:, j]), _add(sk, kh[:, j])
            mq, mk = (sq / F32(dk)).astype(F32), (sk / F32(dk)).astype(F32)
        sp_, ss, kk = (np.zeros(e, F32) for _ in range(3))
        for j in range(dk):
            a = (qh[:, j] - mq).astype(F32)
            b = (kh[:, j] - mk).astype(F32)
            sp_, ss, kk = _fma(a, b, sp_), _fma(a, a, ss), _fma(b, b, kk)
        ns = np.maximum(np.sqrt(ss), F32(1e-5)).astype(F32)
        nk = np.maximum(np.sqrt(kk), F32(1e-5)).astype(F32)
        out[:, h] = (sp_ / (ns * nk).astype(F32)).astype(F32)
    return out


def key_walk(case, pc, x_g, q, keys, heads, shifts, square_plus, cap,
             window):
    """K18's key-family walk: (num [N, H D], den [N, H]) in the kernel's
    order (see the module docstring)."""
    ptr, prow, slot = pc.ptr.numpy(), pc.col.numpy(), pc.slot.numpy()
    row = case.g.row.numpy()
    d = x_g.shape[1]
    hd, cols = heads * d, heads * d + heads
    stride = F.payload_stride(d, heads)
    num = np.full((N, hd), np.nan, F32)
    den = np.full((N, heads), np.nan, F32)
    part = np.full((pc.n_slots, stride), np.nan, F32)
    gm = F32(case.gmax[0])
    col_h = np.concatenate([np.repeat(np.arange(heads), d),
                            np.arange(heads)])
    col_d = np.concatenate([np.tile(np.arange(d), heads),
                            np.zeros(heads, int)])
    is_num = np.arange(cols) < hd

    def flush(p, acc):
        if slot[p] >= 0:
            part[slot[p], :cols] = acc
        else:
            num[prow[p]], den[prow[p]] = acc[:hd], acc[hd:]

    n_windows = max(1, -(-pc.n_edges // window))   # the blocks
    starts = ptr[:pc.n_pieces]
    covered = []
    for w in range(n_windows):
        p0 = int(np.searchsorted(starts, w * window, "left"))
        p1 = (pc.n_pieces if w + 1 == n_windows
              else int(np.searchsorted(starts, (w + 1) * window, "left")))
        if p0 >= p1:
            continue
        covered += list(range(p0, p1))
        e_end, s0, first = ptr[p1], ptr[p0], p0
        carry = np.zeros(cols, F32)
        carried = False
        while True:
            cnt = min(cap, e_end - s0)
            s_end, last = s0 + cnt, s0 + cnt >= e_end
            ids = np.arange(s0, s_end)
            s = head_scores(q[row[ids]], keys[ids], heads, case.score,
                            case.sp)
            sm = (s - gm).astype(F32)
            if shifts is not None:
                sm = (sm - shifts[ids]).astype(F32)
            if square_plus:
                root = np.sqrt(sm * sm + F32(4)).astype(F32)
                u = ((sm + root) * F32(0.5)).astype(F32)
            else:
                u = np.exp(sm).astype(F32)
            acc = carry.copy() if carried else np.zeros(cols, F32)
            p, p_end = first, ptr[first + 1]
            for i, e in enumerate(ids):
                while p_end <= e:                  # pieces that end here
                    flush(p, acc)
                    acc = np.zeros(cols, F32)
                    p += 1
                    p_end = ptr[p + 1]
                ue = u[i, col_h]
                acc = np.where(is_num, _fma(ue, x_g[e, col_d], acc),
                               _add(acc, ue)).astype(F32)
            if last:
                for q_ in range(p, p1):
                    flush(q_, acc)
                    acc = np.zeros(cols, F32)
            else:
                while ptr[p + 1] <= s_end:
                    flush(p, acc)
                    acc = np.zeros(cols, F32)
                    p += 1
                carry = acc
                while ptr[first + 1] <= s_end:
                    first += 1
                carried = ptr[first] < s_end
            s0 = s_end
            if s0 >= e_end:
                break
    assert covered == list(range(pc.n_pieces))      # every piece once
    multi_row, multi_ptr = pc.multi_col.numpy(), pc.multi_ptr.numpy()
    for m in range(pc.n_multi):
        tot = np.zeros(stride, F32)
        for p in range(multi_ptr[m], multi_ptr[m + 1]):
            tot = _add(tot, part[p])
        num[multi_row[m]], den[multi_row[m]] = tot[:hd], tot[hd:cols]
    return num, den


def mirror_aggregate(case, payload=torch.float32, shifts=False,
                     square_plus=False, cap=None, blocks=3):
    """The walk over ``blocks`` windows (the launcher's W: the edges over
    the blocks) in tiles of the design's CAP, or of ``cap``."""
    x_g = torch.tensor(case.x_g).to(payload).float().numpy()
    des = F.key_design(x_g.shape[1], case.att, case.heads,
                       2 if payload == BF16 else 4)
    q = (case.x_n @ case.qw + case.qb).astype(F32)
    keys = key_tile(x_g, case.kw, case.kb, exact=payload == BF16)
    pc = case.g.scatter_pieces
    return key_walk(case, pc, x_g, q, keys, case.heads,
                    case.shifts if shifts else None, square_plus,
                    cap or des["cap"], max(1, -(-pc.n_edges // blocks)))


def plain64(case, payload=torch.float32, shifts=False, square_plus=False):
    qw, qb, kw, kb, x_n, x_g, gmax = case.t_ops(payload)
    var, ls = case.t_scalars()

    def wide(t):
        return None if t is None else t.double()
    return kernels.fused_aggregate_plain(
        case.g.rowptr, case.g.row, x_n.double(), x_g, wide(qw), wide(qb),
        wide(kw), wide(kb), wide(gmax), heads=case.heads, score=case.score,
        var=wide(var), ls=wide(ls),
        shifts=torch.tensor(case.shifts).double() if shifts else None,
        square_plus=square_plus)


class TestKeyWalk:
    @pytest.mark.parametrize("score", KEY_FAMILIES)
    @pytest.mark.parametrize("tile", ["design", "small"])
    def test_against_plain(self, score, tile):
        """Three windows in tiles of the design, and 50 windows of 12 edges
        in tiles of 16 rows (windows that span tiles: the carried sums; and
        windows that hold no piece's start), within 1e-5 of the plain
        version in float64; every row written, the edgeless one 0."""
        case = HubCase(score, seed=10)
        small = dict(cap=16, blocks=50) if tile == "small" else {}
        num, den = mirror_aggregate(case, **small)
        want_num, want_den = plain64(case)
        assert not np.isnan(num).any() and not np.isnan(den).any()
        assert not num[EDGELESS].any() and not den[EDGELESS].any()
        assert _rel(num, want_num) < 1e-5 and _rel(den, want_den) < 1e-5

    @pytest.mark.parametrize("score", KEY_FAMILIES)
    def test_against_pallas(self, score):
        """Against the Pallas ``_fused_call`` (``fused_rhs_aggregate``'s
        forward) at float32 in interpret mode, 1e-5 of scale."""
        case = HubCase(score, seed=11)
        num, den = mirror_aggregate(case)
        jn, jd = jfused._fused_call(
            case.plan, *(jnp.asarray(a) for a in (case.qw, case.qb,
                                                  case.kw, case.kb,
                                                  case.x_n)),
            case.slots(case.x_g), jnp.asarray(case.gmax[0]), heads=H,
            square_plus=False, dtype=jnp.float32, interpret=True,
            score=score, score_params=tuple(jnp.asarray(v)
                                            for v in case.sp))
        assert _rel(num, jn) < 1e-5 and _rel(den, np.asarray(jd)[:, :H]) \
            < 1e-5

    @pytest.mark.parametrize("score", KEY_FAMILIES)
    def test_bf16_payload(self, score):
        """A bfloat16 payload (two products a step), shifts and
        squareplus: within 1e-5 of the plain version on the same bf16
        values in float64."""
        case = HubCase(score, seed=12)
        num, den = mirror_aggregate(case, BF16, shifts=True,
                                    square_plus=True, cap=32, blocks=7)
        want_num, want_den = plain64(case, BF16, shifts=True,
                                     square_plus=True)
        assert _rel(num, want_num) < 1e-5 and _rel(den, want_den) < 1e-5

    def test_wrapper_on_cpu(self):
        """On CPU tensors the wrapper runs the plain version (the pieces
        handed over are not read) and counts no launch."""
        case = HubCase("pearson", seed=13)
        qw, qb, kw, kb, x_n, x_g, gmax = case.t_ops()
        before = (kernels.fused_aggregate.launches,
                  kernels.fused_aggregate.walk_launches,
                  kernels.fused_aggregate.piece_builds)
        num, den = kernels.fused_aggregate(
            case.g.rowptr, case.g.row, x_n, x_g, qw, qb, kw, kb, gmax,
            heads=H, score="pearson", pieces=case.g.scatter_pieces)
        want_num, want_den = plain64(case)
        assert _rel(num, want_num) < 1e-5 and _rel(den, want_den) < 1e-5
        assert (kernels.fused_aggregate.launches,
                kernels.fused_aggregate.walk_launches,
                kernels.fused_aggregate.piece_builds) == before


# ---------------------------------------------------------------------------
# key_design's shared-memory sums
# ---------------------------------------------------------------------------

def _layout_regions(d, att, heads, cap, elem):
    """``csrc/fused_payload.cu``'s key_layout, region by region: Kw's
    TF32 parts, the two row buffers, their edges' rows, the keys, u, the
    carried sums and the window's bounds."""
    d8, a8 = -(-d // 8) * 8, -(-att // 8) * 8
    xs = -(-d // (128 // elem)) * (128 // elem) + 16 // elem
    regions = [8 * d8 * a8, 2 * cap * xs * elem, 2 * 4 * cap,
               4 * cap * (a8 + 1), 4 * cap * heads,
               4 * F.payload_stride(d, heads), 16]
    assert all(r % 16 == 0 for r in regions[:3]) and (xs * elem) % 16 == 0
    assert (xs * elem) % 128 == 16       # A-fragment loads in 32 banks
    return regions


def _layout_bytes(d, att, heads, cap, elem):
    return sum(_layout_regions(d, att, heads, cap, elem))


def _fits(shared, per_sm):
    return (shared <= F.MAX_SHARED_BYTES and per_sm * (
        shared + F.KEY_BLOCK_RESERVED) <= F.SM_SHARED_BYTES)


class TestKeyDesign:
    @pytest.mark.parametrize("d,att,heads,elem,cap,per_sm", [
        (128, 64, 2, 4, 32, 2),      # arxiv BLEND, float32 payload
        (128, 64, 2, 2, 48, 2),      # ... bfloat16 payload
        (80, 128, 8, 4, 64, 1),      # the Cora GRAND-nl widths
        (80, 128, 8, 2, 64, 1),
        (80, 256, 8, 4, 32, 1),      # BLEND's halves at Cora's widths
        (24, 24, 2, 4, 64, 2),
    ])
    def test_shapes(self, d, att, heads, elem, cap, per_sm):
        """Two blocks an SM at the largest tile where they fit, else one
        at the largest tile that fits; the shared bytes are the kernel's
        layout's."""
        des = F.key_design(d, att, heads, elem)
        assert (des["cap"], des["per_sm"]) == (cap, per_sm)
        assert des["shared"] == _layout_bytes(d, att, heads, cap, elem)
        assert _fits(des["shared"], per_sm)
        larger = F.KEY_CAPS[:F.KEY_CAPS.index(cap)]
        assert not any(_fits(_layout_bytes(d, att, heads, c, elem), per_sm)
                       for c in larger)
        if per_sm == 1:
            assert not any(_fits(_layout_bytes(d, att, heads, c, elem), 2)
                           for c in F.KEY_CAPS[:3])
        # the split Kw is D ATT 8 bytes where both are multiples of 8
        if d % 8 == 0 and att % 8 == 0:
            assert _layout_regions(d, att, heads, cap, elem)[0] == 8 * d * att

    def test_split_weights_region(self):
        """Kw's high and low parts take 8 bytes an element of Kw padded to
        multiples of 8 (64 KB at arxiv BLEND): what leaves a float32
        payload's tile at 32 rows there, where a tile of 64 would fit two
        blocks an SM without them."""
        des = F.key_design(128, 64, 2, 4)
        regions = _layout_regions(128, 64, 2, des["cap"], 4)
        assert regions[0] == 8 * 128 * 64 == 64 * 1024
        assert des["shared"] - sum(regions[1:]) == regions[0]
        assert F.key_shared(128, 64, 2, 4, des["cap"]) == dict(
            weights=regions[0], tiles=sum(regions[1:]))
        assert _layout_regions(80, 20, 2, 16, 4)[0] == 8 * 80 * 24
        assert des["cap"] == 32
        assert _fits(sum(_layout_regions(128, 64, 2, 64, 4)[1:]), 2)

    def test_raises_beyond_a_block(self):
        """Kw's parts at D = ATT = 256 (512 KB) fit no block."""
        with pytest.raises(ValueError, match="shared memory"):
            F.key_design(256, 256, 8)
        with pytest.raises(ValueError, match="Kw's TF32 parts"):
            F.key_design(200, 192, 4, 2)

    def test_payload_shared(self):
        F._payload_shared("k", 8, 8, F.MAX_SHARED_BYTES)
        with pytest.raises(ValueError, match="more shared memory"):
            F._payload_shared("k", 8, 8, F.MAX_SHARED_BYTES + 4)
