"""K18 ``fused_aggregate`` and K8's per-head mode ``fused_rhs_bwd_heads``
over the scaled-dot fold (``csrc/payload_walk.cuh``, ``payload_fwd.cu``,
``payload_bwd.cu``) in a numpy mirror of the kernels' order, on the CPU.

The score is linear in the key, so Kw folds into each row's query once
(r_nh = Kw_h q_nh / sqrt(d_k), c_nh = <q_nh, kb_h> / sqrt(d_k)) and the
walks read each payload row once. The mirror follows the built kernels: the
fold's sums over each head's d_k columns in order, then scaled; a row piece
(``Graph.scatter_pieces``) on a group of G lanes, lane l holding the row's
vectors l, l + G, ... (``kernels.lanes``' ``payload_walk`` entry); each
edge's partial dots reduced by the transposed butterfly (the dual-lanes
file's ``group_head_sums``), u (and ds) on the head's lanes and handed to
every lane; num, dxg and a in float32 fused multiply-adds in edge order;
den and b in edge order; the pieces' partial rows added in piece order;
then the node pass head by head (``payload_bwd.cu``'s
``payload_node_kernel``, its block from ``kernels.fused_rhs.node_design``):
each thread's R rows of dq's share, the shares added in row order, then
scaled; dKw, dKb and the sum of b over each range of nodes in node order,
the ranges added in order. It is held against
``fused_aggregate_plain`` / ``fused_rhs_bwd_heads_plain`` in float64 at
1e-5 of scale: float32 and bfloat16 payloads beside float32 and bfloat16
row sides, per-edge shifts, squareplus, a hub row cut into pieces, an
edgeless row, two head passes and 8 heads on 8 lanes, the padding slots
of dxg (exactly 0), the node pass over several range counts. Also: the
lane chooser, the node pass's design and ranges, the wrappers on the CPU,
and two cases against the Pallas kernels P8 / P11 in interpret mode (their
bfloat16 default, 3e-2).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.kernels import fused_rhs as F
from graph_neural_pde_tpu_torch.kernels.lanes import lanes
from graph_neural_pde_tpu_torch.ops.graph import column_pieces, make_graph
from test_torch_port_aggregate import Case
from test_torch_port_dual_lanes import (_add, _fma, group_head_sums,
                                        vectors_a_lane)

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
ACC = int(re.search(r"constexpr int kPayloadAcc = (\d+);",
                    (CSRC / "payload_walk.cuh").read_text()).group(1))
MAX_HEADS_PER_PASS = 8
BF16 = torch.bfloat16
F32 = np.float32
N, D, ATT, H = 40, 16, 16, 4
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
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = want.detach().double().numpy() if torch.is_tensor(want) else want
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _graph(seed=0):
    """Random rows over nodes 3.., node 0 a hub of 150 edges (longer than
    the rows the walks take whole: five pieces), node 1 a row of 40, node
    2 edgeless; padded to a multiple of 64 slots."""
    rng = np.random.default_rng(seed)
    r = [rng.integers(3, N, 220), np.full(150, HUB), np.full(40, 1)]
    c = [rng.integers(0, N, 220), rng.integers(0, N, 150),
         rng.integers(0, N, 40)]
    g = make_graph(np.concatenate(r), np.concatenate(c), num_nodes=N,
                   pad_multiple=64).sort_by_row()
    assert int(g.rowptr[EDGELESS + 1] - g.rowptr[EDGELESS]) == 0
    assert g.capacity > g.num_valid
    return g


G0 = _graph()


def _inputs(seed, payload=torch.float32, row=torch.float32, heads=H):
    """(x_n, x_g, qw, qb, kw, kb, gmax, shifts, ct_num, ct_den), x_g over
    every slot (the padding rows too)."""
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0):
        return torch.tensor((s * rng.normal(size=shape)).astype(F32))

    x_n, x_g = t(N, D).to(row), t(G0.capacity, D).to(payload)
    qw, kw = t(D, ATT, s=D ** -0.5), t(D, ATT, s=D ** -0.5)
    qb, kb = t(ATT, s=0.1), t(ATT, s=0.1)
    gmax = torch.tensor([0.25])
    return (x_n, x_g, qw, qb, kw, kb, gmax, t(G0.capacity, heads, s=0.5),
            t(N, heads * D), 1.0 + t(N, heads, s=0.1))


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def _layout(d, g_, v):
    """[G, K, V]: the feature each lane holds at (k, i), -1 past D."""
    k = vectors_a_lane(d, g_, v)
    vec = np.arange(g_)[:, None] + g_ * np.arange(k)[None, :]
    pos = vec[..., None] * v + np.arange(v)
    return np.where((vec < d // v)[..., None], pos, -1)


def _lanes_of(rows, pos):
    """Rows [..., D] as the lanes hold them, [..., G, K, V] (0 past D)."""
    rows = np.asarray(rows, F32)
    return np.where(pos >= 0, rows[..., np.maximum(pos, 0)], 0).astype(F32)


def _rows_of(held, pos, d):
    out = np.zeros(held.shape[:-3] + (d,), F32)
    m = pos >= 0
    out[..., pos[m]] = held[..., m]
    return out


def _heads_a_pass(heads, k, v):
    """HP: the heads rounded up to a power of two, at most the power of two
    whose K V floats a head fit GNPDE_PAYLOAD_ACC (``payload_head_cap``),
    at most 8."""
    cap = 1
    while 2 * cap <= ACC // (k * v) and 2 * cap <= MAX_HEADS_PER_PASS:
        cap *= 2
    hp = 1
    while hp < heads and hp < cap:
        hp *= 2
    return hp


def _q(x_n, qw, qb):
    return (x_n.float() @ qw + qb).numpy()


def _fold(q, kw, kb, heads):
    """(r [N, H, D], c [N, H]): each sum over the head's d_k columns in
    order as float32 fused multiply-adds, then scaled, as the walk folds
    q's row (``fold_row``)."""
    kw, kb = kw.numpy(), kb.numpy()
    n, att = q.shape
    dk = att // heads
    r = np.zeros((n, heads, kw.shape[0]), F32)
    c = np.zeros((n, heads), F32)
    for j in range(dk):
        cols = np.arange(heads) * dk + j
        r = _fma(q[:, cols][:, :, None], kw[:, cols].T[None], r)
        c = _fma(q[:, cols], kb[cols][None], c)
    scale = F32(1.0) / np.sqrt(F32(dk))
    return (r * scale).astype(F32), (c * scale).astype(F32)


def _u(sm, square_plus):
    sm = np.asarray(sm, F32)
    if square_plus:
        root = np.sqrt(sm * sm + F32(4.0)).astype(F32)
        return ((sm + root) * F32(0.5)).astype(F32), \
            ((F32(1.0) + sm / root) * F32(0.5)).astype(F32)
    u = np.exp(sm).astype(F32)
    return u, u


class Walk:
    """One lane layout (G, V) over D features and H heads."""

    def __init__(self, d, heads, g_, v):
        self.d, self.heads, self.g, self.v = d, heads, g_, v
        self.pos = _layout(d, g_, v)
        self.k = self.pos.shape[1]
        self.hp = _heads_a_pass(heads, self.k, v)
        self.lane = np.arange(g_)
        self.hl = self.lane * self.hp // g_            # each lane's head
        self.src = np.arange(self.hp) * (g_ // self.hp)
        self.writes = self.lane % max(g_ // self.hp, 1) == 0
        self.stride = F.payload_stride(d, heads)

    def passes(self):
        for h0 in range(0, self.heads, self.hp):
            yield h0, min(self.hp, self.heads - h0)

    def held(self, rows, h0, nh):
        """The pass's heads of [H, D] rows as the lanes hold them."""
        out = np.zeros((self.hp, self.g, self.k, self.v), F32)
        out[:nh] = _lanes_of(rows[h0:h0 + nh], self.pos)
        return out

    def dots(self, held, xv):
        """[G, HP]: each lane's partial dots, in (k, i) order."""
        s = np.zeros((self.g, held.shape[0]), F32)
        for kk in range(self.k):
            for i in range(self.v):
                s = _fma(held[:, :, kk, i].T, xv[:, kk, i][:, None], s)
        return s

    def merge(self, pc, part, out):
        """The rows of several pieces: their partial rows in piece order."""
        multi_row, multi_ptr = pc.multi_col.numpy(), pc.multi_ptr.numpy()
        for m in range(pc.n_multi):
            tot = np.zeros(self.stride, F32)
            for p in range(multi_ptr[m], multi_ptr[m + 1]):
                tot = _add(tot, part[p])
            out(multi_row[m], tot)

    def forward(self, pc, x_g, r, c, gmax, shifts, square_plus):
        """K18's walk: (num [N, H D], den [N, H])."""
        n, hd = r.shape[0], self.heads * self.d
        num = np.full((n, hd), np.nan, F32)
        den = np.full((n, self.heads), np.nan, F32)
        part = np.full((pc.n_slots, self.stride), np.nan, F32)

        def out(row, vals):
            num[row], den[row] = vals[:hd], vals[hd:hd + self.heads]

        ptr, prow, slot = pc.ptr.numpy(), pc.col.numpy(), pc.slot.numpy()
        gm = F32(gmax)
        for p in range(pc.n_pieces):
            row, start, end = prow[p], ptr[p], ptr[p + 1]
            vals = np.zeros(self.stride, F32)
            for h0, nh in self.passes():
                has = end > start
                rl = self.held(r[row] if has else np.zeros_like(r[row]), h0,
                               nh)
                cl = np.zeros(self.hp, F32)
                cl[:nh] = c[row, h0:h0 + nh] if has else 0.0
                acc = np.zeros_like(rl)
                dsum = np.zeros(self.g, F32)
                for e in range(start, end):
                    xv = _lanes_of(x_g[e], self.pos)
                    s = group_head_sums(self.dots(rl, xv)[None])[0][:, 0]
                    sm = ((s + cl[self.hl]).astype(F32) - gm).astype(F32)
                    if shifts is not None:
                        sh = shifts[e, np.minimum(h0 + self.hl,
                                                  self.heads - 1)]
                        sm = np.where(self.hl < nh, sm - sh, sm).astype(F32)
                    u, _ = _u(sm, square_plus)
                    dsum = _add(dsum, u)
                    acc = _fma(u[self.src][:, None, None, None], xv[None],
                               acc)
                for h in range(nh):
                    vals[(h0 + h) * self.d:(h0 + h + 1) * self.d] = \
                        _rows_of(acc[h], self.pos, self.d)
                for lane in self.lane[self.writes & (self.hl < nh)]:
                    vals[hd + h0 + self.hl[lane]] = dsum[lane]
            if slot[p] < 0:
                out(row, vals)
            else:
                part[slot[p]] = vals
        self.merge(pc, part, out)
        return num, den

    def backward(self, pc, x_g, r, c, gmax, ct_num, ct_den, square_plus,
                 n_slots):
        """The per-head walk: (dxg [n_slots, D], ab [N, S])."""
        n, hd = r.shape[0], self.heads * self.d
        p2 = 2 * self.hp
        pair = self.g // p2 if p2 <= self.g else 0
        odd = (self.lane // max(pair, 1)) % 2 == 1
        dxg = np.full((n_slots, self.d), np.nan, F32)
        ab = np.zeros((n, self.stride), F32)
        part = np.full((pc.n_slots, self.stride), np.nan, F32)
        ptr, prow, slot = pc.ptr.numpy(), pc.col.numpy(), pc.slot.numpy()
        dxg[ptr[-1]:] = 0.0                  # the padding slots
        gm = F32(gmax)
        ctn = ct_num.reshape(n, self.heads, self.d)
        for p in range(pc.n_pieces):
            row, start, end = prow[p], ptr[p], ptr[p + 1]
            vals = np.zeros(self.stride, F32)
            for h0, nh in self.passes():
                has = end > start
                rl = self.held(r[row] if has else np.zeros_like(r[row]), h0,
                               nh)
                cl = np.zeros(self.hp, F32)
                cl[:nh] = c[row, h0:h0 + nh] if has else 0.0
                cn = self.held(ctn[row], h0, nh)
                cden = np.where(self.hl < nh, ct_den[
                    row, np.minimum(h0 + self.hl, self.heads - 1)],
                    0.0).astype(F32)
                acc = np.zeros_like(rl)
                bsum = np.zeros(self.g, F32)
                for e in range(start, end):
                    xv = _lanes_of(x_g[e], self.pos)
                    both = np.empty((self.g, p2), F32)
                    both[:, 0::2] = self.dots(rl, xv)
                    both[:, 1::2] = self.dots(cn, xv)
                    s = group_head_sums(both[None])[0]
                    if pair:
                        other = s[self.lane ^ pair, 0]
                        score = np.where(odd, other, s[:, 0])
                        dot = np.where(odd, s[:, 0], other)
                    else:
                        score, dot = s[:, 0], s[:, 1]
                    u, duds = _u(((score + cl[self.hl]).astype(F32) - gm)
                                 .astype(F32), square_plus)
                    ds = ((dot + cden).astype(F32) * duds).astype(F32)
                    bsum = _add(bsum, ds)
                    o = (np.zeros((self.g, self.k, self.v), F32) if h0 == 0
                         else _lanes_of(dxg[e], self.pos))
                    for h in range(self.hp):
                        o = _fma(u[self.src[h]], cn[h], o)
                        o = _fma(ds[self.src[h]], rl[h], o)
                        acc[h] = _fma(ds[self.src[h]], xv, acc[h])
                    dxg[e] = _rows_of(o, self.pos, self.d)
                for h in range(nh):
                    vals[(h0 + h) * self.d:(h0 + h + 1) * self.d] = \
                        _rows_of(acc[h], self.pos, self.d)
                for lane in self.lane[self.writes & (self.hl < nh)]:
                    vals[hd + h0 + self.hl[lane]] = bsum[lane]
            if slot[p] < 0:
                ab[row] = vals
            else:
                part[slot[p]] = vals

        def out(row, vals):
            ab[row] = vals

        self.merge(pc, part, out)
        return dxg, ab


def node_pass(ab, q, kw, kb, heads, ranges=3):
    """(dq, dkw, dkb, dgmax) from [a | b] and q as the node pass forms them
    head by head over ``ranges`` ranges of nodes: a thread's share of dq
    over its R rows of [a_h | b_h] x [Kw_h | kb_h] in row order, the
    shares added in order, then scaled; each range's [a_h | b_h]^T q_h
    and sum of b in node order, the ranges' partials added in order."""
    kw, kb = kw.numpy(), kb.numpy()
    d, att = kw.shape
    dk = att // heads
    des = F.node_design(d, att, heads)
    rows, chunks = des["rows"], des["chunks"]
    n = ab.shape[0]
    per = -(-n // ranges)
    scale = F32(1.0) / np.sqrt(F32(dk))
    dq = np.zeros((n, att), F32)
    part = np.zeros((ranges, d + 1, att), F32)
    bsum = np.zeros((ranges, heads), F32)
    for h in range(heads):
        cols = h * dk + np.arange(dk)
        a = np.zeros((n, rows * chunks), F32)
        a[:, :d], a[:, d] = ab[:, h * d:(h + 1) * d], ab[:, heads * d + h]
        w = np.zeros((rows * chunks, dk), F32)
        w[:d], w[d] = kw[:, cols], kb[cols]
        s = np.zeros((n, dk), F32)
        for c in range(chunks):
            share = np.zeros((n, dk), F32)
            for i in range(c * rows, (c + 1) * rows):
                share = _fma(a[:, i, None], w[i][None], share)
            s = _add(s, share)
        dq[:, cols] = s * scale
        for b in range(ranges):
            acc = np.zeros((d + 1, dk), F32)
            for node in range(b * per, min(n, (b + 1) * per)):
                acc = _fma(a[node, :d + 1, None], q[node, cols][None], acc)
                bsum[b, h] = _add(bsum[b, h], a[node, d])
            part[b][:, cols] = acc
    tot = np.zeros((d + 1, att), F32)
    for b in range(ranges):
        tot = _add(tot, part[b])
    tot = (tot * scale).astype(F32)
    dg = F32(0.0)
    for v in bsum.reshape(-1):
        dg = _add(dg, v)
    return dq, tot[:d], tot[d], -dg


def _widened(t):
    return t.float().numpy() if t.dtype == BF16 else t.numpy()


def mirror_forward(inp, walk, pieces, shifts=False, square_plus=False):
    x_n, x_g, qw, qb, kw, kb, gmax, sh = inp[:8]
    r, c = _fold(_q(x_n, qw, qb), kw, kb, walk.heads)
    return walk.forward(pieces, _widened(x_g), r, c, float(gmax[0]),
                        sh.numpy() if shifts else None, square_plus)


def mirror_backward(inp, walk, pieces, square_plus=False, ranges=3):
    """(dq, dxg, dkw, dkb, dgmax) in the kernels' order."""
    x_n, x_g, qw, qb, kw, kb, gmax, _, ct_num, ct_den = inp
    q = _q(x_n, qw, qb)
    r, c = _fold(q, kw, kb, walk.heads)
    dxg, ab = walk.backward(pieces, _widened(x_g), r, c, float(gmax[0]),
                            ct_num.numpy(), ct_den.numpy(), square_plus,
                            x_g.shape[0])
    dq, dkw, dkb, dgmax = node_pass(ab, q, kw, kb, walk.heads, ranges)
    return dq, dxg, dkw, dkb, dgmax


def _plain64(fn, inp, **kw):
    def wide(t):
        return t.double() if t.dtype == torch.float32 else t
    return fn(G0.rowptr, G0.row, *map(wide, inp), heads=kw.pop("heads", H),
              score="scaled_dot", **kw)


def _walk_for(inp, heads=H):
    g_, v = lanes("payload_walk", D, inp[1], heads=heads)
    return Walk(D, heads, g_, v)


DTYPES = [("f32 payload, f32 rows", torch.float32, torch.float32),
          ("bf16 payload, f32 rows", BF16, torch.float32),
          ("bf16 payload, bf16 rows", BF16, BF16),
          ("f32 payload, bf16 rows", torch.float32, BF16)]


# ---------------------------------------------------------------------------
# the mirror against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["exp", "shifts", "squareplus"])
@pytest.mark.parametrize("name,payload,row", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_forward_mirror(name, payload, row, variant):
    inp = _inputs(1, payload, row)
    shifts, sq = variant == "shifts", variant == "squareplus"
    num, den = mirror_forward(inp, _walk_for(inp), G0.scatter_pieces,
                              shifts, sq)
    want = _plain64(F.fused_aggregate_plain, inp[:7], square_plus=sq,
                    shifts=inp[7].double() if shifts else None)
    assert _rel(num, want[0]) < 1e-5 and _rel(den, want[1]) < 1e-5
    assert not num[EDGELESS].any() and not den[EDGELESS].any()


@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("name,payload,row", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_backward_mirror(name, payload, row, square_plus):
    inp = _inputs(2, payload, row)
    got = mirror_backward(inp, _walk_for(inp), G0.scatter_pieces,
                          square_plus)
    want = _plain64(F.fused_rhs_bwd_heads_plain, inp[:7] + inp[8:],
                    square_plus=square_plus)
    for i, (a, b) in enumerate(zip(got, want[:5])):
        assert _rel(a, b) < 1e-5, i
    assert not got[1][G0.num_valid:].any()          # padding slots: 0


def test_hub_row_in_pieces_against_whole_rows():
    """The hub row walks in five pieces and their merge; walked whole it
    gives the same sums within float32 rounding, forward and backward."""
    pieces = G0.scatter_pieces
    assert pieces.n_multi == 1 and int(pieces.multi_col[0]) == HUB
    assert int(pieces.multi_ptr[1]) == 5
    whole = column_pieces(G0.rowptr, piece=1 << 20)
    assert whole.n_multi == 0
    inp = _inputs(3)
    walk = _walk_for(inp)
    for a, b in zip(mirror_forward(inp, walk, pieces),
                    mirror_forward(inp, walk, whole)):
        assert _rel(a, b) < 1e-6
    for a, b in zip(mirror_backward(inp, walk, pieces),
                    mirror_backward(inp, walk, whole)):
        assert _rel(a, b) < 1e-6


LAYOUTS = {
    # single elements at 32 lanes (K = 8): 8 heads in two passes of 4, the
    # second adding its terms to the dxg rows the first wrote
    "two passes": (32, 1, 4),
    # 8 lanes, 8 heads in one pass: the backward's 16 sums an edge leave
    # each lane both of its head's (no pair exchange)
    "both sums on a lane": (8, 4, 8),
}


@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_head_layouts(layout, which):
    heads = 8
    g_, v, hp = LAYOUTS[layout]
    inp = _inputs(4, heads=heads)
    walk = Walk(D, heads, g_, v)
    assert walk.hp == hp
    if which == "forward":
        got = mirror_forward(inp, walk, G0.scatter_pieces, shifts=True)
        want = _plain64(F.fused_aggregate_plain, inp[:7], heads=heads,
                        shifts=inp[7].double())
    else:
        got = mirror_backward(inp, walk, G0.scatter_pieces)
        want = _plain64(F.fused_rhs_bwd_heads_plain, inp[:7] + inp[8:],
                        heads=heads)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


# ---------------------------------------------------------------------------
# the node-level products, the choosers, the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranges", [1, 4, 40])
def test_node_pass_over_ranges(ranges):
    """The node pass over one range, several, and a range a node (the
    partials and sums of b added in range order) against the plain
    version at 1e-5 of scale."""
    inp = _inputs(5)
    got = mirror_backward(inp, _walk_for(inp), G0.scatter_pieces,
                          ranges=ranges)
    want = _plain64(F.fused_rhs_bwd_heads_plain, inp[:7] + inp[8:])
    for i in (0, 2, 3, 4):
        assert _rel(got[i], want[i]) < 1e-5, i


@pytest.mark.parametrize("d,att,heads,want", [
    # arxiv: d_k 16, 17 chunks of 8 rows (D + 1 = 129), 3 blocks an SM
    (128, 32, 2, dict(cols=16, col_blocks=1, rows=8, chunks=17,
                      threads=288, shared=128 * (2 * (136 + 16) + 272),
                      per_sm=3)),
    # Cora: 11 chunks of 8 rows over d_k 16
    (80, 128, 8, dict(cols=16, col_blocks=1, rows=8, chunks=11,
                      threads=192, shared=128 * (2 * (88 + 16) + 176),
                      per_sm=4)),
    # the oracle: d_k 32 would take 544 threads at 8 rows
    (128, 64, 2, dict(cols=32, col_blocks=1, rows=16, chunks=9,
                      threads=288, shared=128 * (2 * (144 + 32) + 288),
                      per_sm=1)),
    # the widest: d_k 256 in 8 column blocks of 32
    (256, 256, 1, dict(cols=32, col_blocks=8, rows=16, chunks=17,
                       threads=544, shared=128 * (2 * (272 + 32) + 544),
                       per_sm=1)),
    # narrow heads: d_k 4
    (16, 16, 4, dict(cols=4, col_blocks=1, rows=8, chunks=3, threads=32,
                     shared=128 * (2 * (24 + 4) + 12), per_sm=24)),
])
def test_node_design(d, att, heads, want):
    got = F.node_design(d, att, heads)
    assert got == want
    assert got["threads"] <= (512 if got["rows"] == 8 else 544)
    assert got["shared"] <= F.MAX_SHARED_BYTES
    assert got["chunks"] * got["rows"] >= d + 1 > (got["chunks"] - 1) * \
        got["rows"]


@pytest.mark.parametrize("n,d,att,heads,sms,want", [
    (169343, 128, 32, 2, 132, 198),   # arxiv: one wave of 3 blocks an SM
    (2708, 80, 128, 8, 132, 43),      # Cora: ranges of at least 64 nodes
    (40, 16, 16, 4, 132, 1),          # fewer nodes than a range holds
])
def test_node_ranges(n, d, att, heads, sms, want):
    assert F.node_ranges(n, d, att, heads, sms) == want


def test_fold_dk_against_the_per_edge_reduction():
    """dKw, dKb from the reduction over nodes equal sum_e x_g^T dk_e and
    sum_e dk_e over the edges (the plain version's form)."""
    inp = _inputs(7)
    want = _plain64(F.fused_rhs_bwd_heads_plain, inp[:7] + inp[8:])
    got = mirror_backward(inp, _walk_for(inp), G0.scatter_pieces)
    assert _rel(got[2], want[2]) < 1e-5 and _rel(got[3], want[3]) < 1e-5
    assert got[2].shape == (D, ATT) and got[3].shape == (ATT,)


@pytest.mark.parametrize("d,heads,dtype,offset,want", [
    (128, 2, torch.float32, 0, (32, 4)),      # arxiv: a vector a lane
    (80, 8, torch.float32, 0, (32, 4)),       # Cora: 20 vectors
    (16, 4, torch.float32, 0, (8, 4)),        # at least 8 lanes
    (256, 8, torch.float32, 0, (32, 4)),      # two vectors a lane
    (128, 2, BF16, 0, (16, 8)),               # bf16: 16-byte vectors
    (80, 8, BF16, 0, (32, 4)),                # bf16, 8 heads: 8-byte ones
    (80, 8, torch.float32, 4, (32, 1)),       # a float table off 16 bytes
])
def test_lane_chooser(d, heads, dtype, offset, want):
    assert lanes("payload_walk", d, (0, dtype), (64 + offset, torch.float32),
                 heads=heads) == want
    g_, v = want
    k = vectors_a_lane(d, g_, v)
    assert _heads_a_pass(heads, k, v) * k * v <= max(ACC, k * v)


def test_wrappers_on_the_cpu_run_the_plain_versions():
    """On CPU tensors both wrappers run their plain versions, whatever
    ``pieces`` says, and count no launch of any pass."""
    inp = _inputs(8)
    counts = [(k, a, getattr(k, a)) for k, a in (
        (kernels.fused_aggregate, "launches"),
        (kernels.fused_aggregate, "walk_launches"),
        (kernels.fused_rhs_bwd_heads, "launches"),
        (kernels.fused_rhs_bwd_heads, "walk_launches"),
        (kernels.fused_rhs_bwd_heads, "node_launches"),
        (kernels.node_project, "launches"))]
    kw = dict(heads=H, score="scaled_dot", pieces=G0.scatter_pieces)
    num, _ = kernels.fused_aggregate(G0.rowptr, G0.row, *inp[:7], **kw)
    out = kernels.fused_rhs_bwd_heads(G0.rowptr, G0.row, *inp[:7],
                                      *inp[8:], **kw)
    assert torch.equal(num, F.fused_aggregate_plain(
        G0.rowptr, G0.row, *inp[:7], heads=H, score="scaled_dot")[0])
    assert out[1].shape == (G0.capacity, D)
    assert all(getattr(k, a) == v for k, a, v in counts)


# ---------------------------------------------------------------------------
# against the Pallas kernels
# ---------------------------------------------------------------------------

def _case_inputs(c):
    qw, qb, kw, kb, x_n, x_g, gmax = c.t_ops()
    ct_num, ct_den = c.t_cts()
    return (x_n, x_g, qw, qb, kw, kb, gmax, None, ct_num, ct_den)


def test_forward_mirror_against_pallas():
    """The mirror against P8 ``_fused_call`` in interpret mode at its
    bfloat16 default (3e-2 of scale)."""
    c = Case("scaled_dot", seed=11)
    inp = _case_inputs(c)
    g_, v = lanes("payload_walk", inp[1].shape[1], inp[1], heads=2)
    walk = Walk(inp[1].shape[1], 2, g_, v)
    r, cc = _fold(_q(inp[0], inp[2], inp[3]), inp[4], inp[5], 2)
    num, den = walk.forward(c.g.scatter_pieces, inp[1].numpy(), r, cc,
                            float(inp[6][0]), None, False)
    jn, jd = jfused._fused_call(c.plan, *c.j_ops(), heads=2,
                                square_plus=False, interpret=True)
    assert _rel(num, jn) < 3e-2 and _rel(den, np.asarray(jd)[:, :2]) < 3e-2


def test_backward_mirror_against_pallas():
    """The mirror against P11 ``_fused_bwd_mega_call`` without recip_p in
    interpret mode at its bfloat16 default (3e-2 of scale): dq, dxg per
    edge, dkw, dkb, dgmax."""
    c = Case("scaled_dot", seed=12)
    inp = _case_inputs(c)
    d = inp[1].shape[1]
    g_, v = lanes("payload_walk", d, inp[1], heads=2)
    walk = Walk(d, 2, g_, v)
    q = _q(inp[0], inp[2], inp[3])
    r, cc = _fold(q, inp[4], inp[5], 2)
    dxg, ab = walk.backward(c.g.scatter_pieces, inp[1].numpy(), r, cc,
                            float(inp[6][0]), inp[8].numpy(),
                            inp[9].numpy(), False, inp[1].shape[0])
    dq, dkw, dkb, dgmax = node_pass(ab, q, inp[4], inp[5], 2)
    got = [dq, dxg, dkw, dkb, dgmax]
    dq, jdxg, jdkw, jdkb, dgmax, _ = jfused._fused_bwd_mega_call(
        c.plan, *c.j_ops(), *c.j_cts(), heads=2, square_plus=False,
        interpret=True)
    want = [dq, np.asarray(jdxg)[c.slot], jdkw, jdkb, dgmax]
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a, b) < 3e-2, i
    assert math.isfinite(float(got[4]))
