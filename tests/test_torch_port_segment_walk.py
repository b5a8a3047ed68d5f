"""The walk of K3 ``segment_norm`` and K4 ``segment_norm_bwd`` on the CPU,
where the kernels cannot run: numpy mirrors of the order in which the
kernels (``csrc/segment_norm.cu``) visit and combine their operands, held
against the plain versions that define them and against the JAX package,
and the chooser (``kernels.lanes.segment_design``) held to what the kernels
were built for.

* A segment's piece (``ops.graph.column_pieces`` of its pointer, at most
  P = 32 members, 64 where the mean segment is longer: the graph's
  ``row_segments`` / ``col_segments``) goes to a group of G lanes; lane l
  holds the members l, l + G, ... (R = P / G of them), the heads in passes
  of HP, and reduces its members in that order.
* The group's per-head max and sum: the transposed xor butterfly, then each
  head read from the first lane holding it; every lane ends with all
  heads.
* A segment of one piece is written by its group; the pieces of a longer
  one write (max, sum) (K4: the sum of g * out) to their partial rows, and
  the second pass merges a segment's rows in piece order and writes the
  piece's members; the first piece's group writes den.
* The padding slots past segptr[N] are written 0, so the outputs start as
  NaN here: every slot must be written.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.ops import scatter as jsc
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.pallas.stripe import (build_stripe_plan,
                                                    stripe_segment_softmax,
                                                    stripe_segment_squareplus)
from graph_neural_pde_tpu_torch.kernels import lanes as L
from graph_neural_pde_tpu_torch.kernels.segment_norm import (
    segment_norm, segment_norm_bwd, segment_norm_bwd_plain,
    segment_norm_plain)
from graph_neural_pde_tpu_torch.ops import scatter as tsc
from graph_neural_pde_tpu_torch.ops.graph import (COL_PIECE,
                                                 SEGMENT_LONG_PIECE,
                                                 make_graph, segment_piece)

F32 = np.float32
EPS = F32(1e-16)


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# graphs: mean segments of 1, 9 and 64, a hub of 360, a directed graph with
# a hub column and empty columns, and a masked one
# ---------------------------------------------------------------------------

def _sym(r, c):
    return np.concatenate([r, c]), np.concatenate([c, r])


def _pairs(n):
    """Node 2i joined to 2i + 1 both ways, the last 10 nodes without edges:
    segments of 1 and empty ones."""
    r = np.arange(0, n - 10, 2)
    return _sym(r, r + 1) + (n,)


def _random(n, pairs, seed):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, pairs), rng.integers(0, n, pairs)
    return _sym(r, c) + (n,)


def _hub(n, degree, seed):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(1, n, 3 * n), rng.integers(1, n, 3 * n)
    peers = rng.choice(np.arange(1, n), degree, replace=False)
    r = np.concatenate([r, np.zeros(degree, np.int64)])
    c = np.concatenate([c, peers])
    return _sym(r, c) + (n,)


def _directed(n, seed):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, 6 * n), rng.integers(0, n // 2, 6 * n)
    r = np.concatenate([r, rng.integers(0, n, 100)])
    c = np.concatenate([c, np.full(100, 7)])                # a hub column
    return r, c, n


GRAPHS = {"mean1": lambda: _pairs(210),
          "mean9": lambda: _random(120, 540, 1),
          "mean64": lambda: _random(40, 1280, 2),
          "hub360": lambda: _hub(400, 360, 3),
          "directed": lambda: _directed(150, 4),
          "masked": lambda: _random(120, 540, 5)}


def _graph(name):
    r, c, n = GRAPHS[name]()
    g = make_graph(r.astype(np.int32), c.astype(np.int32), num_nodes=n,
                   pad_multiple=16).sort_by_row()
    if name == "masked":
        rng = np.random.default_rng(6)
        keep = g.mask & torch.from_numpy(rng.random(g.capacity) > 0.3)
        # node 3's row and, through rev, column: every edge masked
        keep &= (g.row != 3) & (g.col != 3)
        g = g.with_mask(keep)
    return g


def _layouts(g):
    """(name, segptr, seg, perm, pieces) of every layout the graph has:
    rows, columns through rev (symmetric graphs), the CSC view."""
    out = [("rows", g.rowptr, g.row, None, g.row_segments)]
    if g.rev is not None:
        out.append(("columns", g.rowptr, g.row, g.rev, g.row_segments))
    out.append(("csc", g.colptr, g.col_by_col, g.col_perm, g.col_segments))
    return out


def _scores(g, h, mode, seed):
    """float32 [capacity, H]: N(0, 1) scores for softmax (-inf on masked
    slots), positive weights for normalise (0 on masked slots)."""
    rng = np.random.default_rng(seed)
    if mode == "softmax":
        s = rng.normal(size=(g.capacity, h)).astype(F32)
        fill = -np.inf
    else:
        s = (rng.random((g.capacity, h)) + 0.05).astype(F32)
        fill = 0.0
    if g.masked:
        s[~g.mask.numpy()] = fill
    return s


# ---------------------------------------------------------------------------
# the mirrors
# ---------------------------------------------------------------------------

def per_pass(h):
    return min(L.SEGMENT_HEADS_PER_PASS, 1 << (h - 1).bit_length())


def group_reduce(v, op):
    """The kernels' ``group_reduce`` over axis -2 (G lanes) of v [..., G,
    HP]: the transposed xor butterfly, then every head's result read from
    the first lane holding it."""
    G, HP = v.shape[-2:]
    v = v.copy()
    lane = np.arange(G)
    level = 0
    while G >> (level + 1):
        o, m = G >> (level + 1), HP >> level
        partner = lane ^ o
        new = v.copy()
        if m >= 2:
            upper = ((lane & o) != 0)[:, None]
            send = np.where(upper, v[..., :m // 2], v[..., m // 2:m])
            keep = np.where(upper, v[..., m // 2:m], v[..., :m // 2])
            new[..., :m // 2] = op(keep, send[..., partner, :])
        else:
            new[..., 0] = op(v[..., 0], v[..., partner, 0])
        v = new
        level += 1
    if HP > 1:
        J = max(HP // G, 1)
        src = [h // J if G <= HP else h * (G // HP) for h in range(HP)]
        held = np.stack([v[..., src[h], h % J] for h in range(HP)], -1)
        v = np.repeat(held[..., None, :], G, axis=-2)
    return v


def _np(pc):
    return {k: getattr(pc, k).numpy().astype(np.int64)
            for k in ("ptr", "col", "slot", "multi_piece")}


def _members(ptr_lo, ptr_hi, perm, G, piece, cap):
    """Each group's members: (slots [P, G, R], present [P, G, R]); lane l's
    r-th member is position lo + l + G * r."""
    R = piece // G
    pos = (ptr_lo[:, None, None] + np.arange(G)[None, :, None]
           + G * np.arange(R)[None, None, :])
    ok = pos < ptr_hi[:, None, None]
    pos = np.where(ok, pos, 0)
    at = pos if perm is None else perm[np.minimum(pos, cap - 1)]
    return np.where(ok, at, 0), ok


def _lane_sums(v):
    """Each lane's sum of its members, in member order: v [P, G, R, HP]."""
    acc = np.zeros(v.shape[:2] + v.shape[3:], F32)
    for r in range(v.shape[2]):
        acc = acc + v[:, :, r]
    return acc


def _multi(p, segptr, q, length):
    """The merge pass's view of partial row q's piece: its segment, its
    index among the segment's pieces (of ``length`` members), the
    segment's first partial row and its count of pieces (``multi_piece``
    in the kernel)."""
    piece = p["multi_piece"][q]
    seg = p["col"][piece]
    s0, s1 = segptr[seg], segptr[seg + 1]
    index = (p["ptr"][piece] - s0) // length
    return piece, seg, index, q - index, -(-(s1 - s0) // length)


def _merge_rows(part, first, count, width, off):
    """[Q, count_max, width] rows of each group's segment, NaN past its
    count (every row read inside the count is a written one)."""
    cmax = int(count.max())
    i = np.arange(cmax)
    rows = part[np.minimum(first[:, None] + i, part.shape[0] - 1)][
        ..., off:off + width]
    return np.where((i < count[:, None])[..., None], rows, np.nan), cmax


def mirror_k3(segptr, perm, pc, s, mode, G):
    """K3's two passes as the kernel orders them: (out, den)."""
    segptr = segptr.numpy().astype(np.int64)
    perm = None if perm is None else perm.numpy().astype(np.int64)
    p = _np(pc)
    cap, H = s.shape
    n = segptr.shape[0] - 1
    HP, soft = per_pass(H), mode == "softmax"
    fillv = F32(-np.inf) if soft else F32(0)
    out = np.full((cap, H), np.nan, F32)
    den = np.full((n, H), np.nan, F32)
    part = np.full((pc.n_slots, 2 * H), np.nan, F32)
    out[segptr[n]:] = 0                      # the padding slots
    at, ok = _members(p["ptr"][:-1], p["ptr"][1:], perm, G, pc.piece, cap)
    single = p["slot"] < 0
    for h0 in range(0, H, HP):
        nh = min(HP, H - h0)
        v = np.full(at.shape + (HP,), fillv, F32)
        v[..., :nh] = np.where(ok[..., None], s[at, h0:h0 + nh], fillv)
        if soft:
            m = np.full(v.shape[:2] + (HP,), -np.inf, F32)
            for r in range(v.shape[2]):
                m = np.maximum(m, v[:, :, r])
            m = group_reduce(m, np.maximum)
            shift = np.where(m == -np.inf, F32(0), m)
            v = np.exp(v - shift[:, :, None, :]).astype(F32)
        tot = group_reduce(_lane_sums(v), np.add)
        multi = ~single
        if soft:
            part[p["slot"][multi], h0:h0 + nh] = m[multi, 0, :nh]
        part[p["slot"][multi], H + h0:H + h0 + nh] = tot[multi, 0, :nh]
        den[p["col"][single], h0:h0 + nh] = tot[single, 0, :nh]
        o = (v / (tot + EPS)[:, :, None, :]).astype(F32)
        sel = ok & single[:, None, None]
        out[at[sel], h0:h0 + nh] = o[sel][:, :nh]
    q = np.arange(pc.n_slots)
    if q.size == 0:
        return out, den
    piece, seg, index, first, count = _multi(p, segptr, q, pc.piece)
    at, ok = _members(p["ptr"][piece], p["ptr"][piece + 1], perm, G,
                      pc.piece, cap)
    for h0 in range(0, H, HP):
        nh = min(HP, H - h0)
        a, cmax = _merge_rows(part, first, count, nh, h0)
        b, _ = _merge_rows(part, first, count, nh, H + h0)
        shift = np.zeros((q.size, nh), F32)
        total = np.zeros((q.size, nh), F32)
        if soft:
            shift = np.full((q.size, nh), -np.inf, F32)
            for i in range(cmax):
                shift = np.where((i < count)[:, None],
                                 np.maximum(shift, a[:, i]), shift)
            shift = np.where(shift == -np.inf, F32(0), shift)
        for i in range(cmax):
            if soft:
                add = np.where(a[:, i] != -np.inf,
                               b[:, i] * np.exp(a[:, i] - shift), F32(0))
            else:
                add = b[:, i]
            total = np.where((i < count)[:, None], (total + add).astype(F32),
                             total)
        den[seg[index == 0], h0:h0 + nh] = total[index == 0]
        v = s[at, h0:h0 + nh]
        if soft:
            v = np.exp(v - shift[:, None, None, :]).astype(F32)
        o = (v / (total + EPS)[:, None, None, :]).astype(F32)
        out[at[ok], h0:h0 + nh] = o[ok]
    return out, den


def mirror_k4(segptr, perm, pc, out, g, den, mode, G):
    """K4's two passes as the kernel orders them: ds."""
    segptr = segptr.numpy().astype(np.int64)
    perm = None if perm is None else perm.numpy().astype(np.int64)
    p = _np(pc)
    cap, H = g.shape
    n = segptr.shape[0] - 1
    HP, soft = per_pass(H), mode == "softmax"
    ds = np.full((cap, H), np.nan, F32)
    part = np.full((pc.n_slots, H), np.nan, F32)
    ds[segptr[n]:] = 0

    def formula(o, gg, dot, dn):
        return (o * (gg - dot) if soft else (gg - dot) / dn).astype(F32)

    at, ok = _members(p["ptr"][:-1], p["ptr"][1:], perm, G, pc.piece, cap)
    single = p["slot"] < 0
    for h0 in range(0, H, HP):
        nh = min(HP, H - h0)
        o = np.zeros(at.shape + (HP,), F32)
        gg = np.zeros(at.shape + (HP,), F32)
        o[..., :nh] = np.where(ok[..., None], out[at, h0:h0 + nh], 0)
        gg[..., :nh] = np.where(ok[..., None], g[at, h0:h0 + nh], 0)
        dot = group_reduce(_lane_sums((gg * o).astype(F32)), np.add)
        part[p["slot"][~single], h0:h0 + nh] = dot[~single, 0, :nh]
        dn = (den[p["col"], h0:h0 + nh] + EPS)[:, None, None, :]
        d = formula(o[..., :nh], gg[..., :nh], dot[:, :, None, :nh], dn)
        sel = ok & single[:, None, None]
        ds[at[sel], h0:h0 + nh] = d[sel]
    q = np.arange(pc.n_slots)
    if q.size == 0:
        return ds
    piece, seg, index, first, count = _multi(p, segptr, q, pc.piece)
    at, ok = _members(p["ptr"][piece], p["ptr"][piece + 1], perm, G,
                      pc.piece, cap)
    for h0 in range(0, H, HP):
        nh = min(HP, H - h0)
        rows, cmax = _merge_rows(part, first, count, nh, h0)
        dot = np.zeros((q.size, nh), F32)
        for i in range(cmax):
            dot = np.where((i < count)[:, None], (dot + rows[:, i]).astype(F32),
                           dot)
        dn = (den[seg, h0:h0 + nh] + EPS)[:, None, None, :]
        d = formula(out[at, h0:h0 + nh], g[at, h0:h0 + nh],
                    dot[:, None, None, :], dn)
        ds[at[ok], h0:h0 + nh] = d[ok]
    return ds


def _plain64(segptr, seg, perm, s, mode):
    out, den = segment_norm_plain(segptr, seg, perm,
                                  torch.from_numpy(s).double(), mode)
    return out.numpy(), den.numpy()


def _close(got, want, bound=1e-6, floor=1e-30):
    """Every entry finite and within ``bound`` of ``want``'s scale (at
    least ``floor``: K4's terms are of the cotangent's scale where the
    gradient itself vanishes, as on segments of one member)."""
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= bound * scale, (err, scale)


# ---------------------------------------------------------------------------
# the walk against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_walk_matches_plain(graph, heads):
    """K3 and K4's walk, in both modes and every layout, at the lane group
    the chooser picks and at the narrowest and widest groups the pieces
    take (every lane group's member order; pieces merged; the mean-64
    graph in pieces of 64), within 1e-6 of scale of the plain versions in
    float64: only the order of the float32 sums differs. Every slot is
    written (padding 0); masked slots come out 0, in softmax with no
    gradient."""
    g = _graph(graph)
    mask = g.mask.numpy()
    for name, segptr, seg, perm, pc in _layouts(g):
        n = segptr.shape[0] - 1
        g0, _ = L.segment_design(heads, pc.n_edges / n, piece=pc.piece)
        for mode in ("softmax", "normalise"):
            s = _scores(g, heads, mode, 7 + heads)
            ct = np.random.default_rng(8).normal(
                size=s.shape).astype(F32)
            want, want_den = _plain64(segptr, seg, perm, s, mode)
            want_ds = segment_norm_bwd_plain(
                segptr, seg, perm, torch.from_numpy(want),
                torch.from_numpy(ct).double(), torch.from_numpy(want_den),
                mode).numpy()
            for G in sorted({g0, pc.piece // L.SEGMENT_MEMBERS, 32}):
                out, den = mirror_k3(segptr, perm, pc, s, mode, G)
                _close(out, want)
                _close(den, want_den)
                ds = mirror_k4(segptr, perm, pc, want.astype(F32), ct,
                               want_den.astype(F32), mode, G)
                _close(ds, want_ds, floor=float(np.abs(ct).max()))
                if g.masked:
                    assert np.all(out[~mask] == 0)
                    # in softmax their out of 0 stops the gradient; in
                    # normalise the caller zeroes them (ops.scatter)
                    assert mode != "softmax" or np.all(ds[~mask] == 0)


def test_all_masked_segment_and_its_pieces():
    """A segment whose every score is -inf shifts by 0 (its members and den
    0, no NaN), also when it is cut into pieces; a piece of only -inf
    scores beside finite ones adds 0 to the merged sum."""
    r, c, n = _hub(400, 360, 9)
    g = make_graph(r.astype(np.int32), c.astype(np.int32), num_nodes=n,
                   pad_multiple=16).sort_by_row()
    s = np.random.default_rng(10).normal(size=(g.capacity, 2)).astype(F32)
    lo, hi = int(g.rowptr[0]), int(g.rowptr[1])        # the hub's row
    s[lo:lo + 2 * COL_PIECE, 0] = -np.inf    # its first two pieces, head 0
    s[lo:hi, 1] = -np.inf                    # every piece, head 1
    want, want_den = _plain64(g.rowptr, g.row, None, s, "softmax")
    out, den = mirror_k3(g.rowptr, None, g.row_segments, s, "softmax", 8)
    _close(out, want)
    _close(den, want_den)
    assert np.all(out[lo:hi, 1] == 0) and den[0, 1] == 0
    assert np.all(out[lo:lo + 2 * COL_PIECE, 0] == 0)


# ---------------------------------------------------------------------------
# the butterfly, the pieces, the chooser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hp", [1, 2, 4, 8])
@pytest.mark.parametrize("G", L.SEGMENT_LANES)
def test_group_reduce(G, hp):
    """Every lane ends with every head's max (exact) and sum (within float32
    rounding of the exact sum), the sums the same on every lane and in
    every run (a fixed order)."""
    v = np.random.default_rng(G * 10 + hp).normal(size=(3, G, hp)).astype(F32)
    mx = group_reduce(v, np.maximum)
    assert np.array_equal(mx, np.repeat(v.max(1, keepdims=True), G, 1))
    sm = group_reduce(v, np.add)
    assert np.array_equal(sm, np.repeat(sm[:, :1], G, 1))
    np.testing.assert_allclose(sm[:, 0], v.astype(np.float64).sum(1),
                               rtol=1e-5, atol=1e-6)
    assert np.array_equal(sm, group_reduce(v, np.add))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_members_are_the_valid_slots(graph):
    """In every layout the members of the segments are a bijection onto the
    valid slots [0, segptr[N]) (rev on a symmetric multiset, col_perm on
    the CSC view, masked edges among them), so the kernels' padding writes
    cover exactly the rest; the pieces (of 64 members where the mean
    segment is longer than 32) cover every position once and in order,
    their partial rows map back to their pieces."""
    g = _graph(graph)
    long = graph == "mean64"
    assert (g.row_segments is g.row_pieces) != long
    assert g.row_segments.piece == (SEGMENT_LONG_PIECE if long
                                    else COL_PIECE)
    assert segment_piece(g.num_valid, g.num_nodes) == g.row_segments.piece
    for name, segptr, seg, perm, pc in _layouts(g):
        nv = int(segptr[-1])
        assert nv == g.num_valid and pc.n_edges == nv
        members = np.arange(nv) if perm is None else perm[:nv].numpy()
        assert np.array_equal(np.sort(members), np.arange(nv)), name
        p = _np(pc)
        assert p["ptr"][0] == 0 and p["ptr"][-1] == nv
        assert np.all(np.diff(p["ptr"]) <= pc.piece)
        assert pc.piece == g.row_segments.piece
        assert np.array_equal(p["slot"][p["multi_piece"]],
                              np.arange(pc.n_slots))
        sp = segptr.numpy().astype(np.int64)
        for q in range(pc.n_slots):
            piece, sg, index, first, count = _multi(p, sp, q, pc.piece)
            assert p["ptr"][piece] == sp[sg] + index * pc.piece
            rows = p["slot"][p["col"] == sg]
            assert np.array_equal(rows, first + np.arange(count))


def test_segment_design_is_what_the_kernels_build():
    """(G, V) within what csrc/segment_norm.cu dispatches: pieces of 32
    (COL_PIECE) or 64 (SEGMENT_LONG_PIECE) members, G of SEGMENT_LANES and
    at most SEGMENT_MEMBERS members a lane; V of SEGMENT_VECTORS, dividing
    H, at most a pass's heads, on every table's boundary. G follows the
    mean segment length and the heads of a pass."""
    assert L.SEGMENT_PIECES == (COL_PIECE, SEGMENT_LONG_PIECE)
    for piece in L.SEGMENT_PIECES:
        for h in range(1, 17):
            for mean in (0.0, 1, 2.9, 5.6, 9, 14.6, 23, 64, 360):
                G, V = L.segment_design(h, mean, piece=piece)
                assert G in L.SEGMENT_LANES
                assert piece // G <= L.SEGMENT_MEMBERS
                assert V in L.SEGMENT_VECTORS and h % V == 0
                assert V <= per_pass(h)
    assert L.segment_design(8, 64, piece=64)[0] == 32
    assert L.segment_design(1, 1, piece=64)[0] == 8
    means = (1, 7.9, 9, 14.6, 16, 64)
    assert [L.segment_design(8, m)[0] for m in means] == \
        [4, 8, 16, 16, 16, 32]
    assert [L.segment_design(4, m)[0] for m in means] == \
        [4, 8, 16, 16, 16, 32]
    assert [L.segment_design(1, m)[0] for m in means] == \
        [4, 4, 8, 8, 16, 32]
    assert L.segment_design(8, 9)[1] == 4
    assert L.segment_design(8, 9, (0x1008, torch.float32))[1] == 2
    assert L.segment_design(8, 9, (0x1004, torch.float32))[1] == 1
    assert L.segment_design(6, 9)[1] == 2 and L.segment_design(3, 9)[1] == 1
    with pytest.raises(ValueError):
        L.segment_design(0, 9)
    with pytest.raises(ValueError):
        L.segment_design(8, 9, piece=128)


def test_wrappers_on_the_cpu_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions (pieces unread)
    and count no launch; ``segment_pieces`` names the rows' segments for
    rows and rev, the CSC view's otherwise."""
    g = _graph("mean9")
    d = _graph("directed")
    assert tsc.segment_pieces(g, 0) is g.row_segments
    assert tsc.segment_pieces(g, 1) is g.row_segments
    assert tsc.segment_pieces(d, 1) is d.col_segments
    s = torch.from_numpy(_scores(g, 3, "softmax", 1))
    before = (segment_norm.launches, segment_norm_bwd.launches)
    out, den = segment_norm(g.rowptr, g.row, g.rev, s, "softmax")
    ref = segment_norm_plain(g.rowptr, g.row, g.rev, s, "softmax")
    assert torch.equal(out, ref[0]) and torch.equal(den, ref[1])
    segment_norm_bwd(g.rowptr, g.row, g.rev, out, s, den, "softmax",
                     g.row_segments)
    assert (segment_norm.launches, segment_norm_bwd.launches) == before


# ---------------------------------------------------------------------------
# against the JAX package (f32), as tests/test_torch_port_segment.py
# ---------------------------------------------------------------------------

def _jax_graph(g):
    nv = g.num_valid
    return j_make_graph(g.row[:nv].numpy(), g.col[:nv].numpy(), None,
                        num_nodes=g.num_nodes, pad_multiple=g.capacity)


@pytest.mark.parametrize("layout", ["rows", "columns", "csc"])
@pytest.mark.parametrize("fn", ["softmax", "squareplus"])
def test_walk_matches_jax(fn, layout):
    """The mirrors against ``graph_neural_pde_tpu.ops.scatter``'s
    ``segment_softmax`` / ``segment_squareplus`` over row or col indices
    on a hub graph (pieces merged), H = 8: values rtol 1e-5, and K4
    against ``jax.vjp`` of ``segment_softmax`` / ``normalize_attention``
    (squareplus's normalisation) rtol 1e-4."""
    g = _graph("hub360") if layout != "csc" else _graph("directed")
    jg = _jax_graph(g)
    lay = {n: (sp, sg, pm, pc) for n, sp, sg, pm, pc in _layouts(g)}[layout]
    segptr, seg, perm, pc = lay
    idx = jg.row if layout == "rows" else jg.col
    rng = np.random.default_rng(20)
    s = rng.normal(size=(g.capacity, 8)).astype(F32)
    ct = rng.normal(size=s.shape).astype(F32)
    m = g.mask.numpy()[:, None]
    G, _ = L.segment_design(8, pc.n_edges / (segptr.shape[0] - 1),
                            piece=pc.piece)
    if fn == "softmax":
        want, vjp = jax.vjp(lambda x: jsc.segment_softmax(
            x, idx, jg.num_nodes, jg.mask), jnp.asarray(s))
        out, den = mirror_k3(segptr, perm, pc, s, "softmax", G)
        mode = "softmax"
    else:
        want = jsc.segment_squareplus(jnp.asarray(s), idx, jg.num_nodes,
                                      jg.mask)
        sm = s - s[m[:, 0]].max()
        u = ((sm + np.sqrt(sm * sm + F32(4))) / F32(2)).astype(F32) * m
        _, vjp = jax.vjp(lambda x: jsc.normalize_attention(
            x, idx, jg.num_nodes, jg.mask), jnp.asarray(u))
        out, den = mirror_k3(segptr, perm, pc, u, "normalise", G)
        mode = "normalise"
    np.testing.assert_allclose(out, np.asarray(want) * m, rtol=1e-5,
                               atol=1e-7)
    ds = mirror_k4(segptr, perm, pc, out, ct, den, mode, G)
    want_ds = np.asarray(vjp(jnp.asarray(ct))[0]) * m
    np.testing.assert_allclose(ds, want_ds, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want_ds).max()))


@pytest.mark.parametrize("fn", ["softmax", "squareplus"])
def test_walk_matches_stripe_kernels_interpret(fn):
    """The rows' mirror against the TPU's stripe segment softmax /
    squareplus (P3's stripe scatter and P2's row gather, f32 one-hot,
    Pallas interpret mode), mapped through the plan's slot order, on a
    graph with rows of several pieces: rtol 1e-5 on values (as
    tests/test_torch_port_segment.py), and in softmax K4 against the
    stripe's gradient, 1e-4."""
    g = _graph("mean64")
    n, h = g.num_nodes, 3
    plan = build_stripe_plan(g.row.numpy(), g.mask.numpy(), num_nodes=n,
                             block_n=8, chunk=64)
    idx = np.where(g.mask.numpy())[0]
    slots = np.asarray(plan.slot_of_edge)[idx]
    rng = np.random.default_rng(21)
    s = rng.normal(size=(g.capacity, h)).astype(F32)
    probe = rng.normal(size=s.shape).astype(F32)
    s_s = np.zeros((plan.capacity, h), F32)
    s_s[slots] = s[idx]
    probe_s = np.zeros_like(s_s)
    probe_s[slots] = probe[idx]
    row_s = np.zeros(plan.capacity, np.int32)
    row_s[slots] = g.row.numpy()[idx]
    valid = jnp.asarray(plan.valid)

    def stripe(x):
        if fn == "squareplus":
            return stripe_segment_squareplus(plan, x)
        return stripe_segment_softmax(
            plan, x, lambda: jsc.segment_softmax(x, row_s, n, valid))

    want = np.asarray(stripe(jnp.asarray(s_s)))[slots]
    pc = g.row_segments
    G, _ = L.segment_design(h, g.num_valid / n, piece=pc.piece)
    if fn == "softmax":
        out, den = mirror_k3(g.rowptr, None, pc, s, "softmax", G)
    else:
        sm = s - s[idx].max()
        u = ((sm + np.sqrt(sm * sm + F32(4))) / F32(2)).astype(F32)
        out, den = mirror_k3(g.rowptr, None, pc, u, "normalise", G)
    np.testing.assert_allclose(out[idx], want, rtol=1e-5, atol=1e-6)
    if fn == "softmax":
        want_g = np.asarray(jax.grad(lambda x: jnp.sum(
            jnp.where(valid[:, None], stripe(x), 0.0) * probe_s))(
            jnp.asarray(s_s)))[slots]
        ds = mirror_k4(g.rowptr, None, pc, out, probe, den, "softmax", G)
        np.testing.assert_allclose(ds[idx], want_g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want_g).max()))
