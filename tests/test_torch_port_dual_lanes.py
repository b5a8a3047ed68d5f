"""The lane groups of K10 ``dual_scatter`` and K11 ``dual_gather`` on the
CPU, where the kernels cannot run: numpy mirrors of the order in which each
kernel visits and sums its operands (``csrc/dual_scatter.cu``,
``csrc/dual_gather.cu``, ``csrc/dual_common.cuh``), held against the plain
versions that define them, and the chooser (``kernels.lanes``) held to what
the kernels were built for.

* Both kernels give a row piece (``Graph.row_pieces``) to a group of G
  lanes; lane l holds the vectors l, l + G, ... of V elements of a D-wide
  row, K of them (one pass over the row), and the heads go in passes of HP.
* K10 sums every element of num in one lane with a fused multiply-add an
  edge, in edge order; den per head in edge order, on the lane of the
  head's index.
* K11's du walk forms each edge's H partial dot products on the lanes
  (fused multiply-adds over the lane's vectors in order), reduces them by
  the transposed butterfly and adds ct_den; du's padding slots are 0. Its
  dx walk (lanes of its own, over the float32 rows of ct_num) sums each
  edge's heads of u[rev] * ct_num[col] in edge order, head pass by head
  pass.
* The rows of several pieces add their pieces' partial rows in piece
  order.
* One case each against the TPU kernels P4 / P5 in Pallas interpret mode
  (``stripe_scatter_add2``, ``_stripe_gather2_call``), whose one-hot and
  payload round to bfloat16: 3e-2.

Inputs are made with numpy from a seed.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.ops.pallas import stripe as jstripe
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.kernels import lanes as L
from graph_neural_pde_tpu_torch.kernels.fused_rhs import _row_pieces
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.ops.graph import (SCATTER_WHOLE,
                                                 column_pieces, make_graph)

# the module (the package's name dual_scatter is K10's wrapper)
DS = importlib.import_module("graph_neural_pde_tpu_torch.kernels.dual_scatter")
BF16 = torch.bfloat16
F32 = torch.float32
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


def _define(name):
    """A ``#define`` default of the kernels' sources, so that the mirrors
    follow the built kernels."""
    for src in ("dual_common.cuh", "dual_scatter.cu", "dual_gather.cu"):
        m = re.search(rf"#define {name} (\d+)", (CSRC / src).read_text())
        if m:
            return int(m.group(1))
    raise KeyError(name)


ACC = _define("GNPDE_DUAL_ACC")
MAX_HEADS_PER_PASS = 8


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
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = want.detach().double().numpy() if torch.is_tensor(want) else want
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _fma(a, b, c):
    """float32 fused multiply-add: the product of two float32s is exact in
    float64, and the sum is rounded once to float32."""
    return (np.asarray(c, np.float64) + np.asarray(a, np.float64)
            * np.asarray(b, np.float64)).astype(np.float32)


def _add(a, b):
    return (np.asarray(a, np.float32) + np.asarray(b, np.float32)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# graphs and inputs
# ---------------------------------------------------------------------------

def _hub_graph(seed, n=180, e=300, degrees=(150, 60)):
    """A symmetric random graph whose node 0 is joined both ways to 150
    others (a row of five pieces of ``COL_PIECE`` edges, longer than the
    rows K10 walks whole) and node 1 to 60 (a row of two pieces that K10
    walks whole)."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(2, n, e), rng.integers(2, n, e)
    keep = r != c
    r, c = [r[keep], c[keep]], [c[keep], r[keep]]
    for node, degree in enumerate(degrees):
        peers = rng.choice(np.arange(2, n), degree, replace=False)
        r += [np.full(degree, node), peers]
        c += [peers, np.full(degree, node)]
    return make_graph(np.concatenate(r), np.concatenate(c), num_nodes=n,
                      pad_multiple=64).sort_by_row()


def _directed_graph(seed, n=120, e=300, hub_degree=140):
    """Random pairs one way only, node 3's row a hub (five pieces) and
    node 4's of two: no reverse-edge map, so K11 writes du only."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, e), rng.integers(0, n, e)
    r = np.concatenate([r, np.full(hub_degree, 3), np.full(50, 4)])
    c = np.concatenate([c, rng.integers(0, n, hub_degree + 50)])
    g = make_graph(r, c, num_nodes=n, pad_multiple=64).sort_by_row()
    assert g.rev is None
    return g


GRAPHS = {"symmetric hub": lambda: _hub_graph(3),
          "directed hub": lambda: _directed_graph(4)}


def _inputs(g, dim, heads, table, seed):
    """u positive on the valid slots and 0 on padding (as squareplus gives),
    x as the table, and K10's cotangents."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    u = torch.tensor(rng.uniform(0.05, 1.0, (g.capacity, heads))
                     .astype(np.float32)) * g.mask[:, None]
    x = torch.tensor(rng.normal(size=(n, dim)).astype(np.float32)).to(table)
    ct_num = torch.tensor(rng.normal(size=(n, heads * dim))
                          .astype(np.float32))
    ct_den = torch.tensor(rng.normal(size=(n, heads)).astype(np.float32))
    return u, x, ct_num, ct_den


# ---------------------------------------------------------------------------
# the layout: vectors a lane, heads a pass, the transposed butterfly
# ---------------------------------------------------------------------------

def vectors_a_lane(dim, group, vec):
    """K: the row's vectors over the group's lanes, 1 or 2 with 16-byte
    (or K10's 8-byte bfloat16) vectors, 8 single elements (``launch_k``):
    one pass covers the row."""
    k = -(-(dim // vec) // group)
    if vec == 1:
        assert group == 32 and k <= 8
        return 8
    assert k <= 2
    return k


def heads_a_pass(heads, k, vec):
    """HP: the heads rounded up to a power of two, at most the power of two
    of heads whose K * V floats fit GNPDE_DUAL_ACC (``head_cap``), at most
    8."""
    cap = 1
    while 2 * cap <= ACC // (k * vec) and 2 * cap <= MAX_HEADS_PER_PASS:
        cap *= 2
    hp = 1
    while hp < heads and hp < cap:
        hp *= 2
    return hp


def group_head_sums(v):
    """``group_head_sums`` in numpy: ``v`` [B, G, HP] float32, each lane's
    partial sums of HP heads (B groups at once). At level o (G/2, ..., 1)
    the lanes with bit o set keep the upper half of the values they hold
    and add their partner's upper half, the others the lower halves; with
    one value left, lane l adds its partner's. Returns [B, G, J], lane l's
    sums of the heads (l * HP) // G + j."""
    _, g_, m = v.shape
    lane = np.arange(g_)
    v = v.astype(np.float32)
    o = g_ // 2
    while o:
        if m >= 2:
            half = m // 2
            upper = ((lane & o) != 0)[None, :, None]
            lo, hi = v[:, :, :half], v[:, :, half:m]
            send = np.where(upper, lo, hi)
            keep = np.where(upper, hi, lo)
            v = _add(keep, send[:, lane ^ o])
            m = half
        else:
            v = _add(v, v[:, lane ^ o])
        o //= 2
    return v[:, :, :m]


def head_sums_by_head(v):
    """The heads' sums [B, HP] after the butterfly, each read from every
    lane that holds it (which must agree bit for bit)."""
    b_, g_, hp = v.shape
    sums = group_head_sums(v)
    out = np.full((b_, hp), np.nan, np.float32)
    for ln in range(g_):
        for j in range(sums.shape[2]):
            h = ln * hp // g_ + j
            seen = ~np.isnan(out[:, h])
            assert (out[seen, h] == sums[seen, ln, j]).all()
            out[:, h] = sums[:, ln, j]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("group", [4, 8, 16, 32])
def test_group_head_sums(group):
    """Every head's sum lands in (l * HP) // G + j of each lane that holds
    it, the same bits in every such lane, within float32 rounding of the
    sum over the lanes; H - 1 + log2(G / H) exchanges where G >= H."""
    rng = np.random.default_rng(group)
    for hp in (1, 2, 4, 8):
        v = rng.normal(size=(5, group, hp)).astype(np.float32)
        got = head_sums_by_head(v)
        want = v.astype(np.float64).sum(1)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(v).sum(1).max()


# ---------------------------------------------------------------------------
# the mirrors
# ---------------------------------------------------------------------------

def _pieces(g, whole=False, scatter=False):
    pc = (column_pieces(g.rowptr, piece=1 << 30) if whole
          else g.scatter_pieces if scatter else g.row_pieces)
    return {k: getattr(pc, k).numpy() for k in
            ("ptr", "col", "slot", "multi_col", "multi_ptr")}


def _merge(out, part, pc):
    """The rows of several pieces: their partial rows added in piece order,
    from 0."""
    for m, row in enumerate(pc["multi_col"]):
        s = np.zeros(part.shape[1], np.float32)
        for p in range(pc["multi_ptr"][m], pc["multi_ptr"][m + 1]):
            s = _add(s, part[p])
        out[row] = s


def _positions(pc):
    """Each piece's first edge and length, and the longest piece: the walks
    below step every piece through its edges at once, edge t of each."""
    first = pc["ptr"][:-1]
    length = pc["ptr"][1:] - first
    return first, length, int(length.max())


def k10_walk(g, u, x, group, vec, whole=False):
    """K10's loop in numpy over its pieces (``Graph.scatter_pieces``: rows
    of up to ``SCATTER_WHOLE`` edges whole, longer ones in pieces of
    ``COL_PIECE``): (num, den, pieces)."""
    pc = _pieces(g, whole, scatter=True)
    col, uf, xf = g.col.numpy(), u.numpy(), x.float().numpy()
    n, d = xf.shape
    h = uf.shape[1]
    hp = heads_a_pass(h, vectors_a_lane(d, group, vec), vec)
    first, length, longest = _positions(pc)
    num = np.zeros((len(first), h, d), np.float32)
    den = np.zeros((len(first), h), np.float32)
    for h0 in range(0, h, hp):
        nh = min(hp, h - h0)
        for t in range(longest):                        # edge order
            live = length > t
            e = first[live] + t
            num[live, h0:h0 + nh] = _fma(uf[e, h0:h0 + nh, None],
                                         xf[col[e]][:, None, :],
                                         num[live, h0:h0 + nh])
            den[live, h0:h0 + nh] = _add(den[live, h0:h0 + nh],
                                         uf[e, h0:h0 + nh])
    rows = np.concatenate([num.reshape(len(first), -1), den], 1)
    out = np.full((n, h * d + h), np.nan, np.float32)
    one = pc["slot"] < 0
    out[pc["col"][one]] = rows[one]
    part = np.full((int(pc["multi_ptr"][-1]), h * d + h), np.nan,
                   np.float32)
    part[pc["slot"][~one]] = rows[~one]
    _merge(out, part, pc)
    assert not np.isnan(out).any()
    return out[:, :h * d], out[:, h * d:], pc


def k11_walk(g, u, x, ct_num, ct_den, group, vec, dx_lanes, whole=False):
    """K11's two walks in numpy over the row pieces: (du [E_pad, H], dx or
    None). du is per edge (every valid edge at once) on the du walk's
    (``group``, ``vec``); dx steps the pieces through their edges, in head
    passes of the dx walk's lanes ``dx_lanes``."""
    pc = _pieces(g, whole)
    col, row = g.col.numpy(), g.row.numpy()
    rev = None if g.rev is None else g.rev.numpy()
    uf, xf = u.numpy(), x.float().numpy()
    cd = ct_den.numpy()
    n, d = xf.shape
    h = uf.shape[1]
    cn3 = ct_num.numpy().reshape(n, h, d)
    k = vectors_a_lane(d, group, vec)
    hp = heads_a_pass(h, k, vec)
    nv = int(pc["ptr"][-1])
    du = np.zeros(uf.shape, np.float32)                 # the padding: 0
    r, c = row[:nv], col[:nv]
    for h0 in range(0, h, hp):
        nh = min(hp, h - h0)
        ctn, xc = cn3[r, h0:h0 + nh], xf[c]             # [E, nh, D], [E, D]
        lanes_sums = np.zeros((nv, group, hp), np.float32)
        for kk in range(k):                 # lane l's vectors l + G k, in
            lanes = np.arange(group)        # order, element by element
            v = lanes + group * kk
            lanes = lanes[v < d // vec]
            for i in range(vec):
                f = v[v < d // vec] * vec + i
                lanes_sums[:, lanes, :nh] = _fma(
                    ctn[:, :, f].transpose(0, 2, 1), xc[:, f, None],
                    lanes_sums[:, lanes, :nh])
        du[:nv, h0:h0 + nh] = _add(head_sums_by_head(lanes_sums)[:, :nh],
                                   cd[r, h0:h0 + nh])
    if rev is None:
        return du, None
    hp = heads_a_pass(h, vectors_a_lane(d, *dx_lanes), dx_lanes[1])
    first, length, longest = _positions(pc)
    dxa = np.zeros((len(first), d), np.float32)
    for h0 in range(0, h, hp):
        for t in range(longest):                        # edge order, then
            live = length > t                           # the pass's heads
            e = first[live] + t
            for hh in range(h0, min(h0 + hp, h)):
                dxa[live] = _fma(uf[rev[e], hh, None], cn3[col[e], hh],
                                 dxa[live])
    dx = np.full((n, d), np.nan, np.float32)
    one = pc["slot"] < 0
    dx[pc["col"][one]] = dxa[one]
    part = np.full((int(pc["multi_ptr"][-1]), d), np.nan, np.float32)
    part[pc["slot"][~one]] = dxa[~one]
    _merge(dx, part, pc)
    assert not np.isnan(dx).any()
    return du, dx


# ---------------------------------------------------------------------------
# the mirrors against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [1, 2, 8])
@pytest.mark.parametrize("dim", [16, 80, 128])
@pytest.mark.parametrize("table", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_dual_walks_equal_plain(graph, table, dim, heads):
    """K10 and K11's mirrors over the chooser's (G, V) and the graph's row
    pieces (a hub row of several) against ``dual_scatter_plain`` and
    ``dual_gather_plain`` (1e-5 of scale), K11 also against the plain
    version in float64 on the same inputs; on the directed graph K11
    writes du only."""
    g = GRAPHS[graph]()
    assert g.row_pieces.n_multi > 0
    u, x, ct_num, ct_den = _inputs(g, dim, heads, table, seed=dim + heads)
    csr = (g.rowptr, g.row, g.col)
    group, vec = L.lanes("dual_scatter", dim, x, heads=heads)
    num, den, _ = k10_walk(g, u, x, group, vec)
    num_p, den_p = kernels.dual_scatter_plain(*csr, u, x)
    assert _rel(num, num_p) < 1e-5 and _rel(den, den_p) < 1e-5
    group, vec = L.lanes("dual_gather", dim, x, ct_num)
    du, dx = k11_walk(g, u, x, ct_num, ct_den, group, vec,
                      L.lanes("dual_gather", dim, ct_num))
    want = kernels.dual_gather_plain(*csr, u, x, ct_num, ct_den,
                                     want_dx=g.rev is not None)
    wide = kernels.dual_gather_plain(*csr, u.double(), x.double(),
                                     ct_num.double(), ct_den.double(),
                                     want_dx=g.rev is not None)
    for w in (want, wide):
        assert _rel(du, w[0]) < 1e-5
        assert (du[g.num_valid:] == 0).all()
        if g.rev is None:
            assert dx is None and w[1] is None
        else:
            assert _rel(dx, w[1]) < 1e-5


def test_pieces_change_only_the_rows_of_several():
    """Walking whole rows in place of the row pieces (the probe's
    comparison): every row of one piece comes out bit for bit the same
    (K10 leaves the row of 60 edges whole, K11 cuts it in two), the rows
    of several within float32 rounding."""
    g = GRAPHS["symmetric hub"]()
    u, x, ct_num, ct_den = _inputs(g, 80, 8, F32, seed=11)
    group, vec = L.lanes("dual_scatter", 80, x)
    num, den, pc = k10_walk(g, u, x, group, vec)
    num_w, den_w, _ = k10_walk(g, u, x, group, vec, whole=True)
    hub = np.zeros(g.num_nodes, bool)
    hub[pc["multi_col"]] = True
    assert hub.sum() == 1 and hub[0]
    assert g.scatter_pieces.n_pieces == g.num_nodes - 1 + 5   # 150 / 32
    assert (num[~hub] == num_w[~hub]).all()
    assert (den[~hub] == den_w[~hub]).all()
    assert _rel(num, num_w) < 1e-6 and _rel(den, den_w) < 1e-6
    multi = np.zeros(g.num_nodes, bool)
    multi[g.row_pieces.multi_col.numpy()] = True
    assert multi.sum() == 2 and multi[0] and multi[1]
    dx_lanes = L.lanes("dual_gather", 80, ct_num)
    _, dx = k11_walk(g, u, x, ct_num, ct_den, group, vec, dx_lanes)
    _, dx_w = k11_walk(g, u, x, ct_num, ct_den, group, vec, dx_lanes,
                       whole=True)
    assert (dx[~multi] == dx_w[~multi]).all() and _rel(dx, dx_w) < 1e-6


def test_wrappers_take_the_row_pieces():
    """``dual_scatter`` and ``dual_gather`` take the graph's pieces (CPU
    tensors run the plain version whatever they are given), and the pieces
    a CUDA call would build from rowptr are those of the graph (K10's
    rows of up to ``SCATTER_WHOLE`` edges whole, K11's all in pieces of
    ``COL_PIECE``)."""
    g = GRAPHS["symmetric hub"]()
    u, x, ct_num, ct_den = _inputs(g, 16, 4, F32, seed=12)
    csr = (g.rowptr, g.row, g.col)
    for pieces in (None, g.row_pieces):
        num, den = kernels.dual_scatter(*csr, u, x, pieces=g.scatter_pieces
                                        if pieces is not None else None)
        assert torch.equal(num, kernels.dual_scatter_plain(*csr, u, x)[0])
        du, dx = kernels.dual_gather(*csr, g.rev, u, x, ct_num, ct_den,
                                     pieces=pieces)
        assert torch.equal(dx, kernels.dual_gather_plain(
            *csr, u, x, ct_num, ct_den)[1])
    before = kernels.dual_gather.piece_builds
    built = _row_pieces(kernels.dual_gather, g.rowptr, None, g.num_nodes,
                        g.rowptr.device)
    assert kernels.dual_gather.piece_builds == before + 1
    built_k10 = _row_pieces(kernels.dual_scatter, g.rowptr, None,
                            g.num_nodes, g.rowptr.device, SCATTER_WHOLE)
    for f in ("ptr", "col", "slot", "multi_col", "multi_ptr"):
        assert torch.equal(getattr(built, f), getattr(g.row_pieces, f))
        assert torch.equal(getattr(built_k10, f),
                           getattr(g.scatter_pieces, f))
    with pytest.raises(ValueError):           # another graph's pieces
        _row_pieces(kernels.dual_scatter, g.rowptr, g.row_pieces,
                    g.row_pieces.n_pieces + 1, g.rowptr.device)


# ---------------------------------------------------------------------------
# the chooser
# ---------------------------------------------------------------------------

# (kernel, D, x's dtype, x's offset, ct_num's offset, heads) -> (lanes, V)
CHOICES = [
    # 16-byte vectors: K10 a lane a vector up to 32 vectors, at least 8
    # lanes (D = 16 cora-small, 80 Cora, 128 arxiv; two vectors a lane
    # above 32), K11 up to 24 vectors, at least 4 lanes
    ("dual_scatter", 16, F32, 0, None, 4, (8, 4)),
    ("dual_scatter", 80, F32, 0, None, 8, (32, 4)),
    ("dual_scatter", 128, F32, 0, None, 2, (32, 4)),
    ("dual_scatter", 256, F32, 0, None, 2, (32, 4)),
    ("dual_scatter", 16, BF16, 0, None, 4, (8, 8)),
    ("dual_scatter", 80, BF16, 0, None, 4, (16, 8)),
    ("dual_scatter", 128, BF16, 0, None, 2, (16, 8)),
    # ... K10 on a bf16 table with more than 4 heads: 8-byte vectors
    ("dual_scatter", 80, BF16, 0, None, 8, (32, 4)),
    ("dual_scatter", 16, BF16, 8, None, 8, (32, 4)),
    ("dual_scatter", 18, BF16, 0, None, 8, (32, 1)),
    ("dual_gather", 16, F32, 0, 0, 4, (4, 4)),
    ("dual_gather", 80, F32, 0, 0, 8, (32, 4)),
    ("dual_gather", 128, F32, 0, 0, 2, (16, 4)),
    ("dual_gather", 128, BF16, 0, 0, 2, (16, 8)),
    ("dual_gather", 80, BF16, 0, 0, 8, (16, 8)),
    # single elements at 32 lanes where D or an address rules the wide
    # vector out
    ("dual_scatter", 20, BF16, 0, None, 2, (32, 1)),
    ("dual_scatter", 3, F32, 0, None, 2, (32, 1)),
    ("dual_scatter", 80, F32, 8, None, 2, (32, 1)),
    ("dual_gather", 80, F32, 0, 4, 2, (32, 1)),
]


@pytest.mark.parametrize("kernel,dim,dtype,x_off,ct_off,heads,want",
                         CHOICES)
def test_dual_lane_choices(kernel, dim, dtype, x_off, ct_off, heads, want):
    """The chooser's (lanes, V) at the widths K10 and K11 run and at odd
    widths and addresses."""
    tables = [(4096 + x_off, dtype)]
    if ct_off is not None:
        tables.append((4096 + ct_off, F32))
    assert L.lanes(kernel, dim, *tables, heads=heads) == want


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_dual_lane_choices_fit_the_kernels(dtype):
    """At every width up to the wrappers' MAX_DIM, every 4-byte offset and
    few or many heads: the (G, V, K) picked is one the kernels are built
    for (16-byte vectors at 4 to 32 lanes, K of 1 or 2; K10's 8-byte
    bfloat16 vectors at 32 lanes; single elements at 32 lanes, K up to 8),
    and K10's partial rows keep 16-byte boundaries."""
    size = torch.empty((), dtype=dtype).element_size()
    for dim in range(1, DS.MAX_DIM + 1):
        for off in range(0, 32, 4):
            for kernel in L.DUAL_KERNELS:
                for heads in (2, 8):
                    group, vec = L.lanes(kernel, dim,
                                         ((1 << 20) + off, dtype),
                                         ((1 << 20) + off, F32), heads=heads)
                    assert dim % vec == 0
                    if vec * size == 16:
                        assert off % 16 == 0 and group in (4, 8, 16, 32)
                    else:
                        assert group == 32
                        assert vec == 1 or (kernel == "dual_scatter"
                                            and size == 2 and heads > 4
                                            and vec == 4 and off % 8 == 0)
                    vectors_a_lane(dim, group, vec)   # asserts K's range
        for heads in (1, 3, 8, DS.MAX_HEADS):
            floats = DS.scatter_part_floats(dim, heads)
            assert floats % 4 == 0 and floats >= heads * (dim + 1)


# ---------------------------------------------------------------------------
# the TPU kernels P4, P5 (interpret mode)
# ---------------------------------------------------------------------------

N, D, H = 64, 16, 4
SBM = dict(num_nodes=N, num_classes=3, num_features=6, seed=2,
           edge_pad_multiple=32, num_val=16)
NL = dict(function="transformer", block="constant", attention_norm_idx=0,
          square_plus=True, self_loop_weight=1.0, add_source=True,
          hidden_dim=D, attention_dim=16, heads=H)


@pytest.fixture(scope="module")
def stripe():
    """One prepared SBM graph in both packages (the same arrays slot for
    slot), the JAX stripe plan over it (block_n 8, chunk 16) and each CSR
    edge's slot in the plan; operands from a seed."""
    jg = jblocks.prepare_graph(JConfig(**NL), j_sbm(**SBM).graph)
    tg = tblocks.prepare_graph(Config(**NL), make_sbm_dataset(**SBM).graph)
    np.testing.assert_array_equal(np.asarray(jg.col), tg.col.numpy())
    _, plan = jblocks.build_stripe_engine(
        JConfig(**NL).replace(stripe_fused=True, stripe_block_n=8,
                              stripe_chunk=16), jg)
    nv = tg.num_valid
    slots = np.asarray(plan.slot_of_edge)[np.arange(nv)]
    rng = np.random.default_rng(0)
    u = np.zeros((tg.capacity, H), np.float32)
    u[:nv] = rng.uniform(0.05, 1.0, (nv, H))
    x = rng.normal(size=(N, D)).astype(np.float32)
    ct_num = rng.normal(size=(N, H * D)).astype(np.float32)
    ct_den = rng.normal(size=(N, H)).astype(np.float32)
    return tg, plan, slots, u, x, ct_num, ct_den


def test_k10_walk_against_p4_interpret(stripe):
    """K10's mirror against ``stripe_scatter_add2`` in interpret mode (its
    payload u * x[col] and its one-hot in bfloat16): 3e-2 of scale."""
    tg, plan, slots, u, x, _, _ = stripe
    nv = tg.num_valid
    col = tg.col.numpy()[:nv]
    vals = (u[:nv, :, None] * x[col][:, None, :]).reshape(nv, H * D)
    vals_s = np.zeros((plan.capacity, H * D), np.float32)
    vals_s[slots] = vals
    u_s = np.zeros((plan.capacity, max(8, H)), np.float32)
    u_s[slots, :H] = u[:nv]
    num_j, den_j = jstripe.stripe_scatter_add2(
        plan, jnp.asarray(vals_s, jnp.bfloat16),
        jnp.asarray(u_s, jnp.bfloat16))
    group, vec = L.lanes("dual_scatter", D, (0, F32))
    num, den, _ = k10_walk(tg, torch.tensor(u), torch.tensor(x), group, vec)
    assert _rel(num, np.asarray(num_j)[:N]) < 3e-2
    assert _rel(den, np.asarray(den_j)[:N, :H]) < 3e-2


def test_k11_walk_against_p5_interpret(stripe):
    """K11's mirror against ``_stripe_gather2_call`` in interpret mode (its
    bf16 one-hot: the cotangents rounded) composed with the products the
    JAX package forms after it: 3e-2 of scale."""
    tg, plan, slots, u, x, ct_num, ct_den = stripe
    nv = tg.num_valid
    col = tg.col.numpy()[:nv]
    den_pad = np.zeros((N, max(8, H)), np.float32)
    den_pad[:, :H] = ct_den
    gv, gu = jstripe._stripe_gather2_call(plan, jnp.asarray(ct_num),
                                          jnp.asarray(den_pad))
    gv = np.asarray(gv)[slots].reshape(nv, H, D)
    gu = np.asarray(gu)[slots][:, :H]
    du_want = np.einsum("ehd,ed->eh", gv, x[col]) + gu
    dx_want = np.zeros((N, D), np.float32)
    np.add.at(dx_want, col, np.einsum("eh,ehd->ed", u[:nv], gv))
    group, vec = L.lanes("dual_gather", D, (0, F32), (0, F32))
    du, dx = k11_walk(tg, torch.tensor(u), torch.tensor(x),
                      torch.tensor(ct_num), torch.tensor(ct_den), group, vec,
                      L.lanes("dual_gather", D, (0, F32)))
    assert _rel(du[:nv], du_want) < 3e-2
    assert _rel(dx, dx_want) < 3e-2
