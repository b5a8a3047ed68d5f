"""The PyTorch port's bfloat16 payload and state on the softmax over
columns (``attention_norm_idx=1``), against the JAX package:
``make_fused_ax_norm1`` (K12 in both modes, K13, K14) with the bfloat16
column table beside a float32 and a bfloat16 row side, which configs take
it, a forced poison re-solved through ``block_forward`` over columns under
the payload and under the bf16 rk4 state, the composition a directed GDC
graph takes over columns, and three training steps of
``config.GRAND_NL_BENCH`` over columns.

References, each at its stated tolerance of the reference array's scale:

* a jnp composition of the JAX package's ``_scores`` (BLEND's split-space
  score written out as its ``transformer_scores`` writes it) and its
  ``segment_softmax`` / ``segment_sum`` over ``g.col``, with x[col], Kw, kb
  and k rounded to bfloat16 as the kernels round them and every cast the
  identity in the gradient, as the kernels' backward takes it (1e-5);
* the Pallas interpret path (the JAX ``make_fused_ax_norm1``, set up as the
  JAX package's own norm-1 tests set it up, 3e-2): it packs x and the
  cotangent as bf16 pairs rounded half-up and feeds the MXU bf16 operands;
* the JAX package's blocks and trainer, whose CPU path composes the
  softmax over columns without the payload (its engine is the Pallas one
  only): where the port composes (a directed graph; the re-solve of a
  forced poison) at the float32 poison test's 1e-4 (1e-3 for the forced
  poison, see ``POISON_TOL``) and one bf16 step under the bf16 state;
  where the port runs the payload (K12-K14) and the JAX package does not,
  the 3-step trains at rtol 1e-4 / 1e-3.

On the CPU every wrapper runs its plain version, which ``chip_smoke.py``
holds the kernels to on the card. Inputs come from seeded numpy
generators and go through both packages.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.models import functions as jfunctions
from graph_neural_pde_tpu.models.attention import _scores as j_scores
from graph_neural_pde_tpu.models.gnn import GNNModel as JModel
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu.ops.scatter import segment_softmax as j_softmax
from graph_neural_pde_tpu.ops.scatter import segment_sum as j_segment_sum
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import GRAND_NL_BENCH, Config
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.data.synthetic import (
    make_random_graph_dataset, make_sbm_dataset)
from graph_neural_pde_tpu_torch.kernels.fused_rhs import _col_side, edge_scores
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.gnn import GNNModel, check_supported
from graph_neural_pde_tpu_torch.ops.graph import make_graph
from graph_neural_pde_tpu_torch.rewiring import gdc as tgdc
from graph_neural_pde_tpu_torch.training.train import Trainer

N, D, ATT, H = 320, 16, 16, 2
FEAT = 12           # BLEND's split widths: 12 features, D - FEAT positions
SBM = dict(num_nodes=N, num_classes=4, num_features=6, seed=5,
           edge_pad_multiple=64, num_val=40)
NL1 = dict(function="transformer", block="constant", attention_norm_idx=1,
           square_plus=False, self_loop_weight=1.0, add_source=True,
           hidden_dim=D, attention_dim=ATT, heads=H,
           rhs_payload_dtype="bfloat16")
BF16 = jnp.bfloat16
BELTRAMI = "exp_kernel_beltrami"
NORM1 = ("norm1_den", "norm1_fwd", "norm1_bwd")


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The tensors here are small, and the suite runs several workers at
    once: torch's intra-op thread pool only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want, scale=None):
    """Largest error relative to ``scale``, by default the reference
    array's largest entry."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    scale = np.abs(want).max() + 1e-30 if scale is None else scale
    return float(np.abs(got - want).max() / scale)


def _round(a):
    """float32 ``a`` rounded to bfloat16 (to nearest even), in float32."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(BF16)
                      .astype(jnp.float32))


def _st(a):
    """Rounded to bfloat16 in value, the identity in the gradient."""
    return a + jax.lax.stop_gradient(a.astype(BF16).astype(jnp.float32) - a)


class Graphs:
    """The SBM stand-in (a symmetric edge multiset) prepared by both
    packages for the softmax over columns."""

    def __init__(self):
        self.jcfg, self.tcfg = JConfig(**NL1), Config(**NL1)
        self.jg = jblocks.prepare_graph(self.jcfg, j_sbm(**SBM).graph)
        self.tg = tblocks.prepare_graph(self.tcfg,
                                        make_sbm_dataset(**SBM).graph)
        assert self.tg.rev is not None
        np.testing.assert_array_equal(self.tg.col.numpy(),
                                      np.asarray(self.jg.col))
        nv = self.tg.num_valid
        self.row = self.tg.row.numpy()[:nv].astype(np.int64)
        self.col = self.tg.col.numpy()[:nv].astype(np.int64)


@functools.lru_cache(maxsize=None)
def _graphs():
    return Graphs()


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


class Ops:
    """Seeded operands of the attention RHS for one score family; for
    BLEND's split-space score the block-structured packed projections
    (``models.functions.pack_beltrami``: features [0, FEAT) to the first
    ATT columns, positions to the last ATT) and two pairs of scalars."""

    def __init__(self, g, score, seed=0, n=N, d=D):
        self.g, self.score = g, score
        rng = np.random.default_rng(seed)
        f32 = np.float32
        att = 2 * ATT if score == BELTRAMI else ATT
        self.x = rng.normal(size=(n, d)).astype(f32)
        self.qw = (0.3 * rng.normal(size=(d, att))).astype(f32)
        self.kw = (0.3 * rng.normal(size=(d, att))).astype(f32)
        if score == BELTRAMI:
            for w in (self.qw, self.kw):
                w[FEAT:, :ATT] = 0.0
                w[:FEAT, ATT:] = 0.0
        self.qb = (0.1 * rng.normal(size=att)).astype(f32)
        self.kb = (0.1 * rng.normal(size=att)).astype(f32)
        self.probe = rng.normal(size=(n, d)).astype(f32)
        if score == "exp_kernel":
            self.sp = (np.array([1.3], f32), np.array([0.8], f32))
        elif score == BELTRAMI:
            self.sp = (np.array([1.3], f32), np.array([1.4], f32),
                       np.array([0.9], f32), np.array([1.1], f32))
        else:
            self.sp = ()

    def t_ops(self, grad=False, x=None):
        ops = [torch.tensor(a) for a in (self.qw, self.qb, self.kw, self.kb)]
        ops.append(torch.tensor(self.x) if x is None else x)
        return [t.requires_grad_(grad) for t in ops]

    def t_sp(self, grad=False):
        return tuple(torch.tensor(a, requires_grad=grad) for a in self.sp)

    def j_sp(self):
        return tuple(jnp.asarray(a).reshape(()) for a in self.sp)

    def k_exact(self, x):
        """The k table's value: bf16(bf16(x_b Kw_b) + kb_b), the product
        summed in float64 (what the JAX package's bf16 dot rounds)."""
        prod = (_round(x).astype(np.float64)
                @ _round(self.kw).astype(np.float64)).astype(np.float32)
        return _round(_round(prod) + _round(self.kb))

    def j_scores(self, q, k, sp):
        """Per-edge, per-head scores [E, H] of the gathered q and k rows,
        as the JAX package's XLA path computes them."""
        jg = self.g.jg
        src, dst = q[jg.row], k[jg.col]
        if self.score == BELTRAMI:
            var_x, ls_x, var_p, ls_p = sp
            d_k = ATT // H

            def sq(a, b):
                return jnp.sum((a.reshape(-1, H, d_k)
                                - b.reshape(-1, H, d_k)) ** 2, axis=-1)

            return (var_x ** 2 * jnp.exp(-sq(src[:, :ATT], dst[:, :ATT])
                                         / (2.0 * ls_x ** 2))
                    * var_p ** 2 * jnp.exp(-sq(src[:, ATT:], dst[:, ATT:])
                                           / (2.0 * ls_p ** 2)))
        cfg = self.g.jcfg.replace(attention_type=self.score)
        d_k = ATT // H
        ap = {} if not sp else {"output_var": sp[0], "lengthscale": sp[1]}
        return j_scores(cfg, src.reshape(-1, H, d_k), dst.reshape(-1, H, d_k),
                        d_k, ap)

    def j_composition(self, qw, qb, kw, kb, x, sp, k_val):
        """(ax, den) of the softmax over columns with the bf16 column
        table, from the JAX package's scores, ``segment_softmax`` over
        ``g.col`` and ``segment_sum``; each cast is the identity in the
        gradient and the k table takes the value ``k_val``. The row side is
        x itself (q = x Qw + qb)."""
        jg = self.g.jg
        n = x.shape[0]
        xb = _st(x)
        lin = xb @ _st(kw) + _st(kb)
        k = lin + jax.lax.stop_gradient(k_val - lin)
        prods = self.j_scores(x @ qw + qb, k, sp)
        att = j_softmax(prods, jg.col, n, mask=jg.mask)
        ax = j_segment_sum(jnp.mean(att, axis=1)[:, None] * xb[jg.col],
                           jg.row, n, mask=jg.mask)
        den = j_segment_sum(jnp.exp(prods), jg.col, n, mask=jg.mask)
        return ax, den

    def j_reference(self, x=None):
        """(ax, den, the gradients of sum(ax * probe) in qw, qb, kw, kb,
        x and the scalars) of the composition, at the row side ``x``
        (float32 numpy; the operands' own by default)."""
        x = self.x if x is None else x
        k_val = jnp.asarray(self.k_exact(x))

        def jloss(qw, qb, kw, kb, xx, sp):
            return jnp.sum(self.j_composition(qw, qb, kw, kb, xx, sp,
                                              k_val)[0] * self.probe)

        jops = [jnp.asarray(a) for a in (self.qw, self.qb, self.kw, self.kb,
                                         x)]
        ax, den = self.j_composition(*jops, self.j_sp(), k_val)
        grads = jax.grad(jloss, argnums=tuple(range(6)))(*jops, self.j_sp())
        return ax, den, list(grads[:5]) + list(grads[5])


@pytest.fixture
def spy(monkeypatch):
    """The norm-1 wrappers' calls in order, each as (name, whether it read
    a bfloat16 column table): on the CPU no launch is counted, so the route
    is read from the calls."""
    seen = []
    for name in NORM1:
        real = getattr(kernels.norm1, name)

        def call(*a, _name=name, _real=real, **kw):
            seen.append((_name, kw.get("xcol") is not None))
            return _real(*a, **kw)

        monkeypatch.setattr(kernels.norm1, name, call)
    return seen


def _hold_grads(got, want, tol, x_tol=None):
    """Each gradient within ``tol`` of its own scale (x's, the fifth,
    within ``x_tol`` where given), a leaf whose true gradient is ~0 within
    ``tol`` of the largest leaf's."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        scale = float(np.abs(np.asarray(wv)).max())
        t = x_tol if (i == 4 and x_tol is not None) else tol
        bound = t * (scale if scale > 1e-3 * top else top)
        err = np.abs(gv.detach().float().numpy().reshape(-1)
                     - np.asarray(wv).reshape(-1)).max()
        assert err <= bound, (i, err, bound)


# ---------------------------------------------------------------------------
# the op: K12 (both modes), K13, K14 on the bfloat16 column table
# ---------------------------------------------------------------------------

SCORES = ("scaled_dot", "cosine_sim", BELTRAMI)
# x's gradient under the bf16 row side comes back in bfloat16: one bf16
# step of its scale
BF16_STEP = 2.0 ** -8


class TestOp:
    @pytest.mark.parametrize("row_bf16", [False, True])
    @pytest.mark.parametrize("score", SCORES)
    def test_matches_composition(self, graphs, score, row_bf16, spy):
        """ax, den and the gradients of sum(ax * probe) in qw, qb, kw, kb,
        x and the score's scalars against the JAX composition over columns
        with the same casts: 1e-5 of scale. With the bf16 row side (the
        bf16 state) the reference's row side is x rounded to bfloat16 and
        x's gradient, bfloat16 itself, is held within one bf16 step. K12
        (plain and weighted), K13 and K14 all read the bfloat16 table."""
        c = Ops(graphs, score, seed=1)
        x_np = _round(c.x) if row_bf16 else c.x
        want_ax, want_den, want = c.j_reference(x_np)
        x = torch.tensor(c.x)
        x = (x.to(torch.bfloat16) if row_bf16 else x).requires_grad_(True)
        ops, sp = c.t_ops(True, x), c.t_sp(True)
        ax, den = kernels.make_fused_ax_norm1(
            graphs.tg, H, False, score, torch.bfloat16)(
                *ops, torch.zeros(1), sp)
        assert ax.dtype == den.dtype == torch.float32
        assert _rel(ax.detach(), want_ax) < 1e-5
        assert _rel(den.detach(), want_den) < 1e-5
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(c.probe)),
                                  [*ops, *sp])
        assert got[4].dtype == x.dtype
        _hold_grads(got, want, 1e-5, BF16_STEP if row_bf16 else None)
        assert spy == [("norm1_den", True), ("norm1_fwd", True),
                       ("norm1_den", True), ("norm1_bwd", True)]

    @pytest.mark.parametrize("score", ("scaled_dot", "exp_kernel", BELTRAMI))
    def test_matches_pallas_interpret(self, score):
        """Values and gradients against the JAX ``make_fused_ax_norm1`` in
        interpret mode (P14-P16: bf16 pair-packed x and cotangent, bf16 MXU
        operands) on the JAX package's own norm-1 test graph (a 40-node
        SBM, stripe blocks of 8 nodes, chunks of 16): 3e-2 of scale."""
        jcfg = JConfig(**NL1).replace(
            stripe_fused=True, stripe_block_n=8, stripe_chunk=16,
            stripe_chunk_auto=False)
        sbm = dict(num_nodes=40, num_classes=3, num_features=8, seed=3)
        jg = jblocks.prepare_graph(jcfg, j_sbm(**sbm).graph)
        pg, plan = jblocks.build_stripe_engine(jcfg, jg)
        assert plan is not None and plan.symmetric
        tg = tblocks.prepare_graph(Config(**NL1),
                                   make_sbm_dataset(**sbm).graph)
        c = Ops(None, score, seed=3, n=tg.num_nodes)
        op = jfused.make_fused_ax_norm1(plan, H, False, score, pg.col)
        gm = jnp.zeros((), jnp.float32)

        def jloss(qw, qb, kw, kb, x, sp):
            return jnp.sum(op(qw, qb, kw, kb, x, gm, sp)[0] * c.probe)

        jops = [jnp.asarray(a) for a in (c.qw, c.qb, c.kw, c.kb, c.x)]
        want_ax, want_den = op(*jops, gm, c.j_sp())
        want = jax.grad(jloss, argnums=tuple(range(6)))(*jops, c.j_sp())
        want = list(want[:5]) + list(want[5])
        ops, sp = c.t_ops(True), c.t_sp(True)
        ax, den = kernels.make_fused_ax_norm1(
            tg, H, False, score, torch.bfloat16)(*ops, torch.zeros(1), sp)
        assert _rel(ax.detach(), want_ax) < 3e-2
        assert _rel(den.detach(), want_den[:, :H]) < 3e-2
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(c.probe)),
                                  [*ops, *sp])
        top = max(float(np.abs(np.asarray(w)).max()) for w in want)
        for gv, wv in zip(got, want):
            assert np.abs(gv.numpy() - np.asarray(wv)).max() / top < 3e-2

    @pytest.mark.parametrize("row_bf16", [False, True])
    def test_den_is_the_column_mass_of_the_forward_scores(self, graphs,
                                                          row_bf16):
        """The mirror trick on the bf16 tables: K12's denominators (its row
        walk over the reverse edges) equal the sum over each column of the
        very scores K13 weights its edges with (q from the row side, k from
        the bf16 k table), 1e-6 of scale; its weighted mode equals the sum
        over each column n of u_e ct[row_e] . x~_n with x~ the column
        table, the value the forward aggregated."""
        c = Ops(graphs, "scaled_dot", seed=2)
        g = graphs.tg
        qw, qb, kw, kb, x = c.t_ops()
        if row_bf16:
            x = x.to(torch.bfloat16)
        xcol = torch.tensor(c.x).to(torch.bfloat16)
        ct = torch.tensor(c.probe)
        gmax = torch.full((1,), 0.25)
        kw_f = dict(heads=H, score="scaled_dot", xcol=xcol)
        den = kernels.norm1_den(g.rowptr, g.row, g.col, x, qw, qb, kw, kb,
                                gmax, **kw_f)
        m = kernels.norm1_den(g.rowptr, g.row, g.col, x, qw, qb, kw, kb,
                              gmax, ct=ct, **kw_f)
        r, cc = torch.tensor(graphs.row), torch.tensor(graphs.col)
        xr, xe, ke, _ = _col_side(x, xcol, kw, kb, cc)
        d_k = ATT // H
        u = torch.exp(edge_scores((xr @ qw + qb)[r].reshape(-1, H, d_k),
                                  ke.reshape(-1, H, d_k), "scaled_dot")
                      - gmax)
        want = torch.zeros(N, H).index_add(0, cc, u)
        assert _rel(den, want) < 1e-6
        weight = torch.sum(ct[r] * xe, dim=1, keepdim=True)
        assert _rel(m, torch.zeros(N, H).index_add(0, cc, u * weight)) < 1e-6

    def test_routes(self, graphs, spy):
        """Through ``make_rhs``: the payload reaches K12-K14 at widths up
        to 128 (the JAX package's engine) and not above, where they read x
        in float32; a directed graph, the exact re-solve and a re-masked
        graph compose (no norm-1 call)."""
        c = Ops(graphs, "scaled_dot", seed=4)
        for d, bf16 in ((D, True), (136, False)):
            del spy[:]
            cfg = graphs.tcfg.replace(hidden_dim=d)
            func = tfunctions.ODEFunc(cfg, d)
            x = torch.tensor(np.resize(c.x, (N, d)), requires_grad=True)
            aux = tfunctions.FuncAux(None, x.detach(), graphs.tg.weight)
            out = tfunctions.make_rhs(cfg, graphs.tg)(func, aux, 0.0, x)
            torch.sum(out).backward()
            assert spy == [("norm1_den", bf16), ("norm1_fwd", bf16),
                           ("norm1_den", bf16), ("norm1_bwd", bf16)]
        del spy[:]
        func = tfunctions.ODEFunc(graphs.tcfg, D)
        x = torch.tensor(c.x)
        aux = tfunctions.FuncAux(None, x, graphs.tg.weight)
        keep = torch.rand(graphs.tg.capacity,
                          generator=torch.Generator().manual_seed(0)) < 0.7
        for g, exact in ((graphs.tg, True),
                         (graphs.tg.with_mask(keep & graphs.tg.mask), False),
                         (_gdc_graphs()[1], False)):
            xx = x if g.num_nodes == N else torch.tensor(c.x[:g.num_nodes])
            aux = tfunctions.FuncAux(None, xx, g.weight)
            with torch.no_grad():
                out = tfunctions.make_rhs(graphs.tcfg, g,
                                          exact_softmax=exact)(
                    func, aux, 0.0, xx.to(torch.bfloat16))
            assert torch.isfinite(out).all()
        assert spy == []


# ---------------------------------------------------------------------------
# the re-solve and the composition: block_forward against the JAX package
# ---------------------------------------------------------------------------

# z against the JAX package's block, of z's scale. The bf16 state: one bf16
# step. The payload alone (a float32 state): the float32 poison test's 1e-4
# (test_torch_port_fused.py) where the softmax is as sharp as the row
# tests', and 1e-3 for the forced poison over columns, whose float32 solve
# is that much worse conditioned (Q x 400, each column's attention nearly
# one edge): there the JAX package's own float32 block under jit and
# eagerly differ by 1.0e-4 of scale, and lie 2.4e-4 from the same
# composition solved in float64, the port's 1.1e-4 from it.
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}
POISON_TOL = {"float32": 1e-3, "bfloat16": 2.0 ** -8}


def _func_pair(jcfg, tcfg, c, scale=1.0):
    """The transformer ODE function with the operands' Q and K (Q scaled
    by ``scale``) in both packages: (JAX params as numpy, port module)."""
    jp = jax.tree.map(np.asarray, jfunctions.init_func_params(
        jax.random.PRNGKey(0), jcfg, D))
    jp["alpha_train"], jp["beta_train"] = np.float32(0.3), np.float32(0.2)
    jp["att"]["Q"] = {"w": (scale * c.qw).astype(np.float32), "b": c.qb}
    jp["att"]["K"] = {"w": c.kw, "b": c.kb}
    func = tfunctions.ODEFunc(tcfg, D)
    func.load_state_dict(params_from_jax(jp))
    return jp, func


@functools.lru_cache(maxsize=None)
def _gdc_graphs():
    """The SBM stand-in rewired by GDC (the CLI's approximate PPR, top 8 a
    column) once and handed to both packages, prepared for the softmax over
    columns: a directed edge multiset, which composes."""
    tcfg = Config(**NL1).replace(rewiring="gdc", gdc_k=8)
    g = tgdc.apply_gdc(make_sbm_dataset(**SBM).graph, tcfg, pad_multiple=64,
                       device="cpu")
    nv = g.num_valid
    r, c, w = (t.numpy()[:nv] for t in (g.row, g.col, g.weight))
    jg = jblocks.prepare_graph(JConfig(**NL1),
                               j_make_graph(r, c, w, num_nodes=N,
                                            pad_multiple=64))
    tg = tblocks.prepare_graph(Config(**NL1),
                               make_graph(r, c, w, num_nodes=N,
                                          pad_multiple=64))
    assert tg.rev is None
    return jg, tg


def _block_pair(graph, state, training, scale, seed, monkeypatch):
    """block_forward of the softmax over columns (rk4, T = 2, step 0.5) in
    both packages from one function: (z of the port, z of the JAX package,
    the port's solves' exact_softmax flags, the port's block, x)."""
    jg, tg = graph
    jcfg = JConfig(**NL1).replace(dtype=state, method="rk4", step_size=0.5,
                                  time=2.0)
    tcfg = Config(**NL1).replace(dtype=state, method="rk4", step_size=0.5,
                                 time=2.0)
    c = Ops(None, "scaled_dot", seed=seed)
    jp, func = _func_pair(jcfg, tcfg, c, scale)
    block = tblocks.ODEBlock(tcfg, D)
    block.func.load_state_dict(func.state_dict())
    calls = []
    real = tfunctions.make_rhs
    monkeypatch.setattr(
        tblocks, "make_rhs",
        lambda *a, **kw: calls.append(kw["exact_softmax"]) or real(*a, **kw))
    x = torch.tensor(c.x, requires_grad=training)
    z, _ = tblocks.block_forward(block, tcfg, tg, x, training)
    zj, _, _ = jblocks.block_forward({"func": jax.tree.map(jnp.asarray, jp)},
                                     jcfg, jg, jnp.asarray(c.x), training)
    return z, zj, calls, block, x, c


class TestBlock:
    @pytest.mark.parametrize("state,training", [
        ("float32", False), ("float32", True), ("bfloat16", True)])
    def test_poisoned_solve_resolves(self, graphs, state, training,
                                     monkeypatch, spy):
        """Q far outside exp's range: the fast solve over columns poisons
        in K12/K13 on the bf16 column table, and block_forward re-solves on
        the composed exact softmax over columns (K3/K4, K1/K2), which the
        JAX package's CPU path solves at once: z finite, against the JAX
        block's (``POISON_TOL``), loss and gradients finite. T = 2: attention
        normalised over columns is not row-stochastic, and this sharp the
        exact state leaves float32 long before the row's T."""
        z, zj, calls, block, x, c = _block_pair(
            (graphs.jg, graphs.tg), state, training, 400.0, 8, monkeypatch)
        assert calls == [False, True]
        assert ("norm1_den", True) in spy and ("norm1_fwd", True) in spy
        assert torch.isfinite(z).all()
        err = _rel(z.detach(), zj)
        assert err <= POISON_TOL[state], err
        if training:
            del spy[:]
            torch.sum(z * torch.tensor(c.probe)).backward()
            assert torch.isfinite(x.grad).all()
            assert all(torch.isfinite(p.grad).all()
                       for p in block.parameters() if p.grad is not None)
            assert spy == []

    @pytest.mark.parametrize("state", ["float32", "bfloat16"])
    def test_directed_gdc_graph_composes(self, state, monkeypatch, spy):
        """A directed GDC graph over columns composes (no norm-1 call) under
        the payload and under the bf16 rk4 state: z against the JAX
        block's (``BLOCK_TOL``), one solve."""
        z, zj, calls, _, _, _ = _block_pair(_gdc_graphs(), state, True, 1.0,
                                            9, monkeypatch)
        assert calls == [False] and spy == []
        err = _rel(z.detach(), zj)
        assert err <= BLOCK_TOL[state], err


# ---------------------------------------------------------------------------
# three training steps of GRAND_NL_BENCH over columns
# ---------------------------------------------------------------------------

BENCH_SIZES = dict(num_nodes=300, num_edges=900, hidden=16, attention_dim=16,
                   heads=2, seed=3)


def _three_steps(state_dtype):
    """Three optimizer steps of GRAND_NL_BENCH with the softmax over
    columns at a small width over the bench's random graph in both
    packages, from one converted init (Q and K drawn off their
    near-constant init): per step (loss, forward NFE, backward NFE)."""
    tcfg = GRAND_NL_BENCH.replace(
        hidden_dim=BENCH_SIZES["hidden"],
        attention_dim=BENCH_SIZES["attention_dim"],
        heads=BENCH_SIZES["heads"], dtype=state_dtype, attention_norm_idx=1)
    jcfg = JConfig(**dataclasses.asdict(tcfg))
    _, _, _, jx, jg, nf, nc = jbench.build_benchmark(**BENCH_SIZES)
    data = make_random_graph_dataset(
        BENCH_SIZES["num_nodes"], BENCH_SIZES["num_edges"], num_features=128,
        num_classes=40, seed=BENCH_SIZES["seed"], edge_pad_multiple=1024)
    jm = JModel(jcfg, nf, nc, jg)
    params, state = jm.init(jax.random.PRNGKey(7))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(8)
    for k in ("Q", "K"):
        w = params["block"]["func"]["att"][k]["w"]
        params["block"]["func"]["att"][k]["w"] = \
            (0.3 * rng.normal(size=w.shape)).astype(np.float32)
    n = BENCH_SIZES["num_nodes"]
    y = rng.integers(0, nc, n)
    mask = rng.random(n) < 0.5
    jp, jt = jax.tree.map(jnp.asarray, params), JTrainer(jm)
    opt_state, jlogs = jt.optimizer.init(jp), []
    for step in range(3):
        jp, state, opt_state, loss, st = jt._train_step(
            jp, state, opt_state, jx, None, jnp.asarray(y),
            jnp.asarray(mask), jax.random.PRNGKey(step))
        jlogs.append((float(loss), int(st["nfe"]),
                      int(st["accepted"]) * jt._bwd_evals_per_step))
    tm = GNNModel(tcfg, nf, nc, data.graph)
    tm.load_state_dict(params_from_jax(params))
    trainer, tlogs = Trainer(tm), []
    for _ in range(3):
        loss, st = trainer.train_step(data.x, torch.as_tensor(y),
                                      torch.as_tensor(mask))
        tlogs.append((loss, st["nfe"], st["bwd_nfe"]))
    return jlogs, tlogs


class TestBenchTraining:
    @pytest.mark.parametrize("state,rtol", [("float32", 1e-4),
                                            ("bfloat16", 1e-3)])
    def test_three_steps(self, state, rtol, spy):
        """The payload with a float32 state (rtol 1e-4), and the bf16 rk4
        state too, bench.py's precision (rtol 1e-3: a flipped bf16 bit is
        3.9e-3 relative in one element): losses against the JAX Trainer's,
        NFE identical, every norm-1 launch on the bf16 column table."""
        jlogs, tlogs = _three_steps(state)
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=rtol)
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        assert tlogs[0][0] != tlogs[-1][0]
        assert {s[0] for s in spy} == set(NORM1)
        assert all(s[1] for s in spy)


# ---------------------------------------------------------------------------
# the composed column routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("override", [
    dict(square_plus=True), dict(reweight_attention=True),
    dict(mix_features=True), dict(fused_attention_agg=False)])
def test_composed_column_routes_accepted(override):
    """The column configs outside ``norm1_fused_ok`` compose on K1-K4 and,
    as the JAX package's composition there, apply no payload (B1 item 4,
    refused at config time before it was ported): accepted at bench
    precision (tests/test_torch_port_bf16_composed.py holds their
    values)."""
    check_supported(GRAND_NL_BENCH.replace(attention_norm_idx=1, **override))
