"""The PyTorch port's bfloat16 payload and state on the column-plan backward
and the exact re-solve, against the JAX package: ``make_fused_ax_colplan``
(K6, K8 without its per-edge dxg, K17) with the bfloat16 column table on a
directed graph and, under ``sym_backward=False``, on a symmetric one; the
exact mode's K7 row maxima, K6 shifted and ``fused_rhs_ax`` (K8 with dxg);
a forced poison through ``block_forward`` under the payload and under the
bf16 rk4 state; three training steps of ``config.GRAND_NL_BENCH`` with
``sym_backward=False``.

References, each at its stated tolerance of the reference array's scale:

* the JAX package's float32 XLA path with the same casts (1e-5): its own
  ``make_rhs`` (values, the exact mode's included) and a jnp composition of
  its ``_scores`` (BLEND's split-space score written out as its
  ``transformer_scores`` writes it) and ``_fused_normalized_aggregate``,
  with x[col], Kw, kb and k rounded to bfloat16 as the kernels round them
  and every cast the identity in the gradient, as the kernels' backward
  takes it (the XLA path's own autodiff rounds the cotangent of x[col] to
  bfloat16 and sums it there);
* the Pallas interpret path (``make_fused_ax_colplan(..., pay_dt)``, 3e-2):
  it also rounds its one-hot operands and packs its node table to bf16.

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
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import GRAND_NL_BENCH, Config
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.data.synthetic import (
    make_random_graph_dataset, make_sbm_dataset)
from graph_neural_pde_tpu_torch.kernels.fused_rhs import _col_side, edge_scores
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.gnn import GNNModel
from graph_neural_pde_tpu_torch.ops.graph import make_graph
from graph_neural_pde_tpu_torch.training.train import Trainer

N, D, ATT, H = 320, 16, 16, 2
FEAT = 12           # BLEND's split widths: 12 features, D - FEAT positions
SBM = dict(num_nodes=N, num_classes=4, num_features=6, seed=5,
           edge_pad_multiple=64, num_val=40)
NL = dict(function="transformer", block="constant", attention_norm_idx=0,
          square_plus=False, self_loop_weight=1.0, add_source=True,
          hidden_dim=D, attention_dim=ATT, heads=H,
          rhs_payload_dtype="bfloat16")
BF16 = jnp.bfloat16
BELTRAMI = "exp_kernel_beltrami"


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


def _directed_edges(seed, n=N, e=1500):
    """Uniform pairs one way only, no self pairs (prepare_graph adds the
    loops): a directed edge multiset."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e).astype(np.int32)
    c = rng.integers(0, n, e).astype(np.int32)
    keep = r != c
    return r[keep], c[keep]


class Graphs:
    """One prepared graph in both packages (``kind``: "directed", random
    pairs one way; "symmetric", the SBM stand-in, under which only
    ``sym_backward=False`` takes the column plan) and the JAX stripe plan
    over it with its column plan (the Pallas interpret path)."""

    def __init__(self, kind):
        self.kind = kind
        self.jcfg = JConfig(**NL)
        self.tcfg = Config(**NL)
        if kind == "directed":
            r, c = _directed_edges(11)
            jraw = j_make_graph(r, c, None, num_nodes=N, pad_multiple=64)
            traw = make_graph(r, c, num_nodes=N, pad_multiple=64)
        else:
            jraw, traw = j_sbm(**SBM).graph, make_sbm_dataset(**SBM).graph
        self.jg = jblocks.prepare_graph(self.jcfg, jraw)
        self.tg = tblocks.prepare_graph(self.tcfg, traw)
        assert (self.tg.rev is None) == (kind == "directed")
        np.testing.assert_array_equal(self.tg.col.numpy(),
                                      np.asarray(self.jg.col))
        pcfg = self.jcfg.replace(stripe_fused=True, stripe_block_n=32,
                                 stripe_chunk=64, stripe_chunk_auto=False)
        self.pg, self.plan = jblocks.build_stripe_engine(pcfg, self.jg)
        assert self.plan.col_plan is not None
        assert self.plan.symmetric == (kind == "symmetric")
        self.nv = self.tg.num_valid
        self.row = self.tg.row.numpy()[:self.nv].astype(np.int64)
        self.col = self.tg.col.numpy()[:self.nv].astype(np.int64)


@functools.lru_cache(maxsize=None)
def _graphs(kind):
    return Graphs(kind)


@pytest.fixture(scope="module", params=["directed", "symmetric"])
def graphs(request):
    return _graphs(request.param)


class Ops:
    """Seeded operands of the attention RHS for one score family; for
    BLEND's split-space score the block-structured packed projections
    (``models.functions.pack_beltrami``: features [0, FEAT) to the first
    ATT columns, positions to the last ATT) and two pairs of scalars."""

    def __init__(self, g, score, seed=0):
        self.g, self.score = g, score
        rng = np.random.default_rng(seed)
        f32 = np.float32
        att = 2 * ATT if score == BELTRAMI else ATT
        self.x = rng.normal(size=(N, D)).astype(f32)
        self.qw = (0.3 * rng.normal(size=(D, att))).astype(f32)
        self.kw = (0.3 * rng.normal(size=(D, att))).astype(f32)
        if score == BELTRAMI:
            for w in (self.qw, self.kw):
                w[FEAT:, :ATT] = 0.0
                w[:FEAT, ATT:] = 0.0
        self.qb = (0.1 * rng.normal(size=att)).astype(f32)
        self.kb = (0.1 * rng.normal(size=att)).astype(f32)
        self.probe = rng.normal(size=(N, D)).astype(f32)
        if score == "exp_kernel":
            self.sp = (np.array([1.3], f32), np.array([0.8], f32))
        elif score == BELTRAMI:
            self.sp = (np.array([1.3], f32), np.array([1.4], f32),
                       np.array([0.9], f32), np.array([1.1], f32))
        else:
            self.sp = ()

    def t_ops(self, grad=False):
        return [torch.tensor(a, requires_grad=grad)
                for a in (self.qw, self.qb, self.kw, self.kb, self.x)]

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
        """(ax, den) of the row softmax with the bf16 column table, from
        the JAX package's scores and ``_fused_normalized_aggregate``; each
        cast is the identity in the gradient and the k table takes the
        value ``k_val``."""
        jg = self.g.jg
        xb = _st(x)
        lin = xb @ _st(kw) + _st(kb)
        k = lin + jax.lax.stop_gradient(k_val - lin)
        prods = self.j_scores(x @ qw + qb, k, sp)
        u = jnp.where(jg.mask[:, None], jnp.exp(prods), 0.0)
        ax = jfunctions._fused_normalized_aggregate(self.g.jcfg, jg, u,
                                                    xb[jg.col], x)
        den = jax.ops.segment_sum(u, jg.row, num_segments=N)
        return ax, den

    def j_reference(self):
        """(ax, den, the gradients of sum(ax * probe) in qw, qb, kw, kb,
        x and the scalars) of the composition."""
        k_val = jnp.asarray(self.k_exact(self.x))

        def jloss(qw, qb, kw, kb, x, sp):
            return jnp.sum(self.j_composition(qw, qb, kw, kb, x, sp,
                                              k_val)[0] * self.probe)

        jops = [jnp.asarray(a) for a in (self.qw, self.qb, self.kw, self.kb,
                                         self.x)]
        ax, den = self.j_composition(*jops, self.j_sp(), k_val)
        grads = jax.grad(jloss, argnums=tuple(range(6)))(*jops, self.j_sp())
        return ax, den, list(grads[:5]) + list(grads[5])


@pytest.fixture
def spy(monkeypatch):
    """The kernel wrappers' calls in order, each as (name, whether it read a
    bfloat16 column table, whether it took the exact mode's shifts): on the
    CPU no launch is counted, so the route is read from the calls."""
    seen = []

    def wrap(module, name):
        real = getattr(module, name)

        def call(*a, **kw):
            seen.append((name, kw.get("xcol") is not None,
                         kw.get("shifts") is not None))
            return real(*a, **kw)

        monkeypatch.setattr(module, name, call)

    for name in ("fused_rhs_fwd", "fused_rhs_bwd", "fused_rhs_bwd_sym",
                 "fused_rhs_bwd_col"):
        wrap(kernels.fused_rhs, name)
    wrap(tfunctions, "fused_rowmax")
    return seen


def _hold_grads(got, want, tol):
    """Each gradient within ``tol`` of its own scale, a leaf whose true
    gradient is ~0 (K.b under the row softmax: its own scale is
    cancellation noise) within ``tol`` of the largest leaf's."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        scale = float(np.abs(np.asarray(wv)).max())
        bound = tol * (scale if scale > 1e-3 * top else top)
        err = np.abs(gv.detach().numpy().reshape(-1)
                     - np.asarray(wv).reshape(-1)).max()
        assert err <= bound, (i, err, bound)


# ---------------------------------------------------------------------------
# the column-plan engine: K6, K8 without dxg, K17
# ---------------------------------------------------------------------------

SCORES = ("scaled_dot", "exp_kernel", BELTRAMI)


class TestColplan:
    @pytest.mark.parametrize("score", SCORES)
    def test_matches_composition(self, graphs, score, spy):
        """ax, den and the gradients of sum(ax * probe) in qw, qb, kw, kb,
        x and the score's scalars against the JAX composition with the same
        casts: 1e-5 of scale. K6, K8 (without dxg) and K17 all read the
        bfloat16 column table."""
        c = Ops(graphs, score, seed=1)
        want_ax, want_den, want = c.j_reference()
        ops, sp = c.t_ops(True), c.t_sp(True)
        ax, den = kernels.make_fused_ax_colplan(
            graphs.tg, H, False, score, torch.bfloat16)(
                *ops, torch.zeros(1), sp)
        assert ax.dtype == den.dtype == torch.float32
        assert _rel(ax.detach(), want_ax) < 1e-5
        assert _rel(den.detach(), want_den) < 1e-5
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(c.probe)),
                                  [*ops, *sp])
        _hold_grads(got, want, 1e-5)
        assert spy == [("fused_rhs_fwd", True, False),
                       ("fused_rhs_bwd", True, False),
                       ("fused_rhs_bwd_col", True, False)]

    def test_bf16_row_side(self, graphs):
        """Under the bf16 state x itself is bfloat16: the same op on the
        rounded x, its gradient returned in bfloat16."""
        c = Ops(graphs, "scaled_dot", seed=2)
        outs = []
        for x in (torch.tensor(c.x).to(torch.bfloat16),
                  torch.tensor(_round(c.x))):
            x.requires_grad_(True)
            ops = c.t_ops()[:4] + [x]
            ax, _ = kernels.make_fused_ax_colplan(
                graphs.tg, H, False, "scaled_dot", torch.bfloat16)(
                    *ops, torch.zeros(1), ())
            torch.sum(ax * torch.tensor(c.probe)).backward()
            outs.append((ax.detach(), x.grad))
        (ax_b, g_b), (ax_r, g_r) = outs
        assert g_b.dtype == torch.bfloat16
        assert _rel(ax_b, ax_r) < 1e-6
        assert _rel(g_b.float(), g_r.to(torch.bfloat16).float()) == 0

    @pytest.mark.parametrize("kind,score", [
        ("directed", "scaled_dot"), ("directed", "exp_kernel"),
        ("symmetric", "scaled_dot")])
    def test_matches_pallas_interpret(self, kind, score):
        """Values and gradients against the JAX ``make_fused_ax_colplan``
        with ``pay_dt=bfloat16`` in interpret mode (bf16 one-hots and a
        packed bf16 node table): 3e-2 of scale."""
        graphs = _graphs(kind)
        c = Ops(graphs, score, seed=3)
        op = jfused.make_fused_ax_colplan(graphs.plan, H, False, score,
                                          graphs.pg.col, BF16)
        gm = jnp.zeros((), jnp.float32)

        def jloss(qw, qb, kw, kb, x, sp):
            return jnp.sum(op(qw, qb, kw, kb, x, gm, sp)[0] * c.probe)

        jops = [jnp.asarray(a) for a in (c.qw, c.qb, c.kw, c.kb, c.x)]
        want_ax, want_den = op(*jops, gm, c.j_sp())
        want = jax.grad(jloss, argnums=tuple(range(6)))(*jops, c.j_sp())
        want = list(want[:5]) + list(want[5])
        ops, sp = c.t_ops(True), c.t_sp(True)
        ax, den = kernels.make_fused_ax_colplan(
            graphs.tg, H, False, score, torch.bfloat16)(*ops, torch.zeros(1),
                                                        sp)
        assert _rel(ax.detach(), want_ax) < 3e-2
        assert _rel(den.detach(), want_den[:, :H]) < 3e-2
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(c.probe)),
                                  [*ops, *sp])
        top = max(float(np.abs(np.asarray(w)).max()) for w in want)
        for gv, wv in zip(got, want):
            assert np.abs(gv.numpy() - np.asarray(wv)).max() / top < 3e-2

    def test_rhs_value_matches_xla(self, graphs, spy):
        """The whole RHS through ``make_rhs`` (the column plan: a directed
        graph, or ``sym_backward=False``) against the JAX package's
        ``make_rhs`` with the bf16 payload, its CPU (XLA) path: 1e-5."""
        c = Ops(graphs, "scaled_dot", seed=4)
        jp, func = _func_pair(graphs, c)
        jcfg = graphs.jcfg.replace(sym_backward=False)
        tcfg = graphs.tcfg.replace(sym_backward=False)
        jaux = jfunctions.FuncAux(None, jnp.asarray(c.probe), graphs.jg.weight)
        taux = tfunctions.FuncAux(None, torch.tensor(c.probe), graphs.tg.weight)
        want = jfunctions.make_rhs(jcfg, graphs.jg)(
            jax.tree.map(jnp.asarray, jp), jaux, 0.0, jnp.asarray(c.x))
        x = torch.tensor(c.x, requires_grad=True)
        got = tfunctions.make_rhs(tcfg, graphs.tg)(func, taux, 0.0, x)
        torch.sum(got).backward()
        assert _rel(got.detach(), want) < 1e-5
        assert [s[:2] for s in spy] == [("fused_rhs_fwd", True),
                                        ("fused_rhs_bwd", True),
                                        ("fused_rhs_bwd_col", True)]


def _func_pair(g, c, scale=1.0):
    """The transformer ODE function with the operands' Q and K (Q scaled
    by ``scale``) in both packages: (JAX params as numpy, port module)."""
    jp = jax.tree.map(np.asarray, jfunctions.init_func_params(
        jax.random.PRNGKey(0), g.jcfg, D))
    jp["alpha_train"], jp["beta_train"] = np.float32(0.3), np.float32(0.2)
    jp["att"]["Q"] = {"w": (scale * c.qw).astype(np.float32), "b": c.qb}
    jp["att"]["K"] = {"w": c.kw, "b": c.kb}
    func = tfunctions.ODEFunc(g.tcfg, D)
    func.load_state_dict(params_from_jax(jp))
    return jp, func


# ---------------------------------------------------------------------------
# the exact re-solve: K7, K6 shifted, K8 with dxg
# ---------------------------------------------------------------------------

class TestExact:
    @pytest.mark.parametrize("row_bf16", [False, True])
    def test_rowmax_shifts_leave_zero_maxima(self, graphs, row_bf16):
        """K7 over the bfloat16 column table gives each row's largest score
        of the very keys K6 reads: the shifted scores' maximum is exactly 0
        on every row with edges, and the maxima hold against the JAX
        composition's scores (same casts) at 1e-5 of scale."""
        c = Ops(graphs, "scaled_dot", seed=5)
        g = graphs.tg
        ops = c.t_ops()
        x = ops[4].to(torch.bfloat16) if row_bf16 else ops[4]
        xcol = ops[4].to(torch.bfloat16)
        smax = kernels.fused_rowmax(g.rowptr, g.row, g.col, x, *ops[:4],
                                    heads=H, xcol=xcol)
        assert smax.dtype == torch.float32 and smax.shape == (N, H)
        r, cc = torch.tensor(graphs.row), torch.tensor(graphs.col)
        xr, _, ke, _ = _col_side(x, xcol, ops[2], ops[3], cc)
        d_k = ATT // H
        s = edge_scores((xr @ ops[0] + ops[1])[r].reshape(-1, H, d_k),
                        ke.reshape(-1, H, d_k), "scaled_dot")
        shifted = s - smax[r]
        top = torch.full((N, H), -torch.inf).scatter_reduce(
            0, r[:, None].expand_as(shifted), shifted, "amax")
        has = (g.rowptr[1:] > g.rowptr[:-1])
        assert torch.equal(top[has], torch.zeros_like(top[has]))
        k_val = jnp.asarray(c.k_exact(c.x))
        xq = _round(c.x) if row_bf16 else c.x
        prods = np.asarray(c.j_scores(jnp.asarray(xq) @ c.qw + c.qb, k_val,
                                      ()))[:graphs.nv]
        want = np.full((N, H), -np.inf, np.float32)
        np.maximum.at(want, graphs.row, prods)
        assert _rel(smax.numpy()[has.numpy()], want[has.numpy()]) < 1e-5

    def test_fused_rhs_ax_matches_composition(self, graphs, spy):
        """``fused_rhs_ax`` with the rows' maxima as shifts and the bf16
        payload (K6 shifted; K8 with dxg summed over columns): ax and every
        gradient against the unshifted JAX composition with the same casts
        (the softmax is shift-invariant): 1e-5 of scale."""
        c = Ops(graphs, "scaled_dot", seed=6)
        want_ax, want_den, want = c.j_reference()
        g = graphs.tg
        ops = c.t_ops(True)
        with torch.no_grad():
            smax = kernels.fused_rowmax(
                g.rowptr, g.row, g.col, ops[4], *ops[:4], heads=H,
                xcol=ops[4].to(torch.bfloat16))
        ax, den = kernels.fused_rhs_ax(g, H, False, "scaled_dot", *ops,
                                       torch.zeros(1), smax[g.row.long()],
                                       payload_dtype=torch.bfloat16)
        assert _rel(ax.detach(), want_ax) < 1e-5
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(c.probe)), ops)
        _hold_grads(got, want, 1e-5)
        assert spy == [("fused_rhs_fwd", True, True),
                       ("fused_rhs_bwd", True, True)]

    def test_exact_rhs_value_matches_xla(self, graphs):
        """The exact RHS through ``make_rhs(exact_softmax=True)`` (K7, K6
        shifted) against the JAX package's exact XLA path (the per-row
        softmax over the bf16 payload): 1e-5 of scale."""
        c = Ops(graphs, "scaled_dot", seed=7)
        jp, func = _func_pair(graphs, c)
        jaux = jfunctions.FuncAux(None, jnp.asarray(c.probe), graphs.jg.weight)
        taux = tfunctions.FuncAux(None, torch.tensor(c.probe), graphs.tg.weight)
        want = jfunctions.make_rhs(graphs.jcfg, graphs.jg, exact_softmax=True)(
            jax.tree.map(jnp.asarray, jp), jaux, 0.0, jnp.asarray(c.x))
        with torch.no_grad():
            got = tfunctions.make_rhs(graphs.tcfg, graphs.tg,
                                      exact_softmax=True)(
                func, taux, 0.0, torch.tensor(c.x))
        assert _rel(got, want) < 1e-5


# z against the JAX package's re-solved block, of z's scale: the payload
# alone at the float32 poison test's 1e-4 (test_torch_port_fused.py; the
# sharp exact softmax amplifies the order of float32 sums: measured
# 9.6e-6 on the directed graph, 4.8e-6 on the symmetric one), the bf16
# state at one bf16 step (measured 0: every stage sum rounds alike)
POISON_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}


class TestPoisonedSolve:
    @pytest.mark.parametrize("state,training", [
        ("float32", False), ("float32", True), ("bfloat16", True)])
    def test_block_forward_resolves(self, graphs, state, training,
                                    monkeypatch, spy):
        """Q far outside exp's range: the fast solve poisons, block_forward
        re-solves with the exact softmax on the bf16 payload (K7, K6
        shifted and, in training, K8 with dxg) and comes back finite,
        against the JAX package's re-solved block (``POISON_TOL``). The JAX
        block runs eagerly: under jit, XLA drops the bf16 rounding of k_e
        where the float32 state casts it straight back (a convert pair),
        and at these scores one bf16 step of k moves the solve by 2-4%."""
        jcfg = graphs.jcfg.replace(dtype=state, method="rk4", step_size=0.5,
                                   time=1.0)
        tcfg = graphs.tcfg.replace(dtype=state, method="rk4", step_size=0.5,
                                   time=1.0)
        c = Ops(graphs, "scaled_dot", seed=8)
        jp, func = _func_pair(graphs, c, scale=400.0)
        block = tblocks.ODEBlock(tcfg, D)
        block.func.load_state_dict(func.state_dict())
        calls = []
        real = tfunctions.make_rhs
        monkeypatch.setattr(
            tblocks, "make_rhs",
            lambda *a, **kw: calls.append(kw["exact_softmax"]) or real(*a, **kw))
        x = torch.tensor(c.x, requires_grad=training)
        z, _ = tblocks.block_forward(block, tcfg, graphs.tg, x, training)
        assert calls == [False, True]
        assert ("fused_rowmax", True, False) in spy
        assert ("fused_rhs_fwd", True, True) in spy
        with jax.disable_jit():
            zj, _, _ = jblocks.block_forward(
                {"func": jax.tree.map(jnp.asarray, jp)}, jcfg, graphs.jg,
                jnp.asarray(c.x), training)
        assert torch.isfinite(z).all()
        assert _rel(z.detach(), zj) <= POISON_TOL[state]
        if training:
            del spy[:]
            torch.sum(z * torch.tensor(c.probe)).backward()
            assert torch.isfinite(x.grad).all()
            assert all(torch.isfinite(p.grad).all()
                       for p in block.parameters() if p.grad is not None)
            assert set(spy) == {("fused_rhs_bwd", True, True)}


# ---------------------------------------------------------------------------
# three training steps of GRAND_NL_BENCH with sym_backward=False
# ---------------------------------------------------------------------------

BENCH_SIZES = dict(num_nodes=300, num_edges=900, hidden=16, attention_dim=16,
                   heads=2, seed=3)


def _three_steps(state_dtype):
    """Three optimizer steps of GRAND_NL_BENCH with ``sym_backward=False``
    (the column-plan backward) at a small width over the bench's random
    graph in both packages, from one converted init (Q and K drawn off
    their near-constant init): per step (loss, forward NFE, backward
    NFE)."""
    tcfg = GRAND_NL_BENCH.replace(
        hidden_dim=BENCH_SIZES["hidden"],
        attention_dim=BENCH_SIZES["attention_dim"],
        heads=BENCH_SIZES["heads"], dtype=state_dtype, sym_backward=False)
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


def _colplan_only(seen):
    """Every backward went through K8 (without dxg) and K17 on the bf16
    column table, none through K9."""
    names = [s[0] for s in seen]
    assert "fused_rhs_bwd_sym" not in names
    assert names.count("fused_rhs_bwd") == names.count("fused_rhs_bwd_col") > 0
    assert all(s[1] for s in seen)


class TestBenchTraining:
    def test_payload_only(self, spy):
        """The bf16 payload with a float32 state, the column-plan backward
        on the bench's symmetric graph: losses rtol 1e-4, NFE identical,
        every backward through K8 and K17 on the bf16 table, none through
        K9."""
        jlogs, tlogs = _three_steps("float32")
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-4)
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        assert tlogs[0][0] != tlogs[-1][0]
        _colplan_only(spy)

    def test_bf16_state(self, spy):
        """The bf16 rk4 state (bench.py's precision) with the column-plan
        backward: losses rtol 1e-3 (a flipped bf16 bit is 3.9e-3 relative
        in one element), NFE identical."""
        jlogs, tlogs = _three_steps("bfloat16")
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-3)
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        _colplan_only(spy)
