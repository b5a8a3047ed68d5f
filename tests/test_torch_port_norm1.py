"""The PyTorch port's column-normalised GRAND-nl slice and its tuned
ogbn-arxiv row against the JAX package, on the CPU.

Part A: the plain versions of K12 ``norm1_den`` (both modes), K13
``norm1_fwd`` and K14 ``norm1_bwd`` against the Pallas calls they replace
(interpret mode on a small stripe plan) and, through ``make_rhs``, against
``jax.grad`` of the float32 XLA composition with ``attention_norm_idx=1``;
the denominators against a segment sum over columns; ``gradcheck``; which
configurations ``make_rhs`` sends to the fused engine; the poison re-solve;
three training epochs of the Cora row as GRAND-nl with its own column
normalisation.

Part B: the OGB raw-layout loader, the ogbn-arxiv stand-in, the label block
(``use_labels``) and three epochs of the tuned ogbn-arxiv row.

On the CPU every wrapper runs its plain version, so what is held against
the JAX package here is what the kernels are held against on the card
(``chip_smoke.py``). Inputs come from seeded numpy generators and go
through both packages.
"""

import gzip
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.data import datasets as jdatasets
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.models import functions as jfunctions
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config, best_params
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.data import datasets as tdatasets
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.kernels.fused_rhs import edge_scores
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.gnn import check_supported
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.ops.graph import make_graph
from graph_neural_pde_tpu_torch.training import train as ttrain
from graph_neural_pde_tpu_torch.training.train import Trainer

SCORES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel")
ATT = 8
NL1 = dict(function="transformer", block="constant", attention_norm_idx=1,
           square_plus=False, add_source=True, attention_dim=ATT)
SBM = dict(num_nodes=40, num_classes=3, num_features=8, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The tensors here are tiny, and the suite runs several workers at
    once: torch's intra-op thread pool only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    """Largest error relative to the reference array's largest entry."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _operands(n, d, seed):
    """Seeded operands of one RHS evaluation, as numpy float32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.normal(size=(n, d)).astype(f32),
        qw=(0.3 * rng.normal(size=(d, ATT))).astype(f32),
        kw=(0.3 * rng.normal(size=(d, ATT))).astype(f32),
        qb=(0.1 * rng.normal(size=ATT)).astype(f32),
        kb=(0.1 * rng.normal(size=ATT)).astype(f32),
        ct=rng.normal(size=(n, d)).astype(f32),
        var=np.array([1.3], f32), ls=np.array([0.8], f32),
        gmax=np.array([0.25], f32))


def _t_score_kw(o, score, dtype=torch.float32):
    if score != "exp_kernel":
        return {}
    return dict(var=torch.tensor(o["var"], dtype=dtype),
                ls=torch.tensor(o["ls"], dtype=dtype))


# ---------------------------------------------------------------------------
# the plain versions against the Pallas calls (interpret mode)
# ---------------------------------------------------------------------------

class PlanCase:
    """The SBM graph prepared by both packages, the JAX stripe plan over it
    (block_n 8, chunk 16, symmetric: as the JAX package's own norm-1 tests)
    and the operands of the Pallas calls as ``make_fused_ax_norm1`` prepares
    them: x and the projections padded to 128 columns in the pair-decode
    order, x (with 1/den) and the cotangent packed as bf16 pairs."""

    def __init__(self, score, heads=2, d=8, seed=3):
        self.score, self.h, self.d = score, heads, d
        jcfg = JConfig(**NL1).replace(
            attention_type=score, heads=heads, hidden_dim=d,
            stripe_fused=True, stripe_block_n=8, stripe_chunk=16,
            stripe_chunk_auto=False, rhs_payload_dtype="bfloat16")
        jg = jblocks.prepare_graph(jcfg, j_sbm(**SBM).graph)
        self.jg, self.plan = jblocks.build_stripe_engine(jcfg, jg)
        assert self.plan is not None and self.plan.symmetric
        tcfg = Config(**NL1).replace(attention_type=score, heads=heads,
                                     hidden_dim=d)
        self.tg = tblocks.prepare_graph(tcfg, make_sbm_dataset(**SBM).graph)
        self.n = self.tg.num_nodes
        assert self.jg.num_nodes == self.n
        self.o = _operands(self.n, d, seed)

    # -- JAX side ----------------------------------------------------------
    def j_sp(self):
        if self.score != "exp_kernel":
            return ()
        return (jnp.asarray(self.o["var"]).reshape(()),
                jnp.asarray(self.o["ls"]).reshape(()))

    def j_prepared(self):
        o, d = self.o, self.d
        pm = jnp.asarray(jfused._norm1_perm(128))
        pad = ((0, 0), (0, 128 - d))
        x_e = jnp.pad(jnp.asarray(o["x"]), pad) @ pm
        qw_e = pm.T @ jnp.pad(jnp.asarray(o["qw"]), ((0, 128 - d), (0, 0)))
        kw_e = pm.T @ jnp.pad(jnp.asarray(o["kw"]), ((0, 128 - d), (0, 0)))
        return pm, x_e, qw_e, kw_e

    def j_kwargs(self):
        return dict(heads=self.h, square_plus=False, score=self.score,
                    score_params=self.j_sp(), interpret=True)

    # -- port side ---------------------------------------------------------
    def t_args(self):
        o = self.o
        return (self.tg.rowptr, self.tg.row, self.tg.col,
                *(torch.tensor(o[k]) for k in ("x", "qw", "qb", "kw", "kb",
                                               "gmax")))

    def t_kwargs(self):
        return dict(heads=self.h, score=self.score,
                    **_t_score_kw(self.o, self.score))


@pytest.fixture(scope="module", params=SCORES)
def plan_case(request):
    return PlanCase(request.param)


class TestPlainAgainstPallas:
    """5e-2 of each array's scale: the Pallas calls gather x (and the
    cotangent) as bf16 pairs and feed the MXU bf16 operands; the float32
    check of the same functions is TestRhsAgainstXla. pearson's gradients
    are held at 1e-1: the kernel's one-pass variance cancels in bf16."""

    def _j_den(self, c, ct=None):
        o, hp = c.o, max(8, c.h)
        pm, x_e, qw_e, kw_e = c.j_prepared()
        pack = jfused._pack_x_recip(jnp.asarray(o["x"]), None, hp)[c.jg.col]
        ct_g = None
        if ct is not None:
            ct128 = jnp.pad(jnp.asarray(ct), ((0, 0), (0, 128 - c.d)))
            ct_g = jfused._pack_pairs64(ct128)[c.jg.col]
        out = jfused._norm1_rev_call(
            c.plan, qw_e, jnp.asarray(o["qb"]), kw_e, jnp.asarray(o["kb"]),
            x_e, pack, jnp.asarray(o["gmax"][0]), ct_g=ct_g, **c.j_kwargs())
        return out[:, :c.h]

    def test_den(self, plan_case):
        c = plan_case
        den = kernels.norm1_den(*c.t_args(), **c.t_kwargs())
        assert _rel(den, self._j_den(c)) < 5e-2

    def test_den_weighted_by_cotangent(self, plan_case):
        c = plan_case
        m = kernels.norm1_den(*c.t_args(), ct=torch.tensor(c.o["ct"]),
                              **c.t_kwargs())
        assert _rel(m, self._j_den(c, c.o["ct"])) < 5e-2

    def test_forward(self, plan_case):
        c, o = plan_case, plan_case.o
        den = kernels.norm1_den(*c.t_args(), **c.t_kwargs())
        recip = 1.0 / (den + 1e-16)
        ax = kernels.norm1_fwd(*c.t_args(), recip, **c.t_kwargs())
        pm, x_e, qw_e, kw_e = c.j_prepared()
        pack = jfused._pack_x_recip(jnp.asarray(o["x"]),
                                    jnp.asarray(recip.numpy()),
                                    max(8, c.h))[c.jg.col]
        ax_e = jfused._norm1_fwd_call(
            c.plan, qw_e, jnp.asarray(o["qb"]), kw_e, jnp.asarray(o["kb"]),
            x_e, pack, jnp.asarray(o["gmax"][0]), **c.j_kwargs())
        assert _rel(ax, (ax_e @ pm.T)[:, :c.d]) < 5e-2

    def test_backward(self, plan_case):
        """Every output of K14's plain version from the same recip and
        den cotangent (a non-zero one) as the Pallas call."""
        c, o, h = plan_case, plan_case.o, plan_case.h
        hp = max(8, h)
        den = kernels.norm1_den(*c.t_args(), **c.t_kwargs())
        recip = 1.0 / (den + 1e-16)
        rng = np.random.default_rng(11)
        ctd = (0.5 + 0.1 * rng.normal(size=(c.n, h))).astype(np.float32)
        got = kernels.norm1_bwd(*c.t_args(), torch.tensor(o["ct"]),
                                (recip / h).contiguous(), torch.tensor(ctd),
                                **c.t_kwargs())
        pm, x_e, qw_e, kw_e = c.j_prepared()
        jrecip = jnp.asarray(recip.numpy())
        pack = jfused._pack_x_recip(jnp.asarray(o["x"]), jrecip,
                                    hp)[c.jg.col]
        ct128 = jnp.pad(jnp.asarray(o["ct"]), ((0, 0), (0, 128 - c.d)))
        ctd_p = jnp.pad(jnp.asarray(ctd), ((0, 0), (0, hp - h)))
        rcp_p = jnp.pad(jrecip / h, ((0, 0), (0, hp - h)))
        dq, dxr_e, dkw_e, dkb, dgmax, dextra = jfused._norm1_bwd_call(
            c.plan, qw_e, jnp.asarray(o["qb"]), kw_e, jnp.asarray(o["kb"]),
            x_e, pack, jfused._pack_pairs64(ct128)[c.jg.col],
            ctd_p[c.jg.col], jnp.asarray(o["gmax"][0]), ct128 @ pm, rcp_p,
            ctd_p, **c.j_kwargs())
        want = [dq, (dxr_e @ pm.T)[:, :c.d], (pm @ dkw_e)[:c.d], dkb, dgmax,
                *dextra]
        got = [g for g in got if g is not None]
        assert len(got) == len(want) == (7 if c.score == "exp_kernel" else 5)
        bound = 1e-1 if c.score == "pearson" else 5e-2
        for g, w in zip(got, want):
            assert _rel(g.reshape(-1), np.asarray(w).reshape(-1)) < bound


# ---------------------------------------------------------------------------
# the whole RHS against the float32 XLA composition
# ---------------------------------------------------------------------------

def _uneven_edges():
    """A symmetric edge multiset over 7 nodes with uneven degrees (node 0
    has 8 edges), self-loops (0, 3, 4), duplicated edges ((1, 2) twice,
    (0, 0) twice) and a node without edges (6)."""
    pairs = [(0, 1), (0, 2), (0, 3), (0, 5), (1, 2), (1, 2), (4, 5)]
    loops = [0, 0, 3, 4]
    row = [a for a, b in pairs] + [b for a, b in pairs] + loops
    col = [b for a, b in pairs] + [a for a, b in pairs] + loops
    return np.array(row, np.int32), np.array(col, np.int32), 7


class RhsCase:
    """One configuration in both packages over the uneven graph (no
    self-loops added: ``self_loop_weight=0``), converted parameters with
    random Q and K, non-zero alpha and beta."""

    def __init__(self, score="scaled_dot", heads=2, d=8, seed=5, **kw):
        row, col, n = _uneven_edges()
        kw = dict(NL1, attention_type=score, heads=heads, hidden_dim=d,
                  self_loop_weight=0.0, **kw)
        self.jcfg, self.tcfg = JConfig().replace(**kw), Config().replace(**kw)
        self.jg = jblocks.prepare_graph(
            self.jcfg, j_make_graph(row, col, None, num_nodes=n))
        self.tg = tblocks.prepare_graph(
            self.tcfg, make_graph(row, col, num_nodes=n, pad_multiple=8))
        assert self.tg.rev is not None
        self.n, self.d, self.score = n, d, score
        self.o = o = _operands(n, d, seed)
        p = jfunctions.init_func_params(jax.random.PRNGKey(0), self.jcfg, d)
        p = jax.tree.map(np.asarray, p)
        p["alpha_train"], p["beta_train"] = np.float32(0.3), np.float32(0.2)
        if self.jcfg.function == "transformer":
            p["att"]["Q"] = {"w": o["qw"], "b": o["qb"]}
            p["att"]["K"] = {"w": o["kw"], "b": o["kb"]}
            if score == "exp_kernel":
                p["att"]["output_var"], p["att"]["lengthscale"] = (o["var"],
                                                                   o["ls"])
        self.jp = p
        self.func = tfunctions.ODEFunc(self.tcfg, d)
        self.func.load_state_dict(params_from_jax(p))
        self.jaux = jfunctions.FuncAux(None, jnp.asarray(o["ct"]),
                                       self.jg.weight)
        self.taux = tfunctions.FuncAux(None, torch.tensor(o["ct"]),
                                       self.tg.weight)

    def j_rhs(self, **kw):
        """The JAX package's float32 XLA composition (no stripe plan)."""
        rhs = jfunctions.make_rhs(self.jcfg.replace(stripe_fused=False),
                                  self.jg, **kw)
        return lambda p, x: rhs(p, self.jaux, 0.0, x)

    def t_rhs(self, g=None, **kw):
        rhs = tfunctions.make_rhs(self.tcfg, g or self.tg, **kw)
        return lambda x: rhs(self.func, self.taux, 0.0, x)


SHAPES = ((2, 8), (4, 9))      # (heads, state width): an even and an odd D


@pytest.fixture(scope="module",
                params=[(s, h, d) for s in SCORES for h, d in SHAPES],
                ids=lambda p: f"{p[0]}-H{p[1]}-D{p[2]}")
def rhs_case(request):
    score, heads, d = request.param
    return RhsCase(score, heads, d)


class TestRhsAgainstXla:
    """make_rhs in both packages from converted weights: the port's fused
    column-normalised RHS against the JAX package's float32 composition
    (segment softmax over ``col``, then SpMM). Values at 1e-5 of scale,
    every leaf's gradient at 1e-4 of its scale (a leaf below 1e-3 of the
    largest one: 1e-4 of the largest)."""

    def test_value(self, rhs_case):
        c = rhs_case
        assert tfunctions.norm1_fused_ok(c.tcfg)
        want = c.j_rhs()(jax.tree.map(jnp.asarray, c.jp),
                         jnp.asarray(c.o["x"]))
        with torch.no_grad():
            got = c.t_rhs()(torch.tensor(c.o["x"]))
            folded = c.t_rhs(eval_fold=True)(torch.tensor(c.o["x"]))
        assert np.isfinite(np.asarray(want)).all()
        assert _rel(got, want) < 1e-5
        assert torch.equal(folded, got)     # no folded form: the same op

    def test_gradients(self, rhs_case):
        c = rhs_case
        w = np.random.default_rng(9).normal(size=(c.n, c.d)) \
            .astype(np.float32)
        jrhs = c.j_rhs()
        gp, gx = jax.grad(lambda p, x: jnp.sum(jrhs(p, x) * w),
                          argnums=(0, 1))(jax.tree.map(jnp.asarray, c.jp),
                                          jnp.asarray(c.o["x"]))
        x = torch.tensor(c.o["x"], requires_grad=True)
        c.func.zero_grad()
        torch.sum(c.t_rhs()(x) * torch.tensor(w)).backward()
        want = params_from_jax(jax.tree.map(np.asarray, gp))
        got = {k: p.grad for k, p in c.func.named_parameters()}
        top = max(float(v.abs().max()) for v in want.values())
        checked = 0
        for k, wv in want.items():
            if k.startswith(("att.V.", "att.Wout.")):
                assert got[k] is None or not got[k].any()   # not read
                continue
            scale = float(wv.abs().max())
            bound = 1e-4 * (scale if scale > 1e-3 * top else top)
            assert float((got[k] - wv).abs().max()) <= bound, k
            checked += 1
        assert checked == (8 if c.score == "exp_kernel" else 6)
        assert _rel(x.grad, gx) < 1e-4


# ---------------------------------------------------------------------------
# the op itself
# ---------------------------------------------------------------------------

def _op_inputs(c, dtype, grad=False):
    o = c.o
    ops = [torch.tensor(o[k], dtype=dtype, requires_grad=grad)
           for k in ("qw", "qb", "kw", "kb", "x", "gmax")]
    sp = ()
    if c.score == "exp_kernel":
        sp = tuple(torch.tensor(o[k], dtype=dtype, requires_grad=grad)
                   for k in ("var", "ls"))
    return ops, sp


class TestOp:
    @pytest.mark.parametrize("score", SCORES)
    def test_den_is_the_column_mass(self, score):
        """The op's ``den`` (a walk over each node's ROW that scores the
        reverse edges) against a segment sum of u over ``col``, and ``ax``
        against the aggregation written out edge by edge: float32 sums in
        another order, 1e-6 of scale."""
        c = RhsCase(score, heads=4, d=9)
        (qw, qb, kw, kb, x, gmax), sp = _op_inputs(c, torch.float32)
        ax, den = kernels.make_fused_ax_norm1(c.tg, 4, False, score)(
            qw, qb, kw, kb, x, gmax, sp)
        nv = c.tg.num_valid
        r, col = c.tg.row[:nv].long(), c.tg.col[:nv].long()
        q = (x @ qw + qb)[r].reshape(nv, 4, -1)
        k = (x @ kw + kb)[col].reshape(nv, 4, -1)
        u = torch.exp(edge_scores(q, k, score, *(sp or (None, None))) - gmax)
        want = torch.zeros(c.n, 4).index_add(0, col, u)
        assert _rel(den, want) < 1e-6
        assert float(den[6].abs().max()) == 0.0       # the edgeless node
        a = torch.mean(u / (want[col] + 1e-16), dim=1, keepdim=True)
        assert _rel(ax, torch.zeros(c.n, c.d).index_add(0, r, a * x[col])) \
            < 1e-6

    @pytest.mark.parametrize("score", SCORES)
    def test_gradcheck(self, score):
        """float64 finite differences of both outputs, so with a non-zero
        cotangent on ``den``, in every input."""
        c = RhsCase(score, heads=2, d=5)
        ops, sp = _op_inputs(c, torch.float64, grad=True)
        op = kernels.make_fused_ax_norm1(c.tg, 2, False, score)
        assert torch.autograd.gradcheck(lambda *a: op(*a[:6], a[6:]),
                                        (*ops, *sp))

    def test_squareplus_form(self):
        """The kernels also carry the squareplus numerator (the TPU
        kernels' ``_norm1_u_duds``), which no model path uses."""
        c = RhsCase("scaled_dot", heads=2, d=5)
        ops, sp = _op_inputs(c, torch.float64, grad=True)
        op = kernels.make_fused_ax_norm1(c.tg, 2, True, "scaled_dot")
        assert torch.autograd.gradcheck(lambda *a: op(*a, ()), tuple(ops))

    def test_cpu_runs_plain_versions_without_launching(self):
        c = RhsCase("scaled_dot")
        before = [k.launches for k in kernels.KERNELS]
        ops, sp = _op_inputs(c, torch.float32, grad=True)
        ax, den = kernels.make_fused_ax_norm1(c.tg, 2, False, "scaled_dot")(
            *ops, sp)
        torch.sum(ax).backward()
        assert [k.launches for k in kernels.KERNELS] == before
        assert kernels.KERNELS[10:13] == (kernels.norm1_den,
                                          kernels.norm1_fwd,
                                          kernels.norm1_bwd)

    @pytest.mark.parametrize("bad", ["dtype", "shape", "heads", "score",
                                     "beltrami", "meta"])
    def test_wrappers_reject(self, bad):
        c = RhsCase("scaled_dot")
        (qw, qb, kw, kb, x, gmax), _ = _op_inputs(c, torch.float32)
        rowptr, row, col = c.tg.rowptr, c.tg.row, c.tg.col
        heads, score, err = 2, "scaled_dot", (TypeError, ValueError)
        sp = {}
        if bad == "dtype":
            x = x.double()          # float64 only when every operand is
        elif bad == "shape":
            kw = kw[:, :-1].contiguous()
        elif bad == "heads":
            heads = 3
        elif bad == "score":
            score = "dot"
        elif bad == "beltrami":
            # the split-space score takes two elements of var and ls
            score, err = "exp_kernel_beltrami", ValueError
            sp = dict(var=torch.ones(1), ls=torch.ones(1))
        else:
            err = NotImplementedError
            rowptr, row, col, qw, qb, kw, kb, x, gmax = (
                t.to("meta") for t in (rowptr, row, col, qw, qb, kw, kb, x,
                                       gmax))
        with pytest.raises(err):
            kernels.norm1_den(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                              heads=heads, score=score, **sp)
        recip = torch.ones((x.shape[0], heads), device=x.device)
        with pytest.raises(err):
            kernels.norm1_fwd(rowptr, row, col, x, qw, qb, kw, kb, gmax,
                              recip, heads=heads, score=score, **sp)

    def test_directed_graph_raises(self):
        """Both the denominators and x's gradient reach an edge's column
        through its reverse edge: on a non-symmetric edge multiset the fused
        op refuses, and ``make_rhs`` composes the column softmax over the
        CSC view instead (K3/K4, K1/K2), equal to the exact re-solve's
        composition."""
        g = make_graph([0, 1, 2], [1, 2, 0], num_nodes=3).sort_by_row()
        assert g.rev is None
        with pytest.raises(ValueError, match="CSC view"):
            kernels.make_fused_ax_norm1(g, 1, False, "scaled_dot")
        cfg = Config(**NL1).replace(hidden_dim=4, heads=1,
                                    self_loop_weight=0.0)
        func = tfunctions.ODEFunc(cfg, 4)
        x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
        aux = tfunctions.FuncAux(None, x, g.weight)
        fast = tfunctions.make_rhs(cfg, g)(func, aux, 0.0, x)
        exact = tfunctions.make_rhs(cfg, g, exact_softmax=True)(func, aux,
                                                                 0.0, x)
        assert torch.isfinite(fast).all() and torch.equal(fast, exact)


# ---------------------------------------------------------------------------
# which configurations take the fused engine
# ---------------------------------------------------------------------------

@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the RHS evaluations that build the fused column-normalised
    op."""
    calls = []
    real = tfunctions.make_fused_ax_norm1
    monkeypatch.setattr(
        tfunctions, "make_fused_ax_norm1",
        lambda *a, **kw: calls.append(a[3]) or real(*a, **kw))
    return calls


class TestDispatch:
    def test_eligible_configuration_is_fused(self, fused_calls):
        c = RhsCase("cosine_sim")
        assert tfunctions.norm1_fused_ok(c.tcfg)
        assert tfunctions.rhs_may_poison(c.tcfg)
        assert not tfunctions.fused_attention(c.tcfg)   # the row engines
        with torch.no_grad():
            c.t_rhs()(torch.tensor(c.o["x"]))
        assert fused_calls == ["cosine_sim"]

    @pytest.mark.parametrize("kw,rhs_kw", [
        (dict(), dict(exact_softmax=True)),
        (dict(square_plus=True), dict()),
        (dict(reweight_attention=True), dict()),
        (dict(mix_features=True), dict()),
        (dict(function="GAT"), dict()),
        (dict(fused_attention_agg=False), dict()),
    ], ids=["exact_softmax", "square_plus", "reweight", "mix_features", "GAT",
            "no_fused_agg"])
    def test_composition(self, fused_calls, kw, rhs_kw):
        """Everything else with column normalisation composes attention
        (K3/K4 over columns) and SpMM (K1/K2), and equals the JAX package's
        composition at 1e-5 of scale."""
        c = RhsCase("scaled_dot", **kw)
        assert not tfunctions.norm1_fused_ok(c.tcfg) or rhs_kw
        want = c.j_rhs(**rhs_kw)(jax.tree.map(jnp.asarray, c.jp),
                                 jnp.asarray(c.o["x"]))
        with torch.no_grad():
            got = c.t_rhs(**rhs_kw)(torch.tensor(c.o["x"]))
        assert fused_calls == []
        assert _rel(got, want) < 1e-5

    def test_masked_graph_composes(self, fused_calls):
        """Hard attention over a transformer function re-masks the graph;
        dropped edges take no attention, which the fused kernels (no mask)
        cannot express."""
        c = RhsCase("scaled_dot")
        keep = c.tg.mask.clone()
        nv = c.tg.num_valid
        r, col = c.tg.row[:nv], c.tg.col[:nv]
        drop = ((r == 0) & (col == 5)) | ((r == 5) & (col == 0))
        keep[:nv] &= ~drop
        # both packages sort the same edges into the same slots; the
        # port's graph only has more padding
        cap = c.jg.row.shape[0]
        for a in ("row", "col"):
            np.testing.assert_array_equal(
                np.asarray(getattr(c.jg, a))[:nv],
                getattr(c.tg, a).numpy()[:nv])
        jg = c.jg.with_edges(c.jg.row, c.jg.col, c.jg.weight,
                             jnp.asarray(keep.numpy()[:cap]))
        jrhs = jfunctions.make_rhs(c.jcfg.replace(stripe_fused=False), jg)
        want = jrhs(jax.tree.map(jnp.asarray, c.jp), c.jaux, 0.0,
                    jnp.asarray(c.o["x"]))
        with torch.no_grad():
            got = c.t_rhs(g=c.tg.with_mask(keep))(torch.tensor(c.o["x"]))
        assert fused_calls == []
        assert _rel(got, want) < 1e-5


# ---------------------------------------------------------------------------
# poison and re-solve
# ---------------------------------------------------------------------------

class TestPoison:
    """Q scaled by 400 drives the unshifted exp past float32: the fused
    column-normalised RHS poisons its output, ``block_forward`` re-solves
    on the exact composition, and the state equals the JAX package's solve
    (its float32 path is the exact composition) at 1e-4 of scale: four rk4
    steps in float32."""

    def _case(self):
        c = RhsCase("scaled_dot", method="rk4", step_size=0.25, time=1.0)
        c.jp["att"]["Q"]["w"] = c.o["qw"] * 400.0
        c.func.load_state_dict(params_from_jax(c.jp))
        return c

    def test_fast_path_poisons(self):
        c = self._case()
        x = torch.tensor(c.o["x"])
        with torch.no_grad():
            assert torch.isnan(c.t_rhs()(x)).all()
            assert torch.isfinite(c.t_rhs(exact_softmax=True)(x)).all()

    @pytest.mark.parametrize("training", [False, True])
    def test_block_forward_resolves(self, training, monkeypatch):
        c = self._case()
        calls = []
        real = tfunctions.make_rhs
        monkeypatch.setattr(
            tblocks, "make_rhs",
            lambda *a, **kw: calls.append(kw["exact_softmax"])
            or real(*a, **kw))
        block = tblocks.ODEBlock(c.tcfg, c.d)
        block.func.load_state_dict(c.func.state_dict())
        x = torch.tensor(c.o["x"], requires_grad=training)
        z, _ = tblocks.block_forward(block, c.tcfg, c.tg, x, training)
        assert calls == [False, True]
        zj, _, _ = jblocks.block_forward(
            {"func": jax.tree.map(jnp.asarray, c.jp)}, c.jcfg, c.jg,
            jnp.asarray(c.o["x"]), training)
        assert torch.isfinite(z).all() and _rel(z.detach(), zj) < 1e-4
        if training:
            torch.sum(z).backward()
            assert torch.isfinite(x.grad).all()

    def test_early_stop_eval_resolves(self, monkeypatch):
        """GNNEarly's evaluation solve re-solves too."""
        from graph_neural_pde_tpu_torch.models import gnn_early
        cfg = best_params["Cora"].replace(
            function="transformer", block="constant", square_plus=False,
            hidden_dim=8, attention_dim=8, heads=2)
        d = make_sbm_dataset(**SBM)
        m = GNNEarlyModel(cfg, 8, 3, d.graph)
        with torch.no_grad():
            m.block.func.att.Q.w.copy_(400.0 * torch.randn(
                m.block.func.att.Q.w.shape,
                generator=torch.Generator().manual_seed(0)))
            m.block.func.att.K.w.copy_(torch.randn(
                m.block.func.att.K.w.shape,
                generator=torch.Generator().manual_seed(1)))
        calls = []
        real = tfunctions.make_rhs
        monkeypatch.setattr(
            gnn_early, "make_rhs",
            lambda *a, **kw: calls.append(kw["exact_softmax"])
            or real(*a, **kw))
        zT, best, _ = m.apply_early(d.x, d.y, (d.train_mask, d.val_mask,
                                               d.test_mask))
        assert calls == [False, True] and torch.isfinite(zT).all()


def test_continuous_adjoint_differentiates_the_fused_op():
    """The continuous adjoint integrates a cotangent for every tensor of
    the function (the JAX package's leaf order) through the fused
    column-normalised RHS: its gradients equal the discrete adjoint's of
    the same rk4 solve up to the backward solve's discretisation error
    (step 0.125: 2e-3 of each leaf's scale; Q's bias shifts every score of
    a column alike, so its true gradient is 0 under the column softmax and
    it is held at 2e-3 of the largest leaf)."""
    grads = {}
    for adjoint in (False, True):
        c = RhsCase("scaled_dot", method="rk4", step_size=0.125, time=1.0,
                    adjoint=adjoint, adjoint_method="rk4",
                    adjoint_step_size=0.125)
        block = tblocks.ODEBlock(c.tcfg, c.d)
        block.func.load_state_dict(c.func.state_dict())
        x = torch.tensor(c.o["x"], requires_grad=True)
        z, stats = tblocks.block_forward(block, c.tcfg, c.tg, x, True)
        torch.sum(z * torch.tensor(c.o["ct"])).backward()
        assert ("bwd_nfe" in stats) == adjoint
        grads[adjoint] = {"x": x.grad, **{k: p.grad for k, p in
                                          block.func.named_parameters()}}
    top = max(float(v.abs().max()) for v in grads[False].values()
              if v is not None)
    for k in ("x", "alpha_train", "beta_train", "att.Q.w", "att.Q.b",
              "att.K.w", "att.K.b"):
        want, got = grads[False][k], grads[True][k]
        scale = max(float(want.abs().max()), 1e-3 * top)
        assert got is not None and float((got - want).abs().max()) \
            < 2e-3 * scale, k
    assert float(grads[True]["att.K.b"].abs().max()) > 1e-3 * top



# ---------------------------------------------------------------------------
# three epochs of the Cora row as GRAND-nl with its column normalisation
# ---------------------------------------------------------------------------

TOY = dict(hidden_dim=16, attention_dim=16, input_dropout=0.0, dropout=0.0,
           epoch=4)
TOY_DATA = dict(num_nodes=60, num_classes=3, num_features=10, seed=4,
                edge_pad_multiple=32, num_val=20)


def _toy_models(jcfg, tcfg, seed=7):
    """Both packages' GNNEarly over one SBM graph from one JAX init with
    random attention Q/K (the 1e-5 constant init gives uniform attention)."""
    jd, td = j_sbm(**TOY_DATA), make_sbm_dataset(**TOY_DATA)
    jm = JEarly(jcfg, 10, 3, jd.graph)
    params, state = jm.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 1)
    att = params["block"]["func"].get("att") or params["block"]["att"]
    for k in ("Q", "K"):
        att[k]["w"] = (0.3 * rng.normal(size=att[k]["w"].shape)) \
            .astype(np.float32)
    tm = GNNEarlyModel(tcfg, 10, 3, td.graph)
    tm.load_state_dict(params_from_jax(params,
                                       jax.tree.map(np.asarray, state)))
    return jd, td, jm, tm, params, state


def _jax_steps(jm, jcfg, params, state, jd, keys):
    """Three optimizer steps of the JAX Trainer, without the eval solves
    (its time is XLA compilation, and the eval step would be a second
    program): per step (loss, forward NFE, backward NFE)."""
    jp, jt = jax.tree.map(jnp.asarray, params), JTrainer(jm)
    opt_state, logs = jt.optimizer.init(jp), []
    for key in keys:
        jp, state, opt_state, loss, st = jt._train_step(
            jp, state, opt_state, jd.x, None, jd.y, jd.train_mask, key)
        bwd = (int(st["bwd_nfe"]) if jcfg.adjoint
               else int(st["accepted"]) * jt._bwd_evals_per_step)
        logs.append((float(loss), int(st["nfe"]), bwd))
    return logs


@pytest.fixture(scope="module")
def cora_norm1_epochs():
    """The tuned Cora row as GRAND-nl (transformer function, constant
    block, softmax) with ``attention_norm_idx`` left at its tuned 1, at
    width 16 with 4 heads: dopri5 with the discrete adjoint."""
    kw = dict(TOY, function="transformer", block="constant",
              square_plus=False, heads=4)
    jcfg, tcfg = j_best["Cora"].replace(**kw), best_params["Cora"].replace(**kw)
    assert tcfg.attention_norm_idx == 1 and tfunctions.norm1_fused_ok(tcfg)
    jd, td, jm, tm, params, state = _toy_models(jcfg, tcfg)
    jlogs = _jax_steps(jm, jcfg, params, state, jd,
                       [jax.random.PRNGKey(s) for s in range(3)])
    trainer, tlogs = Trainer(tm), []
    for _ in range(3):
        loss, st = trainer.train_step(td.x, td.y, td.train_mask)
        tlogs.append((loss, st["nfe"], st["bwd_nfe"]))
    return jlogs, tlogs, tm, params


class TestThreeEpochsNorm1:
    def test_losses(self, cora_norm1_epochs):
        """rtol 1e-4: three solves and adamax updates, each differing from
        the JAX package only in the order of float32 sums."""
        jlogs, tlogs, _, _ = cora_norm1_epochs
        assert len(tlogs) == len(jlogs) == 3
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-4)
        assert all(math.isfinite(l[0]) for l in tlogs)
        assert tlogs[0][0] != tlogs[-1][0]

    def test_nfe(self, cora_norm1_epochs):
        """Identical forward and backward NFE per epoch: the same
        accept/reject sequence in every solve."""
        jlogs, tlogs, _, _ = cora_norm1_epochs
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        assert all(fwd > 0 and bwd > 0 for _, fwd, bwd in tlogs)

    def test_attention_parameters_train(self, cora_norm1_epochs):
        _, _, tm, params = cora_norm1_epochs
        before = params["block"]["func"]["att"]["Q"]["w"]
        assert not np.allclose(tm.block.func.att.Q.w.detach().numpy(), before)


# ---------------------------------------------------------------------------
# part B: the tuned ogbn-arxiv row
# ---------------------------------------------------------------------------

def _write_ogb_tree(root, n=30, f=5, classes=4, seed=0):
    """A tiny dataset in OGB's raw layout: ogbn_arxiv/raw/*.csv.gz and the
    time split under split/time/."""
    rng = np.random.default_rng(seed)
    base = root / "ogbn-arxiv" / "ogbn_arxiv"
    (base / "raw").mkdir(parents=True)
    (base / "split" / "time").mkdir(parents=True)

    def dump(path, arr, fmt):
        with gzip.open(path, "wt") as fh:
            np.savetxt(fh, arr, delimiter=",", fmt=fmt)

    edges = rng.integers(0, n, size=(70, 2))        # directed, with repeats
    dump(base / "raw" / "edge.csv.gz", edges, "%d")
    dump(base / "raw" / "node-feat.csv.gz", rng.normal(size=(n, f)), "%.6f")
    dump(base / "raw" / "node-label.csv.gz",
         rng.integers(0, classes, size=(n, 1)), "%d")
    perm = rng.permutation(n)
    for part, idx in (("train", perm[:15]), ("valid", perm[15:22]),
                      ("test", perm[22:])):
        dump(base / "split" / "time" / f"{part}.csv.gz", idx[:, None], "%d")


def _same_dataset(td, jd):
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, m).numpy(),
                                      np.asarray(getattr(jd, m)))
    for a in ("row", "col", "mask"):
        np.testing.assert_array_equal(getattr(td.graph, a).numpy(),
                                      np.asarray(getattr(jd.graph, a)))
    assert (td.num_classes, td.num_features) == (jd.num_classes,
                                                 jd.num_features)


class TestArxivData:
    def test_loader_matches_jax(self, tmp_path):
        """The csv.gz parser, the time split and ``to_undirected`` give the
        JAX package's arrays exactly; ``not_lcc=False`` keeps the whole
        graph whatever ``use_lcc`` says."""
        _write_ogb_tree(tmp_path)
        got = tdatasets.load_ogbn_arxiv(str(tmp_path))
        want = jdatasets.load_ogbn_arxiv(str(tmp_path))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        cfg = best_params["ogbn-arxiv"].replace(edge_pad_multiple=16)
        jcfg = j_best["ogbn-arxiv"].replace(edge_pad_multiple=16)
        td = tdatasets.get_dataset(cfg, str(tmp_path), use_lcc=True,
                                   synthetic_fallback=False)
        jd = jdatasets.get_dataset(jcfg, str(tmp_path), use_lcc=True,
                                   synthetic_fallback=False)
        assert td.name == "ogbn-arxiv" and td.x.shape == (30, 5)
        assert int(td.train_mask.sum()) == 15
        _same_dataset(td, jd)

    def test_missing_files(self, tmp_path):
        with pytest.raises(tdatasets.DatasetUnavailable):
            tdatasets.load_ogbn_arxiv(str(tmp_path))
        with pytest.raises(tdatasets.DatasetUnavailable):
            tdatasets.get_dataset(best_params["ogbn-arxiv"], str(tmp_path),
                                  synthetic_fallback=False)

    def test_stand_in_is_bit_identical(self, tmp_path):
        """With no raw files both packages build the same SBM stand-in
        (20,000 nodes, 128 features, 40 classes) and the same seeded
        split."""
        cfg = best_params["ogbn-arxiv"]
        td = tdatasets.get_dataset(cfg, str(tmp_path), use_lcc=cfg.not_lcc)
        jd = jdatasets.get_dataset(j_best["ogbn-arxiv"], str(tmp_path),
                                   use_lcc=cfg.not_lcc)
        assert td.name == "ogbn-arxiv-synthetic"
        assert td.x.shape == (20000, 128) and td.num_classes == 40
        _same_dataset(td, jd)


def _arxiv_toy(**kw):
    kw = dict(TOY, **kw)
    return (j_best["ogbn-arxiv"].replace(**kw),
            best_params["ogbn-arxiv"].replace(**kw))


def test_label_block_forward_matches_jax():
    """``use_labels``: an eval forward of the arxiv row at width 16 from
    converted weights, the same label mask appended to the features in
    both packages: logits at 1e-5 of scale. The ODE state, m2 and the batch
    norm are ``hidden_dim + num_classes`` wide."""
    jcfg, tcfg = _arxiv_toy(use_labels=True)
    jd, td, jm, tm, params, state = _toy_models(jcfg, tcfg)
    assert jm.core_dim == tm.core_dim == 16 + 3
    assert tm.m2.w.shape[0] == 19 and tm.bn_in.scale.shape == (19,)
    mask = np.random.default_rng(3).random(60) < 0.5
    jt = JTrainer(jm)
    xt = ttrain.with_labels(td.x, td.y, torch.tensor(mask), 3)
    xj = jt._with_labels(jd.x, jd.y, jnp.asarray(mask, jnp.float32))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert xt.shape == (60, 13) and float(xt[:, 10:].sum()) == mask.sum()
    want, _, _, _ = jm.apply(jax.tree.map(jnp.asarray, params), state, xj,
                             training=False)
    with torch.no_grad():
        got, _ = tm(xt, training=False)
    assert _rel(got, want) < 1e-5


@pytest.fixture(scope="module", params=[False, True],
                ids=["as_tuned", "use_labels"])
def arxiv_epochs(request):
    """Three training steps of the tuned ogbn-arxiv row at width 16 (hard
    attention at att_samp_pct 0.81, batch norm, dopri5 with the rk4
    continuous adjoint, rmsprop), as tuned and with label diffusion. The
    label masks are the JAX Trainer's own draws, handed to the port."""
    use_labels = request.param
    jcfg, tcfg = _arxiv_toy(use_labels=use_labels)
    jd, td, jm, tm, params, state = _toy_models(jcfg, tcfg)
    keys = [jax.random.PRNGKey(s) for s in range(3)]
    jlogs = _jax_steps(jm, jcfg, params, state, jd, keys)
    trainer, tlogs = Trainer(tm), []
    for key in keys:
        label_mask = None
        if use_labels:      # the draw of JTrainer._train_step_impl
            _, k_lab = jax.random.split(key)
            coin = jax.random.uniform(k_lab, jd.train_mask.shape) \
                < jcfg.label_rate
            label_mask = torch.tensor(np.asarray(jd.train_mask & coin))
        loss, st = trainer.train_step(td.x, td.y, td.train_mask,
                                      label_mask=label_mask)
        tlogs.append((loss, st["nfe"], st["bwd_nfe"]))
    return jlogs, tlogs, trainer, td


class TestArxivRow:
    def test_losses(self, arxiv_epochs):
        """rtol 1e-4: three solves and rmsprop updates, each differing from
        the JAX package only in the order of float32 sums."""
        jlogs, tlogs, _, _ = arxiv_epochs
        assert len(tlogs) == len(jlogs) == 3
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-4)
        assert all(math.isfinite(l[0]) for l in tlogs)
        assert tlogs[0][0] != tlogs[-1][0]

    def test_nfe(self, arxiv_epochs):
        """Identical forward NFE and backward NFE (the rk4 adjoint's)."""
        jlogs, tlogs, _, _ = arxiv_epochs
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        assert all(fwd > 0 and bwd > 0 for _, fwd, bwd in tlogs)

    def test_eval_and_own_label_draw(self, arxiv_epochs):
        """The eval step (every training node shows its label) and a
        training step with the trainer's own label draw run and stay
        finite."""
        _, _, trainer, td = arxiv_epochs
        masks = (td.train_mask, td.val_mask, td.test_mask)
        accs, logits, _ = trainer.eval_step(td.x, td.y, masks)
        assert torch.isfinite(logits).all() and all(0 <= a <= 1 for a in accs)
        loss, _ = trainer.train_step(td.x, td.y, td.train_mask)
        assert math.isfinite(loss)


def test_label_draw_is_seeded_and_rated(monkeypatch):
    """The trainer draws the label mask from its own generator: two
    trainers of one seed draw the same masks, only training nodes carry a
    label, and about ``label_rate`` of them do."""
    _, tcfg = _arxiv_toy(use_labels=True, label_rate=0.25)
    td = make_sbm_dataset(num_nodes=400, num_classes=3, num_features=10,
                          seed=4, train_per_class=100)
    seen, real = [], ttrain.with_labels
    monkeypatch.setattr(ttrain, "with_labels", lambda x, y, m, c: (
        seen.append(m.clone()) or real(x, y, m, c)))
    for _ in range(2):
        tr = Trainer(GNNEarlyModel(tcfg, 10, 3, td.graph))
        tr.train_step(td.x, td.y, td.train_mask)
    assert torch.equal(seen[0], seen[1])
    assert not (seen[0] & ~td.train_mask).any()
    rate = float(seen[0].sum()) / float(td.train_mask.sum())
    assert 0.15 < rate < 0.35


def test_cli_runs_the_arxiv_row(tmp_path):
    """``--dataset ogbn-arxiv --use_best_params`` through ``run.main`` over
    the tiny raw tree: GNNEarly, two epochs, with and without labels."""
    from graph_neural_pde_tpu_torch import run
    _write_ogb_tree(tmp_path, n=60, f=6, classes=3)
    args = run.build_parser().parse_args(
        ["--dataset", "ogbn-arxiv", "--use_best_params", "--epoch", "3"])
    cfg = run.config_from_args(args)
    assert cfg == best_params["ogbn-arxiv"].replace(epoch=3)
    check_supported(cfg)
    for kw in (dict(), dict(use_labels=True)):
        small = cfg.replace(hidden_dim=8, attention_dim=8, **kw)
        res = run.main(small, data_dir=str(tmp_path), verbose=False,
                       device="cpu")
        assert len(res.logs) == 2
        assert all(math.isfinite(log.loss) for log in res.logs)
        assert 0.0 <= res.best["val_acc"] <= 1.0
