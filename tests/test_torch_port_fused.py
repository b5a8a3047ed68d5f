"""The PyTorch port's GRAND-nl slice against the JAX package: the plain
versions of the fused attention RHS kernels (K6 ``fused_rhs_fwd``, K7
``fused_rowmax``, K8 ``fused_rhs_bwd``, K9 ``fused_rhs_bwd_sym``) against
the Pallas kernels they replace (interpret mode on a small stripe plan) and
against ``jax.grad`` of the float32 XLA composition; the transformer RHS as
a whole; the poison-and-re-solve discipline; three training epochs of a
Cora-stand-in GRAND-nl config; and the parameter conversion.

On the CPU every wrapper runs its plain version, so what is held against
the JAX package here is exactly what the kernels are held against on the
card (``chip_smoke.py``). Inputs come from seeded numpy generators and go
through both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.models import functions as jfunctions
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config, best_params
from graph_neural_pde_tpu_torch.convert import params_from_jax, params_to_jax
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.gnn import check_supported
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.training.train import Trainer

SCORES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel")
N, D, ATT, H = 40, 12, 16, 4
SBM = dict(num_nodes=N, num_classes=3, num_features=6, seed=2,
           edge_pad_multiple=32, num_val=10)
NL = dict(function="transformer", block="constant", attention_norm_idx=0,
          square_plus=False, self_loop_weight=1.0, add_source=True,
          hidden_dim=D, attention_dim=ATT, heads=H)


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The tensors here are tiny, and the suite runs several workers at
    once: torch's intra-op thread pool only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    return JConfig(**NL).replace(**kw), Config(**NL).replace(**kw)


def _rel(got, want):
    """Largest error relative to the reference array's largest entry."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


class Case:
    """One graph and one set of inputs in both packages: the prepared SBM
    graph (symmetric, self loops), the JAX stripe plan over it (block_n 8,
    chunk 16, as the JAX package's own kernel tests) and seeded operands."""

    def __init__(self, score, seed=0):
        self.score = score
        self.jcfg, self.tcfg = _cfgs(attention_type=score)
        jcfg = self.jcfg.replace(stripe_fused=True, stripe_block_n=8,
                                 stripe_chunk=16)
        jg = jblocks.prepare_graph(jcfg, j_sbm(**SBM).graph)
        self.jg, self.plan = jblocks.build_stripe_engine(jcfg, jg)
        assert self.plan is not None and self.plan.symmetric
        assert self.jg.num_nodes == N
        self.tg = tblocks.prepare_graph(self.tcfg, make_sbm_dataset(**SBM).graph)
        rng = np.random.default_rng(seed)
        f32 = np.float32
        self.x = rng.normal(size=(N, D)).astype(f32)
        self.qw = (0.3 * rng.normal(size=(D, ATT))).astype(f32)
        self.kw = (0.3 * rng.normal(size=(D, ATT))).astype(f32)
        self.qb = (0.1 * rng.normal(size=ATT)).astype(f32)
        self.kb = (0.1 * rng.normal(size=ATT)).astype(f32)
        self.ct = rng.normal(size=(N, D)).astype(f32)
        self.var, self.ls = np.array([1.3], f32), np.array([0.8], f32)
        self.gmax = np.array([0.25], f32)

    # -- JAX side ----------------------------------------------------------
    def j_sp(self):
        if self.score != "exp_kernel":
            return ()
        return (jnp.asarray(self.var).reshape(()),
                jnp.asarray(self.ls).reshape(()))

    def j_ops(self):
        return tuple(jnp.asarray(a) for a in (self.qw, self.qb, self.kw,
                                              self.kb, self.x))

    # -- port side ---------------------------------------------------------
    def t_sp(self, grad=False):
        if self.score != "exp_kernel":
            return ()
        return tuple(torch.tensor(a, requires_grad=grad)
                     for a in (self.var, self.ls))

    def t_ops(self, grad=False):
        return tuple(torch.tensor(a, requires_grad=grad)
                     for a in (self.qw, self.qb, self.kw, self.kb, self.x))

    def t_csr(self):
        return self.tg.rowptr, self.tg.row, self.tg.col


@pytest.fixture(scope="module", params=SCORES)
def case(request):
    return Case(request.param)


class TestPlainAgainstPallas:
    """The plain versions against the Pallas kernels in interpret mode.
    float32 where the call takes ``dtype`` (1e-4 of the array's scale: only
    the order of the sums differs); the custom-VJP ops round their MXU
    operands to bf16, so their gradients are held at 5e-2 of the largest
    gradient entry, as the JAX package's own tests hold them (1e-1 for
    pearson); the float32 check of the same gradients is TestRhsAgainstXla."""

    def _j_forward(self, c, **kw):
        qw, qb, kw_, kb, x = c.j_ops()
        return jfused._fused_ax_call(
            c.plan, qw, qb, kw_, kb, x, x[c.jg.col], jnp.asarray(c.gmax[0]),
            heads=H, square_plus=False, dtype=jnp.float32, interpret=True,
            score=c.score, score_params=c.j_sp(), **kw)

    def _t_forward(self, c, **kw):
        qw, qb, kw_, kb, x = c.t_ops()
        sp = c.t_sp()
        return kernels.fused_rhs_fwd(
            *c.t_csr(), x, qw, qb, kw_, kb, torch.tensor(c.gmax), heads=H,
            score=c.score, var=sp[0] if sp else None,
            ls=sp[1] if sp else None, **kw)

    def test_forward(self, case):
        jax_ax, jax_den, jax_num = self._j_forward(case, want_num=True)
        ax, den, num = self._t_forward(case, want_num=True)
        assert _rel(ax, jax_ax) < 1e-4
        assert _rel(den, jax_den[:, :H]) < 1e-4
        # the Pallas kernel flushes its numerators in bf16
        assert _rel(num, jax_num.astype(jnp.float32)) < 1e-2

    def test_forward_folded(self, case):
        """f = alpha (ax - x) with the per-row guard, no row poisoned."""
        alpha = np.array([0.37], np.float32)
        f_jax, _ = self._j_forward(case, fold=jnp.asarray(alpha[0]))
        f, _, _ = self._t_forward(case, alpha=torch.tensor(alpha))
        assert np.isfinite(np.asarray(f_jax)).all()
        assert _rel(f, f_jax) < 1e-4

    def test_rowmax_and_shifted_forward(self):
        """K7 against fused_rowmax, and K6 with those per-edge shifts
        against the Pallas kernel with its per-head shift arrays."""
        c = Case("scaled_dot", seed=3)
        qw, qb, kw_, kb, x = c.j_ops()
        smax_j = jfused.fused_rowmax(c.plan, x @ qw + qb, kw_, kb, heads=H,
                                     x_g=x[c.jg.col], dtype=jnp.float32,
                                     interpret=True)
        smax = kernels.fused_rowmax(*c.t_csr(), *[c.t_ops()[i] for i in
                                                  (4, 0, 1, 2, 3)], heads=H)
        assert _rel(smax, smax_j[:, :H]) < 1e-5
        shifts_j = tuple(smax_j[:, h][c.jg.row] for h in range(H))
        ax_j, den_j = self._j_forward(c, shifts=shifts_j)
        ax, den, _ = self._t_forward(c, shifts=smax[c.tg.row.long()])
        assert _rel(ax, ax_j) < 1e-4 and _rel(den, den_j[:, :H]) < 1e-4

    @pytest.mark.parametrize("engine", ["sym", "general"])
    def test_backward(self, case, engine):
        """K9 (make_fused_ax_sym) and K8 (fused_rhs_ax): the gradient of
        sum(ax * ct) with respect to Q, K, x, gmax and the exp_kernel
        scalars, against the Pallas custom VJPs."""
        c = case
        gmax_j = jnp.asarray(c.gmax[0])
        if engine == "sym":
            op = jfused.make_fused_ax_sym(c.plan, H, False, c.score,
                                          c.jg.col, None)

            def jloss(qw, qb, kw_, kb, x, gmax, sp):
                return jnp.sum(op(qw, qb, kw_, kb, x, gmax, sp)[0] * c.ct)
        else:
            def jloss(qw, qb, kw_, kb, x, gmax, sp):
                ax, _ = jfused.fused_rhs_ax(c.plan, H, False, c.score, qw, qb,
                                            kw_, kb, x, x[c.jg.col], gmax,
                                            None, sp)
                return jnp.sum(ax * c.ct)
        want = jax.grad(jloss, argnums=tuple(range(7)))(*c.j_ops(), gmax_j,
                                                        c.j_sp())
        want = list(want[:6]) + list(want[6])

        ops, sp = c.t_ops(grad=True), c.t_sp(grad=True)
        gmax = torch.tensor(c.gmax, requires_grad=True)
        if engine == "sym":
            ax, _ = kernels.make_fused_ax_sym(c.tg, H, False, c.score)(
                *ops, gmax, sp)
        else:
            ax, _ = kernels.fused_rhs_ax(c.tg, H, False, c.score, *ops, gmax,
                                         None, sp)
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(c.ct)),
                                  [*ops, gmax, *sp])
        scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
        # pearson: the Pallas kernel's one-pass variance (ss - d_k m^2)
        # cancels in bf16, so its gradients are twice as noisy
        bound = 1e-1 if c.score == "pearson" else 5e-2
        assert len(got) == len(want)
        for g, w in zip(got, want):
            err = np.abs(g.numpy().reshape(-1) - np.asarray(w).reshape(-1))
            assert err.max() / scale < bound


def _jax_func_params(c, alpha=0.3, beta=0.2):
    p = jfunctions.init_func_params(jax.random.PRNGKey(0), c.jcfg, D)
    p = jax.tree.map(np.asarray, p)
    p["alpha_train"] = np.float32(alpha)
    p["beta_train"] = np.float32(beta)
    p["att"]["Q"] = {"w": c.qw, "b": c.qb}
    p["att"]["K"] = {"w": c.kw, "b": c.kb}
    if c.score == "exp_kernel":
        p["att"]["output_var"], p["att"]["lengthscale"] = c.var, c.ls
    return p


def _port_func(c, jparams):
    func = tfunctions.ODEFunc(c.tcfg, D)
    func.load_state_dict(params_from_jax(jparams))
    return func


class TestRhsAgainstXla:
    """make_rhs in both packages from converted weights: the port's fused
    RHS against the JAX package's float32 XLA composition (its CPU path:
    global-max shift and a ones-column segment sum). Values at rtol 1e-5 of
    scale, gradients at 1e-4 of each leaf's scale (K.b's true gradient is
    0 under the row softmax: held at 1e-4 of the largest leaf)."""

    def _both(self, c, **kw):
        jp = _jax_func_params(c)
        func = _port_func(c, jp)
        jaux = jfunctions.FuncAux(None, jnp.asarray(c.ct),
                                  c.jg.weight)
        taux = tfunctions.FuncAux(None, torch.tensor(c.ct), c.tg.weight)
        jrhs = jfunctions.make_rhs(c.jcfg, c.jg, **kw)
        trhs = tfunctions.make_rhs(c.tcfg, c.tg, **kw)
        return jp, func, jaux, taux, jrhs, trhs

    def test_value(self, case):
        jp, func, jaux, taux, jrhs, trhs = self._both(case)
        want = jrhs(jax.tree.map(jnp.asarray, jp), jaux, 0.0,
                    jnp.asarray(case.x))
        with torch.no_grad():
            got = trhs(func, taux, 0.0, torch.tensor(case.x))
            folded = tfunctions.make_rhs(case.tcfg, case.tg, eval_fold=True)(
                func, taux, 0.0, torch.tensor(case.x))
        assert _rel(got, want) < 1e-5
        assert _rel(folded, want) < 1e-5

    def test_gradients(self, case):
        c = case
        jp, func, jaux, taux, jrhs, trhs = self._both(c)
        w = jnp.asarray(np.random.default_rng(9).normal(
            size=(N, D)).astype(np.float32))

        def jloss(p, x):
            return jnp.sum(jrhs(p, jaux, 0.0, x) * w)

        gp, gx = jax.grad(jloss, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(c.x))
        x = torch.tensor(c.x, requires_grad=True)
        loss = torch.sum(trhs(func, taux, 0.0, x) * torch.tensor(np.asarray(w)))
        loss.backward()
        want = params_from_jax(jax.tree.map(np.asarray, gp))
        got = {k: p.grad for k, p in func.named_parameters()}
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

    def test_folded_rhs_differentiates(self):
        """A gradient through the eval-mode (folded) RHS is the training
        path's, not silently absent."""
        c = Case("scaled_dot", seed=6)
        jp, func, jaux, taux, _, trhs = self._both(c)
        fold = tfunctions.make_rhs(c.tcfg, c.tg, eval_fold=True)
        grads = []
        for rhs in (trhs, fold):
            x = torch.tensor(c.x, requires_grad=True)
            func.zero_grad()
            torch.sum(rhs(func, taux, 0.0, x) ** 2).backward()
            grads.append((x.grad, func.att.Q.w.grad.clone()))
        # the folded op differentiates through the general backward (K8),
        # the training path through the symmetric one (K9): 1e-5 of scale
        for a, b in zip(*grads):
            assert b.abs().max() > 0 and _rel(b, a) < 1e-5

    def test_exact_softmax_value(self, case):
        """The exact mode (K7 shifts for scaled_dot, the composition for
        the bounded families) equals the fast path where nothing
        overflows."""
        jp, func, jaux, taux, jrhs, _ = self._both(case, exact_softmax=True)
        want = jrhs(jax.tree.map(jnp.asarray, jp), jaux, 0.0,
                    jnp.asarray(case.x))
        trhs = tfunctions.make_rhs(case.tcfg, case.tg, exact_softmax=True)
        x = torch.tensor(case.x, requires_grad=True)
        got = trhs(func, taux, 0.0, x)
        assert _rel(got.detach(), want) < 1e-5
        torch.sum(got).backward()       # K8 (or K3/K4) differentiates it
        assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0

    def test_composition_paths(self):
        """Column normalisation without the fused engine (its fused form:
        test_torch_port_norm1.py), and fused_attention_agg=False with
        squareplus, compose attention (K3/K4) and SpMM (K1/K2)."""
        for kw in (dict(fused_attention_agg=False, attention_norm_idx=1),
                   dict(fused_attention_agg=False, square_plus=True)):
            c = Case("scaled_dot", seed=5)
            c.jcfg, c.tcfg = _cfgs(**kw)
            jp, func, jaux, taux, jrhs, trhs = self._both(c)
            want = jrhs(jax.tree.map(jnp.asarray, jp), jaux, 0.0,
                        jnp.asarray(c.x))
            with torch.no_grad():
                got = trhs(func, taux, 0.0, torch.tensor(c.x))
            assert _rel(got, want) < 1e-5


class TestPoison:
    """Scores far outside float32's exp range: both packages' fast paths
    poison, both block_forwards re-solve with the exact softmax, and the
    results agree (rtol 1e-4 of scale: two euler steps in float32)."""

    def _setup(self):
        c = Case("scaled_dot", seed=7)
        c.qw = c.qw * 400.0
        c.jcfg, c.tcfg = _cfgs(method="euler", step_size=0.5, time=1.0)
        jp = _jax_func_params(c)
        return c, jp, _port_func(c, jp)

    def test_fast_path_poisons_and_exact_recovers(self):
        c, jp, func = self._setup()
        assert tfunctions.rhs_may_poison(c.tcfg)
        assert jfunctions.rhs_may_poison(c.jcfg)
        taux = tfunctions.FuncAux(None, torch.tensor(c.x), c.tg.weight)
        x = torch.tensor(c.x)
        with torch.no_grad():
            fast = tfunctions.make_rhs(c.tcfg, c.tg)(func, taux, 0.0, x)
            fold = tfunctions.make_rhs(c.tcfg, c.tg, eval_fold=True)(
                func, taux, 0.0, x)
            exact = tfunctions.make_rhs(c.tcfg, c.tg, exact_softmax=True)(
                func, taux, 0.0, x)
        assert torch.isnan(fast).all()          # the global guard
        assert torch.isnan(fold).any()          # the per-row guard
        jaux = jfunctions.FuncAux(None, jnp.asarray(c.x), c.jg.weight)
        jpj = jax.tree.map(jnp.asarray, jp)
        assert np.isnan(np.asarray(jfunctions.make_rhs(c.jcfg, c.jg)(
            jpj, jaux, 0.0, jnp.asarray(c.x)))).all()
        want = jfunctions.make_rhs(c.jcfg, c.jg, exact_softmax=True)(
            jpj, jaux, 0.0, jnp.asarray(c.x))
        assert torch.isfinite(exact).all() and _rel(exact, want) < 1e-4

    @pytest.mark.parametrize("training", [False, True])
    def test_block_forward_resolves(self, training, monkeypatch):
        c, jp, func = self._setup()
        calls = []
        real = tfunctions.make_rhs
        monkeypatch.setattr(
            tblocks, "make_rhs",
            lambda *a, **kw: calls.append(kw["exact_softmax"]) or real(*a, **kw))
        block = tblocks.ODEBlock(c.tcfg, D)
        block.func.load_state_dict(func.state_dict())
        x = torch.tensor(c.x, requires_grad=training)
        z, stats = tblocks.block_forward(block, c.tcfg, c.tg, x, training)
        assert calls == [False, True]
        zj, _, _ = jblocks.block_forward(
            {"func": jax.tree.map(jnp.asarray, jp)}, c.jcfg, c.jg,
            jnp.asarray(c.x), training)
        assert torch.isfinite(z).all() and _rel(z.detach(), zj) < 1e-4
        if training:
            torch.sum(z).backward()
            assert torch.isfinite(x.grad).all()


CORA_NL = dict(function="transformer", block="constant", attention_norm_idx=0,
               square_plus=False, hidden_dim=16, attention_dim=16, heads=4,
               input_dropout=0.0, dropout=0.0, epoch=4)
SLICE = {"dopri5": dict(adjoint=False),
         "rk4": dict(adjoint=False, method="rk4", step_size=1.0, time=4.0),
         "adjoint": dict(adjoint=True, adjoint_method="dopri5", time=4.0)}


@pytest.fixture(scope="module", params=sorted(SLICE))
def three_epochs(request):
    """Three epochs (training steps) of each package's Trainer on the
    Cora-stand-in GRAND-nl config at reduced width, from one converted
    init, dropout off: per epoch (loss, forward NFE, backward NFE)."""
    kw = dict(CORA_NL, **SLICE[request.param])
    jcfg, tcfg = j_best["Cora"].replace(**kw), best_params["Cora"].replace(**kw)
    data = dict(num_nodes=60, num_classes=3, num_features=10, seed=4,
                edge_pad_multiple=32, num_val=20)
    jd, td = j_sbm(**data), make_sbm_dataset(**data)
    jm = JEarly(jcfg, 10, 3, jd.graph)
    params, state = jm.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(8)
    params = jax.tree.map(np.asarray, params)
    for k in ("Q", "K"):    # off the 1e-5 constant init: nonuniform attention
        w = params["block"]["func"]["att"][k]["w"]
        params["block"]["func"]["att"][k]["w"] = \
            (0.3 * rng.normal(size=w.shape)).astype(np.float32)
    tm = GNNEarlyModel(tcfg, 10, 3, td.graph)
    tm.load_state_dict(params_from_jax(params))
    # three optimizer steps each, without the eval solves (the JAX side's
    # time is XLA compilation, and the eval step would be a second program)
    jp, jt = jax.tree.map(jnp.asarray, params), JTrainer(jm)
    opt_state, jlogs = jt.optimizer.init(jp), []
    for step in range(3):
        jp, state, opt_state, loss, st = jt._train_step(
            jp, state, opt_state, jd.x, None, jd.y, jd.train_mask,
            jax.random.PRNGKey(step))
        bwd = (int(st["bwd_nfe"]) if jcfg.adjoint
               else int(st["accepted"]) * jt._bwd_evals_per_step)
        jlogs.append((float(loss), int(st["nfe"]), bwd))
    trainer, tlogs = Trainer(tm), []
    x, y, mask = td.x, td.y, td.train_mask
    for _ in range(3):
        loss, st = trainer.train_step(x, y, mask)
        tlogs.append((loss, st["nfe"], st["bwd_nfe"]))
    return jlogs, tlogs, tm, params


class TestThreeEpochs:
    def test_losses(self, three_epochs):
        """rtol 1e-4: three solves and adamax updates, each differing from
        the JAX package only in the order of float32 sums."""
        jlogs, tlogs, _, _ = three_epochs
        assert len(tlogs) == len(jlogs) == 3
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-4)
        assert all(math.isfinite(l[0]) for l in tlogs)
        assert tlogs[0][0] != tlogs[-1][0]

    def test_nfe(self, three_epochs):
        """Identical forward and backward NFE per epoch: the same
        accept/reject sequence in every solve."""
        jlogs, tlogs, _, _ = three_epochs
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        assert all(fwd > 0 and bwd > 0 for _, fwd, bwd in tlogs)

    def test_attention_parameters_train(self, three_epochs):
        _, _, tm, params = three_epochs
        before = params["block"]["func"]["att"]["Q"]["w"]
        assert not np.allclose(tm.block.func.att.Q.w.detach().numpy(), before)


@pytest.mark.parametrize("score", ["scaled_dot", "exp_kernel"])
def test_params_round_trip(score):
    """params_from_jax / params_to_jax carry the transformer function's
    attention parameters (and exp_kernel's scalars) both ways."""
    jcfg, tcfg = _cfgs(attention_type=score)
    jd = j_sbm(**SBM)
    params, _ = JEarly(jcfg, 6, 3, jd.graph).init(jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, params)
    tm = GNNEarlyModel(tcfg, 6, 3, make_sbm_dataset(**SBM).graph)
    sd = params_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert "block.func.att.Q.w" in sd
    assert ("block.func.att.output_var" in sd) == (score == "exp_kernel")
    tm.load_state_dict(sd)
    back = params_to_jax(tm.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


class TestWrappers:
    def test_cpu_runs_plain_versions_without_launching(self):
        c = Case("scaled_dot")
        before = [k.launches for k in kernels.KERNELS]
        ops = c.t_ops(grad=True)
        ax, den = kernels.make_fused_ax_sym(c.tg, H, False, c.score)(
            *ops, torch.zeros(1), ())
        torch.sum(ax).backward()
        kernels.fused_rowmax(*c.t_csr(), ops[4].detach(), *[o.detach() for o
                                                            in ops[:4]],
                             heads=H)
        assert [k.launches for k in kernels.KERNELS] == before
        assert len(kernels.KERNELS) == 21

    @pytest.mark.parametrize("bad", ["dtype", "shape", "heads", "score",
                                     "beltrami", "meta"])
    def test_fused_rhs_fwd_rejects(self, bad):
        c = Case("scaled_dot")
        qw, qb, kw_, kb, x = c.t_ops()
        heads, score, err = H, "scaled_dot", (TypeError, ValueError)
        rowptr, row, col = c.t_csr()
        var = ls = None
        if bad == "dtype":
            x = x.double()
        elif bad == "shape":
            kw_ = kw_[:, :-1].contiguous()
        elif bad == "heads":
            heads = 3
        elif bad == "score":
            score = "dot"
        elif bad == "beltrami":
            # the split-space score takes two elements of var and ls
            score, err = "exp_kernel_beltrami", ValueError
            var = ls = torch.ones(1)
        else:
            err = NotImplementedError
            rowptr, row, col, qw, qb, kw_, kb, x = (
                t.to("meta") for t in (rowptr, row, col, qw, qb, kw_, kb, x))
        gmax = torch.zeros(1, device=x.device)
        with pytest.raises(err):
            kernels.fused_rhs_fwd(rowptr, row, col, x, qw, qb, kw_, kb, gmax,
                                  heads=heads, score=score, var=var, ls=ls)

    def test_directed_graph_raises(self):
        """K9 reaches x's gradient through reverse edges: on a non-symmetric
        edge multiset its op refuses, and the column-plan op (K8 and K17
        over the CSC view) takes the graph."""
        from graph_neural_pde_tpu_torch.ops.graph import make_graph
        g = make_graph([0, 1, 2], [1, 2, 0], num_nodes=3).sort_by_row()
        assert g.rev is None
        with pytest.raises(ValueError, match="make_fused_ax_colplan"):
            kernels.make_fused_ax_sym(g, 1, False, "scaled_dot")
        x = torch.randn(3, 2, requires_grad=True)
        w = [torch.randn(2, 2, requires_grad=True) for _ in range(2)]
        ax, _ = kernels.make_fused_ax_colplan(g, 1, False, "scaled_dot")(
            w[0], torch.zeros(2), w[1], torch.zeros(2), x, torch.zeros(1))
        torch.sum(ax ** 2).backward()
        assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0

    @pytest.mark.parametrize("override", [
        dict(optimizer="adagrad"), dict(mesh_devices=2),
        dict(fa_layer=True), dict(edge_sampling=True),
        dict(rewire_KNN=True), dict(use_mlp=True)])
    def test_unported_variants_raise(self, override):
        _, tcfg = _cfgs(**override)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_supported(tcfg)

    def test_supported_variants(self):
        for kw in (dict(), dict(attention_norm_idx=1, square_plus=True),
                   dict(fused_attention_agg=False, reweight_attention=True),
                   dict(attention_type="pearson"), dict(block="attention"),
                   dict(function="GAT"), dict(mix_features=True),
                   dict(square_plus=True), dict(reweight_attention=True),
                   dict(block="hard_attention"),
                   dict(dtype="bfloat16", square_plus=True)):
            check_supported(_cfgs(**kw)[1])
