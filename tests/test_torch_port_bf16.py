"""The PyTorch port's bfloat16 payload and fixed-grid state against the JAX
package: the plain versions of K1 ``csr_spmm`` and K2 ``edge_dot`` on a
bfloat16 table and ``make_spmm`` with its payload; ``make_fused_ax_sym``
(K6 + K9) and ``fused_rhs_f`` (K6 folded) with the bfloat16 column table;
three training steps of ``config.GRAND_NL_BENCH`` at a small width, with
the payload alone and with the bf16 rk4 state; that every route takes the
mode; and what the kernels refuse.

References, each at its stated tolerance of the reference array's scale:

* the JAX package's float32 XLA path with the same casts (1e-5): for the
  SpMM a jnp composition of its ``_gather`` (``ops/spmm.py:102-106``:
  ``x.astype(bf16)[col]``, then a float32 segment sum); for the attention
  RHS the package's own ``make_rhs`` (values) and a jnp composition of its
  ``_scores`` and ``_fused_normalized_aggregate`` in which every cast is
  the identity in the gradient, as the kernels' backward takes it
  (gradients; the XLA path's own autodiff accumulates cotangents in
  bfloat16);
* the Pallas interpret path (``stripe_fused=True``, 3e-2): it also rounds
  its one-hot operands, the packed cotangents and the numerators to bf16.

On the CPU every wrapper runs its plain version, which ``chip_smoke.py``
holds the kernels to on the card. Inputs come from seeded numpy
generators and go through both packages.
"""

import dataclasses

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
from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu.ops.spmm import make_stripe_spmm, spmm_coo
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import (FLOAT32, GRAND_NL_BENCH,
                                               Config)
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.data.synthetic import (
    make_random_graph_dataset, make_sbm_dataset)
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.gnn import GNNModel, check_supported
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
from graph_neural_pde_tpu_torch.training.train import Trainer

N, D, ATT, H = 320, 16, 16, 2
SBM = dict(num_nodes=N, num_classes=4, num_features=6, seed=5,
           edge_pad_multiple=64, num_val=40)
NL = dict(function="transformer", block="constant", attention_norm_idx=0,
          square_plus=False, self_loop_weight=1.0, add_source=True,
          hidden_dim=D, attention_dim=ATT, heads=H,
          rhs_payload_dtype="bfloat16")
BF16 = jnp.bfloat16


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
    """The prepared SBM graph (symmetric, self loops) in both packages, and
    the JAX stripe plan over it (the Pallas interpret path)."""

    def __init__(self, **cfg):
        self.jcfg = JConfig(**NL).replace(**cfg)
        self.tcfg = Config(**NL).replace(**cfg)
        jg = jblocks.prepare_graph(self.jcfg, j_sbm(**SBM).graph)
        self.jg = jg
        self.tg = tblocks.prepare_graph(self.tcfg,
                                        make_sbm_dataset(**SBM).graph)
        assert self.tg.rev is not None and jg.num_nodes == N
        np.testing.assert_array_equal(self.tg.col.numpy(), np.asarray(jg.col))
        pcfg = self.jcfg.replace(stripe_fused=True, stripe_block_n=32,
                                 stripe_chunk=64)
        self.pg, self.plan = jblocks.build_stripe_engine(pcfg, jg)
        assert self.plan is not None and self.plan.symmetric
        valid = np.where(self.tg.mask.numpy())[0]
        self.valid = valid
        self.slots = np.asarray(self.plan.slot_of_edge)[valid]
        self.nv = self.tg.num_valid
        self.row = self.tg.row.numpy()[:self.nv].astype(np.int64)
        self.col = self.tg.col.numpy()[:self.nv].astype(np.int64)

    def to_slots(self, per_edge):
        """A per-edge array of the port's graph in the plan's slot order."""
        out = np.zeros((self.plan.capacity,) + per_edge.shape[1:],
                       per_edge.dtype)
        out[self.slots] = per_edge[self.valid]
        return out


@pytest.fixture(scope="module")
def graphs():
    return Graphs()


# ---------------------------------------------------------------------------
# K1, K2 and make_spmm
# ---------------------------------------------------------------------------

class TestSpmm:
    """K1 / K2 on a bfloat16 table and ``make_spmm(g, bfloat16)``: values,
    dx (the transpose matvec on ct cast to bfloat16) and dw (the float32
    ct[row] dotted with the bf16 x[col])."""

    @staticmethod
    def _inputs(g, seed=0, d=32):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(N, d)).astype(np.float32)
        w = rng.random(g.tg.capacity).astype(np.float32)
        w[~g.tg.mask.numpy()] = 0.0
        ct = rng.normal(size=(N, d)).astype(np.float32)
        return x, w, ct

    @staticmethod
    def _j_gather_composition(g, x, w, ct):
        """The JAX package's _make_stripe_spmm_sym with its gathers
        ``x.astype(bf16)[col]`` and ``ct.astype(bf16)[col]`` and float32
        sums in place of the stripe kernels: (out, dx, dw)."""
        jg = g.jg
        xb = jnp.asarray(x).astype(BF16)
        out = spmm_coo(jg.row, jg.col, jnp.asarray(w), xb.astype(jnp.float32),
                       N, jg.mask, rows_sorted=True)
        ctb = jnp.asarray(ct).astype(BF16).astype(jnp.float32)
        # dx[n] = sum_{e: col[e]=n} w[e] ct_b[row[e]]: the transpose matvec
        dx = jax.ops.segment_sum(jnp.where(jg.mask, jnp.asarray(w), 0.0)[:, None]
                                 * ctb[jg.row], jg.col, num_segments=N)
        dw = jnp.sum(jnp.asarray(ct)[jg.row] * xb[jg.col].astype(jnp.float32),
                     axis=1) * jg.mask
        return out, dx, dw

    def test_kernels_match_gather_composition(self, graphs):
        g = graphs
        x, w, ct = self._inputs(g)
        want_out, want_dx, want_dw = self._j_gather_composition(g, x, w, ct)
        tg = g.tg
        xb, ctb = (torch.tensor(a).to(torch.bfloat16) for a in (x, ct))
        out = kernels.csr_spmm(tg.rowptr, tg.row, tg.col, torch.tensor(w), xb)
        w_rev = torch.tensor(w)[tg.rev.long()]
        dx = kernels.csr_spmm(tg.rowptr, tg.row, tg.col, w_rev, ctb)
        dw = kernels.edge_dot(tg.row, tg.col, torch.tensor(ct), xb, tg.num_valid)
        assert out.dtype == dx.dtype == dw.dtype == torch.float32
        assert _rel(out, want_out) < 1e-5
        assert _rel(dx, want_dx) < 1e-5
        assert _rel(dw, want_dw) < 1e-5

    def test_make_spmm_matches_gather_composition(self, graphs):
        g = graphs
        x, w, ct = self._inputs(g, seed=1)
        want_out, want_dx, want_dw = self._j_gather_composition(g, x, w, ct)
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        out = make_spmm(g.tg, torch.bfloat16)(xt, wt)
        out.backward(torch.tensor(ct))
        assert _rel(out.detach(), want_out) < 1e-5
        assert _rel(xt.grad, want_dx) < 1e-5
        assert _rel(wt.grad, want_dw) < 1e-5
        # a bf16 state: dx comes back in its dtype
        xs = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
        out_s = make_spmm(g.tg, torch.bfloat16)(xs, torch.tensor(w))
        out_s.backward(torch.tensor(ct))
        assert xs.grad.dtype == torch.bfloat16
        assert _rel(out_s.detach(), want_out) < 1e-5

    def test_make_spmm_matches_pallas_interpret(self, graphs):
        """Against ``make_stripe_spmm(g, plan, bfloat16)`` in interpret
        mode (its one-hot and payload rounded to bf16 too): 3e-2."""
        g = graphs
        x, w, ct = self._inputs(g, seed=2)
        f = make_stripe_spmm(g.pg, g.plan, BF16)

        def loss(x_, w_):
            return jnp.sum(f(x_, w_) * ct)

        want = np.asarray(f(jnp.asarray(x), jnp.asarray(g.to_slots(w))))
        rx, rw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(g.to_slots(w)))
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        out = make_spmm(g.tg, torch.bfloat16)(xt, wt)
        torch.sum(out * torch.tensor(ct)).backward()
        assert _rel(out.detach(), want) < 3e-2
        assert _rel(xt.grad, rx) < 3e-2
        assert _rel(wt.grad[g.valid], np.asarray(rw)[g.slots]) < 3e-2

    def test_other_table_dtypes_raise(self, graphs):
        tg = graphs.tg
        x16 = torch.zeros(N, 4, dtype=torch.float16)
        w = torch.zeros(tg.capacity)
        with pytest.raises(TypeError):
            kernels.csr_spmm(tg.rowptr, tg.row, tg.col, w, x16)
        with pytest.raises(TypeError):
            kernels.edge_dot(tg.row, tg.col, torch.zeros(N, 4), x16,
                             tg.num_valid)
        with pytest.raises(TypeError):
            make_spmm(tg, torch.float16)(torch.zeros(N, 4), w)


# ---------------------------------------------------------------------------
# K6 + K9: make_fused_ax_sym and fused_rhs_f
# ---------------------------------------------------------------------------

SCORES = ("scaled_dot", "exp_kernel")


class Fused:
    """Seeded operands of the attention RHS for one score family."""

    def __init__(self, g, score, seed=0):
        self.g, self.score = g, score
        rng = np.random.default_rng(seed)
        f32 = np.float32
        self.x = rng.normal(size=(N, D)).astype(f32)
        self.qw = (0.3 * rng.normal(size=(D, ATT))).astype(f32)
        self.kw = (0.3 * rng.normal(size=(D, ATT))).astype(f32)
        self.qb = (0.1 * rng.normal(size=ATT)).astype(f32)
        self.kb = (0.1 * rng.normal(size=ATT)).astype(f32)
        self.probe = rng.normal(size=(N, D)).astype(f32)
        self.var, self.ls = np.array([1.3], f32), np.array([0.8], f32)

    def t_ops(self, grad=False):
        return [torch.tensor(a, requires_grad=grad)
                for a in (self.qw, self.qb, self.kw, self.kb, self.x)]

    def t_sp(self, grad=False):
        if self.score != "exp_kernel":
            return ()
        return tuple(torch.tensor(a, requires_grad=grad)
                     for a in (self.var, self.ls))

    def j_sp(self):
        if self.score != "exp_kernel":
            return ()
        return (jnp.asarray(self.var).reshape(()),
                jnp.asarray(self.ls).reshape(()))

    def k_exact(self, x):
        """The k table's value: bf16(bf16(x_b Kw_b) + kb_b), the product
        summed in float64 (what the JAX package's bf16 dot rounds)."""
        prod = (_round(x).astype(np.float64)
                @ _round(self.kw).astype(np.float64)).astype(np.float32)
        return _round(_round(prod) + _round(self.kb))

    def j_composition(self, qw, qb, kw, kb, x, sp, k_val):
        """(ax, den) of the row softmax with the bf16 column table, from
        the JAX package's ``_scores`` and ``_fused_normalized_aggregate``;
        each cast is the identity in the gradient and the k table takes
        the value ``k_val``."""
        g, cfg = self.g, self.g.jcfg.replace(attention_type=self.score)
        jg = g.jg
        xb = _st(x)
        lin = xb @ _st(kw) + _st(kb)
        k = lin + jax.lax.stop_gradient(k_val - lin)
        q = x @ qw + qb
        d_k = ATT // H
        ap = {} if not sp else {"output_var": sp[0], "lengthscale": sp[1]}
        prods = j_scores(cfg, q[jg.row].reshape(-1, H, d_k),
                         k[jg.col].reshape(-1, H, d_k), d_k, ap)
        u = jnp.where(jg.mask[:, None], jnp.exp(prods), 0.0)
        ax = jfunctions._fused_normalized_aggregate(cfg, jg, u, xb[jg.col], x)
        den = jax.ops.segment_sum(u, jg.row, num_segments=N)
        return ax, den


@pytest.fixture(scope="module", params=SCORES)
def fused(request, graphs):
    return Fused(graphs, request.param)


def _t_sym(c, grad, x=None):
    ops, sp = c.t_ops(grad), c.t_sp(grad)
    if x is not None:
        ops[4] = x
    gmax = torch.zeros(1)
    ax, den = kernels.make_fused_ax_sym(c.g.tg, H, False, c.score,
                                        torch.bfloat16)(*ops, gmax, sp)
    return ops, sp, ax, den


class TestFusedSym:
    def test_matches_composition(self, fused):
        """ax, den and the gradients of sum(ax * probe) in qw, qb, kw, kb
        and x (and the exp_kernel scalars) against the JAX composition with
        the same casts: 1e-5 of scale."""
        c = fused
        k_val = jnp.asarray(c.k_exact(c.x))

        def jloss(qw, qb, kw, kb, x, sp):
            return jnp.sum(c.j_composition(qw, qb, kw, kb, x, sp, k_val)[0]
                           * c.probe)

        jops = [jnp.asarray(a) for a in (c.qw, c.qb, c.kw, c.kb, c.x)]
        want_ax, want_den = c.j_composition(*jops, c.j_sp(), k_val)
        want = jax.grad(jloss, argnums=tuple(range(6)))(*jops, c.j_sp())
        want = list(want[:5]) + list(want[5])
        ops, sp, ax, den = _t_sym(c, True)
        assert ax.dtype == den.dtype == torch.float32
        assert _rel(ax.detach(), want_ax) < 1e-5
        assert _rel(den.detach(), want_den) < 1e-5
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(c.probe)),
                                  [*ops, *sp])
        top = max(float(np.abs(np.asarray(w)).max()) for w in want)
        assert len(got) == len(want) == (7 if sp else 5)
        for i, (gv, wv) in enumerate(zip(got, want)):
            scale = float(np.abs(np.asarray(wv)).max())
            # K.b's true gradient is ~0 under the row softmax: its own
            # scale is cancellation noise, so the largest leaf's bounds it
            bound = 1e-5 * (scale if scale > 1e-3 * top else top)
            assert np.abs(gv.numpy() - np.asarray(wv)).max() <= bound, i

    def test_bf16_row_side(self, fused):
        """Under the bf16 state x itself is bfloat16: the same op on the
        rounded x, its gradient returned in bfloat16."""
        c = fused
        xb = torch.tensor(c.x).to(torch.bfloat16).requires_grad_(True)
        _, _, ax, _ = _t_sym(c, False, x=xb)
        torch.sum(ax * torch.tensor(c.probe)).backward()
        assert xb.grad.dtype == torch.bfloat16
        xr = torch.tensor(_round(c.x), requires_grad=True)
        _, _, ax_r, _ = _t_sym(c, False, x=xr)
        torch.sum(ax_r * torch.tensor(c.probe)).backward()
        assert _rel(ax.detach(), ax_r.detach()) < 1e-6
        assert _rel(xb.grad.float(), xr.grad.to(torch.bfloat16).float()) == 0

    def test_rhs_value_matches_xla(self, fused):
        """The whole RHS f (and the folded f) against the JAX package's
        ``make_rhs`` with the bf16 payload, its CPU (XLA) path: 1e-5."""
        c = fused
        jcfg = c.g.jcfg.replace(attention_type=c.score)
        tcfg = c.g.tcfg.replace(attention_type=c.score)
        jp = jfunctions.init_func_params(jax.random.PRNGKey(0), jcfg, D)
        jp = jax.tree.map(np.asarray, jp)
        jp["alpha_train"], jp["beta_train"] = np.float32(0.3), np.float32(0.2)
        jp["att"]["Q"] = {"w": c.qw, "b": c.qb}
        jp["att"]["K"] = {"w": c.kw, "b": c.kb}
        if c.score == "exp_kernel":
            jp["att"]["output_var"], jp["att"]["lengthscale"] = c.var, c.ls
        func = tfunctions.ODEFunc(tcfg, D)
        func.load_state_dict(params_from_jax(jp))
        x0 = c.probe
        jaux = jfunctions.FuncAux(None, jnp.asarray(x0), c.g.jg.weight)
        taux = tfunctions.FuncAux(None, torch.tensor(x0), c.g.tg.weight)
        want = jfunctions.make_rhs(jcfg, c.g.jg)(
            jax.tree.map(jnp.asarray, jp), jaux, 0.0, jnp.asarray(c.x))
        with torch.no_grad():
            got = tfunctions.make_rhs(tcfg, c.g.tg)(func, taux, 0.0,
                                                    torch.tensor(c.x))
            fold = tfunctions.make_rhs(tcfg, c.g.tg, eval_fold=True)(
                func, taux, 0.0, torch.tensor(c.x))
        assert _rel(got, want) < 1e-5
        assert _rel(fold, want) < 1e-5

    def test_matches_pallas_interpret(self, fused):
        """Values and gradients against the JAX ``make_fused_ax_sym`` with
        ``pay_dt=bfloat16`` in interpret mode (bf16 one-hots and packed
        cotangents): 3e-2 of scale."""
        c = fused
        op = jfused.make_fused_ax_sym(c.g.plan, H, False, c.score,
                                      c.g.pg.col, BF16)
        gm = jnp.zeros((), jnp.float32)

        def jloss(qw, qb, kw, kb, x, sp):
            return jnp.sum(op(qw, qb, kw, kb, x, gm, sp)[0] * c.probe)

        jops = [jnp.asarray(a) for a in (c.qw, c.qb, c.kw, c.kb, c.x)]
        want_ax, want_den = op(*jops, gm, c.j_sp())
        want = jax.grad(jloss, argnums=tuple(range(6)))(*jops, c.j_sp())
        want = list(want[:5]) + list(want[5])
        ops, sp, ax, den = _t_sym(c, True)
        assert _rel(ax.detach(), want_ax) < 3e-2
        assert _rel(den.detach(), want_den[:, :H]) < 3e-2
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(c.probe)),
                                  [*ops, *sp])
        top = max(float(np.abs(np.asarray(w)).max()) for w in want)
        for gv, wv in zip(got, want):
            assert np.abs(gv.numpy() - np.asarray(wv)).max() / top < 3e-2

    def test_folded_matches_pallas_interpret(self, fused):
        """``fused_rhs_f`` with the bf16 payload against the JAX
        ``fused_rhs_f`` (pay_dt bfloat16) in interpret mode: 3e-2."""
        c = fused
        alpha = 0.37
        jops = [jnp.asarray(a) for a in (c.qw, c.qb, c.kw, c.kb, c.x)]
        want = jfused.fused_rhs_f(c.g.plan, H, c.score, *jops[:4], jops[4],
                                  c.g.pg.col, BF16, jnp.float32(alpha),
                                  c.j_sp())
        with torch.no_grad():
            ops, sp = c.t_ops(), c.t_sp()
            got = kernels.fused_rhs_f(c.g.tg, H, c.score, *ops,
                                      torch.tensor(alpha), sp,
                                      payload_dtype=torch.bfloat16)
        assert _rel(got, want) < 3e-2


# ---------------------------------------------------------------------------
# three training steps of GRAND_NL_BENCH
# ---------------------------------------------------------------------------

BENCH_SIZES = dict(num_nodes=300, num_edges=900, hidden=16, attention_dim=16,
                   heads=2, seed=3)


def _three_steps(state_dtype):
    """Three optimizer steps of GRAND_NL_BENCH at a small width over the
    bench's random graph in both packages, from one converted init (Q and
    K drawn off their near-constant init): per step (loss, forward NFE,
    backward NFE)."""
    tcfg = GRAND_NL_BENCH.replace(
        hidden_dim=BENCH_SIZES["hidden"],
        attention_dim=BENCH_SIZES["attention_dim"],
        heads=BENCH_SIZES["heads"], dtype=state_dtype)
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
    def test_payload_only(self):
        """The bf16 payload with a float32 state: losses rtol 1e-4 (measured
        3.6e-5: the JAX package's XLA gradients accumulate their cotangents
        in bfloat16, the port's in float32), NFE identical."""
        jlogs, tlogs = _three_steps("float32")
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-4)
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        assert tlogs[0][0] != tlogs[-1][0]

    def test_bf16_state(self):
        """The bf16 rk4 state (bench.py's precision): every stage sum rounds
        to bfloat16, where one flipped last bit is 3.9e-3 relative. The
        losses are held at rtol 1e-3 (measured 2.4e-5: a flipped bit in one
        element of a 300 x 16 state barely moves a mean loss), NFE
        identical."""
        jlogs, tlogs = _three_steps("bfloat16")
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-3)
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]

    def test_bf16_state_rhs_within_one_ulp(self, graphs):
        """One RHS evaluation on a bfloat16 state, cast to the state's
        dtype as the solver casts it: within one bf16 step at the output's
        scale of the JAX package's."""
        c = Fused(graphs, "scaled_dot", seed=4)
        jcfg = graphs.jcfg.replace(dtype="bfloat16", method="rk4")
        tcfg = graphs.tcfg.replace(dtype="bfloat16", method="rk4")
        jp = jax.tree.map(np.asarray, jfunctions.init_func_params(
            jax.random.PRNGKey(0), jcfg, D))
        jp["alpha_train"], jp["beta_train"] = np.float32(0.3), np.float32(0.2)
        jp["att"]["Q"] = {"w": c.qw, "b": c.qb}
        jp["att"]["K"] = {"w": c.kw, "b": c.kb}
        func = tfunctions.ODEFunc(tcfg, D)
        func.load_state_dict(params_from_jax(jp))
        jaux = jfunctions.FuncAux(None, jnp.asarray(c.probe), graphs.jg.weight)
        taux = tfunctions.FuncAux(None, torch.tensor(c.probe), graphs.tg.weight)
        xb = jnp.asarray(c.x).astype(BF16)
        want = jfunctions.make_rhs(jcfg, graphs.jg)(
            jax.tree.map(jnp.asarray, jp), jaux, 0.0, xb).astype(BF16)
        with torch.no_grad():
            got = tfunctions.make_rhs(tcfg, graphs.tg)(
                func, taux, 0.0, torch.tensor(c.x).to(torch.bfloat16)
            ).to(torch.bfloat16)
        want = np.asarray(want.astype(jnp.float32))
        scale = np.abs(want).max()
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert np.abs(got.float().numpy() - want).max() <= ulp


# ---------------------------------------------------------------------------
# every route takes the mode
# ---------------------------------------------------------------------------

BF = dict(rhs_payload_dtype="bfloat16", dtype="bfloat16")


class TestRefusals:
    @pytest.mark.parametrize("override", [
        dict(), dict(rhs_payload_dtype="float32"), dict(method="dopri5"),
        dict(function="laplacian"), dict(function="laplacian",
                                         block="attention"),
        dict(attention_type="exp_kernel"), dict(dtype="float32"),
        dict(**FLOAT32),
        dict(sym_backward=False),                      # colplan K8 + K17
        dict(attention_norm_idx=1),                    # columns K12-K14
        # the routes that refused the mode until B1 items 4 and 6 were
        # ported
        dict(attention_norm_idx=1, square_plus=True),  # composed K1-K4
        dict(square_plus=True),                        # composed K10/K11
        dict(reweight_attention=True),                 # composed K10/K11
        dict(function="GAT"),                          # K10/K11
        dict(mix_features=True),                       # composed K1-K4
        dict(fused_attention_agg=False),               # composed K1-K4
        dict(block="hard_attention"),                  # K10/K11
        dict(function="laplacian", spmm_impl="pallas_blocked"),  # K15/K16
    ])
    def test_check_supported_accepts(self, override):
        check_supported(GRAND_NL_BENCH.replace(**override))

    def test_runtime_routes_raise(self, graphs):
        """The route a re-solve reaches at run time takes the mode (it
        refused it before B1 item 4): the exact softmax of a family other
        than scaled_dot composes on K10/K11 over the bf16 column table and
        comes back finite, values and gradients. The exact re-solve of
        scaled_dot (K7, K6 shifted, K8) and a directed graph (K8 + K17)
        build and run on the bf16 column table too
        (tests/test_torch_port_bf16_col.py holds their values,
        tests/test_torch_port_bf16_composed.py the composed ones)."""
        exp_cfg = graphs.tcfg.replace(attention_type="exp_kernel")
        c = Fused(graphs, "scaled_dot")
        func = tfunctions.ODEFunc(exp_cfg, D)
        x = torch.tensor(c.x, requires_grad=True)
        aux = tfunctions.FuncAux(None, x.detach(), graphs.tg.weight)
        out = tfunctions.make_rhs(exp_cfg, graphs.tg, exact_softmax=True)(
            func, aux, 0.0, x)
        torch.sum(out).backward()
        assert torch.isfinite(out).all() and torch.isfinite(x.grad).all()
        tfunctions.make_rhs(exp_cfg, graphs.tg)
        directed = make_random_graph_dataset(40, 80, num_features=4,
                                             num_classes=2, seed=0).graph
        from graph_neural_pde_tpu_torch.ops.graph import make_graph
        g = make_graph(directed.row[:30], directed.col[:30],
                       num_nodes=40).sort_by_row()
        assert g.rev is None
        func = tfunctions.ODEFunc(graphs.tcfg, D)
        x = torch.tensor(c.x[:40], requires_grad=True)
        aux = tfunctions.FuncAux(None, x.detach(), g.weight)
        for exact in (False, True):
            out = tfunctions.make_rhs(graphs.tcfg, g, exact_softmax=exact)(
                func, aux, 0.0, x)
            torch.sum(out).backward()
            assert torch.isfinite(out).all() and torch.isfinite(x.grad).all()

    @pytest.mark.parametrize("state,training", [
        ("float32", False), ("bfloat16", False), ("bfloat16", True)])
    def test_poisoned_solve_raises(self, graphs, state, training,
                                   monkeypatch):
        """A solve whose fast softmax poisons re-solves under the mode:
        with scaled_dot scores (Q far outside exp's range) on the bf16
        column table (K7, K6 shifted, K8), with exp_kernel scores
        (output_var far outside it), which it refused before B1 item 4,
        on the composed exact softmax (K3, then K10/K11 on the bf16 column
        table). Both come back finite, and in training so do the
        gradients (tests/test_torch_port_bf16_composed.py holds the
        exp_kernel re-solve against the JAX block)."""
        cfg = graphs.tcfg.replace(dtype=state, method="rk4", step_size=0.5,
                                  time=1.0)
        c = Fused(graphs, "scaled_dot", seed=7)
        calls = []
        real = tfunctions.make_rhs
        monkeypatch.setattr(
            tblocks, "make_rhs",
            lambda *a, **kw: calls.append(kw["exact_softmax"]) or real(*a, **kw))
        block = tblocks.ODEBlock(cfg, D)
        with torch.no_grad():
            block.func.att.Q.w.copy_(torch.tensor(400.0 * c.qw))
        x = torch.tensor(c.x, requires_grad=training)
        z, _ = tblocks.block_forward(block, cfg, graphs.tg, x, training)
        assert calls == [False, True]
        assert torch.isfinite(z).all()
        if training:
            torch.sum(z).backward()
            assert torch.isfinite(x.grad).all()
        calls.clear()
        cfg_e = cfg.replace(attention_type="exp_kernel")
        block = tblocks.ODEBlock(cfg_e, D)
        with torch.no_grad():
            block.func.att.output_var.fill_(20.0)
            block.func.att.lengthscale.fill_(100.0)
        x = torch.tensor(c.x, requires_grad=training)
        z, _ = tblocks.block_forward(block, cfg_e, graphs.tg, x, training)
        assert calls == [False, True]
        assert torch.isfinite(z).all()
        if training:
            torch.sum(z).backward()
            assert torch.isfinite(x.grad).all()
            assert all(torch.isfinite(p.grad).all()
                       for p in block.parameters() if p.grad is not None)

    def test_aggregate_and_sharded_routes_raise(self, graphs):
        """K18 / K19 / K8's per-head mode (``fused_rhs_aggregate``) and the
        shard functions take the mode (ROADMAP Queue 2 B1 items 3 and 6):
        the op runs on a bfloat16 payload, float32 out, the x_g gradient in
        bfloat16; both dispatchers build under the bench's bf16 config; and
        the stripe spmm, which refused its bfloat16 payload before item 6,
        runs on it (K1 in table mode on the bf16 payload, K20 writing its
        bf16 gradient), float32 out, finite values and gradients. Values:
        tests/test_torch_port_bf16_aggregate.py and
        tests/test_torch_port_parallel.py."""
        from graph_neural_pde_tpu_torch.parallel.mesh import split_mesh
        from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
            make_sharded_fused_rhs_for, make_sharded_spmm_for,
            make_sharded_stripe_spmm)
        tg = graphs.tg
        c = Fused(graphs, "scaled_dot")
        qw, qb, kw, kb, x = c.t_ops()
        x_g = x[tg.col.long()].to(torch.bfloat16).requires_grad_(True)
        num, den = kernels.fused_rhs_aggregate(tg, H, False, "scaled_dot",
                                               qw, qb, kw, kb, x, x_g,
                                               torch.zeros(1))
        assert num.dtype == den.dtype == torch.float32
        assert torch.isfinite(num).all() and torch.isfinite(den).all()
        num.sum().backward()
        assert x_g.grad.dtype == torch.bfloat16
        mesh = split_mesh(2, "cpu")
        make_sharded_spmm_for(GRAND_NL_BENCH, mesh, tg)
        make_sharded_fused_rhs_for(GRAND_NL_BENCH, mesh, tg, heads=H)
        spmm_fn = make_sharded_stripe_spmm(mesh, tg,
                                           payload_dtype=torch.bfloat16)
        xs = x.clone().requires_grad_(True)
        w = (tg.weight * tg.mask).requires_grad_(True)
        out = spmm_fn(xs, w)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        torch.sum(out * torch.tensor(c.probe)).backward()
        assert torch.isfinite(xs.grad).all() and torch.isfinite(w.grad).all()

    def test_kernels_refuse_what_they_lack(self, graphs):
        """K8 refuses a bfloat16 x without its column table, K6-K8, K17
        and K10/K11 any column table but a bfloat16 one (float16 here), and
        K10 a bfloat16 u: nothing falls back to float32."""
        tg = graphs.tg
        c = Fused(graphs, "scaled_dot")
        qw, qb, kw, kb, x = c.t_ops()
        xb = x.to(torch.bfloat16)
        ct = torch.zeros(N, D)
        rp = torch.zeros(N, H)
        with pytest.raises(TypeError):
            kernels.fused_rhs_bwd(tg.rowptr, tg.row, tg.col, xb, qw, qb, kw,
                                  kb, torch.zeros(1), ct, rp, rp, heads=H,
                                  score="scaled_dot")
        x16 = x.to(torch.float16)
        with pytest.raises(TypeError):
            kernels.fused_rhs_fwd(tg.rowptr, tg.row, tg.col, x, qw, qb, kw,
                                  kb, torch.zeros(1), heads=H,
                                  score="scaled_dot",
                                  shifts=torch.zeros(tg.capacity, H),
                                  xcol=x16)
        with pytest.raises(TypeError):
            kernels.fused_rowmax(tg.rowptr, tg.row, tg.col, x, qw, qb, kw,
                                 kb, heads=H, xcol=x16)
        with pytest.raises(TypeError):
            kernels.fused_rhs_bwd(tg.rowptr, tg.row, tg.col, x, qw, qb, kw,
                                  kb, torch.zeros(1), ct, rp, rp, heads=H,
                                  score="scaled_dot", xcol=x16)
        with pytest.raises(TypeError):
            kernels.fused_rhs_bwd_col(tg.colptr, tg.col_by_col,
                                      tg.row_by_col, x, qw, qb, kw, kb,
                                      torch.zeros(1), ct, rp, rp, heads=H,
                                      score="scaled_dot", xcol=x16)
        # K10 and K11 read a float32 or bfloat16 table beside a float32 u,
        # and their op takes no float16 payload
        u = torch.rand(tg.capacity, H) * tg.mask[:, None]
        csr = (tg.rowptr, tg.row, tg.col)
        with pytest.raises(TypeError):
            kernels.dual_scatter(*csr, u, x16)
        with pytest.raises(TypeError):
            kernels.dual_gather(*csr, tg.rev, u, x16, torch.zeros(N, H * D),
                                rp)
        with pytest.raises(TypeError):
            kernels.dual_scatter(*csr, u.to(torch.bfloat16), xb)
        with pytest.raises(TypeError):
            kernels.dual_scatter_add(tg, u, x, torch.float16)
