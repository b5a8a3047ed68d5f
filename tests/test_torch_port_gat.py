"""The rest of the PyTorch port's GRAND-nl slice against the JAX package:
the plain versions of K10 ``dual_scatter`` and K11 ``dual_gather`` against
the Pallas kernels they replace (interpret mode on a small stripe plan) and
``jax.grad`` of the XLA aggregate; the composed transformer RHS (squareplus,
reweighted attention), the GAT RHS and ``mix_features`` against the JAX
package's float32 XLA composition; the GAT attention layer, the multihead
SpMM, the mixed block and hard attention over a function-owned layer; the
poison-and-re-solve discipline of the GAT function; and three training
epochs of four configurations.

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
from graph_neural_pde_tpu.models import attention as jattention
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.models import functions as jfunctions
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.ops.pallas import stripe as jstripe
from graph_neural_pde_tpu.ops.spmm import spmm_mean_heads as j_spmm_mean_heads
from graph_neural_pde_tpu.ops.spmm import spmm_multihead as j_spmm_multihead
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels, run
from graph_neural_pde_tpu_torch.config import Config, best_params
from graph_neural_pde_tpu_torch.convert import params_from_jax, params_to_jax
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.models import attention as tattention
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.gnn import check_supported
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.ops import spmm as tspmm
from graph_neural_pde_tpu_torch.ops.graph import make_graph
from graph_neural_pde_tpu_torch.training.train import Trainer

N, D, ATT, H = 40, 12, 16, 4
SBM = dict(num_nodes=N, num_classes=3, num_features=6, seed=2,
           edge_pad_multiple=32, num_val=10)
NL = dict(function="transformer", block="constant", attention_norm_idx=0,
          square_plus=True, self_loop_weight=1.0, add_source=True,
          hidden_dim=D, attention_dim=ATT, heads=H)
F32 = np.float32


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
    if torch.is_tensor(got):
        got = got.detach().numpy()
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


class Graphs:
    """One prepared SBM graph (symmetric, self loops) in both packages, the
    JAX stripe plan over it (block_n 8, chunk 16, as the JAX package's own
    kernel tests) and the slot of every CSR edge in that plan. The two
    prepared graphs hold the same arrays slot for slot."""

    def __init__(self):
        jcfg, tcfg = _cfgs()
        self.jg = jblocks.prepare_graph(jcfg, j_sbm(**SBM).graph)
        self.tg = tblocks.prepare_graph(tcfg, make_sbm_dataset(**SBM).graph)
        np.testing.assert_array_equal(np.asarray(self.jg.col),
                                      self.tg.col.numpy())
        self.nv = self.tg.num_valid
        self.row = self.tg.row.numpy()[:self.nv]
        self.col = self.tg.col.numpy()[:self.nv]
        _, self.plan = jblocks.build_stripe_engine(
            jcfg.replace(stripe_fused=True, stripe_block_n=8,
                         stripe_chunk=16), self.jg)
        assert self.plan is not None and self.plan.num_nodes == N
        idx = np.where(np.asarray(self.jg.mask))[0]
        np.testing.assert_array_equal(idx, np.arange(self.nv))
        self.slots = np.asarray(self.plan.slot_of_edge)[idx]

    def to_slots(self, per_edge):
        """A per-edge array in CSR order, laid out in the plan's slots
        (zeros elsewhere)."""
        out = np.zeros((self.plan.capacity,) + per_edge.shape[1:], F32)
        out[self.slots] = per_edge
        return out

    def padded(self, per_edge):
        """A per-edge array over the valid prefix, zero-padded to the
        graph's capacity."""
        out = np.zeros((self.tg.capacity,) + per_edge.shape[1:], F32)
        out[:self.nv] = per_edge
        return out

    def csr(self):
        return self.tg.rowptr, self.tg.row, self.tg.col


@pytest.fixture(scope="module")
def graphs():
    return Graphs()


@pytest.fixture(scope="module")
def operands(graphs):
    rng = np.random.default_rng(0)
    u = rng.uniform(0.05, 1.0, size=(graphs.nv, H)).astype(F32)
    x = rng.normal(size=(N, D)).astype(F32)
    ct_num = rng.normal(size=(N, H * D)).astype(F32)
    ct_den = rng.normal(size=(N, H)).astype(F32)
    return u, x, ct_num, ct_den


def _pad_heads(a):
    out = np.zeros((a.shape[0], max(8, H)), F32)
    out[:, :H] = a
    return out


class TestPlainAgainstPallas:
    """K10 and K11's plain versions against the Pallas calls in interpret
    mode. float32 where the call takes ``dtype`` (1e-5 of the array's scale:
    only the order of the sums differs); the default call rounds its MXU
    operands to bf16 (2e-2)."""

    def _vals(self, graphs, u, x):
        vals = (u[:, :, None] * x[graphs.col][:, None, :]).reshape(-1, H * D)
        return (jnp.asarray(graphs.to_slots(vals)),
                jnp.asarray(graphs.to_slots(_pad_heads(u))))

    def _port(self, graphs, u, x):
        return kernels.dual_scatter(*graphs.csr(),
                                    torch.tensor(graphs.padded(u)),
                                    torch.tensor(x))

    def test_dual_scatter_float32(self, graphs, operands):
        u, x, _, _ = operands
        num_j, den_j = jstripe._stripe_scatter2_call(
            graphs.plan, *self._vals(graphs, u, x), dtype=jnp.float32,
            interpret=True)
        num, den = self._port(graphs, u, x)
        assert num.shape == (N, H * D) and den.shape == (N, H)
        assert _rel(num, num_j) < 1e-5
        assert _rel(den, den_j[:, :H]) < 1e-5

    def test_dual_scatter_default_bf16(self, graphs, operands):
        u, x, _, _ = operands
        num_j, den_j = jstripe.stripe_scatter_add2(
            graphs.plan, *self._vals(graphs, u, x))
        num, den = self._port(graphs, u, x)
        assert _rel(num, num_j) < 2e-2
        assert _rel(den, den_j[:, :H]) < 2e-2

    def test_dual_gather_float32(self, graphs, operands):
        """K11 against the Pallas row gather of both cotangents composed
        with the products XLA forms after it (the VJP of ``vals = u (x)
        x[col]``)."""
        u, x, ct_num, ct_den = operands
        gv, gu = jstripe._stripe_gather2_call(
            graphs.plan, jnp.asarray(ct_num), jnp.asarray(_pad_heads(ct_den)),
            dtype=jnp.float32, interpret=True)
        gv = np.asarray(gv)[graphs.slots].reshape(-1, H, D)    # CSR order
        gu = np.asarray(gu)[graphs.slots][:, :H]
        du_want = np.einsum("ehd,ed->eh", gv, x[graphs.col]) + gu
        dx_want = np.zeros((N, D), F32)
        np.add.at(dx_want, graphs.col, np.einsum("eh,ehd->ed", u, gv))
        du, dx = kernels.dual_gather(
            *graphs.csr(), graphs.tg.rev, torch.tensor(graphs.padded(u)),
            torch.tensor(x), torch.tensor(ct_num), torch.tensor(ct_den))
        assert _rel(du[:graphs.nv], du_want) < 1e-5
        assert not du[graphs.nv:].any()
        assert _rel(dx, dx_want) < 1e-5

    def test_aggregate_gradient_against_xla(self, graphs, operands):
        """The autograd op inside ``_fused_normalized_aggregate`` against
        ``jax.grad`` of the JAX function on its XLA branch."""
        u, x, _, _ = operands
        jcfg, tcfg = _cfgs()
        w = np.random.default_rng(3).normal(size=(N, D)).astype(F32)
        u_pad = graphs.padded(u)

        def jloss(uu, xx):
            out = jfunctions._fused_normalized_aggregate(
                jcfg, graphs.jg, uu, xx[graphs.jg.col], xx, None)
            return jnp.sum(out * w), out

        (_, want), (gu, gx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(u_pad),
                                                 jnp.asarray(x))
        tu = torch.tensor(u_pad, requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)
        out = tfunctions._fused_normalized_aggregate(tcfg, graphs.tg, tu, tx)
        torch.sum(out * torch.tensor(w)).backward()
        assert _rel(out, want) < 1e-5
        assert _rel(tu.grad[:graphs.nv], np.asarray(gu)[:graphs.nv]) < 1e-5
        assert _rel(tx.grad, gx) < 1e-5


class TestDualScatterOp:
    def _tiny(self, dtype=torch.float64):
        g = make_graph([0, 1, 1, 2, 0, 2, 0, 1, 2], [1, 0, 2, 1, 2, 0, 0, 1, 2],
                       num_nodes=3, pad_multiple=4).sort_by_row()
        gen = torch.Generator().manual_seed(0)
        u = torch.rand((g.capacity, 2), generator=gen, dtype=dtype) + 0.1
        u = u * g.mask[:, None]
        x = torch.randn((3, 3), generator=gen, dtype=dtype)
        return g, u, x

    def test_gradcheck(self):
        g, u, x = self._tiny()
        u.requires_grad_(True)
        x.requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda uu, xx: kernels.dual_scatter_add(g, uu, xx), (u, x))

    def test_cpu_runs_plain_versions_without_launching(self):
        g, u, x = self._tiny(torch.float32)
        before = [k.launches for k in kernels.KERNELS]
        u.requires_grad_(True)
        num, den = kernels.dual_scatter_add(g, u, x)
        (num.sum() + den.sum()).backward()
        assert [k.launches for k in kernels.KERNELS] == before
        assert kernels.KERNELS[8:10] == (kernels.dual_scatter,
                                        kernels.dual_gather)

    @pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape", "heads",
                                     "width", "index_dtype", "meta"])
    def test_dual_scatter_rejects(self, bad):
        g, u, x = self._tiny(torch.float32)
        rowptr, row, col = g.rowptr, g.row, g.col
        err = (TypeError, ValueError)
        if bad == "dtype":
            u, x = u.half(), x.half()
        elif bad == "mixed_dtype":
            u = u.double()
        elif bad == "shape":
            u = u[:-1].contiguous()
        elif bad == "heads":
            u = torch.zeros((g.capacity, 33))
        elif bad == "width":
            x = torch.zeros((3, 257))
        elif bad == "index_dtype":
            col = col.long()
        else:
            err = NotImplementedError
            rowptr, row, col, u, x = (t.to("meta") for t in
                                      (rowptr, row, col, u, x))
        with pytest.raises(err):
            kernels.dual_scatter(rowptr, row, col, u, x)

    def test_directed_graph_raises(self):
        """x's gradient on a non-symmetric edge multiset no longer raises:
        K11 gives du, and K1 over the CSC view sums dx over the columns
        (against the plain version, which sums over columns directly)."""
        g = make_graph([0, 1, 2, 2], [1, 2, 0, 1], num_nodes=3).sort_by_row()
        assert g.rev is None
        u = torch.rand(4, 2, requires_grad=True)
        x = torch.randn(3, 3, requires_grad=True)
        num, den = kernels.dual_scatter_add(g, u, x)
        ct_num, ct_den = torch.randn(3, 6), torch.randn(3, 2)
        (torch.sum(num * ct_num) + torch.sum(den * ct_den)).backward()
        du, dx = kernels.dual_gather_plain(g.rowptr, g.row, g.col,
                                           u.detach(), x.detach(), ct_num,
                                           ct_den)
        assert torch.allclose(u.grad, du, rtol=1e-6, atol=1e-6)
        assert torch.allclose(x.grad, dx, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the right-hand sides
# ---------------------------------------------------------------------------

SCORES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel")
RHS_CASES = {
    **{f"squareplus-{s}": dict(attention_type=s) for s in SCORES},
    "reweight-softmax": dict(square_plus=False, reweight_attention=True),
    "reweight-squareplus": dict(reweight_attention=True),
    "bounded-exact": dict(square_plus=False, attention_type="cosine_sim",
                          exact=True),
    "gat": dict(function="GAT", square_plus=False),
    "gat-exact": dict(function="GAT", square_plus=False, exact=True),
    "gat-column-norm": dict(function="GAT", attention_norm_idx=1),
    "transformer-mix": dict(mix_features=True),
    "transformer-mix-softmax": dict(mix_features=True, square_plus=False),
    "gat-mix": dict(function="GAT", mix_features=True),
}


def _func_params(jcfg, seed=1, alpha=0.3, beta=0.2):
    """JAX function parameters with every attention leaf redrawn from a
    seeded numpy generator (off the constant 1e-5 init)."""
    p = jfunctions.init_func_params(jax.random.PRNGKey(0), jcfg, D)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    p["alpha_train"], p["beta_train"] = F32(alpha), F32(beta)

    def redraw(leaf, scale):
        return (scale * rng.normal(size=leaf.shape)).astype(F32)

    att = p["att"]
    if jcfg.function == "GAT":
        att.update({k: redraw(att[k], 0.4) for k in ("W", "Wout", "a")})
    else:
        for m in ("Q", "K", "V", "Wout"):
            att[m] = {"w": redraw(att[m]["w"], 0.3),
                      "b": redraw(att[m]["b"], 0.1)}
        if jcfg.attention_type == "exp_kernel":
            att["output_var"] = np.array([1.3], F32)
            att["lengthscale"] = np.array([0.8], F32)
    return p


class RhsCase:
    def __init__(self, graphs, name):
        kw = dict(RHS_CASES[name])
        self.exact = kw.pop("exact", False)
        self.jcfg, self.tcfg = _cfgs(**kw)
        self.graphs = graphs
        self.jp = _func_params(self.jcfg)
        self.func = tfunctions.ODEFunc(self.tcfg, D)
        self.func.load_state_dict(params_from_jax(self.jp))
        rng = np.random.default_rng(5)
        self.x = rng.normal(size=(N, D)).astype(F32)
        self.x0 = rng.normal(size=(N, D)).astype(F32)
        self.w = rng.normal(size=(N, D)).astype(F32)

    def jax_value_and_grads(self, jg=None):
        jg = self.graphs.jg if jg is None else jg
        rhs = jfunctions.make_rhs(self.jcfg, jg, exact_softmax=self.exact)
        aux = jfunctions.FuncAux(None, jnp.asarray(self.x0), jg.weight)

        def loss(p, x):
            f = rhs(p, aux, 0.0, x)
            return jnp.sum(f * self.w), f

        (_, f), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(
            jax.tree.map(jnp.asarray, self.jp), jnp.asarray(self.x))
        return f, params_from_jax(jax.tree.map(np.asarray, gp)), gx

    def port_value_and_grads(self, tg=None):
        tg = self.graphs.tg if tg is None else tg
        rhs = tfunctions.make_rhs(self.tcfg, tg, exact_softmax=self.exact)
        aux = tfunctions.FuncAux(None, torch.tensor(self.x0), tg.weight)
        x = torch.tensor(self.x, requires_grad=True)
        self.func.zero_grad()
        f = rhs(self.func, aux, 0.0, x)
        torch.sum(f * torch.tensor(self.w)).backward()
        return f.detach(), {k: p.grad for k, p in
                            self.func.named_parameters()}, x.grad


def _check_grads(got, want, gx_got, gx_want):
    """Every parameter leaf at 1e-4 of its own scale (a leaf whose gradient
    is below 1e-3 of the largest holds rounding noise: 1e-4 of the largest),
    a leaf the RHS does not read at exactly 0."""
    top = max(float(v.abs().max()) for v in want.values())
    read = 0
    for k, wv in want.items():
        if not wv.any():
            assert got[k] is None or not got[k].any(), k
            continue
        scale = float(wv.abs().max())
        bound = 1e-4 * (scale if scale > 1e-3 * top else top)
        assert float((got[k] - wv).abs().max()) <= bound, k
        read += 1
    assert _rel(gx_got, gx_want) < 1e-4
    return read


@pytest.mark.parametrize("name", sorted(RHS_CASES))
class TestRhsAgainstXla:
    """make_rhs in both packages from converted weights: the port's composed
    RHS (K10/K11, K3/K4, K1/K2 through their plain versions) against the
    JAX package's float32 XLA composition. Values at 1e-5 of scale,
    gradients at 1e-4 of each leaf's scale."""

    def test_value(self, graphs, name):
        c = RhsCase(graphs, name)
        want, _, _ = c.jax_value_and_grads()
        got, _, _ = c.port_value_and_grads()
        assert np.isfinite(np.asarray(want)).all()
        assert _rel(got, want) < 1e-5

    def test_gradients(self, graphs, name):
        c = RhsCase(graphs, name)
        _, want, gx_want = c.jax_value_and_grads()
        _, got, gx_got = c.port_value_and_grads()
        assert set(got) == set(want)
        read = _check_grads(got, want, gx_got, gx_want)
        assert read >= (4 if c.tcfg.function == "GAT" else 6)


def test_rhs_on_a_remasked_graph(graphs):
    """Hard attention's re-masked graph: dropped edges take no attention in
    the composed RHS (u = 0) and give no gradient, in both packages, for
    the softmax (which leaves the one-kernel path) and squareplus."""
    keep = np.asarray(graphs.jg.mask).copy()
    keep[np.random.default_rng(2).choice(graphs.nv, graphs.nv // 3,
                                         replace=False)] = False
    jg2 = graphs.jg.with_edges(graphs.jg.row, graphs.jg.col, graphs.jg.weight,
                               jnp.asarray(keep))
    tg2 = graphs.tg.with_mask(torch.tensor(keep))
    for name in ("squareplus-scaled_dot", "reweight-softmax", "gat"):
        c = RhsCase(graphs, name)
        if name == "reweight-softmax":
            c.jcfg, c.tcfg = _cfgs(square_plus=False)
        want, gwant, gx_want = c.jax_value_and_grads(jg2)
        got, ggot, gx_got = c.port_value_and_grads(tg2)
        assert _rel(got, want) < 1e-5
        _check_grads(ggot, gwant, gx_got, gx_want)
        full, _, _ = c.port_value_and_grads()
        assert _rel(got, full) > 1e-3           # the mask was honoured


class TestPoison:
    """GAT scores far outside float32's exp range: the global-shift fast
    path poisons, block_forward re-solves with the per-row softmax, and the
    two packages agree (1e-4 of scale: two euler steps in float32)."""

    def _setup(self, graphs, **kw):
        kw = dict(dict(function="GAT", square_plus=False, method="euler",
                       step_size=0.5, time=1.0), **kw)
        jcfg, tcfg = _cfgs(**kw)
        jp = _func_params(jcfg)
        jp["att"]["W"] = jp["att"]["W"] * 60.0
        func = tfunctions.ODEFunc(tcfg, D)
        func.load_state_dict(params_from_jax(jp))
        x = np.random.default_rng(7).normal(size=(N, D)).astype(F32)
        return jcfg, tcfg, jp, func, x

    def test_fast_path_poisons_and_exact_recovers(self, graphs):
        jcfg, tcfg, jp, func, x = self._setup(graphs)
        assert tfunctions.rhs_may_poison(tcfg)
        assert jfunctions.rhs_may_poison(jcfg)
        tg, jg = graphs.tg, graphs.jg
        taux = tfunctions.FuncAux(None, torch.tensor(x), tg.weight)
        with torch.no_grad():
            fast = tfunctions.make_rhs(tcfg, tg)(func, taux, 0.0,
                                                 torch.tensor(x))
            exact = tfunctions.make_rhs(tcfg, tg, exact_softmax=True)(
                func, taux, 0.0, torch.tensor(x))
        assert torch.isnan(fast).all()
        jaux = jfunctions.FuncAux(None, jnp.asarray(x), jg.weight)
        jpj = jax.tree.map(jnp.asarray, jp)
        assert np.isnan(np.asarray(jfunctions.make_rhs(jcfg, jg)(
            jpj, jaux, 0.0, jnp.asarray(x)))).all()
        want = jfunctions.make_rhs(jcfg, jg, exact_softmax=True)(
            jpj, jaux, 0.0, jnp.asarray(x))
        assert torch.isfinite(exact).all() and _rel(exact, want) < 1e-4

    @pytest.mark.parametrize("training", [False, True])
    def test_block_forward_resolves(self, graphs, training, monkeypatch):
        jcfg, tcfg, jp, func, x = self._setup(graphs)
        calls = []
        real = tfunctions.make_rhs
        monkeypatch.setattr(
            tblocks, "make_rhs",
            lambda *a, **kw: calls.append(kw["exact_softmax"]) or real(*a, **kw))
        block = tblocks.ODEBlock(tcfg, D)
        block.func.load_state_dict(func.state_dict())
        tx = torch.tensor(x, requires_grad=training)
        z, _ = tblocks.block_forward(block, tcfg, graphs.tg, tx, training)
        assert calls == [False, True]
        zj, _, _ = jblocks.block_forward(
            {"func": jax.tree.map(jnp.asarray, jp)}, jcfg, graphs.jg,
            jnp.asarray(x), training)
        assert torch.isfinite(z).all() and _rel(z, zj) < 1e-4
        if training:
            torch.sum(z).backward()
            assert torch.isfinite(tx.grad).all()

    def test_gat_with_square_plus_set_still_resolves(self, graphs):
        """The fused GAT RHS runs exp whatever ``square_plus`` says, so it
        poisons with the flag set too. The JAX package's ``rhs_may_poison``
        answers False there and its block returns the NaN (ROADMAP Queue 3,
        R6: the reference at fault); the port re-solves and agrees with the
        JAX package's own exact RHS."""
        jcfg, tcfg, jp, func, x = self._setup(graphs, square_plus=True)
        assert not jfunctions.rhs_may_poison(jcfg)
        assert tfunctions.rhs_may_poison(tcfg)
        jpj = jax.tree.map(jnp.asarray, jp)
        zj, _, _ = jblocks.block_forward({"func": jpj}, jcfg, graphs.jg,
                                         jnp.asarray(x), False)
        assert np.isnan(np.asarray(zj)).all()       # never re-solved
        block = tblocks.ODEBlock(tcfg, D)
        block.func.load_state_dict(func.state_dict())
        with torch.no_grad():
            z, _ = tblocks.block_forward(block, tcfg, graphs.tg,
                                         torch.tensor(x), False)
        # the same two euler steps on the JAX package's exact RHS
        rhs = jfunctions.make_rhs(jcfg, graphs.jg, exact_softmax=True)
        aux = jfunctions.FuncAux(None, jnp.asarray(x), graphs.jg.weight)
        y = jnp.asarray(x)
        for _ in range(2):
            y = y + 0.5 * rhs(jpj, aux, 0.0, y)
        assert torch.isfinite(z).all() and _rel(z, y) < 1e-4


# ---------------------------------------------------------------------------
# attention layers, the multihead SpMM and the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_idx", [0, 1])
def test_apply_gat_attention(graphs, norm_idx):
    """square_plus is set and must be ignored: GAT always takes softmax."""
    jcfg, tcfg = _cfgs(function="GAT", attention_norm_idx=norm_idx)
    jp = _func_params(jcfg)["att"]
    x = np.random.default_rng(4).normal(size=(N, D)).astype(F32)
    want, wx_want = jattention.apply_gat_attention(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x), graphs.jg)
    func = tfunctions.ODEFunc(tcfg, D)
    func.load_state_dict(params_from_jax({"att": jp}), strict=False)
    with torch.no_grad():
        got, wx = tattention.apply_gat_attention(func.att, tcfg,
                                                 torch.tensor(x), graphs.tg)
    assert got.shape == (graphs.tg.capacity, H)
    assert _rel(got, want) < 1e-5 and _rel(wx, wx_want) < 1e-5
    assert not got[graphs.nv:].any()


def test_gat_attention_init_statistics():
    """W, Wout and a are normal with deviation 1.414 sqrt(2 / (rows +
    cols)), drawn from the explicit generator."""
    cfg = Config(**NL).replace(function="GAT", attention_dim=256, heads=2)
    gen = torch.Generator().manual_seed(0)
    att = tattention.GATAttention(cfg, 200, generator=gen)
    assert att.W.shape == (200, 256) and att.Wout.shape == (256, 200)
    assert att.a.shape == (256, 1)
    want = 1.414 * math.sqrt(2.0 / 456)
    assert abs(float(att.W.detach().std()) / want - 1) < 0.02
    assert abs(float(att.Wout.detach().std()) / want - 1) < 0.02
    again = tattention.GATAttention(cfg, 200,
                                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(att.W, again.W) and torch.equal(att.a, again.a)
    with pytest.raises(ValueError, match="factor"):
        tattention.GATAttention(cfg.replace(heads=3), 200)


def test_spmm_multihead_and_mean_heads(graphs):
    rng = np.random.default_rng(6)
    att = graphs.padded(rng.uniform(size=(graphs.nv, H)).astype(F32))
    v = rng.normal(size=(N, H, 5)).astype(F32)
    x = rng.normal(size=(N, D)).astype(F32)
    want = j_spmm_multihead(graphs.jg, jnp.asarray(att), jnp.asarray(v))
    want_mean = j_spmm_mean_heads(graphs.jg, jnp.asarray(att),
                                      jnp.asarray(x))
    tatt = torch.tensor(att, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    got = tspmm.spmm_multihead(graphs.tg, tatt, tv)
    assert got.shape == (N, H, 5) and _rel(got, want) < 1e-5
    assert _rel(tspmm.spmm_mean_heads(graphs.tg, tatt, torch.tensor(x)),
                want_mean) < 1e-5
    w = rng.normal(size=(N, H, 5)).astype(F32)
    ga, gv = jax.grad(lambda a, vv: jnp.sum(
        j_spmm_multihead(graphs.jg, a, vv) * w), argnums=(0, 1))(
            jnp.asarray(att), jnp.asarray(v))
    torch.sum(got * torch.tensor(w)).backward()
    assert _rel(tatt.grad[:graphs.nv], np.asarray(ga)[:graphs.nv]) < 1e-5
    assert _rel(tv.grad, gv) < 1e-5


def _block_pair(graphs, seed=3, **kw):
    """init_block parameters (attention leaves redrawn) in both packages."""
    jcfg, tcfg = _cfgs(**kw)
    bp = jax.tree.map(np.asarray,
                      jblocks.init_block(jax.random.PRNGKey(1), jcfg, D))
    bp["func"] = _func_params(jcfg, seed) if jcfg.function != "laplacian" \
        else bp["func"]
    rng = np.random.default_rng(seed + 10)
    if "att" in bp:
        for m in ("Q", "K"):
            bp["att"][m]["w"] = (0.3 * rng.normal(
                size=bp["att"][m]["w"].shape)).astype(F32)
    block = tblocks.ODEBlock(tcfg, D)
    sd = params_from_jax(bp)
    assert set(sd) == set(block.state_dict())
    block.load_state_dict(sd)
    x = rng.normal(size=(N, D)).astype(F32)
    return jcfg, tcfg, bp, block, x


def test_mixed_block_aux(graphs):
    """The mixed block's frozen weights mean_h(att) (1 - sigmoid(gamma)) +
    weight sigmoid(gamma), and their gradient in gamma and Q."""
    jcfg, tcfg, bp, block, x = _block_pair(graphs, function="laplacian",
                                           block="mixed")
    bp["gamma"] = np.array([0.4], F32)
    block.load_state_dict(params_from_jax(bp))
    assert "att" in bp and block.gamma.shape == (1,)
    w = np.random.default_rng(8).normal(size=graphs.tg.capacity).astype(F32)

    def jloss(p):
        aux, _ = jblocks.build_aux(p, jcfg, graphs.jg, jnp.asarray(x), True)
        return jnp.sum(aux.attention * w), aux.attention

    (_, want), gp = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, bp))
    aux, keep = tblocks.build_aux(block, tcfg, graphs.tg, torch.tensor(x),
                                  True)
    assert keep is None and _rel(aux.attention, want) < 1e-5
    torch.sum(aux.attention * torch.tensor(w)).backward()
    assert _rel(block.gamma.grad, gp["gamma"]) < 1e-4
    assert _rel(block.att.Q.w.grad, gp["att"]["Q"]["w"]) < 1e-4


@pytest.mark.parametrize("function", ["transformer", "GAT"])
def test_hard_attention_over_a_function_layer(graphs, function):
    """No block attention layer: the function's own layer scores the edges
    under no-grad, the keep mask and the renormalised weights agree, and
    the training solve on the re-masked graph agrees with the JAX
    package's (value 1e-4 of scale after an euler solve; x's gradient)."""
    jcfg, tcfg, bp, block, x = _block_pair(
        graphs, function=function, block="hard_attention",
        square_plus=function == "transformer", att_samp_pct=0.6,
        method="euler", step_size=0.5, time=1.0)
    assert "att" not in bp and not hasattr(block, "att")
    jpj = jax.tree.map(jnp.asarray, bp)
    jaux, jg2 = jblocks.build_aux(jpj, jcfg, graphs.jg, jnp.asarray(x), True)
    aux, keep = tblocks.build_aux(block, tcfg, graphs.tg, torch.tensor(x),
                                  True)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jg2.mask))
    assert 0 < int(keep.sum()) < graphs.nv
    assert _rel(aux.attention, jaux.attention) < 1e-5
    assert not aux.attention.requires_grad
    # eval: the full head mean, no mask
    jaux_e, _ = jblocks.build_aux(jpj, jcfg, graphs.jg, jnp.asarray(x), False)
    aux_e, keep_e = tblocks.build_aux(block, tcfg, graphs.tg,
                                      torch.tensor(x), False)
    assert keep_e is None and _rel(aux_e.attention, jaux_e.attention) < 1e-5

    def jloss(xx):
        z, _, _ = jblocks.block_forward(jpj, jcfg, graphs.jg, xx, True)
        return jnp.sum(z * z), z

    (_, zj), gx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    z, _ = tblocks.block_forward(block, tcfg, graphs.tg, tx, True)
    torch.sum(z * z).backward()
    assert _rel(z, zj) < 1e-4 and _rel(tx.grad, gx) < 1e-4


def test_adjoint_leaf_order_of_the_gat_function():
    """The continuous adjoint's augmented state holds the function's
    leaves in the JAX package's flattening order: the inert probe, alpha,
    W, Wout, a, beta (capitals sort first)."""
    jcfg, tcfg = _cfgs(function="GAT")
    jp = jfunctions.init_func_params(jax.random.PRNGKey(0), jcfg, D)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jp)]
    assert paths == ["['adjoint_nfe_probe']", "['alpha_train']",
                     "['att']['W']", "['att']['Wout']", "['att']['a']",
                     "['beta_train']"]
    func = tfunctions.ODEFunc(tcfg, D)
    inert = torch.zeros(())
    leaves = tfunctions.func_tensors(func, inert)
    want = [inert, func.alpha_train, func.att.W, func.att.Wout, func.att.a,
            func.beta_train]
    assert len(leaves) == len(want)
    assert all(a is b for a, b in zip(leaves, want))
    back = tfunctions.func_from_tensors(func, leaves)
    assert back.att.W is func.att.W and back.att.a is func.att.a
    assert back.alpha_train is func.alpha_train
    assert back.beta_train is func.beta_train


# ---------------------------------------------------------------------------
# three epochs
# ---------------------------------------------------------------------------

SMALL = dict(hidden_dim=16, attention_dim=16, heads=4, input_dropout=0.0,
             dropout=0.0, epoch=4)
GRAND_NL = dict(function="transformer", block="constant",
                attention_norm_idx=0, adjoint=False)
# The Cora row leaves tol_scale_adjoint at 1: a backward rtol of 1e-7, below
# float32's resolution, where the error estimate is rounding noise and the
# accept/reject sequence differs between any two orders of summation (the
# backward NFE of the GAT function changes with the order of one dot
# product within either package). The adjoint run therefore takes rtol
# 1e-5, where the sequence is the trajectory's.
RUNS = {
    "squareplus": dict(GRAND_NL),
    "gat": dict(GRAND_NL, function="GAT", square_plus=False),
    "gat-adjoint": dict(GRAND_NL, function="GAT", square_plus=False,
                        adjoint=True, adjoint_method="dopri5", time=4.0,
                        tol_scale_adjoint=100.0),
    "mixed": dict(block="mixed", adjoint=False),
}


def _redraw_qk(att, rng):
    for k in ("Q", "K"):    # off the 1e-5 constant init: nonuniform attention
        att[k]["w"] = (0.3 * rng.normal(size=att[k]["w"].shape)).astype(F32)


@pytest.fixture(scope="module", params=sorted(RUNS))
def three_epochs(request):
    """Three epochs (training steps) of each package's Trainer on the
    Cora-stand-in config at reduced width, from one converted init, dropout
    off: per epoch (loss, forward NFE, backward NFE)."""
    kw = dict(SMALL, **RUNS[request.param])
    jcfg, tcfg = j_best["Cora"].replace(**kw), best_params["Cora"].replace(**kw)
    data = dict(num_nodes=60, num_classes=3, num_features=10, seed=4,
                edge_pad_multiple=32, num_val=20)
    jd, td = j_sbm(**data), make_sbm_dataset(**data)
    jm = JEarly(jcfg, 10, 3, jd.graph)
    params, state = jm.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(8)
    params = jax.tree.map(np.asarray, params)
    if jcfg.function == "transformer":
        _redraw_qk(params["block"]["func"]["att"], rng)
    if "att" in params["block"]:
        _redraw_qk(params["block"]["att"], rng)
    tm = GNNEarlyModel(tcfg, 10, 3, td.graph)
    sd = params_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
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
    for _ in range(3):
        loss, st = trainer.train_step(td.x, td.y, td.train_mask)
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

    def test_params_round_trip(self, three_epochs):
        """params_to_jax inverts params_from_jax over the GAT leaves, the
        mixed block's gamma and a block without an attention layer."""
        _, _, tm, params = three_epochs
        back = params_to_jax(tm.state_dict())
        flat_a = jax.tree_util.tree_leaves_with_path(params)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            assert np.asarray(leaf).shape == flat_b[path].shape
        again = params_from_jax(back)
        for k, v in tm.state_dict().items():
            assert torch.equal(again[k], v)


# ---------------------------------------------------------------------------
# the CLI and what is supported
# ---------------------------------------------------------------------------

def test_cli_flags_of_the_slice():
    args = run.build_parser().parse_args(
        ["--dataset", "Cora", "--use_best_params", "--function", "GAT",
         "--no-square_plus", "--block", "mixed", "--mix_features",
         "--reweight_attention", "--leaky_relu_slope", "0.3"])
    cfg = run.config_from_args(args)
    assert cfg == best_params["Cora"].replace(
        function="GAT", square_plus=False, block="mixed", mix_features=True,
        reweight_attention=True, leaky_relu_slope=0.3)
    check_supported(cfg)


@pytest.mark.parametrize("override", [
    dict(), dict(function="GAT", square_plus=False),
    dict(function="GAT", mix_features=True), dict(mix_features=True),
    dict(reweight_attention=True), dict(block="hard_attention"),
    dict(block="mixed"), dict(function="GAT", block="hard_attention"),
    dict(function="laplacian", block="mixed")])
def test_newly_supported_configurations(override):
    check_supported(best_params["Cora"].replace(**dict(
        dict(function="transformer", block="constant",
             attention_norm_idx=0), **override)))


def test_cli_main_runs_gat(tmp_path, capsys):
    """run.main on the tuned Cora row as the GAT function at reduced width
    over the stand-in, with the early-stop eval after its epoch."""
    cfg = best_params["Cora"].replace(
        function="GAT", block="constant", attention_norm_idx=0,
        square_plus=False, hidden_dim=8, attention_dim=8, heads=2, epoch=2)
    res = run.main(cfg, data_dir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert out.count("Epoch: ") == 1 and "best val accuracy" in out
    assert all(math.isfinite(log.loss) and log.fwd_nfe > 0
               for log in res.logs)
