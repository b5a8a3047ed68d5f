"""The PyTorch port's bfloat16 payload and state on the composed routes,
against the JAX package (ROADMAP Queue 2 B1 items 4 and 6): K10
``dual_scatter`` and K11 ``dual_gather`` on a bfloat16 column table; the
composed transformer RHS (squareplus, reweighted attention, a re-masked
graph, the exact re-solve of exp_kernel) and the GAT RHS with k and s_dst
from that table; the composed routes without the fused aggregate
(``mix_features``, ``fused_attention_agg=False``, the squareplus over
columns), which apply no payload; a forced exp_kernel poison through
``block_forward``; three training steps of GAT on the Cora stand-in and of
GRAND-nl squareplus; the blocked engine; K20 ``row_gather`` writing
bfloat16 rows and the P6 pair over a bfloat16 payload.

References, each at its stated tolerance of the reference array's scale:

* the JAX package's float32 XLA path with the same casts (1e-5): its own
  ``make_rhs`` on the CPU (values) and a jnp composition of its ``_scores``
  and ``_fused_normalized_aggregate`` in which x[col], Kw, kb and k (GAT:
  W folded with a_dst, and s_dst) are rounded to bfloat16 as the JAX
  package rounds them and every cast is the identity in the gradient, as
  the port's kernels take it (gradients; the XLA path's own autodiff
  rounds the cotangents to bfloat16 and sums them there);
* the Pallas interpret path (3e-2): ``stripe_scatter_add2`` and
  ``_stripe_gather2_call`` also round u, the products u * x[col] and the
  cotangents to bfloat16;
* under the bfloat16 state, one RHS output cast to bfloat16 within one
  bf16 step of the JAX package's (its ``_scores`` computes the norms of the
  cosine and pearson families on the bf16 k, the port in float32).

On the CPU every wrapper runs its plain version, which ``chip_smoke.py``
holds the kernels to on the card. Inputs come from seeded numpy
generators and go through both packages.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.models import functions as jfunctions
from graph_neural_pde_tpu.models.attention import _scores as j_scores
from graph_neural_pde_tpu.models.gnn import GNNModel as JModel
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.ops.pallas import stripe as jstripe
from graph_neural_pde_tpu.ops.scatter import segment_softmax as j_softmax
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import (GRAND_NL_BENCH, Config,
                                               best_params)
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.data.synthetic import (
    make_random_graph_dataset, make_sbm_dataset)
from graph_neural_pde_tpu_torch.kernels.shard_scatter import (ScatterPlan,
                                                              shard_scatter)
from graph_neural_pde_tpu_torch.models import blocks as tblocks
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.gnn import GNNModel
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.training.train import Trainer

N, D, ATT, H = 64, 12, 16, 4
SBM = dict(num_nodes=N, num_classes=3, num_features=6, seed=2,
           edge_pad_multiple=32, num_val=16)
NL = dict(function="transformer", block="constant", attention_norm_idx=0,
          square_plus=True, self_loop_weight=1.0, add_source=True,
          hidden_dim=D, attention_dim=ATT, heads=H,
          rhs_payload_dtype="bfloat16")
BF16 = jnp.bfloat16
F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The tensors here are small, and the suite runs several workers at
    once: torch's intra-op thread pool only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    return JConfig(**NL).replace(**kw), Config(**NL).replace(**kw)


def _rel(got, want, scale=None):
    """Largest error relative to ``scale``, by default the reference
    array's largest entry."""
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
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


def _one_bf16_step(got, want):
    """``got`` (a tensor) within one bf16 step of ``want``'s scale."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    err = np.abs(got.float().detach().numpy() - want).max()
    assert err <= ulp, (err, ulp)


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
        assert self.tg.rev is not None
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
    out = np.zeros((a.shape[0], max(8, H)), a.dtype)
    out[:, :H] = a
    return out


# ---------------------------------------------------------------------------
# K10 and K11 on the bfloat16 column table
# ---------------------------------------------------------------------------

class TestDualKernels:
    def test_aggregate_matches_xla_composition(self, graphs, operands):
        """The composed RHS's aggregate (``_fused_normalized_aggregate``:
        K10, its gradient K11) over the bf16 table against the JAX
        function's XLA branch fed ``x_b[col]`` with the cast the identity
        in the gradient: values and both gradients at 1e-5."""
        u, x, _, _ = operands
        jcfg, tcfg = _cfgs()
        probe = np.random.default_rng(3).normal(size=(N, D)).astype(F32)
        u_pad = graphs.padded(u)
        jg = graphs.jg

        def jloss(uu, xx):
            out = jfunctions._fused_normalized_aggregate(
                jcfg, jg, uu, _st(xx)[jg.col], xx, None)
            return jnp.sum(out * probe), out

        (_, want), (gu, gx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(u_pad),
                                                 jnp.asarray(x))
        tu = torch.tensor(u_pad, requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)
        out = tfunctions._fused_normalized_aggregate(tcfg, graphs.tg, tu, tx,
                                                     torch.bfloat16)
        torch.sum(out * torch.tensor(probe)).backward()
        assert out.dtype == tx.grad.dtype == torch.float32
        assert _rel(out, want) < 1e-5
        assert _rel(tu.grad[:graphs.nv], np.asarray(gu)[:graphs.nv]) < 1e-5
        assert _rel(tx.grad, gx) < 1e-5
        # the table is what differs from the float32 run
        f32 = tfunctions._fused_normalized_aggregate(tcfg, graphs.tg, tu,
                                                     tx.detach())
        assert _rel(out, f32.detach()) > 1e-4

    def test_bf16_state_gradient_comes_back_in_bf16(self, graphs, operands):
        """A bfloat16 x is the table itself; its gradient is the float32
        sum cast once to bfloat16."""
        u, x, ct_num, ct_den = operands
        tx = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
        num, den = kernels.dual_scatter_add(graphs.tg,
                                            torch.tensor(graphs.padded(u)),
                                            tx)
        assert num.dtype == den.dtype == torch.float32
        (torch.sum(num * torch.tensor(ct_num))
         + torch.sum(den * torch.tensor(ct_den))).backward()
        _, dx = kernels.dual_gather(*graphs.csr(), graphs.tg.rev,
                                    torch.tensor(graphs.padded(u)),
                                    tx.detach(), torch.tensor(ct_num),
                                    torch.tensor(ct_den))
        assert tx.grad.dtype == torch.bfloat16
        assert torch.equal(tx.grad, dx.to(torch.bfloat16))

    def test_dual_scatter_matches_pallas_interpret(self, graphs, operands):
        """K10 on the bf16 table against ``stripe_scatter_add2`` in
        interpret mode over the JAX package's bf16 payload (its vals
        ``u_b * x_b[col]`` and its one-hot in bfloat16): 3e-2."""
        u, x, _, _ = operands
        xb = jnp.asarray(x).astype(BF16)
        ub = jnp.asarray(u).astype(BF16)
        vals = (ub[:, :, None] * xb[graphs.col][:, None, :]).reshape(-1, H * D)
        vals_s = jnp.zeros((graphs.plan.capacity, H * D), BF16).at[
            graphs.slots].set(vals)
        u_s = jnp.zeros((graphs.plan.capacity, max(8, H)), BF16).at[
            graphs.slots, :H].set(ub)
        num_j, den_j = jstripe.stripe_scatter_add2(graphs.plan, vals_s, u_s)
        num, den = kernels.dual_scatter(*graphs.csr(),
                                        torch.tensor(graphs.padded(u)),
                                        torch.tensor(x).to(torch.bfloat16))
        assert _rel(num, num_j) < 3e-2
        assert _rel(den, np.asarray(den_j)[:, :H]) < 3e-2

    def test_dual_gather_matches_pallas_interpret(self, graphs, operands):
        """K11 on the bf16 table against ``_stripe_gather2_call`` in
        interpret mode (its bf16 one-hot: the cotangents rounded) composed
        with the products the JAX package forms after it: 3e-2."""
        u, x, ct_num, ct_den = operands
        gv, gu = jstripe._stripe_gather2_call(
            graphs.plan, jnp.asarray(ct_num), jnp.asarray(_pad_heads(ct_den)))
        gv = np.asarray(gv)[graphs.slots].reshape(-1, H, D)    # CSR order
        gu = np.asarray(gu)[graphs.slots][:, :H]
        ub = _round(u)
        du_want = np.einsum("ehd,ed->eh", gv, _round(x)[graphs.col]) + gu
        dx_want = np.zeros((N, D), F32)
        np.add.at(dx_want, graphs.col, np.einsum("eh,ehd->ed", ub, gv))
        du, dx = kernels.dual_gather(
            *graphs.csr(), graphs.tg.rev, torch.tensor(graphs.padded(u)),
            torch.tensor(x).to(torch.bfloat16), torch.tensor(ct_num),
            torch.tensor(ct_den))
        assert du.dtype == dx.dtype == torch.float32
        assert _rel(du[:graphs.nv], du_want) < 3e-2
        assert not du[graphs.nv:].any()
        assert _rel(dx, dx_want) < 3e-2


# ---------------------------------------------------------------------------
# K20 writing bfloat16 rows, and the P6 pair over a bfloat16 payload
# ---------------------------------------------------------------------------

def test_row_gather_writes_rounded_rows():
    """K20's bf16 mode: ``bf16(ct[row])`` bit for bit over the valid
    prefix, zero after it; the P6 pair over a bf16 payload sums it in
    float32 (K1 in table mode) and hands back that gradient."""
    rng = np.random.default_rng(9)
    n, d, e = 30, 10, 90
    row = np.sort(rng.integers(0, n, e))
    plan = ScatterPlan.from_rows(row, n)
    ct = torch.tensor(rng.normal(size=(n, d)).astype(F32))
    pad_row = torch.cat([plan.row, torch.zeros(5, dtype=torch.int32)])
    out = kernels.row_gather(plan.rowptr, pad_row, ct, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (e + 5, d)
    want = torch.tensor(_round(ct.numpy()[row]))
    assert torch.equal(out[:e].float(), want)
    assert not out[e:].float().any()
    vals = torch.tensor(rng.normal(size=(e, d)).astype(F32)).to(
        torch.bfloat16).requires_grad_(True)
    s = shard_scatter(plan, vals)
    assert s.dtype == torch.float32
    sums = np.zeros((n, d), np.float64)
    np.add.at(sums, row, vals.detach().float().numpy())
    assert _rel(s, sums) < 1e-6
    torch.sum(s * ct).backward()
    assert vals.grad.dtype == torch.bfloat16
    assert torch.equal(vals.grad.float(), want)
    with pytest.raises(TypeError):
        kernels.row_gather(plan.rowptr, plan.row, ct, out_dtype=torch.float16)


# ---------------------------------------------------------------------------
# make_rhs on the routes B1 item 4 opened
# ---------------------------------------------------------------------------

ROUTES = {
    "squareplus": dict(),
    "squareplus-cosine": dict(attention_type="cosine_sim"),
    "reweighted": dict(square_plus=False, reweight_attention=True),
    "gat": dict(function="GAT", square_plus=False),
    "hard-attention": dict(square_plus=False, masked=True),
    "gat-hard-attention": dict(function="GAT", square_plus=False,
                               masked=True),
    "exact-exp_kernel": dict(square_plus=False, attention_type="exp_kernel",
                             exact=True),
    # no payload on these, in both packages
    "mix_features": dict(mix_features=True),
    "unfused": dict(square_plus=False, fused_attention_agg=False),
    "column-squareplus": dict(attention_norm_idx=1),
}
PAYLOAD_ROUTES = ("squareplus", "squareplus-cosine", "reweighted", "gat",
                  "hard-attention", "gat-hard-attention", "exact-exp_kernel")


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
    """One route in both packages from converted weights, over the graph
    re-masked to two thirds of its edges where the route is hard
    attention's."""

    def __init__(self, graphs, name, state="float32"):
        kw = dict(ROUTES[name])
        self.exact = kw.pop("exact", False)
        masked = kw.pop("masked", False)
        self.jcfg, self.tcfg = _cfgs(dtype=state, method="rk4", **kw)
        self.payload = name in PAYLOAD_ROUTES
        self.jp = _func_params(self.jcfg)
        self.func = tfunctions.ODEFunc(self.tcfg, D)
        self.func.load_state_dict(params_from_jax(self.jp))
        rng = np.random.default_rng(5)
        self.x = rng.normal(size=(N, D)).astype(F32)
        self.x0 = rng.normal(size=(N, D)).astype(F32)
        self.probe = rng.normal(size=(N, D)).astype(F32)
        self.jg, self.tg = graphs.jg, graphs.tg
        if masked:
            keep = np.asarray(graphs.jg.mask).copy()
            keep[np.random.default_rng(2).choice(graphs.nv, graphs.nv // 3,
                                                 replace=False)] = False
            self.jg = graphs.jg.with_edges(graphs.jg.row, graphs.jg.col,
                                           graphs.jg.weight,
                                           jnp.asarray(keep))
            self.tg = graphs.tg.with_mask(torch.tensor(keep))

    def jax_rhs(self, x):
        rhs = jfunctions.make_rhs(self.jcfg, self.jg,
                                  exact_softmax=self.exact)
        aux = jfunctions.FuncAux(None, jnp.asarray(self.x0), self.jg.weight)
        return rhs(jax.tree.map(jnp.asarray, self.jp), aux, 0.0, x)

    def jax_grads(self):
        """The gradients of sum(f * probe) in the parameters and x: of the
        JAX ``make_rhs`` where the route takes no payload, else of
        :meth:`composition`."""
        if self.payload:
            fn = self.composition
        else:
            def fn(p, x):
                rhs = jfunctions.make_rhs(self.jcfg, self.jg,
                                          exact_softmax=self.exact)
                aux = jfunctions.FuncAux(None, jnp.asarray(self.x0),
                                         self.jg.weight)
                return rhs(p, aux, 0.0, x)
        gp, gx = jax.grad(lambda p, x: jnp.sum(fn(p, x) * self.probe),
                          (0, 1))(jax.tree.map(jnp.asarray, self.jp),
                                  jnp.asarray(self.x))
        return params_from_jax(jax.tree.map(np.asarray, gp)), gx

    def composition(self, p, x):
        """The RHS of the composed route over the bf16 column table as the
        JAX package computes it, each cast the identity in the gradient:
        k (GAT: s_dst) takes the value of the package's rounded bf16
        product from these weights, its gradient that of the product of
        the rounded operands."""
        cfg, jg = self.jcfg, self.jg
        att, xb = p["att"], _st(x)
        d_k = ATT // H
        if cfg.function == "GAT":
            w = att["W"]
            hh = (x @ w).reshape(-1, H, d_k)
            a_vec = att["a"][:, 0]
            s_src = jnp.einsum("nhd,d->nh", hh, a_vec[:d_k])
            w_dst = jnp.einsum("dhf,f->dh", w.reshape(D, H, d_k), a_vec[d_k:])
            ja = jax.tree.map(jnp.asarray, self.jp["att"])
            w_val = np.asarray(jnp.einsum(
                "dhf,f->dh", ja["W"].reshape(D, H, d_k), ja["a"][d_k:, 0]))
            val = _round((_round(self.x).astype(np.float64)
                          @ _round(w_val).astype(np.float64)).astype(F32))
            lin = xb @ _st(w_dst)
            s_dst = lin + jax.lax.stop_gradient(val - lin)
            prods = jax.nn.leaky_relu(s_src[jg.row] + s_dst[jg.col],
                                      cfg.leaky_relu_slope)
        else:
            kw, kb = att["K"]["w"], att["K"]["b"]
            kw_val, kb_val = (self.jp["att"]["K"][k] for k in ("w", "b"))
            prod = (_round(self.x).astype(np.float64)
                    @ _round(kw_val).astype(np.float64)).astype(F32)
            val = _round(_round(prod) + _round(kb_val))
            lin = xb @ _st(kw) + _st(kb)
            k = lin + jax.lax.stop_gradient(val - lin)
            q = x @ att["Q"]["w"] + att["Q"]["b"]
            prods = j_scores(cfg, q[jg.row].reshape(-1, H, d_k),
                             k[jg.col].reshape(-1, H, d_k), d_k, att)
            if cfg.reweight_attention:
                prods = prods * jg.weight[:, None]
        m = jg.mask[:, None]
        gmax = jnp.max(jnp.where(m, prods, -jnp.inf))
        s = prods - gmax
        if self.exact:
            u = jnp.where(m, j_softmax(prods, jg.row, N, mask=jg.mask), 0.0)
        elif cfg.square_plus and cfg.function != "GAT":
            u = jnp.where(m, (s + jnp.sqrt(s * s + 4.0)) / 2.0, 0.0)
        else:
            u = jnp.where(m, jnp.exp(s), 0.0)
        ax = jfunctions._fused_normalized_aggregate(cfg, jg, u, xb[jg.col], x)
        f = jfunctions._alpha(cfg, p) * (ax - x)
        aux = jfunctions.FuncAux(None, jnp.asarray(self.x0), jg.weight)
        return jfunctions._source(cfg, p, f, aux)

    def port(self, x):
        rhs = tfunctions.make_rhs(self.tcfg, self.tg,
                                  exact_softmax=self.exact)
        aux = tfunctions.FuncAux(None, torch.tensor(self.x0), self.tg.weight)
        self.func.zero_grad()
        return rhs(self.func, aux, 0.0, x)


def _hold_grads(got, want, gx_got, gx_want):
    """Every parameter leaf within 1e-5 of the largest leaf gradient's
    scale and, unless its gradient is below 1e-3 of that (K's bias under
    the softmax: rounding noise), within 1e-4 of its own (the float32
    tests' bound: K's bias under squareplus takes a remainder of
    cancelling sums, where the order of float32 sums shows); a leaf the
    RHS does not read at exactly 0; x's within 1e-5 of its scale."""
    top = max(float(v.abs().max()) for v in want.values())
    for k, wv in want.items():
        if not wv.any():
            assert got[k] is None or not got[k].any(), k
            continue
        err, scale = float((got[k] - wv).abs().max()), float(wv.abs().max())
        assert err <= 1e-5 * top, (k, err, top)
        assert scale < 1e-3 * top or err <= 1e-4 * scale, (k, err, scale)
    assert _rel(gx_got, gx_want) < 1e-5


@pytest.mark.parametrize("name", sorted(ROUTES))
class TestRhs:
    def test_payload_value(self, graphs, name, spy):
        """make_rhs under the bf16 payload against the JAX package's
        ``make_rhs`` (eager, its CPU XLA path): 1e-5. The routes with the
        fused aggregate read the bf16 table in K10 (the others, no
        payload, in neither package)."""
        c = RhsCase(graphs, name)
        want = c.jax_rhs(jnp.asarray(c.x))
        with torch.no_grad():
            got = c.port(torch.tensor(c.x))
        assert np.isfinite(np.asarray(want)).all()
        assert _rel(got, want) < 1e-5
        tables = {s[1] for s in spy if s[0] == "dual_scatter"}
        assert tables == ({True} if name in PAYLOAD_ROUTES else set())

    def test_payload_gradients(self, graphs, name):
        """The gradients of sum(f * probe) in every parameter and in x
        against the JAX composition with the same forward casts (the
        payload routes) or the JAX ``make_rhs`` (the others): see
        ``_hold_grads``."""
        c = RhsCase(graphs, name)
        want, gx_want = c.jax_grads()
        x = torch.tensor(c.x, requires_grad=True)
        torch.sum(c.port(x) * torch.tensor(c.probe)).backward()
        got = {k: p.grad for k, p in c.func.named_parameters()}
        assert set(got) == set(want)
        _hold_grads(got, want, x.grad, gx_want)

    def test_bf16_state_within_one_step(self, graphs, name):
        """One RHS evaluation on a bfloat16 state, cast to the state's
        dtype as the solver casts it: within one bf16 step at the output's
        scale of the JAX package's."""
        c = RhsCase(graphs, name, state="bfloat16")
        xb = jnp.asarray(c.x).astype(BF16)
        want = c.jax_rhs(xb).astype(BF16)
        with torch.no_grad():
            got = c.port(torch.tensor(c.x).to(torch.bfloat16))
        _one_bf16_step(got.to(torch.bfloat16), want)


@pytest.fixture
def spy(monkeypatch):
    """The K10 / K11 wrappers' calls in order, each as (name, whether it
    read a bfloat16 table): on the CPU no launch is counted, so the route
    is read from the calls."""
    seen = []
    ds = sys.modules["graph_neural_pde_tpu_torch.kernels.dual_scatter"]

    def wrap(name):
        real = getattr(ds, name)

        def call(*a, **kw):
            x = a[4] if name == "dual_scatter" else a[5]
            seen.append((name, x.dtype == torch.bfloat16))
            return real(*a, **kw)

        monkeypatch.setattr(ds, name, call)

    for name in ("dual_scatter", "dual_gather"):
        wrap(name)
    return seen


# ---------------------------------------------------------------------------
# the forced exp_kernel poison through block_forward
# ---------------------------------------------------------------------------

# z against the JAX package's re-solved block, of z's scale: the payload at
# the float32 poison tests' 1e-4, the bf16 state at one bf16 step
POISON_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}


@pytest.mark.parametrize("state,training", [
    ("float32", False), ("float32", True), ("bfloat16", True)])
def test_exp_kernel_poison_resolves(graphs, state, training, monkeypatch,
                                    spy):
    """exp_kernel scores far outside exp's range (output_var 20): the fast
    solve poisons, ``block_forward`` re-solves with the exact softmax,
    which composes (K3, then K10/K11 on the bf16 column table), and comes
    back finite, loss and gradients, against the JAX package's re-solved
    block (``POISON_TOL``; run eagerly: under jit XLA drops the bf16
    rounding of k_e where the float32 state casts it straight back)."""
    jcfg, tcfg = _cfgs(square_plus=False, attention_type="exp_kernel",
                       dtype=state, method="rk4", step_size=0.5, time=1.0)
    jp = _func_params(jcfg)
    jp["att"]["output_var"] = np.array([20.0], F32)
    jp["att"]["lengthscale"] = np.array([100.0], F32)
    block = tblocks.ODEBlock(tcfg, D)
    block.func.load_state_dict(params_from_jax(jp))
    calls = []
    real = tfunctions.make_rhs
    monkeypatch.setattr(
        tblocks, "make_rhs",
        lambda *a, **kw: calls.append(kw["exact_softmax"]) or real(*a, **kw))
    x_np = np.random.default_rng(7).normal(size=(N, D)).astype(F32)
    x = torch.tensor(x_np, requires_grad=training)
    z, _ = tblocks.block_forward(block, tcfg, graphs.tg, x, training)
    assert calls == [False, True]
    assert ("dual_scatter", True) in spy
    with jax.disable_jit():
        zj, _, _ = jblocks.block_forward(
            {"func": jax.tree.map(jnp.asarray, jp)}, jcfg, graphs.jg,
            jnp.asarray(x_np), training)
    assert torch.isfinite(z).all()
    assert _rel(z, zj) <= POISON_TOL[state]
    if training:
        del spy[:]
        torch.sum(z * torch.tensor(x_np)).backward()
        assert torch.isfinite(x.grad).all()
        assert all(torch.isfinite(p.grad).all()
                   for p in block.parameters() if p.grad is not None)
        assert ("dual_gather", True) in spy


# ---------------------------------------------------------------------------
# three training steps
# ---------------------------------------------------------------------------

SMALL = dict(hidden_dim=16, attention_dim=16, heads=4, input_dropout=0.0,
             dropout=0.0, method="rk4", step_size=1.0, time=3.0,
             adjoint=False, rhs_payload_dtype="bfloat16")
BENCH_SIZES = dict(num_nodes=300, num_edges=900, hidden=16, attention_dim=16,
                   heads=2, seed=3)


def _gat_cora_steps(state):
    """Three optimizer steps of the tuned Cora row as GAT at reduced width
    on rk4, over the Cora stand-in, in both packages from one converted
    init: per step (loss, forward NFE, backward NFE)."""
    kw = dict(SMALL, function="GAT", block="constant", attention_norm_idx=0,
              square_plus=False, dtype=state)
    jcfg, tcfg = j_best["Cora"].replace(**kw), best_params["Cora"].replace(
        **kw)
    data = dict(num_nodes=2708, num_classes=7, num_features=32, seed=4,
                edge_pad_multiple=1024, num_val=500)
    jd, td = j_sbm(**data), make_sbm_dataset(**data)
    jm = JEarly(jcfg, 32, 7, jd.graph)
    params, state_j = jm.init(jax.random.PRNGKey(7))
    params = jax.tree.map(np.asarray, params)
    tm = GNNEarlyModel(tcfg, 32, 7, td.graph)
    tm.load_state_dict(params_from_jax(params))
    jp, jt = jax.tree.map(jnp.asarray, params), JTrainer(jm)
    opt_state, jlogs = jt.optimizer.init(jp), []
    for step in range(3):
        jp, state_j, opt_state, loss, st = jt._train_step(
            jp, state_j, opt_state, jd.x, None, jd.y, jd.train_mask,
            jax.random.PRNGKey(step))
        jlogs.append((float(loss), int(st["nfe"]),
                      int(st["accepted"]) * jt._bwd_evals_per_step))
    trainer, tlogs = Trainer(tm), []
    for _ in range(3):
        loss, st = trainer.train_step(td.x, td.y, td.train_mask)
        tlogs.append((loss, st["nfe"], st["bwd_nfe"]))
    return jlogs, tlogs


def _squareplus_bench_steps(state):
    """Three optimizer steps of ``GRAND_NL_BENCH`` with squareplus at a
    small width over the bench's random graph in both packages, from one
    converted init (Q and K drawn off their near-constant init)."""
    tcfg = GRAND_NL_BENCH.replace(
        hidden_dim=BENCH_SIZES["hidden"],
        attention_dim=BENCH_SIZES["attention_dim"],
        heads=BENCH_SIZES["heads"], dtype=state, square_plus=True)
    jcfg = JConfig(**dataclasses.asdict(tcfg))
    _, _, _, jx, jg, nf, nc = jbench.build_benchmark(**BENCH_SIZES)
    data = make_random_graph_dataset(
        BENCH_SIZES["num_nodes"], BENCH_SIZES["num_edges"], num_features=128,
        num_classes=40, seed=BENCH_SIZES["seed"], edge_pad_multiple=1024)
    jm = JModel(jcfg, nf, nc, jg)
    params, state_j = jm.init(jax.random.PRNGKey(7))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(8)
    for k in ("Q", "K"):
        w = params["block"]["func"]["att"][k]["w"]
        params["block"]["func"]["att"][k]["w"] = \
            (0.3 * rng.normal(size=w.shape)).astype(F32)
    n = BENCH_SIZES["num_nodes"]
    y = rng.integers(0, nc, n)
    mask = rng.random(n) < 0.5
    jp, jt = jax.tree.map(jnp.asarray, params), JTrainer(jm)
    opt_state, jlogs = jt.optimizer.init(jp), []
    for step in range(3):
        jp, state_j, opt_state, loss, st = jt._train_step(
            jp, state_j, opt_state, jx, None, jnp.asarray(y),
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


@pytest.mark.parametrize("state,rtol", [("float32", 1e-4),
                                        ("bfloat16", 1e-3)])
@pytest.mark.parametrize("run", [_gat_cora_steps, _squareplus_bench_steps],
                         ids=["gat-cora", "squareplus-bench"])
def test_three_steps(run, state, rtol, spy):
    """Losses at rtol 1e-4 under the payload (the JAX package's XLA
    gradients accumulate their cotangents in bfloat16, the port's in
    float32) and 1e-3 under the bf16 rk4 state (every stage sum rounds to
    bfloat16), NFE identical; K10 and K11 read the bf16 table."""
    jlogs, tlogs = run(state)
    np.testing.assert_allclose([l[0] for l in tlogs], [l[0] for l in jlogs],
                               rtol=rtol)
    assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
    assert tlogs[0][0] != tlogs[-1][0]
    assert {s for s in spy} == {("dual_scatter", True),
                                ("dual_gather", True)}


# ---------------------------------------------------------------------------
# the blocked engine: no payload, the state widened
# ---------------------------------------------------------------------------

def _blocked(state="float32", payload="float32"):
    kw = dict(spmm_impl="pallas_blocked", spmm_block_n=32, spmm_chunk=32,
              hidden_dim=D, dtype=state, rhs_payload_dtype=payload,
              method="rk4", step_size=1.0)
    return j_best["Cora"].replace(**kw), best_params["Cora"].replace(**kw)


def _blocked_rhs(tcfg, x, x0):
    g = tblocks.prepare_graph(tcfg, make_sbm_dataset(**SBM).graph)
    spmm_fn, npad = tblocks.build_spmm_engine(tcfg, g)
    func = tfunctions.ODEFunc(tcfg, D)
    with torch.no_grad():
        func.alpha_train.fill_(0.3)
        func.beta_train.fill_(0.2)
    aux = tfunctions.FuncAux(None, x0, g.weight)
    return tfunctions.make_rhs(tcfg, g, spmm_fn=spmm_fn)(func, aux, 0.0, x), \
        npad, func


def test_blocked_engine_ignores_the_payload():
    """The laplacian on the blocked engine (K15, K16) under the bf16
    payload: its run equals the float32 one bit for bit, value and
    gradients."""
    rng = np.random.default_rng(12)
    outs = []
    for payload in ("float32", "bfloat16"):
        _, tcfg = _blocked(payload=payload)
        npad = tblocks.build_spmm_engine(
            tcfg, tblocks.prepare_graph(tcfg, make_sbm_dataset(**SBM).graph)
        )[1]
        if not outs:
            x_np = rng.normal(size=(npad, D)).astype(F32)
            x_np[N:] = 0.0
        x = torch.tensor(x_np, requires_grad=True)
        f, _, func = _blocked_rhs(tcfg, x, x.detach())
        torch.sum(f * torch.tensor(x_np)).backward()
        outs.append((f.detach(), x.grad, func.alpha_train.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_blocked_engine_bf16_state_within_one_step():
    """Under the bf16 state the engine widens x before K15 (the JAX
    package's blocked kernels cast every table they read to float32):
    one RHS evaluation cast to bfloat16 within one bf16 step of the JAX
    blocked engine's in interpret mode; x's gradient comes back in
    bfloat16."""
    jcfg, tcfg = _blocked(state="bfloat16")
    jg = jblocks.prepare_graph(jcfg, j_sbm(**SBM).graph)
    jg2, jspmm = jblocks.build_spmm_engine(jcfg, jg)
    npad = jg2.num_nodes
    rng = np.random.default_rng(13)
    x_np = rng.normal(size=(npad, D)).astype(F32)
    x_np[N:] = 0.0
    p = {"alpha_train": jnp.float32(0.3), "beta_train": jnp.float32(0.2),
         "inert": jnp.float32(0.0)}
    aux = jfunctions.FuncAux(None, jnp.asarray(x_np), jg2.weight)
    want = jfunctions.make_rhs(jcfg, jg2, spmm_fn=jspmm)(
        p, aux, 0.0, jnp.asarray(x_np).astype(BF16)).astype(BF16)
    x = torch.tensor(x_np).to(torch.bfloat16).requires_grad_(True)
    f, tpad, _ = _blocked_rhs(tcfg, x, torch.tensor(x_np))
    assert tpad == npad
    _one_bf16_step(f.to(torch.bfloat16)[:N], np.asarray(
        want.astype(jnp.float32))[:N])
    torch.sum(f).backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(
        x.grad.float()).all()
