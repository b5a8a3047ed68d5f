"""The PyTorch port on directed graphs, held against the JAX package on the
CPU: the CSC view of ``Graph`` (the port of the JAX package's column plan),
the GDC and two-hop rewirings (``rewiring/gdc.py``) and the loader that
calls them, every column-side pass over the CSC view (``make_spmm``'s dx,
the column softmax and squareplus on K3/K4, K11's dx, the fused RHS's
column-plan backward ``make_fused_ax_colplan`` with K17 and its exact
route), and three training epochs of the tuned Cora row and of GRAND-nl
over a GDC-rewired stand-in.

On the CPU every kernel wrapper runs its plain version, so what is held
against the JAX package here is exactly what the kernels are held against
on the card (``chip_smoke.py``). Inputs are made with numpy from a seed and
handed to both packages.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.data.datasets import get_dataset as j_get_dataset
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.models import functions as jfunctions
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.ops import scatter as jsc
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu.ops.spmm import spmm as j_spmm
from graph_neural_pde_tpu.rewiring import gdc as jgdc
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config, best_params
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.data.datasets import get_dataset
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
from graph_neural_pde_tpu_torch.models.gnn import check_supported
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.ops import scatter as tsc
from graph_neural_pde_tpu_torch.ops.graph import dense_adjacency, make_graph
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
from graph_neural_pde_tpu_torch.rewiring import gdc as tgdc
from graph_neural_pde_tpu_torch.training.train import Trainer

SCORES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel")
N, D, ATT, H = 40, 12, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The tensors here are small, and the suite runs several workers at
    once: torch's intra-op thread pool only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    """Largest error relative to the reference array's largest entry."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _directed(seed, n=N, e=160):
    """Random directed edges, one way only (the multiset is not
    symmetric), with a duplicate edge and a node without in-edges."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e).astype(np.int32)
    c = rng.integers(1, n, e).astype(np.int32)        # nothing into node 0
    keep = r != c
    r, c = r[keep], c[keep]
    return np.concatenate([r, r[:1]]), np.concatenate([c, c[:1]]), n


def _both_prepared(row, col, n, weight=None, pad_multiple=16, **cfg_kw):
    kw = dict(function="laplacian", block="attention", self_loop_weight=1.0)
    kw.update(cfg_kw)
    jg = jblocks.prepare_graph(JConfig(**kw), j_make_graph(
        row, col, weight, num_nodes=n, pad_multiple=pad_multiple))
    tg = prepare_graph(Config(**kw), make_graph(
        row, col, weight, num_nodes=n, pad_multiple=pad_multiple))
    return jg, tg


def _valid_edges(g):
    """(row, col, weight) of a graph's valid edges as numpy arrays."""
    m = np.asarray(g.mask)
    return (np.asarray(g.row)[m], np.asarray(g.col)[m],
            np.asarray(g.weight)[m])


def _col_sets(rows, cols, n):
    return [sorted(rows[cols == c].tolist()) for c in range(n)]


def ring_graph(n):
    row = np.arange(n)
    col = (row + 1) % n
    return (np.concatenate([row, col]).astype(np.int32),
            np.concatenate([col, row]).astype(np.int32), n)


# ---------------------------------------------------------------------------
# the CSC view
# ---------------------------------------------------------------------------

class TestCscView:
    @pytest.mark.parametrize("make", [lambda: _directed(0),
                                      lambda: ring_graph(8)])
    def test_matches_the_column_plan(self, make):
        """Per column, the CSC segment holds the multiset of the JAX
        column plan's edges (``stripe.attach_col_plan``), whose order is
        the stable column sort of the row-sorted slots, as ``col_perm``'s."""
        row, col, n = make()
        jcfg = JConfig(function="laplacian", block="constant",
                       self_loop_weight=1.0, stripe_fused=True,
                       stripe_block_n=8, stripe_chunk=16,
                       stripe_chunk_auto=False)
        jg = jblocks.prepare_graph(jcfg, j_make_graph(row, col, None,
                                                      num_nodes=n))
        jg2, plan = jblocks.build_stripe_engine(jcfg, jg)
        assert plan.col_plan is not None
        cplan = plan.col_plan
        cvalid = np.asarray(cplan.valid, bool)
        ccol = (np.repeat(np.asarray(cplan.chunk_rows), cplan.chunk)
                * cplan.block_n + np.asarray(cplan.row_local))[cvalid]
        src = np.asarray(plan.col_src_slot)[cvalid]
        rslot_row = (np.repeat(np.asarray(plan.chunk_rows), plan.chunk)
                     * plan.block_n + np.asarray(plan.row_local))
        jrows = rslot_row[src]
        tg = prepare_graph(Config(function="laplacian", block="constant",
                                  self_loop_weight=1.0),
                           make_graph(row, col, num_nodes=n))
        nv = tg.num_valid
        cp = tg.colptr.numpy()
        assert cp[0] == 0 and cp[-1] == nv and np.all(np.diff(cp) >= 0)
        tcol = tg.col_by_col[:nv].numpy()
        trow = tg.row_by_col[:nv].numpy()
        np.testing.assert_array_equal(np.repeat(np.arange(n), np.diff(cp)),
                                      tcol)
        perm = tg.col_perm.numpy()
        np.testing.assert_array_equal(np.sort(perm), np.arange(tg.capacity))
        np.testing.assert_array_equal(tg.row.numpy()[perm[:nv]], trow)
        assert _col_sets(trow, tcol, n) == _col_sets(jrows, ccol, n)
        # each column keeps its edges in row order (the stable sort)
        for c in range(n):
            seg = trow[cp[c]:cp[c + 1]]
            assert np.all(np.diff(seg) >= 0)

    def test_survives_to_and_with_mask(self):
        _, tg = _both_prepared(*_directed(1))
        assert tg.rev is None and tg.colptr is not None
        meta = tg.to("meta")
        for name, value in vars(meta).items():
            if torch.is_tensor(value):
                assert value.device.type == "meta", name
        keep = torch.from_numpy(np.random.default_rng(2).random(
            tg.capacity) < 0.6) & tg.mask
        gm = tg.with_mask(keep)
        for name in ("colptr", "col_perm", "row_by_col", "col_by_col"):
            assert torch.equal(getattr(gm, name), getattr(tg, name))
        # the column sum over the re-masked graph drops the masked slots
        table = torch.randn(tg.capacity, 3)
        m = keep.numpy()
        want = np.zeros((tg.num_nodes, 3), np.float32)
        np.add.at(want, tg.col.numpy()[m], table.numpy()[m])
        got = kernels.column_sum(gm, table)
        assert _rel(got, want) < 1e-6

    def test_symmetric_graphs_get_it_too(self):
        """A symmetric graph keeps ``rev`` and gets the CSC view: the
        column sum through either agrees (``sym_backward=False`` takes the
        CSC view there)."""
        row, col, n = ring_graph(8)
        _, tg = _both_prepared(row, col, n)
        assert tg.rev is not None and tg.colptr is not None
        table = torch.randn(tg.capacity, 5)
        via_rev = kernels.column_sum(tg, table)
        via_csc = kernels.column_sum(dataclasses.replace(tg, rev=None),
                                     table)
        assert _rel(via_csc, via_rev) < 1e-6


# ---------------------------------------------------------------------------
# rewiring/gdc.py against the JAX module
# ---------------------------------------------------------------------------

def _sbm_graph(n=150):
    d = make_sbm_dataset(num_nodes=n, num_classes=3, num_features=4, seed=5)
    return _valid_edges(d.graph)[:2] + (n,)


GDC_GRAPHS = {"ring8": lambda: ring_graph(8), "sbm150": _sbm_graph}


def _gdc_pair(name):
    row, col, n = GDC_GRAPHS[name]()
    return (j_make_graph(row, col, None, num_nodes=n),
            make_graph(row, col, num_nodes=n))


class TestGdc:
    @pytest.mark.parametrize("graph", sorted(GDC_GRAPHS))
    def test_dense_steps(self, graph):
        """Each step on its own: the dense adjacency, the three transition
        matrices, exact and approximate PPR, heat, both sparsifiers.
        Values within 1e-5 of scale."""
        jg, tg = _gdc_pair(graph)
        a = dense_adjacency(tg)
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(jgdc.dense_adjacency(jg)))
        a = a + torch.eye(a.shape[0])
        ja = jnp.asarray(a.numpy())
        for norm in ("sym", "col", "row"):
            assert _rel(tgdc.transition_matrix(a, norm),
                        jgdc.transition_matrix(ja, norm)) < 1e-6
        t = tgdc.transition_matrix(a, "sym")
        jt = jnp.asarray(t.numpy())
        pairs = ((tgdc.exact_ppr_matrix(t, 0.1), jgdc.exact_ppr_matrix(jt,
                                                                      0.1)),
                 (tgdc.approx_ppr_matrix(t, 0.1), jgdc.approx_ppr_matrix(
                     jt, 0.1)),
                 (tgdc.exact_heat_matrix(t, 3.0), jgdc.exact_heat_matrix(
                     jt, 3.0)))
        for got, want in pairs:
            assert _rel(got, want) < 1e-5
        s = tgdc.exact_ppr_matrix(t, 0.1)
        js = jnp.asarray(s.numpy())
        for dim in (0, 1):
            np.testing.assert_array_equal(
                tgdc.sparsify_topk(s, 3, dim).numpy(),
                np.asarray(jgdc.sparsify_topk(js, 3, dim)))
        np.testing.assert_array_equal(
            tgdc.sparsify_threshold(s, 0.01).numpy(),
            np.asarray(jgdc.sparsify_threshold(js, 0.01)))

    @pytest.mark.parametrize("graph", sorted(GDC_GRAPHS))
    @pytest.mark.parametrize("exact", [True, False])
    @pytest.mark.parametrize("method,sparsify", [
        ("ppr", "topk"), ("ppr", "threshold"), ("heat", "topk"),
        ("heat", "threshold")])
    def test_apply_gdc(self, graph, exact, method, sparsify):
        """The rewired graph: the same edge set, weights within 1e-5 of
        scale summing to 1 over each column, and not symmetric (on the SBM:
        its weights always, its edge multiset under topk). topk keeps k = 3
        (the ring's ties fall within whole groups)."""
        jg, tg = _gdc_pair(graph)
        kw = dict(gdc_method=method, exact=exact, gdc_sparsification=sparsify,
                  gdc_k=3, gdc_threshold=0.01, ppr_alpha=0.1,
                  self_loop_weight=1.0)
        jr, jc, jw = _valid_edges(jgdc.apply_gdc(jg, JConfig(**kw)))
        out = tgdc.apply_gdc(tg, Config(**kw), device="cpu")
        tr, tc, tw = _valid_edges(out)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tc, jc)
        assert _rel(tw, jw) < 1e-5
        a = dense_adjacency(out).numpy()
        np.testing.assert_allclose(a.sum(axis=0), 1.0, rtol=1e-5)
        if graph == "sbm150":
            assert not np.allclose(a, a.T)
            assert (out.sort_by_row().rev is None) == (sparsify == "topk")

    @pytest.mark.parametrize("orientation", ["row", "col"])
    def test_position_encoding(self, orientation):
        jg, tg = _gdc_pair("sbm150")
        kw = dict(exact=True, ppr_alpha=0.1, self_loop_weight=1.0,
                  pos_enc_orientation=orientation)
        assert _rel(tgdc.gdc_position_encoding(tg, Config(**kw), "cpu"),
                    jgdc.gdc_position_encoding(jg, JConfig(**kw))) < 1e-5

    @pytest.mark.parametrize("graph", sorted(GDC_GRAPHS) + ["directed"])
    def test_two_hop(self, graph):
        if graph == "directed":
            row, col, n = _directed(3)
            jg, tg = (j_make_graph(row, col, None, num_nodes=n),
                      make_graph(row, col, num_nodes=n))
        else:
            jg, tg = _gdc_pair(graph)
        jr, jc, jw = _valid_edges(jgdc.two_hop(jg, pad_multiple=16))
        out = tgdc.two_hop(tg, pad_multiple=16)
        tr, tc, tw = _valid_edges(out)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tw, jw)
        assert out.capacity % 16 == 0


@pytest.mark.parametrize("rewiring", ["gdc", "two_hop"])
def test_get_dataset_rewires_the_cora_stand_in(tmp_path, rewiring):
    """With no raw files both packages build the Cora stand-in and rewire
    it after the split, before training. GDC runs exact PPR with gdc_k = 8:
    the same edge list (0 edges differ), weights within 1e-5 of scale."""
    kw = dict(rewiring=rewiring, exact=True, gdc_k=8)
    jd = j_get_dataset(j_best["Cora"].replace(**kw), str(tmp_path),
                       use_lcc=True)
    td = get_dataset(best_params["Cora"].replace(**kw), str(tmp_path),
                     use_lcc=True, device="cpu")
    jr, jc, jw = _valid_edges(jd.graph)
    tr, tc, tw = _valid_edges(td.graph)
    assert tr.shape == jr.shape
    differ = int(np.sum((tr != jr) | (tc != jc)))
    assert differ == 0, f"{differ} of {tr.shape[0]} edges differ"
    assert _rel(tw, jw) < 1e-5
    assert td.graph.capacity == jd.graph.row.shape[0]
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    # GDC's top-k keeps a directed graph; two hops of a symmetric one stay
    # symmetric
    rev = prepare_graph(best_params["Cora"], td.graph).rev
    assert (rev is None) == (rewiring == "gdc")


def test_rewiring_is_supported_but_pos_enc_knn():
    """Every rewiring is supported; ``pos_enc_knn`` (tested with the
    positional encodings, ``test_torch_port_beltrami.py``) needs a DeepWalk
    or hyperbolic encoding type to measure distances in."""
    for rw in ("gdc", "two_hop", "pos_enc_knn"):
        check_supported(best_params["Cora"].replace(rewiring=rw))
    from graph_neural_pde_tpu_torch.data.datasets import rewire
    with pytest.raises(ValueError, match="DW"):
        rewire(None, best_params["Cora"].replace(rewiring="pos_enc_knn",
                                                 pos_enc_type="GDC"))


# ---------------------------------------------------------------------------
# the column-side passes against the JAX package's XLA composition
# ---------------------------------------------------------------------------

def test_spmm_gradients_over_the_csc_view():
    """make_spmm on a directed graph: the value and both gradients (dx by
    K1 over the CSC view, dw by K2) against jax.grad of the JAX package's
    spmm; 1e-5 of scale for values, 1e-4 for gradients."""
    jg, tg = _both_prepared(*_directed(4))
    assert tg.rev is None
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.random(tg.capacity) * tg.mask.numpy()).astype(np.float32)
    probe = rng.normal(size=(N, D)).astype(np.float32)
    jw = np.zeros(jg.row.shape[0], np.float32)
    # the two packages' slot orders agree: both sort stably by row
    np.testing.assert_array_equal(np.asarray(jg.row), tg.row.numpy())
    np.testing.assert_array_equal(np.asarray(jg.col), tg.col.numpy())
    jw[:] = w

    def jloss(xx, ww):
        return jnp.sum(j_spmm(jg, xx, ww) * probe)

    want = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                     jnp.asarray(jw))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = torch.sum(make_spmm(tg)(xt, wt) * torch.tensor(probe))
    loss.backward()
    assert abs(loss.item() - float(want[0])) <= 1e-5 * abs(float(want[0]))
    assert _rel(xt.grad, want[1][0]) < 1e-4
    m = tg.mask.numpy()
    assert _rel(wt.grad.numpy()[m], np.asarray(want[1][1])[m]) < 1e-4


@pytest.mark.parametrize("fn", ["softmax", "squareplus", "normalise"])
def test_column_normalisation_over_the_csc_view(fn):
    """K3 (and K4 as its gradient) over the columns of a directed graph:
    against the JAX package's segment ops over ``g.col``; values 1e-5 of
    scale, gradients 1e-4."""
    jg, tg = _both_prepared(*_directed(6))
    rng = np.random.default_rng(7)
    s = rng.normal(size=(tg.capacity, 3)).astype(np.float32)
    if fn == "normalise":
        s = np.abs(s) + 0.1
    probe = rng.normal(size=s.shape).astype(np.float32)
    jfn = {"softmax": jsc.segment_softmax,
           "squareplus": jsc.segment_squareplus,
           "normalise": lambda v, i, n, m: jsc.segment_sum(
               jnp.where(m[:, None], v, 0.0), i, n, m)[i]}[fn]
    m = np.asarray(jg.mask)[:, None]

    def jloss(v):
        out = jfn(v, jg.col, jg.num_nodes, jg.mask)
        if fn == "normalise":
            out = jnp.where(m, v, 0.0) / (out + 1e-16)
        return jnp.sum(jnp.where(m, out, 0.0) * probe), out

    (_, want), gw = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(s))
    st = torch.tensor(s, requires_grad=True)
    tfn = {"softmax": tsc.segment_softmax,
           "squareplus": tsc.segment_squareplus,
           "normalise": lambda v, g, k: tsc.normalize_attention(
               v, g, k, mask=g.mask)}[fn]
    out = tfn(st, tg, 1)
    torch.sum(out * torch.tensor(probe)).backward()
    mask = tg.mask.numpy()
    assert _rel(out.detach().numpy()[mask], np.asarray(want)[mask]) < 1e-5
    assert _rel(st.grad.numpy()[mask], np.asarray(gw)[mask]) < 1e-4


NL = dict(function="transformer", block="constant", attention_norm_idx=0,
          square_plus=False, self_loop_weight=1.0, add_source=True,
          hidden_dim=D, attention_dim=ATT, heads=H)


def _rhs_pair(seed, **kw):
    """make_rhs in both packages over one directed graph from one JAX init
    of the ODE function with random attention weights; returns a callable
    that checks value (1e-5 of scale) and every gradient (1e-4 of each
    leaf's scale) of ``sum(rhs(x) * probe)``."""
    jcfg, tcfg = JConfig(**NL).replace(**kw), Config(**NL).replace(**kw)
    jg, tg = _both_prepared(*_directed(seed), **{
        k: v for k, v in dict(NL, **kw).items()
        if k in ("function", "block", "self_loop_weight")})
    assert tg.rev is None
    rng = np.random.default_rng(seed + 1)
    p = jax.tree.map(np.asarray, jfunctions.init_func_params(
        jax.random.PRNGKey(seed), jcfg, D))
    p["alpha_train"], p["beta_train"] = np.float32(0.3), np.float32(0.2)
    att = p["att"]
    for k in ("Q", "K", "V"):
        if k in att:
            att[k]["w"] = (0.3 * rng.normal(size=att[k]["w"].shape)) \
                .astype(np.float32)
    if jcfg.attention_type == "exp_kernel":
        att["output_var"] = np.float32([1.3])
        att["lengthscale"] = np.float32([0.8])
    func = tfunctions.ODEFunc(tcfg, D)
    func.load_state_dict(params_from_jax(p))
    x = rng.normal(size=(N, D)).astype(np.float32)
    x0 = rng.normal(size=(N, D)).astype(np.float32)
    probe = rng.normal(size=(N, D)).astype(np.float32)

    def check(exact_softmax=False):
        jrhs = jfunctions.make_rhs(jcfg, jg, exact_softmax=exact_softmax)
        jaux = jfunctions.FuncAux(None, jnp.asarray(x0), jg.weight)

        def jloss(pp, xx):
            out = jrhs(pp, jaux, 0.0, xx)
            return jnp.sum(out * probe), out

        (_, want), (gp, gx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
                jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        trhs = tfunctions.make_rhs(tcfg, tg, exact_softmax=exact_softmax)
        taux = tfunctions.FuncAux(None, torch.tensor(x0), tg.weight)
        xt = torch.tensor(x, requires_grad=True)
        func.zero_grad()
        out = trhs(func, taux, 0.0, xt)
        torch.sum(out * torch.tensor(probe)).backward()
        assert _rel(out, want) < 1e-5
        assert _rel(xt.grad, gx) < 1e-4
        wantp = params_from_jax(jax.tree.map(np.asarray, gp))
        got = {k: v.grad for k, v in func.named_parameters()}
        top = max(float(v.abs().max()) for v in wantp.values())
        for k, wv in wantp.items():
            g = got[k] if got[k] is not None else torch.zeros_like(wv)
            scale = float(wv.abs().max())
            bound = 1e-4 * (scale if scale > 1e-3 * top else top)
            assert float((g - wv).abs().max()) <= bound, k
        return out

    return check


class TestRhsOnDirectedGraphs:
    @pytest.mark.parametrize("score", SCORES)
    def test_fused_row_softmax(self, score, monkeypatch):
        """The plain softmax over rows: K6 forward, the column-plan
        backward (K8 without dxg, K17), against the JAX package's f32 XLA
        composition."""
        calls = []
        real = kernels.fused_rhs.fused_rhs_bwd_col
        monkeypatch.setattr(kernels.fused_rhs, "fused_rhs_bwd_col",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        _rhs_pair(10, attention_type=score)()
        assert calls

    @pytest.mark.parametrize("score", SCORES)
    def test_exact_softmax_route(self, score):
        """The exact re-solve: K7 shifts (scaled_dot) and K8 with its
        per-edge dxg summed over the CSC view, or the composition."""
        _rhs_pair(11, attention_type=score)(exact_softmax=True)

    def test_sym_backward_off_on_a_symmetric_graph(self):
        """``sym_backward=False`` takes the column-plan backward (K17) on a
        symmetric graph too: the same gradients as K9's."""
        row, col, n = ring_graph(N)
        _, tg = _both_prepared(row, col, n, **{
            k: NL[k] for k in ("function", "block", "self_loop_weight")})
        grads = []
        for sym in (True, False):
            cfg = Config(**NL).replace(sym_backward=sym)
            torch.manual_seed(0)
            func = tfunctions.ODEFunc(cfg, D)
            with torch.no_grad():
                func.att.Q.w.normal_(0, 0.3)
                func.att.K.w.normal_(0, 0.3)
            x = torch.randn(N, D, generator=torch.Generator().manual_seed(1),
                            requires_grad=True)
            aux = tfunctions.FuncAux(None, x.detach(), tg.weight)
            torch.sum(tfunctions.make_rhs(cfg, tg)(func, aux, 0.0, x) ** 2) \
                .backward()
            grads.append((x.grad, func.att.K.w.grad))
        for a, b in zip(*grads):
            assert _rel(b, a.numpy()) < 1e-5

    @pytest.mark.parametrize("variant", [
        dict(square_plus=True), dict(function="GAT"),
        dict(reweight_attention=True),
        dict(attention_norm_idx=1), dict(attention_norm_idx=1,
                                         square_plus=True),
        dict(mix_features=True)])
    def test_composed_paths(self, variant):
        """Squareplus, GAT and reweighting aggregate on K10 with K11's du
        and K1 over the CSC view for dx; the softmax over the columns of a
        directed graph composes K3/K4 over the CSC view with K1/K2."""
        _rhs_pair(12, **variant)()


class TestColplanAgainstPallas:
    @pytest.mark.parametrize("score", ["scaled_dot", "exp_kernel"])
    def test_gradients(self, score):
        """make_fused_ax_colplan's plain version against the JAX package's
        own make_fused_ax_colplan, Pallas in interpret mode on a stripe
        plan with its column plan (block_n 8, chunk 16): the gradient of
        sum(ax * ct) in Q, K, x, gmax and the exp_kernel scalars, at that
        engine's bf16 tolerance, 5e-2 of the largest gradient (the two
        families the JAX package's own test of this engine takes; all four
        are held to the f32 XLA composition above)."""
        row, col, n = _directed(13)
        kw = dict(NL, attention_type=score)
        jcfg = JConfig(**kw).replace(stripe_fused=True, stripe_block_n=8,
                                     stripe_chunk=16, stripe_chunk_auto=False)
        jg = jblocks.prepare_graph(jcfg, j_make_graph(row, col, None,
                                                      num_nodes=n))
        jg2, plan = jblocks.build_stripe_engine(jcfg, jg)
        assert plan.col_plan is not None and not plan.symmetric
        tg = prepare_graph(Config(**kw), make_graph(row, col, num_nodes=n))
        rng = np.random.default_rng(14)
        f32 = np.float32
        x = rng.normal(size=(n, D)).astype(f32)
        qw, kw_ = ((0.3 * rng.normal(size=(D, ATT))).astype(f32)
                   for _ in range(2))
        qb, kb = ((0.1 * rng.normal(size=ATT)).astype(f32) for _ in range(2))
        ct = rng.normal(size=(n, D)).astype(f32)
        gmax = np.array([0.25], f32)
        sp = (np.array([1.3], f32), np.array([0.8], f32)) \
            if score == "exp_kernel" else ()
        op = jfused.make_fused_ax_colplan(plan, H, False, score, jg2.col,
                                          None)

        def jloss(*a):
            return jnp.sum(op(*a[:6], tuple(v.reshape(()) for v in a[6]))[0]
                           * ct)

        want = jax.grad(jloss, argnums=tuple(range(7)))(
            *map(jnp.asarray, (qw, qb, kw_, kb, x)), jnp.asarray(gmax[0]),
            tuple(map(jnp.asarray, sp)))
        want = list(want[:6]) + list(want[6])
        ops = [torch.tensor(a, requires_grad=True)
               for a in (qw, qb, kw_, kb, x, gmax, *sp)]
        ax, _ = kernels.make_fused_ax_colplan(tg, H, False, score)(
            *ops[:6], tuple(ops[6:]))
        got = torch.autograd.grad(torch.sum(ax * torch.tensor(ct)), ops)
        scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
        for g, w in zip(got, want):
            err = np.abs(g.numpy().reshape(-1) - np.asarray(w).reshape(-1))
            assert err.max() / scale < 5e-2


def test_k17_plain_sums_k8_dxg_per_column():
    """K17's plain version is K8's per-edge dxg summed over each column,
    with K8's dkw and dkb; the K8 form without dxg returns K8's dq, dgmax
    and no dkw, dkb."""
    _, tg = _both_prepared(*_directed(15))
    rng = np.random.default_rng(16)

    def t(*shape, scale=1.0):
        return torch.tensor((scale * rng.normal(size=shape)).astype(
            np.float32))

    x, ct_ax = t(N, D), t(N, D)
    qw, kw = t(D, ATT, scale=0.3), t(D, ATT, scale=0.3)
    qb, kb = t(ATT, scale=0.1), t(ATT, scale=0.1)
    recip_p, ct_den = t(N, H).abs() + 0.1, t(N, H)
    gmax = torch.tensor([0.25])
    args = (x, qw, qb, kw, kb, gmax, ct_ax, recip_p, ct_den)
    csr = (tg.rowptr, tg.row, tg.col)
    full = kernels.fused_rhs_bwd(*csr, *args, heads=H, score="scaled_dot")
    lean = kernels.fused_rhs_bwd(*csr, *args, heads=H, score="scaled_dot",
                                 want_dxg=False)
    assert lean[1:4] == (None, None, None)
    for a, b in zip(full[:1] + full[4:5], lean[:1] + lean[4:5]):
        assert torch.equal(a, b)
    dx, dkw, dkb = kernels.fused_rhs_bwd_col(
        tg.colptr, tg.col_by_col, tg.row_by_col, *args, heads=H,
        score="scaled_dot")
    want = torch.zeros(N, D).index_add(0, tg.col[:tg.num_valid].long(),
                                       full[1][:tg.num_valid])
    assert _rel(dx, want.numpy()) < 1e-5
    assert _rel(dkw, full[2].numpy()) < 1e-5
    assert _rel(dkb, full[3].numpy()) < 1e-5
    assert kernels.fused_rhs_bwd_col.launches == 0     # CPU: plain version


def test_dual_gather_without_rev_leaves_dx_to_k1():
    jg, tg = _both_prepared(*_directed(17))
    rng = np.random.default_rng(18)
    u = torch.tensor((rng.random((tg.capacity, 3)) + 0.05).astype(np.float32)
                     ) * tg.mask[:, None]
    x = torch.tensor(rng.normal(size=(N, 5)).astype(np.float32))
    ct_num = torch.tensor(rng.normal(size=(N, 15)).astype(np.float32))
    ct_den = torch.tensor(rng.normal(size=(N, 3)).astype(np.float32))
    du, dx = kernels.dual_gather(tg.rowptr, tg.row, tg.col, None, u, x,
                                 ct_num, ct_den)
    assert dx is None
    du_ref, dx_ref = kernels.dual_gather_plain(tg.rowptr, tg.row, tg.col, u,
                                               x, ct_num, ct_den)
    assert torch.equal(du, du_ref)
    assert _rel(kernels.column_head_sum(tg, u, ct_num), dx_ref.numpy()) < 1e-6


# ---------------------------------------------------------------------------
# three epochs over a GDC-rewired stand-in
# ---------------------------------------------------------------------------

GATE_DATA = dict(num_nodes=60, num_classes=3, num_features=10, seed=4,
                 edge_pad_multiple=32, num_val=20)
GATES = {
    "tuned Cora": dict(hidden_dim=16, attention_dim=16, input_dropout=0.0,
                       dropout=0.0),
    "GRAND-nl": dict(function="transformer", block="constant",
                     attention_norm_idx=0, square_plus=False, hidden_dim=16,
                     attention_dim=16, heads=4, input_dropout=0.0,
                     dropout=0.0),
}


@pytest.fixture(scope="module", params=sorted(GATES))
def gate(request):
    """Three epochs (training steps) of each package's Trainer on the tuned
    Cora row (or GRAND-nl over it) at width 16, from one JAX init with
    random Q/K, dropout off, over a 60-node SBM stand-in rewired by GDC
    once (the CLI's approximate PPR, gdc_k = 8) and handed to both
    packages: per epoch (loss, forward NFE, backward NFE). Without the eval
    solves: the JAX side's time is XLA compilation, and the eval step would
    be a second program."""
    jcfg = j_best["Cora"].replace(**GATES[request.param])
    tcfg = best_params["Cora"].replace(**GATES[request.param])
    jd, td = j_sbm(**GATE_DATA), make_sbm_dataset(**GATE_DATA)
    g = tgdc.apply_gdc(td.graph, tcfg.replace(gdc_k=8), pad_multiple=32,
                       device="cpu")
    r, c, w = _valid_edges(g)
    td.graph = make_graph(r, c, w, num_nodes=g.num_nodes, pad_multiple=32)
    jd.graph = j_make_graph(r, c, w, num_nodes=g.num_nodes, pad_multiple=32)
    assert prepare_graph(tcfg, td.graph).rev is None
    jm = JEarly(jcfg, 10, 3, jd.graph)
    params, state = jm.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(8)
    params = jax.tree.map(np.asarray, params)
    owner = params["block"]["func"] if "att" in params["block"]["func"] \
        else params["block"]
    for k in ("Q", "K"):     # off the 1e-5 constant init: nonuniform
        owner["att"][k]["w"] = (0.3 * rng.normal(
            size=owner["att"][k]["w"].shape)).astype(np.float32)
    tm = GNNEarlyModel(tcfg, 10, 3, td.graph)
    tm.load_state_dict(params_from_jax(params,
                                       jax.tree.map(np.asarray, state)))
    jp, jt = jax.tree.map(jnp.asarray, params), JTrainer(jm)
    opt_state, jlogs = jt.optimizer.init(jp), []
    for step in range(3):
        jp, state, opt_state, loss, st = jt._train_step(
            jp, state, opt_state, jd.x, None, jd.y, jd.train_mask,
            jax.random.PRNGKey(step))
        bwd = (int(st["bwd_nfe"]) if jcfg.adjoint
               else int(st["accepted"]) * jt._bwd_evals_per_step)
        jlogs.append((float(loss), int(st["nfe"]), bwd))
    counts = dict.fromkeys(("fused_rhs_bwd_col", "fused_rhs_bwd_sym"), 0)
    real = {k: getattr(kernels.fused_rhs, k) for k in counts}
    for k in counts:
        def counting(*a, _k=k, **kw):
            counts[_k] += 1
            return real[_k](*a, **kw)
        setattr(kernels.fused_rhs, k, counting)
    trainer, tlogs = Trainer(tm), []
    try:
        for _ in range(3):
            loss, st = trainer.train_step(td.x, td.y, td.train_mask)
            tlogs.append((loss, st["nfe"], st["bwd_nfe"]))
    finally:
        for k in counts:
            setattr(kernels.fused_rhs, k, real[k])
    return request.param, jlogs, tlogs, counts


class TestThreeEpochsOverGdc:
    def test_losses(self, gate):
        """rtol 1e-4: three solves and optimizer updates, each differing
        from the JAX package only in the order of float32 sums."""
        _, jlogs, tlogs, _ = gate
        assert len(tlogs) == len(jlogs) == 3
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-4)
        assert all(math.isfinite(l[0]) for l in tlogs)
        assert tlogs[0][0] != tlogs[-1][0]

    def test_nfe(self, gate):
        """Identical forward and backward NFE per epoch: the same
        accept/reject sequence in every solve."""
        _, jlogs, tlogs, _ = gate
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        assert all(fwd > 0 and bwd > 0 for _, fwd, bwd in tlogs)

    def test_backward_engine(self, gate):
        """GRAND-nl's gradient on the directed graph is K17's, never K9's."""
        name, _, _, counts = gate
        if name == "GRAND-nl":
            assert counts["fused_rhs_bwd_col"] > 0
        else:
            assert counts["fused_rhs_bwd_col"] == 0
        assert counts["fused_rhs_bwd_sym"] == 0
