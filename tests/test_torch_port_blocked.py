"""The PyTorch port's blocked SpMM engine held against the JAX package on
the CPU: the block plan and its transpose (slot for slot), the plain
versions of K15 ``blocked_spmm`` and K16 ``blocked_sddmm`` against the
Pallas calls in float32 interpret mode, the gradients of ``spmm_blocked``
against the JAX custom VJP, ``gradcheck``, the node orders and
``reorder_dataset``, the engine the models build, and three epochs of
the tuned Cora row with ``spmm_impl="pallas_blocked", node_reorder="rcm"``.

Blocks and chunks are small (128, or less) in both packages: JAX's
interpret mode builds a dense one-hot per chunk. Inputs are made with numpy
from a seed and handed to both packages.
"""

import importlib
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_neural_pde_tpu.ops.reorder as jreorder
from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.data.datasets import get_dataset as j_get_dataset
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.ops.pallas.plan import (
    build_block_plan as j_build_plan, transpose_plan as j_transpose_plan)
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import best_params
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.data.datasets import get_dataset
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.kernels import blocked
from graph_neural_pde_tpu_torch.models.blocks import (build_spmm_engine,
                                                      prepare_graph)
from graph_neural_pde_tpu_torch.models.gnn import check_supported
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.ops import reorder
from graph_neural_pde_tpu_torch.ops.plan import (build_block_plan,
                                                 transpose_plan)
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
from graph_neural_pde_tpu_torch.training.train import Trainer

# the module, not the function of the same name that ops.pallas exports
jblocked = importlib.import_module(
    "graph_neural_pde_tpu.ops.pallas.spmm_blocked")

PLAN_FIELDS = ("row_local", "col_local", "weight", "valid", "row", "col",
               "chunk_rows", "chunk_cols")


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _banded(seed, n=700, e=3000, band=150, drop=0.1):
    """A random graph whose edges stay near the diagonal (a few buckets
    per row block), with weights and a validity mask."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e)
    c = np.clip(r + rng.integers(-band, band, e), 0, n - 1)
    w = rng.random(e).astype(np.float32)
    return r, c, w, rng.random(e) > drop, n


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (block_n, chunk, band): several buckets per row block, chunks smaller
# than a bucket, and a band so narrow that row blocks sit empty
PLAN_SHAPES = [(128, 128, 150), (256, 64, 150), (64, 128, 700), (128, 32, 3)]


@pytest.mark.parametrize("block_n,chunk,band", PLAN_SHAPES)
def test_plan_and_transpose_equal_jax(block_n, chunk, band):
    """Every array of the plan and of the transposed plan, and the slot
    permutation between them, slot for slot."""
    r, c, w, m, n = _banded(1, band=band, e=3000 if band > 3 else 40)
    jp = j_build_plan(r, c, w, m, num_nodes=n, block_n=block_n, chunk=chunk)
    tp = build_block_plan(r, c, w, m, num_nodes=n, block_n=block_n,
                          chunk=chunk)
    jt, tt = j_transpose_plan(jp), transpose_plan(tp)
    for a, b in ((jp, tp), (jt[0], tt[0])):
        assert (a.block_n, a.chunk, a.num_nodes) == \
            (b.block_n, b.chunk, b.num_nodes)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(b, f),
                                          np.asarray(getattr(a, f)), f)
    for a, b in zip(jt[1:], tt[1:]):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_plan_tags_map_slots_to_input_edges():
    """``return_tags``: each valid slot holds the kept input edge its tag
    names; padding is -1."""
    r, c, w, m, n = _banded(2)
    plan, tags = build_block_plan(r, c, w, m, num_nodes=n, block_n=128,
                                  chunk=64, return_tags=True)
    assert np.array_equal(tags >= 0, plan.valid)
    v = plan.valid
    np.testing.assert_array_equal(plan.row[v], r[m][tags[v]])
    np.testing.assert_array_equal(plan.col[v], c[m][tags[v]])
    np.testing.assert_array_equal(plan.weight[v], w[m][tags[v]])


# ---------------------------------------------------------------------------
# K15 / K16 plain versions against the Pallas calls (interpret mode)
# ---------------------------------------------------------------------------

def _pair(seed=3, block_n=128, chunk=128):
    r, c, w, m, n = _banded(seed)
    kw = dict(num_nodes=n, block_n=block_n, chunk=chunk)
    return (jblocked.make_plan_pair(r, c, w, m, **kw),
            blocked.make_plan_pair(r, c, w, m, **kw))


@pytest.mark.parametrize("d", [1, 3, 16])
def test_kernels_match_the_pallas_calls(d):
    """K15 on the forward and on the transposed plan, and K16, against
    ``_spmm_call`` / ``_sddmm_call`` in float32 interpret mode: 1e-5 of
    the largest entry."""
    jp, tp = _pair()
    rng = np.random.default_rng(d)
    npad = tp.fwd.num_nodes
    x = rng.normal(size=(npad, d)).astype(np.float32)
    ct = rng.normal(size=(npad, d)).astype(np.float32)
    for jplan, tplan in ((jp.fwd, tp.fwd), (jp.bwd, tp.bwd)):
        lay = blocked.blocked_layout(tplan)
        w = tplan.weight
        want = jblocked._spmm_call(jplan, jnp.asarray(x), jnp.asarray(w))
        got = blocked.blocked_spmm(lay, torch.tensor(w), torch.tensor(x))
        assert _rel(got, want) < 1e-5
        want = jblocked._sddmm_call(jplan, jnp.asarray(ct), jnp.asarray(x))
        got = blocked.blocked_sddmm(lay, torch.tensor(ct), torch.tensor(x))
        assert _rel(got, want) < 1e-5


def test_gradients_match_the_custom_vjp():
    """dx (K15 on the transposed plan with w_t) and dw (K16 masked by
    valid) against ``jax.grad`` through the JAX package's custom VJP."""
    jp, tp = _pair(4)
    rng = np.random.default_rng(5)
    npad, d = tp.fwd.num_nodes, 6
    x = rng.normal(size=(npad, d)).astype(np.float32)
    ct = rng.normal(size=(npad, d)).astype(np.float32)
    w = tp.fwd.weight

    def loss(xx, ww):
        return jnp.sum(jblocked.spmm_blocked(jp, xx, ww) * ct)

    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = blocked.spmm_blocked(tp, xt, wt)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jblocked.spmm_blocked(jp, jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5 * float(np.abs(out.detach().numpy()).max()))
    torch.sum(out * torch.tensor(ct)).backward()
    assert _rel(xt.grad, jgx) < 1e-5
    assert _rel(wt.grad, jgw) < 1e-5
    assert not wt.grad[~torch.as_tensor(tp.fwd.valid)].any()


def test_gradcheck():
    jp, tp = _pair(6, block_n=64, chunk=32)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(tp.fwd.num_nodes, 2)),
                     requires_grad=True)
    w = torch.tensor(tp.fwd.weight, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: blocked.spmm_blocked(tp, a, b), (x, w))


def test_cpu_runs_plain_versions_without_launching():
    _, tp = _pair(10, block_n=64, chunk=32)
    before = [k.launches for k in kernels.KERNELS]
    x = torch.randn(tp.fwd.num_nodes, 4, requires_grad=True)
    w = torch.tensor(tp.fwd.weight, requires_grad=True)
    torch.sum(blocked.spmm_blocked(tp, x, w)).backward()
    assert [k.launches for k in kernels.KERNELS] == before
    assert kernels.KERNELS[-2:] == (kernels.blocked_spmm,
                                    kernels.blocked_sddmm)


@pytest.mark.parametrize("bad", ["dtype", "rows", "w", "meta"])
def test_wrappers_reject(bad):
    _, tp = _pair(11, block_n=64, chunk=32)
    lay = blocked.blocked_layout(tp.fwd)
    x = torch.randn(tp.fwd.num_nodes, 4)
    w = torch.tensor(tp.fwd.weight)
    if bad == "dtype":
        x = x.half()
    elif bad == "rows":
        x = x[:-1]
    elif bad == "w":
        w = w[:-1]
    else:
        x, w = x.to("meta"), w.to("meta")
        lay = blocked.blocked_layout(tp.fwd, "meta")
    err = NotImplementedError if bad == "meta" else (TypeError, ValueError)
    with pytest.raises(err):
        blocked.blocked_spmm(lay, w, x)


# ---------------------------------------------------------------------------
# node orders
# ---------------------------------------------------------------------------

def _sbm_edges():
    d = make_sbm_dataset(num_nodes=300, num_classes=4, num_features=5,
                         seed=12)
    m = d.graph.mask.numpy()
    return d.graph.row.numpy()[m], d.graph.col.numpy()[m], 300


@pytest.mark.parametrize("method", ["rcm", "degree"])
def test_orders_equal_jax(method):
    r, c, n = _sbm_edges()
    order = reorder.node_order(method, r, c, n)
    np.testing.assert_array_equal(order, jreorder.node_order(method, r, c, n))
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    np.testing.assert_array_equal(reorder.invert_order(order),
                                  jreorder.invert_order(order))
    assert reorder.bandwidth(r, c, order) == jreorder.bandwidth(r, c, order)
    assert reorder.bandwidth(r, c) == jreorder.bandwidth(r, c)


def test_rcm_numpy_fallback_equals_jax(monkeypatch):
    """Without scipy the order comes from the numpy BFS, the JAX
    package's ``_rcm_numpy`` on the same symmetric CSR."""
    r, c, n = _sbm_edges()
    indptr, idx = jreorder._symmetric_csr(r, c, n)
    want = jreorder._rcm_numpy(indptr, idx, n)
    np.testing.assert_array_equal(
        reorder._rcm_numpy(*reorder._symmetric_csr(r, c, n), n), want)
    monkeypatch.setitem(sys.modules, "scipy.sparse.csgraph", None)
    np.testing.assert_array_equal(reorder.rcm_order(r, c, n), want)
    assert reorder.bandwidth(r, c, want) < reorder.bandwidth(r, c)


def test_unknown_order_raises():
    with pytest.raises(ValueError, match="node_reorder"):
        reorder.node_order("metis", [0], [1], 2)


@pytest.mark.parametrize("method", ["rcm", "degree"])
def test_reorder_dataset_equals_jax(method):
    kw = dict(num_nodes=200, num_classes=3, num_features=6, seed=13,
              edge_pad_multiple=32)
    jd, jorder = jreorder.reorder_dataset(j_sbm(**kw), method)
    td, torder = reorder.reorder_dataset(make_sbm_dataset(**kw), method)
    np.testing.assert_array_equal(torder, jorder)
    np.testing.assert_array_equal(td.reorder, jd.reorder)
    for f in ("x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)))
    for f in ("row", "col", "weight", "mask"):
        np.testing.assert_array_equal(getattr(td.graph, f).numpy(),
                                      np.asarray(getattr(jd.graph, f)))
    assert not td.graph.rows_sorted


def test_plan_occupancy_equals_jax():
    r, c, w, m, n = _banded(14)
    plan = build_block_plan(r, c, w, m, num_nodes=n, block_n=128, chunk=64)
    assert reorder.plan_occupancy(plan) == jreorder.plan_occupancy(
        j_build_plan(r, c, w, m, num_nodes=n, block_n=128, chunk=64))


# ---------------------------------------------------------------------------
# the engine the models build
# ---------------------------------------------------------------------------

def test_engine_takes_the_row_sorted_graphs_weights():
    """The blocked engine over a prepared graph: value and both gradients
    equal the row-sorted engine's (K1/K2) at 1e-5, per-edge gradients in
    the graph's slot order; padding nodes stay zero."""
    cfg = best_params["Cora"].replace(spmm_impl="pallas_blocked",
                                      spmm_block_n=64, spmm_chunk=32)
    d = make_sbm_dataset(num_nodes=150, num_classes=3, num_features=4,
                         seed=15, edge_pad_multiple=64)
    g = prepare_graph(cfg, d.graph)
    spmm_fn, npad = build_spmm_engine(cfg, g)
    assert npad == 192 and g.num_nodes == 150
    rng = np.random.default_rng(16)
    x = rng.normal(size=(npad, 5)).astype(np.float32)
    x[150:] = 0.0
    w = (rng.random(g.capacity) * g.mask.numpy()).astype(np.float32)
    ct = rng.normal(size=(npad, 5)).astype(np.float32)
    outs = []
    for fn, rows in ((spmm_fn, npad), (make_spmm(g), 150)):
        xt = torch.tensor(x[:rows], requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        out = fn(xt, wt)
        torch.sum(out * torch.tensor(ct[:rows])).backward()
        outs.append((out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()))
    (bo, bx, bw), (xo, xx, xw) = outs
    assert not bo[150:].any()
    assert _rel(bo[:150], xo) < 1e-5
    assert _rel(bx[:150], xx) < 1e-5
    assert _rel(bw, xw) < 1e-5
    assert not bw[~g.mask.numpy()].any()


def test_engine_only_for_the_laplacian_function():
    """As in the JAX package, the transformer function ignores
    ``pallas_blocked``; an unknown engine raises."""
    d = make_sbm_dataset(num_nodes=60, num_classes=3, num_features=4, seed=1)
    cfg = best_params["Cora"].replace(spmm_impl="pallas_blocked")
    g = prepare_graph(cfg, d.graph)
    assert build_spmm_engine(cfg.replace(function="transformer",
                                         block="constant"), g)[1] == 60
    assert build_spmm_engine(cfg, g)[1] == 1024
    check_supported(cfg)
    with pytest.raises(ValueError, match="spmm_impl"):
        check_supported(cfg.replace(spmm_impl="cusparse"))


# ---------------------------------------------------------------------------
# three epochs of the tuned Cora row on the blocked engine
# ---------------------------------------------------------------------------

BLOCKED = dict(hidden_dim=16, attention_dim=16, input_dropout=0.0,
               dropout=0.0, spmm_impl="pallas_blocked", node_reorder="rcm",
               spmm_block_n=128, spmm_chunk=128)


@pytest.fixture(scope="module")
def cora_blocked(tmp_path_factory):
    """The tuned Cora row (attention block, dopri5, adamax, early-stop
    eval) at width 16 over the rcm-ordered Cora stand-in, three epochs of
    each package's Trainer from one JAX init with random Q/K."""
    data_dir = str(tmp_path_factory.mktemp("nodata"))
    jcfg, tcfg = (j_best["Cora"].replace(**BLOCKED),
                  best_params["Cora"].replace(**BLOCKED))
    jd = j_get_dataset(jcfg, data_dir, use_lcc=True)
    td = get_dataset(tcfg, data_dir, use_lcc=True)
    jm = JEarly(jcfg, jd.num_features, jd.num_classes, jd.graph)
    params, state = jm.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(8)
    params = jax.tree.map(np.asarray, params)
    for k in ("Q", "K"):
        w = params["block"]["att"][k]["w"]
        params["block"]["att"][k]["w"] = \
            (0.3 * rng.normal(size=w.shape)).astype(np.float32)
    tm = GNNEarlyModel(tcfg, td.num_features, td.num_classes, td.graph)
    tm.load_state_dict(params_from_jax(params))
    jparams = jax.tree.map(jnp.asarray, params)
    jt = JTrainer(jm)
    carry = {"params": jparams, "state": state,
             "opt_state": jt.optimizer.init(jparams),
             "key": jax.random.PRNGKey(0), "epoch": 1,
             "best": {"val_acc": 0.0, "test_acc": 0.0, "train_acc": 0.0,
                      "epoch": 0}}
    _, _, _, jlogs = jt.fit(jd, epochs=4, carry=carry, verbose=False)
    _, tlogs = Trainer(tm).fit(td, epochs=4, verbose=False)
    return jd, td, jm, tm, jlogs, tlogs


class TestCoraBlocked:
    def test_reordered_stand_in_is_bit_identical(self, cora_blocked):
        jd, td, _, _, _, _ = cora_blocked
        np.testing.assert_array_equal(td.reorder, jd.reorder)
        np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
        np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
        for f in ("row", "col", "mask"):
            np.testing.assert_array_equal(getattr(td.graph, f).numpy(),
                                          np.asarray(getattr(jd.graph, f)))

    def test_model_pads_to_the_plan(self, cora_blocked):
        _, td, jm, tm, _, _ = cora_blocked
        assert tm.padded_nodes == jm.graph.num_nodes == 2816
        assert tm.graph.num_nodes == td.x.shape[0] == 2708

    def test_losses(self, cora_blocked):
        """rtol 1e-4: three adaptive solves and adamax updates, each
        differing from the JAX package only in the order of f32 sums."""
        _, _, _, _, jlogs, tlogs = cora_blocked
        assert len(tlogs) == len(jlogs) == 3
        np.testing.assert_allclose([l.loss for l in tlogs],
                                   [l.loss for l in jlogs], rtol=1e-4)
        assert all(math.isfinite(l.loss) for l in tlogs)
        assert tlogs[0].loss != tlogs[-1].loss

    def test_nfe(self, cora_blocked):
        _, _, _, _, jlogs, tlogs = cora_blocked
        assert [(l.fwd_nfe, l.bwd_nfe) for l in tlogs] == \
            [(l.fwd_nfe, l.bwd_nfe) for l in jlogs]
        assert all(l.fwd_nfe > 0 and l.bwd_nfe > 0 for l in tlogs)
