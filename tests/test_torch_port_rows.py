"""The PyTorch port's second slice, held against the JAX package on the CPU:
the fixed-grid solves, the continuous adjoint, hard attention's keep mask,
the Amazon / Coauthor data, and three training epochs of each of the tuned
Citeseer, Pubmed, CoauthorCS, Computers and Photo rows from identical
weights (the kernels and layers they run: test_torch_port_segment.py).

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the kernel wrappers run their plain versions; ``chip_smoke.py`` holds
the CUDA kernels against the same plain versions on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_neural_pde_tpu.solvers.api as japi
from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.data.datasets import get_dataset as j_get_dataset
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models.blocks import (block_forward as j_block_fwd,
                                                build_aux as j_build_aux,
                                                prepare_graph as j_prepare)
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch.config import best_params
from graph_neural_pde_tpu_torch.convert import (params_from_jax,
                                                params_to_jax, state_to_jax)
from graph_neural_pde_tpu_torch.data.datasets import get_dataset
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.models.blocks import (ODEBlock, block_forward,
                                                      build_aux,
                                                      prepare_graph)
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
from graph_neural_pde_tpu_torch.training.train import Trainer

ROWS = ("Citeseer", "Pubmed", "CoauthorCS", "Computers", "Photo")


def _grad_close(got, want, rtol):
    """rtol, and an absolute floor of rtol of the largest entry: an entry
    that sums terms of mixed sign keeps their absolute error."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


# ---------------------------------------------------------------------------
# block solves: fixed grids and the continuous adjoint
# ---------------------------------------------------------------------------

SMALL = dict(hidden_dim=16, attention_dim=16, input_dropout=0.0, dropout=0.0)
D = SMALL["hidden_dim"]


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small(row, **kw):
    heads = min(best_params[row].heads, 4)
    return (j_best[row].replace(**SMALL, heads=heads, **kw),
            best_params[row].replace(**SMALL, heads=heads, **kw))


def _sbm(pkg_fn):
    return pkg_fn(num_nodes=60, num_classes=3, num_features=10, seed=4,
                  edge_pad_multiple=32, num_val=20)


def _randomised(params, seed):
    """Random attention Q/K (the 1e-5 constant init gives uniform attention,
    whose hard-attention quantile is a tie of most edges) and nonzero
    alpha/beta on top of a JAX init."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, params)
    att = p["block"]["att"]
    for k in ("Q", "K"):
        att[k]["w"] = (0.3 * rng.normal(size=att[k]["w"].shape)) \
            .astype(np.float32)
    p["block"]["func"]["alpha_train"] = np.float32(0.4)
    p["block"]["func"]["beta_train"] = np.float32(-0.3)
    return p


def _recording_solves(calls):
    """Wrap the JAX package's solve dispatch to record each solve's counts
    (run without jit, so the stats are concrete)."""
    orig = japi._solve

    def rec(func, opts, t0, t1, params, y0):
        y, stats = orig(func, opts, t0, t1, params, y0)
        calls.append((opts.method, isinstance(y0, tuple),
                      {k: int(stats[k]) for k in ("nfe", "accepted",
                                                  "rejected")}))
        return y, stats
    return rec


def _block_pair(jcfg, tcfg, seed):
    """One training-mode block solve with gradients in each package, from
    one converted init. Returns a dict of both sides' results."""
    jd, td = _sbm(j_sbm), _sbm(make_sbm_dataset)
    n = td.x.shape[0]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    probe = rng.normal(size=(n, D)).astype(np.float32)
    p = _randomised(JEarly(jcfg, 10, 3, jd.graph).init(
        jax.random.PRNGKey(seed))[0], seed + 1)
    jg = j_prepare(jcfg, jd.graph)

    def loss(bp, xx):
        z, stats, _ = j_block_fwd(bp, jcfg, jg, xx, training=True)
        return jnp.sum(z * probe), (z, stats)

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "_solve", _recording_solves(calls))
        (_, (jz, jstats)), (jgb, jgx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, p["block"]), jnp.asarray(x))

    tg = prepare_graph(tcfg, td.graph)
    block = ODEBlock(tcfg, D)
    block.load_state_dict({k[len("block."):]: v
                           for k, v in params_from_jax(p).items()
                           if k.startswith("block.")})
    xt = torch.tensor(x, requires_grad=True)
    tz, tstats = block_forward(block, tcfg, tg, xt, True,
                               spmm_fn=make_spmm(tg))
    torch.sum(tz * torch.tensor(probe)).backward()
    return dict(jz=np.asarray(jz), jstats=jstats, jgb=jgb,
                jgx=np.asarray(jgx), jcalls=calls, tz=tz.detach().numpy(),
                tstats=tstats, block=block, tgx=xt.grad.numpy())


def _assert_block_pair(r, att_rtol=1e-4):
    """State at rtol 1e-4; gradients at rtol 1e-4 plus 1e-4 of scale, those
    that flow through the frozen attention (x, Q, K) at ``att_rtol``."""
    np.testing.assert_allclose(r["tz"], r["jz"], rtol=1e-4, atol=1e-5)
    _grad_close(r["tgx"], r["jgx"], att_rtol)
    for name, prm in r["block"].named_parameters():
        want = r["jgb"]
        for k in name.split("."):
            want = want[k]
        if prm.grad is None:
            # the hard-attention block's attention has no gradient
            assert not np.any(np.asarray(want))
            continue
        _grad_close(prm.grad.numpy(), want,
                    att_rtol if name.startswith("att.") else 1e-4)


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun2", "rk4"])
def test_fixed_grid_solve_matches_jax(method):
    """Tuned Cora at width 16 with a fixed-grid method, step 1.0 over
    T = 3.58 (the last step shortened): identical NFE, state and gradients
    at rtol 1e-4 (+1e-4 of scale)."""
    jcfg, tcfg = _small("Cora", method=method, time=3.5824027975386623,
                        step_size=1.0)
    r = _block_pair(jcfg, tcfg, seed=1)
    n_steps = 4
    nfe = n_steps * {"euler": 1, "midpoint": 2, "heun2": 2, "rk4": 4}[method]
    assert (r["tstats"]["nfe"], r["tstats"]["accepted"]) == (nfe, n_steps)
    assert int(r["jstats"]["nfe"]) == nfe
    _assert_block_pair(r)


@pytest.fixture(scope="module", params=["Pubmed", "CoauthorCS", "Photo"])
def adjoint_pair(request):
    """A training-mode adjoint block solve of three tuned rows at width 16:
    adaptive_heun (Pubmed), dopri5 (CoauthorCS) and rk4 on a grid (Photo,
    hard attention) backward solves."""
    jcfg, tcfg = _small(request.param)
    return request.param, _block_pair(jcfg, tcfg, seed=2)


class TestContinuousAdjoint:
    def test_backward_counts(self, adjoint_pair):
        """The backward solve takes the JAX package's accepted/rejected
        steps and NFE exactly: the augmented state holds the same leaves
        (y, a and a cotangent of every RHS parameter, the inert probe
        included), so the error norm counts the same elements."""
        row, r = adjoint_pair
        fwd = [c for c in r["jcalls"] if not c[1]]
        bwd = [c for c in r["jcalls"] if c[1]]
        assert len(fwd) == len(bwd) == 1
        t = r["tstats"]
        assert (t["nfe"], t["accepted"], t["rejected"]) == tuple(
            fwd[0][2][k] for k in ("nfe", "accepted", "rejected"))
        assert bwd[0][0] == best_params[row].adjoint_method
        assert (t["bwd_nfe"], t["bwd_accepted"], t["bwd_rejected"]) == tuple(
            bwd[0][2][k] for k in ("nfe", "accepted", "rejected"))
        assert t["bwd_nfe"] > 0
        # the JAX package's measured backward NFE side channel agrees
        assert int(r["jgb"]["func"]["adjoint_nfe_probe"]) == t["bwd_nfe"]

    def test_state_and_gradients(self, adjoint_pair):
        """rtol 1e-4 plus 1e-4 of each array's scale: both backward solves
        take the same steps, and differ in the order of f32 sums. Pubmed's
        gradients through its frozen attention (x, Q, K) are held at 1e-3
        of scale: they are that ill-conditioned in the JAX package itself,
        whose eager and jit runs of this solve (the same steps, other f32
        rounding) differ by 2.0e-4 of scale in Q.w and 8.8e-5 in x."""
        row, r = adjoint_pair
        _assert_block_pair(r, att_rtol=1e-3 if row == "Pubmed" else 1e-4)


@pytest.mark.parametrize("use_flux", [False, True])
def test_hard_attention_keep_mask_matches_jax(use_flux):
    """Tuned Computers at width 16 with random Q/K (and, with use_flux, the
    attention scaled by |x_row - x_col|): the quantile threshold, the keep
    mask (equal counts and slots) and the renormalised sampled weights
    (rtol 1e-5) match the JAX package's build_aux."""
    jcfg, tcfg = _small("Computers", use_flux=use_flux)
    jd, td = _sbm(j_sbm), _sbm(make_sbm_dataset)
    p = _randomised(JEarly(jcfg, 10, 3, jd.graph).init(
        jax.random.PRNGKey(5))[0], 6)
    x = np.random.default_rng(7).normal(size=(60, D)).astype(np.float32)
    jg = j_prepare(jcfg, jd.graph)
    jaux, jg2 = j_build_aux(jax.tree.map(jnp.asarray, p["block"]), jcfg, jg,
                            jnp.asarray(x), training=True)
    block = ODEBlock(tcfg, D)
    block.load_state_dict({k[len("block."):]: v
                           for k, v in params_from_jax(p).items()
                           if k.startswith("block.")})
    aux, keep = build_aux(block, tcfg, prepare_graph(tcfg, td.graph),
                          torch.tensor(x), training=True)
    jkeep = np.asarray(jg2.mask)
    assert 0 < int(keep.sum()) < int(jg.mask.sum())
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_allclose(aux.attention.numpy(),
                               np.asarray(jaux.attention), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the five tuned rows, three epochs each
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ROWS)
def row_epochs(request):
    """Three epochs of each package's Trainer on one tuned row at width 16
    (heads up to 4) from one JAX init with random Q/K, dropout off."""
    row = request.param
    jcfg, tcfg = _small(row)
    jd, td = _sbm(j_sbm), _sbm(make_sbm_dataset)
    jm = JEarly(jcfg, 10, 3, jd.graph)
    params, state = jm.init(jax.random.PRNGKey(7))
    params = _randomised(params, 8)
    tm = GNNEarlyModel(tcfg, 10, 3, td.graph)
    tm.load_state_dict(params_from_jax(params,
                                       jax.tree.map(np.asarray, state)))
    jparams = jax.tree.map(jnp.asarray, params)
    jt = JTrainer(jm)
    carry = {"params": jparams, "state": state,
             "opt_state": jt.optimizer.init(jparams),
             "key": jax.random.PRNGKey(0), "epoch": 1,
             "best": {"val_acc": 0.0, "test_acc": 0.0, "train_acc": 0.0,
                      "epoch": 0}}
    jp, jstate, _, jlogs = jt.fit(jd, epochs=4, carry=carry, verbose=False)
    _, tlogs = Trainer(tm).fit(td, epochs=4, verbose=False)
    return row, jlogs, tlogs, tm, jp, jstate


class TestTunedRows:
    def test_losses(self, row_epochs):
        """rtol 1e-4: three solves and optimizer updates, each differing
        from the JAX package only in the order of f32 sums."""
        _, jlogs, tlogs, _, _, _ = row_epochs
        assert len(tlogs) == len(jlogs) == 3
        np.testing.assert_allclose([l.loss for l in tlogs],
                                   [l.loss for l in jlogs], rtol=1e-4)
        assert all(math.isfinite(l.loss) for l in tlogs)
        assert tlogs[0].loss != tlogs[-1].loss

    def test_nfe(self, row_epochs):
        """Identical forward NFE, and backward NFE (from the continuous
        adjoint's backward solve on the four adjoint rows)."""
        row, jlogs, tlogs, _, _, _ = row_epochs
        assert [(l.fwd_nfe, l.bwd_nfe) for l in tlogs] == \
            [(l.fwd_nfe, l.bwd_nfe) for l in jlogs]
        assert all(l.fwd_nfe > 0 and l.bwd_nfe > 0 for l in tlogs)

    def test_params_round_trip(self, row_epochs):
        """convert: the JAX params and state trees of the trained port model
        have the JAX package's structure, and convert back exactly."""
        _, _, _, tm, jp, jstate = row_epochs
        sd = tm.state_dict()
        tree, state = params_to_jax(sd), state_to_jax(sd)
        assert jax.tree.structure(tree) == jax.tree.structure(
            jax.tree.map(np.asarray, jp))
        assert jax.tree.structure(state) == jax.tree.structure(
            jax.tree.map(np.asarray, jstate))
        back = params_from_jax(tree, state)
        assert set(back) == set(sd)
        assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_tuned_rows_are_supported():
    from graph_neural_pde_tpu_torch.models.gnn import check_supported
    for row in ROWS:
        check_supported(best_params[row])


@pytest.mark.parametrize("row", ["Photo", "CoauthorCS"])
def test_shchur_stand_in_is_bit_identical(tmp_path, row):
    """With no .npz files both packages build the same SBM stand-in and the
    same seeded split (5,000 development nodes for CoauthorCS)."""
    cfg = best_params[row]
    jd = j_get_dataset(j_best[row], str(tmp_path), use_lcc=True)
    td = get_dataset(cfg, str(tmp_path), use_lcc=True)
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, m).numpy(),
                                      np.asarray(getattr(jd, m)))
    for a in ("row", "col", "mask"):
        np.testing.assert_array_equal(getattr(td.graph, a).numpy(),
                                      np.asarray(getattr(jd.graph, a)))


def test_shchur_npz_loader_matches_jax(tmp_path):
    """The .npz parser, to_undirected, LCC and the 1,500-node split give
    the JAX package's arrays exactly."""
    import scipy.sparse as sp
    rng = np.random.default_rng(2)
    n, f = 1800, 7
    adj = sp.random(n, n, density=0.002, random_state=3, format="csr")
    adj.data[:] = 1.0
    attr = sp.csr_matrix((rng.random((n, f)) < 0.3).astype(np.float32))
    raw = tmp_path / "Photo" / "raw"
    raw.mkdir(parents=True)
    np.savez(raw / "amazon_electronics_photo.npz",
             adj_data=adj.data, adj_indices=adj.indices,
             adj_indptr=adj.indptr, adj_shape=adj.shape,
             attr_data=attr.data, attr_indices=attr.indices,
             attr_indptr=attr.indptr, attr_shape=attr.shape,
             labels=rng.integers(0, 4, n))
    cfg = best_params["Photo"].replace(edge_pad_multiple=16)
    jd = j_get_dataset(j_best["Photo"].replace(edge_pad_multiple=16),
                       str(tmp_path), use_lcc=True, synthetic_fallback=False)
    td = get_dataset(cfg, str(tmp_path), use_lcc=True,
                     synthetic_fallback=False)
    assert td.name == "Photo" and td.num_classes == jd.num_classes
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, m).numpy(),
                                      np.asarray(getattr(jd, m)))
    for a in ("row", "col", "mask"):
        np.testing.assert_array_equal(getattr(td.graph, a).numpy(),
                                      np.asarray(getattr(jd.graph, a)))
