"""The PyTorch port's adaptive dopri5 solve (with its discrete-adjoint
gradient) and early-stop integrator, held against the JAX package on the
tuned Cora config at reduced width, from identical weights and inputs.

The accept/reject sequence must be the same step for step, so the counts
(accepted, rejected, NFE) are compared exactly; states and gradients differ
only by the order of f32 sums, amplified by the solve, so they are held at
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models.blocks import (block_forward as j_block_fwd,
                                                prepare_graph as j_prepare)
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu_torch.config import best_params
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.models.blocks import (ODEBlock, block_forward,
                                                      prepare_graph)
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm

# tuned Cora (config.py:277-285) at reduced width: 16 hidden, 4 heads of 4
SMALL = dict(hidden_dim=16, attention_dim=16, heads=4, input_dropout=0.0,
             dropout=0.0)
D = SMALL["hidden_dim"]


def _cfgs(**kw):
    return (j_best["Cora"].replace(**SMALL, **kw),
            best_params["Cora"].replace(**SMALL, **kw))


def _sbm(pkg_fn):
    return pkg_fn(num_nodes=60, num_classes=3, num_features=10, seed=4,
                  edge_pad_multiple=32, num_val=20)


def _randomised(params, seed):
    """Random attention Q/K and nonzero alpha/beta on top of a JAX init (the
    1e-5 constant Q/K init gives uniform attention)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, params)
    att = p["block"]["att"]
    for k in ("Q", "K"):
        att[k]["w"] = (0.3 * rng.normal(size=att[k]["w"].shape)) \
            .astype(np.float32)
    p["block"]["func"]["alpha_train"] = np.float32(0.4)
    p["block"]["func"]["beta_train"] = np.float32(-0.3)
    return p


@pytest.fixture(scope="module")
def solve_pair():
    """One training-mode block solve in each package, with gradients."""
    jcfg, tcfg = _cfgs()
    jd, td = _sbm(j_sbm), _sbm(make_sbm_dataset)
    n = td.x.shape[0]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, D)).astype(np.float32)
    probe = rng.normal(size=(n, D)).astype(np.float32)
    jmodel = JEarly(jcfg, 10, 3, jd.graph)
    p = _randomised(jmodel.init(jax.random.PRNGKey(1))[0], 2)

    jg = j_prepare(jcfg, jd.graph)

    def loss(bp, xx):
        z, stats, _ = j_block_fwd(bp, jcfg, jg, xx, training=True)
        return jnp.sum(z * probe), (z, stats)

    (_, (jz, jstats)), (jgb, jgx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p["block"]), jnp.asarray(x))

    tg = prepare_graph(tcfg, td.graph)
    block = ODEBlock(tcfg, D)
    sd = {k[len("block."):]: v for k, v in params_from_jax(p).items()
          if k.startswith("block.")}
    block.load_state_dict(sd)
    xt = torch.tensor(x, requires_grad=True)
    tz, tstats = block_forward(block, tcfg, tg, xt, True,
                               spmm_fn=make_spmm(tg))
    torch.sum(tz * torch.tensor(probe)).backward()
    return dict(jz=np.asarray(jz), jstats=jax.tree.map(np.asarray, jstats),
                jgb=jax.tree.map(np.asarray, jgb), jgx=np.asarray(jgx),
                tz=tz.detach().numpy(), tstats=tstats, block=block,
                tgx=xt.grad.numpy())


class TestDopri5:
    def test_identical_step_counts(self, solve_pair):
        j, t = solve_pair["jstats"], solve_pair["tstats"]
        assert t["accepted"] > 1
        assert (t["accepted"], t["rejected"], t["nfe"]) == (
            int(j["accepted"]), int(j["rejected"]), int(j["nfe"]))
        assert t["hit_max_steps"] == bool(j["hit_max_steps"])
        # t_final sums the accepted h, and h follows the error ratio, a
        # difference of nearly equal stage combinations whose last bits
        # depend on the order of f32 sums: same steps, h equal to ~1e-5
        np.testing.assert_allclose(t["t_final"], float(j["t_final"]),
                                   rtol=1e-4)

    def test_state(self, solve_pair):
        np.testing.assert_allclose(solve_pair["tz"], solve_pair["jz"],
                                   rtol=1e-4, atol=1e-5)

    def test_state_gradient(self, solve_pair):
        np.testing.assert_allclose(solve_pair["tgx"], solve_pair["jgx"],
                                   rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("name", ["func.alpha_train", "func.beta_train",
                                      "att.Q.w", "att.Q.b", "att.K.w",
                                      "att.K.b"])
    def test_parameter_gradients(self, solve_pair, name):
        want = solve_pair["jgb"]
        for k in name.split("."):
            want = want[k]
        got = dict(solve_pair["block"].named_parameters())[name].grad
        # rtol 1e-4, and an absolute floor of 1e-4 of the largest entry: an
        # entry that sums terms of mixed sign keeps their absolute error
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.max(np.abs(want))))


class TestEarlyStop:
    def test_best_snapshot_matches(self):
        """apply_early of both packages from one converted init: identical
        counts and best train/val/test accuracies (ratios of integer counts,
        so equal predictions give equal floats); t* is a sum of step sizes,
        held at rtol 1e-4 as t_final is above."""
        jcfg, tcfg = _cfgs()
        jd, td = _sbm(j_sbm), _sbm(make_sbm_dataset)
        jm = JEarly(jcfg, 10, 3, jd.graph)
        p = _randomised(jm.init(jax.random.PRNGKey(3))[0], 5)
        masks = (jd.train_mask, jd.val_mask, jd.test_mask)
        jlogits, jbest, jstats = jm.apply_early(
            jax.tree.map(jnp.asarray, p), {}, jd.x, jd.y, masks)

        tm = GNNEarlyModel(tcfg, 10, 3, td.graph)
        tm.load_state_dict(params_from_jax(p))
        tlogits, tbest, tstats = tm.apply_early(
            td.x, td.y, (td.train_mask, td.val_mask, td.test_mask))

        assert (tstats["accepted"], tstats["rejected"], tstats["nfe"]) == (
            int(jstats["accepted"]), int(jstats["rejected"]),
            int(jstats["nfe"]))
        assert (tbest.train, tbest.val, tbest.test) == (
            float(jbest.train), float(jbest.val), float(jbest.test))
        assert tbest.val > 0
        np.testing.assert_allclose(tbest.time, float(jbest.time), rtol=1e-4)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-5)
