"""The PyTorch port's tuned-Cora training slice as a whole: the stand-in
data, three training epochs against the JAX package's Trainer from one
converted init, the CLI entry point, the refusal of configs outside the
slice, and that the port runs without jax installed.
"""

import dataclasses
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.data.datasets import get_dataset as j_get_dataset
from graph_neural_pde_tpu.data.synthetic import make_sbm_dataset as j_sbm
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import run
from graph_neural_pde_tpu_torch.config import Config, best_params
from graph_neural_pde_tpu_torch.convert import params_from_jax, params_to_jax
from graph_neural_pde_tpu_torch.data.datasets import get_dataset
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.models.gnn import check_supported
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.training.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
SMALL = dict(hidden_dim=16, attention_dim=16, heads=4, input_dropout=0.0,
             dropout=0.0, epoch=4)


def test_cora_stand_in_is_bit_identical(tmp_path):
    """With no raw files both packages build the same SBM stand-in (2,708
    nodes, 512 features, 7 classes) and the same seeded split."""
    jd = j_get_dataset(j_best["Cora"], str(tmp_path), use_lcc=True)
    td = get_dataset(best_params["Cora"], str(tmp_path), use_lcc=True)
    assert (td.x.shape, td.num_classes) == ((2708, 512), 7)
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, m).numpy(),
                                      np.asarray(getattr(jd, m)))
    for a in ("row", "col", "weight", "mask"):
        np.testing.assert_array_equal(getattr(td.graph, a).numpy(),
                                      np.asarray(getattr(jd.graph, a)))


def _write_planetoid(root, rng, n_all=1800, n_test=200, f=6, c=3):
    """Small files in the Planetoid raw layout (ind.cora.*), test indices
    shuffled so the loader's reordering runs; 2,000 nodes, because the LCC
    path draws the 1,500-node development split."""
    import pickle
    import scipy.sparse as sp
    raw = root / "Cora" / "raw"
    raw.mkdir(parents=True)
    n = n_all + n_test
    feats = (rng.random((n, f)) < 0.4).astype(np.float32)
    labels = np.eye(c)[rng.integers(0, c, n)]
    test_idx = n_all + rng.permutation(n_test)
    objs = {"x": sp.csr_matrix(feats[:8]), "y": labels[:8],
            "allx": sp.csr_matrix(feats[:n_all]), "ally": labels[:n_all],
            "tx": sp.csr_matrix(feats[n_all:]), "ty": labels[n_all:],
            "graph": {i: sorted(set(rng.integers(0, n, 3).tolist()) - {i})
                      for i in range(n)}}
    for k, v in objs.items():
        with open(raw / f"ind.cora.{k}", "wb") as fh:
            pickle.dump(v, fh)
    (raw / "ind.cora.test.index").write_text(
        "\n".join(str(i) for i in test_idx) + "\n")


@pytest.mark.parametrize("use_lcc", [False, True])
def test_planetoid_loader_matches_jax(tmp_path, use_lcc):
    """The Planetoid parser, to_undirected/dedupe, LCC and split give the
    JAX package's arrays exactly."""
    _write_planetoid(tmp_path, np.random.default_rng(3))
    cfg = best_params["Cora"].replace(edge_pad_multiple=16)
    jd = j_get_dataset(j_best["Cora"].replace(edge_pad_multiple=16),
                       str(tmp_path), use_lcc=use_lcc,
                       synthetic_fallback=False)
    td = get_dataset(cfg, str(tmp_path), use_lcc=use_lcc,
                     synthetic_fallback=False)
    assert td.name == "Cora" and td.num_classes == jd.num_classes
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(td, m).numpy(),
                                      np.asarray(getattr(jd, m)))
    for a in ("row", "col", "weight", "mask"):
        np.testing.assert_array_equal(getattr(td.graph, a).numpy(),
                                      np.asarray(getattr(jd.graph, a)))


@pytest.fixture(scope="module")
def three_epochs():
    """Three epochs of each package's Trainer from one JAX GNNEarlyModel
    init, dropout off."""
    jcfg = j_best["Cora"].replace(**SMALL)
    tcfg = best_params["Cora"].replace(**SMALL)
    kw = dict(num_nodes=60, num_classes=3, num_features=10, seed=4,
              edge_pad_multiple=32, num_val=20)
    jd, td = j_sbm(**kw), make_sbm_dataset(**kw)
    jm = JEarly(jcfg, 10, 3, jd.graph)
    params, state = jm.init(jax.random.PRNGKey(7))
    # attention Q/K off their 1e-5 constant init so the freeze is nontrivial
    rng = np.random.default_rng(8)
    params = jax.tree.map(np.asarray, params)
    for k in ("Q", "K"):
        w = params["block"]["att"][k]["w"]
        params["block"]["att"][k]["w"] = \
            (0.3 * rng.normal(size=w.shape)).astype(np.float32)

    tm = GNNEarlyModel(tcfg, 10, 3, td.graph)
    tm.load_state_dict(params_from_jax(params))

    jparams = jax.tree.map(jnp.asarray, params)
    jt = JTrainer(jm)
    carry = {"params": jparams, "state": state,
             "opt_state": jt.optimizer.init(jparams),
             "key": jax.random.PRNGKey(0), "epoch": 1,
             "best": {"val_acc": 0.0, "test_acc": 0.0, "train_acc": 0.0,
                      "epoch": 0}}
    _, _, jbest, jlogs = jt.fit(jd, epochs=4, carry=carry, verbose=False)
    tbest, tlogs = Trainer(tm).fit(td, epochs=4, verbose=False)
    return jlogs, tlogs, tm, jt


class TestThreeEpochs:
    def test_losses(self, three_epochs):
        """rtol 1e-4: three adaptive solves and adamax updates, each
        differing from the JAX package only in the order of f32 sums."""
        jlogs, tlogs, _, _ = three_epochs
        assert len(tlogs) == len(jlogs) == 3
        np.testing.assert_allclose([l.loss for l in tlogs],
                                   [l.loss for l in jlogs], rtol=1e-4)
        assert all(math.isfinite(l.loss) for l in tlogs)
        # training moves the loss
        assert tlogs[0].loss != tlogs[-1].loss

    def test_nfe(self, three_epochs):
        """Identical per-epoch forward and backward NFE: the same
        accept/reject sequence in every solve."""
        jlogs, tlogs, _, _ = three_epochs
        assert [(l.fwd_nfe, l.bwd_nfe) for l in tlogs] == \
            [(l.fwd_nfe, l.bwd_nfe) for l in jlogs]
        assert all(l.fwd_nfe > 0 and l.bwd_nfe > 0 for l in tlogs)

    def test_params_round_trip(self, three_epochs):
        """convert.params_to_jax inverts params_from_jax."""
        _, _, tm, _ = three_epochs
        back = params_from_jax(params_to_jax(tm.state_dict()))
        for k, v in tm.state_dict().items():
            assert torch.equal(back[k], v)


def test_cli_main_runs_the_tuned_path(tmp_path, capsys):
    """run.main on tuned Cora at reduced width over the stand-in: GNNEarly
    with the early-stop eval after each epoch."""
    cfg = best_params["Cora"].replace(hidden_dim=8, attention_dim=8, heads=2,
                                      epoch=3)
    res = run.main(cfg, data_dir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("[device] cpu\n")
    assert out.count("Epoch: ") == 2 and "best val accuracy" in out
    assert len(res.logs) == 2
    for log in res.logs:
        assert math.isfinite(log.loss) and log.fwd_nfe > 0
        assert log.bwd_nfe == 0 or log.bwd_nfe % 7 == 0
    assert 0 < res.best["best_time"] <= cfg.earlystopxT * cfg.time * 1.01
    assert 0 < res.best["val_acc"] <= 1


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    """The CLI trains on the card: with no CUDA device it raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(best_params["Cora"].replace(epoch=2), data_dir=str(tmp_path))


def test_cli_parser_builds_config():
    args = run.build_parser().parse_args(
        ["--dataset", "Cora", "--use_best_params", "--epoch", "4",
         "--no-add_source"])
    cfg = run.config_from_args(args)
    assert cfg == best_params["Cora"].replace(epoch=4, add_source=False)


@pytest.mark.parametrize("override", [
    dict(block="rewire_attention"), dict(use_mlp=True),
    dict(fc_out=True),
    dict(augment=True), dict(kinetic_energy=0.1), dict(method="cheby"),
    dict(optimizer="sgd"), dict(method="explicit_adams"),
    dict(mesh_devices=4), dict(rewire_KNN=True),
])
def test_configs_outside_the_slice_raise(override):
    cfg = best_params["Cora"].replace(**override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(cfg)


def test_every_other_tuned_row_is_refused():
    """Every tuned row is ported, ogbn-arxiv and its label diffusion
    included, and so is the arxiv row with ``beltrami`` (its tuned
    ``pos_enc_type`` and ``pos_enc_hidden_dim``, read only by BLEND's dual
    encoder): no tuned row is refused."""
    for cfg in best_params.values():
        check_supported(cfg)
    check_supported(best_params["ogbn-arxiv"].replace(use_labels=True))
    check_supported(best_params["ogbn-arxiv"].replace(beltrami=True))


def test_port_runs_without_jax():
    """A fresh interpreter in which jax cannot be imported imports every
    module of the port and runs one CPU forward."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import importlib, pkgutil
        import graph_neural_pde_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import torch
        from graph_neural_pde_tpu_torch.config import best_params
        from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
        from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
        cfg = best_params["Cora"].replace(hidden_dim=8, attention_dim=8,
                                          heads=2)
        d = make_sbm_dataset(num_nodes=40, num_features=6, seed=1)
        m = GNNEarlyModel(cfg, 6, 3, d.graph)
        with torch.no_grad():
            logits, stats = m(d.x)
        assert logits.shape == (40, 3) and torch.isfinite(logits).all()
        assert stats["nfe"] > 0
        nl = cfg.replace(function="transformer", block="constant",
                         attention_norm_idx=0, square_plus=False)
        for c in (nl, nl.replace(square_plus=True),
                  nl.replace(attention_norm_idx=1),
                  nl.replace(function="GAT"), nl.replace(mix_features=True),
                  nl.replace(block="hard_attention"),
                  cfg.replace(block="mixed"),
                  cfg.replace(spmm_impl="pallas_blocked", spmm_block_n=16,
                              spmm_chunk=16)):
            m = GNNEarlyModel(c, 6, 3, d.graph)
            with torch.no_grad():
                logits, stats = m(d.x)
            assert torch.isfinite(logits).all() and stats["nfe"] > 0
        from graph_neural_pde_tpu_torch.training.run_image import train_image
        from graph_neural_pde_tpu_torch.config import Config
        _, hist = train_image(Config(block="constant", method="rk4",
                                     self_loop_weight=1.0), "/nonexistent",
                              batch_size=4, epochs=1, max_batches=1,
                              verbose=False, device="cpu")
        assert len(hist) == 1
        assert "graph_neural_pde_tpu_torch.kernels.dual_scatter" in sys.modules
        assert "graph_neural_pde_tpu_torch.kernels.norm1" in sys.modules
        assert "graph_neural_pde_tpu_torch.kernels.blocked" in sys.modules
        assert "graph_neural_pde_tpu_torch.parallel.shard_spmm" in sys.modules
        assert "graph_neural_pde_tpu_torch.probes.gather" in sys.modules
        from graph_neural_pde_tpu_torch.parallel import split_mesh
        from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
            make_sharded_stripe_spmm)
        from graph_neural_pde_tpu_torch.ops.spmm import spmm
        g = GNNEarlyModel(cfg, 6, 3, d.graph).graph
        f = make_sharded_stripe_spmm(split_mesh(2, "cpu"), g)
        xs = torch.ones((40, 3))
        assert torch.allclose(f(xs, g.weight), spmm(g, xs), atol=1e-6)
        bad = [k for k, mod in sys.modules.items() if mod is not None and (
            k.split(".")[0] in ("jax", "graph_neural_pde_tpu"))]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_config_is_a_copy_of_the_jax_config():
    """Same fields, defaults and tuned rows as graph_neural_pde_tpu.config."""
    from graph_neural_pde_tpu.config import Config as JConfig
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JConfig())
    assert best_params.keys() == j_best.keys()
    for k in best_params:
        assert dataclasses.asdict(best_params[k]) == \
            dataclasses.asdict(j_best[k])
