"""The PyTorch port's image-diffusion model held against the JAX package on
the CPU: the pixel-grid graphs, the MNIST / CIFAR-10 parsers and the
seeded stand-in images (bit for bit), ``GNNImageModel``'s forward and
plots from converted weights, ``train_image`` on both aggregation engines,
and ``remat``: a fixed-grid solve checkpointed step by step gives the same
loss and gradients and saves fewer tensors for backward.
"""

import gzip
import math
import os
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_neural_pde_tpu.data.image as jimage
import graph_neural_pde_tpu.solvers.api as japi
from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.models.gnn_image import GNNImageModel as JImage
from graph_neural_pde_tpu.training.run_image import train_image as j_train
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.convert import (params_from_jax,
                                                params_to_jax)
from graph_neural_pde_tpu_torch.data import image
from graph_neural_pde_tpu_torch.models.gnn_image import GNNImageModel
from graph_neural_pde_tpu_torch.solvers.api import SolverOptions
from graph_neural_pde_tpu_torch.training.run_image import train_image

# the image CLI's configuration (run_image.py's __main__)
CLI = dict(block="constant", function="laplacian", method="rk4",
           step_size=1.0, time=3.0, input_dropout=0.0, dropout=0.0, lr=0.01,
           decay=0.0, self_loop_weight=1.0)
ENGINES = {"xla": {}, "pallas_blocked": dict(spmm_impl="pallas_blocked",
                                             spmm_block_n=128,
                                             spmm_chunk=128)}


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graph_equal(tg, jg):
    assert tg.num_nodes == jg.num_nodes
    for f in ("row", "col", "weight", "mask"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,diagonals", [(28, 28, False), (5, 7, True),
                                           (32, 32, True)])
def test_grid_graphs_are_bit_identical(h, w, diagonals):
    np.testing.assert_array_equal(image.grid_edge_index(h, w, diagonals),
                                  jimage.grid_edge_index(h, w, diagonals))
    _graph_equal(image.batched_grid_graph(3, h, w, diagonals, pad_multiple=64),
                 jimage.batched_grid_graph(3, h, w, diagonals,
                                           pad_multiple=64))


def test_synthetic_images_and_batches_are_bit_identical():
    tx, ty = image.synthetic_images(n=40, h=9, w=10, num_classes=3, seed=5)
    jx, jy = jimage.synthetic_images(n=40, h=9, w=10, num_classes=3, seed=5)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    td = image.load_image_dataset("/nonexistent", "MNIST", 8)
    jd = jimage.load_image_dataset("/nonexistent", "MNIST", 8)
    _graph_equal(td.graph, jd.graph)
    for (a, b), (c, d) in zip(td.batches(seed=3), jd.batches(seed=3)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def _write_idx(path, arr):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("ext", ["", ".gz"])
def test_mnist_parser_matches_jax(tmp_path, ext):
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(6)
    _write_idx(str(raw / f"t10k-images-idx3-ubyte{ext}"),
               rng.integers(0, 256, (5, 28, 28)))
    _write_idx(str(raw / f"t10k-labels-idx1-ubyte{ext}"),
               rng.integers(0, 10, 5))
    tx, ty = image.load_mnist(str(tmp_path), train=False)
    jx, jy = jimage.load_mnist(str(tmp_path), train=False)
    assert tx.shape == (5, 28, 28, 1)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    with pytest.raises(FileNotFoundError):
        image.load_mnist(str(tmp_path), train=True)


def test_cifar_parser_matches_jax(tmp_path):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(7)
    with open(base / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                     b"labels": list(rng.integers(0, 10, 4))}, f)
    tx, ty = image.load_cifar10(str(tmp_path), train=False)
    jx, jy = jimage.load_cifar10(str(tmp_path), train=False)
    assert tx.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    td = image.load_image_dataset(str(tmp_path), "CIFAR", 2, diagonals=True,
                                  train=False)
    assert (td.h, td.w, td.c) == (32, 32, 3)
    assert td.graph.num_valid == 2 * (2 * (31 * 32 * 2) + 4 * 31 * 31)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _models(engine, batch=4, h=6, w=5, c=2, classes=3, **kw):
    """Both packages' models over one batched grid, from the JAX init with
    nonzero alpha / beta."""
    jcfg = JConfig(**CLI, **ENGINES[engine], **kw)
    tcfg = Config(**CLI, **ENGINES[engine], **kw)
    jg = jimage.batched_grid_graph(batch, h, w, True)
    tg = image.batched_grid_graph(batch, h, w, True)
    jm = JImage(jcfg, jg, h, w, c, classes, batch)
    params, _ = jm.init(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    params["block"]["func"]["alpha_train"] = np.float32(0.7)
    params["block"]["func"]["beta_train"] = np.float32(-0.4)
    tm = GNNImageModel(tcfg, tg, h, w, c, classes, batch)
    tm.load_state_dict(params_from_jax(params))
    x = np.random.default_rng(4).random((batch * h * w, c)).astype(
        np.float32)
    return jm, tm, jax.tree.map(jnp.asarray, params), x


@pytest.mark.parametrize("engine", list(ENGINES))
def test_forward_matches_jax(engine):
    jm, tm, p, x = _models(engine)
    jl, _, jstats, _ = jm.apply(p, {}, jnp.asarray(x))
    with torch.no_grad():
        tl, tstats = tm(torch.tensor(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jl).max()))
    assert tstats["nfe"] == int(jstats["nfe"]) == 12
    assert tm.padded_nodes == jm.graph.num_nodes


@pytest.mark.parametrize("engine", list(ENGINES))
def test_plots_match_jax(engine):
    jm, tm, p, x = _models(engine)
    jt = np.asarray(jm.forward_plot_T(p, jnp.asarray(x)))
    tt = tm.forward_plot_T(torch.tensor(x)).numpy()
    assert tt.shape == (4, 60)
    np.testing.assert_allclose(tt, jt, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jt).max()))
    if engine == "xla":
        # the JAX package's path solve takes no engine, so over the
        # blocked plan's padded graph it has no state of the right size
        jpath = np.asarray(jm.forward_plot_path(p, jnp.asarray(x), 2))
        tpath = tm.forward_plot_path(torch.tensor(x), 2).numpy()
        assert tpath.shape == (4, 3, 60)
        np.testing.assert_allclose(tpath, jpath, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jpath).max()))


def test_params_round_trip():
    jm, tm, p, _ = _models("xla")
    tree = params_to_jax(tm.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, p))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(ENGINES))
def image_epochs(request, tmp_path_factory):
    """``train_image`` for 3 epochs x 4 batches of 16 stand-in images in
    both packages, the port from the JAX package's own init."""
    data_dir = str(tmp_path_factory.mktemp("nodata"))
    jcfg = JConfig(**CLI, **ENGINES[request.param])
    tcfg = Config(**CLI, **ENGINES[request.param])
    _, jhist = j_train(jcfg, data_dir, "MNIST", 16, 3, max_batches=4,
                       verbose=False)
    data = jimage.load_image_dataset(data_dir, "MNIST", 16)
    jm = JImage(jcfg, data.graph, data.h, data.w, data.c,
                int(data.y.max()) + 1, 16)
    params, _ = jm.init(jax.random.PRNGKey(jcfg.seed))
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model, thist = train_image(tcfg, data_dir, "MNIST", 16, 3, max_batches=4,
                               verbose=False, device="cpu", state_dict=sd)
    return request.param, jhist, thist, model


class TestTrainImage:
    def test_losses(self, image_epochs):
        """rtol 1e-4: twelve rk4 solves and adam updates."""
        _, jhist, thist, _ = image_epochs
        assert len(thist) == len(jhist) == 3
        np.testing.assert_allclose([h[0] for h in thist],
                                   [h[0] for h in jhist], rtol=1e-4)
        np.testing.assert_allclose([h[1] for h in thist],
                                   [h[1] for h in jhist])
        assert all(math.isfinite(h[0]) for h in thist)
        assert thist[0][0] != thist[-1][0]

    def test_state_is_the_channel_count(self, image_epochs):
        _, _, _, model = image_epochs
        assert model.cfg.hidden_dim == 1
        assert model.padded_nodes == 16 * 12 * 12


def test_train_image_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_image(Config(**CLI), "/nonexistent", epochs=1)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _loss_and_grads(remat: bool, adjoint: bool = False):
    """One training forward and backward of a small image model (rk4, 3
    steps), counting the tensors autograd saves for backward."""
    _, tm, _, x = _models("xla", remat=remat, adjoint=adjoint,
                          adjoint_method="rk4")
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        logits, _ = tm(torch.tensor(x), training=True)
        loss = torch.sum(logits * torch.arange(logits.numel()).reshape(
            logits.shape))
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in
                           tm.named_parameters() if p.grad is not None}, \
        len(saved)


def test_remat_same_loss_and_gradients_fewer_saved_tensors():
    """Bit for bit on the CPU: checkpointing recomputes each step's stages
    in backward from the state it kept; autograd saves the step inputs
    only."""
    loss0, grads0, saved0 = _loss_and_grads(False)
    loss1, grads1, saved1 = _loss_and_grads(True)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)
    assert grads0["block.func.alpha_train"].abs() > 0
    assert saved1 < saved0 / 2


def test_remat_is_off_under_the_adjoint():
    """As the JAX package's ``remat=cfg.remat and not adjoint``: the
    continuous adjoint's backward solve never checkpoints."""
    cfg = Config(**CLI, remat=True, adjoint=True)
    assert SolverOptions.from_config(cfg).remat
    assert not SolverOptions.from_config(cfg, adjoint=True).remat
    jcfg = JConfig(**CLI, remat=True, adjoint=True)
    assert japi.SolverOptions.from_config(jcfg, adjoint=True).remat is False
    loss0, grads0, _ = _loss_and_grads(False, adjoint=True)
    loss1, grads1, _ = _loss_and_grads(True, adjoint=True)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)
