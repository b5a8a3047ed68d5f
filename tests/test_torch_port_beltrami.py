"""BLEND in the PyTorch port, held against the JAX package on the CPU: the
positional encodings (``rewiring/positional.py``: the numpy random walks,
DeepWalk's skip-gram training from one shared start, the GDC encoding, the
``.pkl`` / ``.npz`` caches), the kNN graphs and the ``pos_enc_knn``
rewiring (``rewiring/knn.py``), the split-space attention scores, the
fused engines with the ``exp_kernel_beltrami`` score (over rows on a
symmetric and on a directed graph, over columns, and the eval fold), and
three training epochs of BLEND models from identical weights.

On the CPU every kernel wrapper runs its plain version, so what is held
against the JAX package here is exactly what the kernels are held against
on the card (``chip_smoke.py``). Inputs are made with numpy from a seed and
handed to both packages.
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_neural_pde_tpu.runtime as jruntime
from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.config import best_params as j_best
from graph_neural_pde_tpu.models import attention as jattention
from graph_neural_pde_tpu.models import blocks as jblocks
from graph_neural_pde_tpu.models import functions as jfunctions
from graph_neural_pde_tpu.models.gnn_early import GNNEarlyModel as JEarly
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.rewiring import knn as jknn
from graph_neural_pde_tpu.rewiring import positional as jpos
from graph_neural_pde_tpu.training.train import Trainer as JTrainer
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config, best_params
from graph_neural_pde_tpu_torch.convert import params_from_jax, params_to_jax
from graph_neural_pde_tpu_torch.data.datasets import get_dataset
from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
from graph_neural_pde_tpu_torch.models import attention as tattention
from graph_neural_pde_tpu_torch.models import functions as tfunctions
from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
from graph_neural_pde_tpu_torch.models.gnn import GNNModel, check_supported
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.ops.graph import make_graph
from graph_neural_pde_tpu_torch.rewiring import knn as tknn
from graph_neural_pde_tpu_torch.rewiring import positional as tpos
from graph_neural_pde_tpu_torch.training.train import Trainer

FH, PH = 12, 4                 # feature and position widths of the state
ATT, H = 8, 2                  # attention_dim (each half), heads


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


def _valid_edges(g):
    m = np.asarray(g.mask)
    return np.asarray(g.row)[m], np.asarray(g.col)[m]


def _sbm_edges(n=160, seed=5):
    """A symmetric SBM edge list (with the two packages' stand-in)."""
    d = make_sbm_dataset(num_nodes=n, num_classes=3, num_features=4,
                         seed=seed)
    return _valid_edges(d.graph) + (n,)


def _edge_set(row, col):
    return sorted(zip(np.asarray(row).tolist(), np.asarray(col).tolist()))


# ---------------------------------------------------------------------------
# positional encodings
# ---------------------------------------------------------------------------

def test_random_walks_match_jax():
    """The numpy walks step for step, isolated nodes (5 and 6) looping on
    themselves. An isolated LAST node makes the JAX package's walk index
    past its edge list and raise (ROADMAP Queue 3, R9); the port's loops
    there too."""
    row, col, n = _sbm_edges()
    row, col = (np.where(a >= 5, a + 2, a).astype(a.dtype) for a in (row,
                                                                     col))
    got = tpos.random_walks(row, col, n + 2, seed=3)
    want = jpos.random_walks(row, col, n + 2, seed=3)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (10 * (n + 2), 21)
    assert (got[5::n + 2] == 5).all() and (got[6::n + 2] == 6).all()
    with pytest.raises(IndexError):
        jpos.random_walks(row, col, n + 3, seed=3)
    tail = tpos.random_walks(row, col, n + 3, seed=3)
    assert (tail[n + 2::n + 3] == n + 2).all()


def test_deepwalk_matches_jax(monkeypatch):
    """Skip-gram with negative sampling from the JAX package's first
    embedding ``0.1 jax.random.normal(PRNGKey(seed))``, handed to the
    port, against the JAX package's DeepWalk on its numpy walks (its C++
    walk library switched off): 1e-4 of scale after three epochs of two
    65,536-pair steps each. At the default rate of 0.01 six steps move the
    embedding by 2e-5 of its scale, under the tolerance, so the steps here
    are a hundred times longer."""
    monkeypatch.setattr(jruntime, "available", lambda: False)
    row, col, n = _sbm_edges(160)
    seed, dim, lr = 2, 16, 1.0
    want = jpos.deepwalk_embeddings(row, col, n, dim=dim, seed=seed, lr=lr)
    init = np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(seed),
                                              (n, dim)))
    centers, contexts = tpos.skipgram_pairs(
        tpos.random_walks(row, col, n, seed=seed), 5)
    assert centers.shape[0] >= 2 * tpos.SGNS_BATCH
    got = tpos.sgns_train(torch.tensor(init), centers, contexts, n,
                          seed=seed, lr=lr)
    assert got.dtype == np.float32 and got.shape == (n, dim)
    assert _rel(got, want) < 1e-4
    assert _rel(got, init) > 0.1           # the steps moved it
    # the port's own start: a seeded torch draw, deterministic
    again = tpos.deepwalk_embeddings(row, col, n, dim=dim, seed=seed,
                                     device="cpu")
    np.testing.assert_array_equal(
        again, tpos.deepwalk_embeddings(row, col, n, dim=dim, seed=seed,
                                        device="cpu"))


def _graph_pair(row, col, n, pad_multiple=16):
    return (j_make_graph(row, col, None, num_nodes=n,
                         pad_multiple=pad_multiple),
            make_graph(row, col, num_nodes=n, pad_multiple=pad_multiple))


def test_gdc_encoding_matches_jax():
    """``apply_beltrami`` with ``pos_enc_type="GDC"``: the dense diffusion
    matrix normalised over columns, not sparsified, at 1e-5 of scale."""
    row, col, n = _sbm_edges(60)
    jg, tg = _graph_pair(row, col, n)
    cfg = dict(pos_enc_type="GDC", self_loop_weight=1.0)
    got = tpos.apply_beltrami(tg, Config(**cfg), device="cpu")
    want = jpos.apply_beltrami(jg, JConfig(**cfg))
    assert got.dtype == np.float32 and got.shape == (n, n)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("reordered", [False, True])
def test_apply_beltrami_reads_the_caches(tmp_path, reordered):
    """The reference's pickle (DeepWalk: ``{'data': pe}``) and the ``.npz``
    cache, read by both packages, permuted by ``node_order``; a fresh
    DeepWalk encoding is cached as ``.npz`` (the JAX package reads it) but
    not under a node order."""
    row, col, n = _sbm_edges(60)
    jg, tg = _graph_pair(row, col, n)
    rng = np.random.default_rng(9)
    order = rng.permutation(n) if reordered else None
    (tmp_path / "pos_encodings").mkdir()
    pe_pkl = rng.normal(size=(n, 6)).astype(np.float32)
    with open(tmp_path / "pos_encodings" / "Cora_DW6.pkl", "wb") as f:
        pickle.dump({"data": pe_pkl}, f)
    pe_npz = rng.normal(size=(n, 5)).astype(np.float32)
    np.savez(tmp_path / "pos_encodings" / "Cora_GDC.npz", pe=pe_npz)
    for typ, pe in (("DW6", pe_pkl), ("GDC", pe_npz)):
        cfg = dict(dataset="Cora", pos_enc_type=typ)
        got = tpos.apply_beltrami(tg, Config(**cfg), str(tmp_path),
                                  node_order=order, device="cpu")
        want = jpos.apply_beltrami(jg, JConfig(**cfg), str(tmp_path),
                                   node_order=order)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pe[order] if reordered else pe)
    cfg = dict(dataset="Cora", pos_enc_type="DW4", seed=1)
    fresh = tpos.apply_beltrami(tg, Config(**cfg), str(tmp_path),
                                node_order=order, device="cpu")
    cached = tmp_path / "pos_encodings" / "Cora_DW4.npz"
    assert fresh.shape == (n, 4) and np.isfinite(fresh).all()
    assert cached.exists() != reordered
    if not reordered:
        np.testing.assert_array_equal(
            jpos.apply_beltrami(jg, JConfig(**cfg), str(tmp_path)), fresh)
    with pytest.raises(ValueError, match="does not exist"):
        tpos.apply_beltrami(tg, Config(pos_enc_type="LAP"), device="cpu")


# ---------------------------------------------------------------------------
# kNN graphs and the pos_enc_knn rewiring
# ---------------------------------------------------------------------------

class TestKnn:
    pe = np.random.default_rng(11).normal(size=(70, 8)).astype(np.float32)

    @pytest.mark.parametrize("symmetric", [False, True])
    def test_knn_graph(self, symmetric):
        """The k nearest nodes of each node (itself included), tiled: the
        same edge set as the JAX package's."""
        got = tknn.knn_graph(self.pe, 6, symmetric=symmetric, tile=16,
                             device="cpu")
        want = jknn.knn_graph(self.pe, 6, symmetric=symmetric, tile=16)
        assert _edge_set(*got) == _edge_set(*want)
        if not symmetric:
            np.testing.assert_array_equal(got[0], np.repeat(np.arange(70), 6))
            assert (got[1].reshape(70, 6)[:, 0] == np.arange(70)).all()

    def test_distances_and_sparsifiers(self):
        """Dense distances at 1e-5 of scale off the diagonal (on it both
        packages take the root of |x|^2 - 2 x.x + |x|^2, float32 rounding
        noise: within sqrt(1e-6) of scale); kNN and the quantile threshold
        over one distance matrix give the JAX package's edges; the
        Poincaré distances at 1e-5."""
        dist = tknn.pairwise_distances(self.pe, device="cpu")
        jdist = np.asarray(jknn.pairwise_distances(self.pe))
        off = ~np.eye(70, dtype=bool)
        assert _rel(dist[off], jdist[off]) < 1e-5
        assert np.abs(np.diag(dist)).max() < 1e-3 * np.abs(jdist).max()
        np.testing.assert_array_equal(tknn.apply_dist_knn(jdist, 5),
                                      jknn.apply_dist_knn(jdist, 5))
        for q in (0.001, 0.02):
            np.testing.assert_array_equal(
                tknn.apply_dist_threshold(jdist, q),
                jknn.apply_dist_threshold(jdist, q))
        for scale in (0.05, 1.0):          # inside and outside the ball
            got = tknn.hyperbolize(scale * self.pe)
            assert _rel(got, jknn.hyperbolize(scale * self.pe)) < 1e-5

    @pytest.mark.parametrize("pos_enc_type", ["DW16", "HYP16"])
    @pytest.mark.parametrize("sparsify", ["topk", "threshold"])
    def test_apply_pos_dist_rewire(self, tmp_path, pos_enc_type, sparsify):
        """The ``pos_enc_knn`` rewiring from a cached DeepWalk encoding
        (``HYP16`` finds no hyperbolic encoding on disk and hyperbolises
        the cached DW64 one, as the JAX package does): the same edge list
        in both packages, a directed graph for kNN. The DeepWalk threshold
        keeps the closest 1/1000 of all pairs, self pairs included, whose
        float32 distances are rounding noise that differs between the
        packages' matmuls: that case takes an integer-valued encoding,
        whose distances both packages compute exactly."""
        row, col, n = _sbm_edges(80)
        jg, tg = _graph_pair(row, col, n)
        rng = np.random.default_rng(12)
        if pos_enc_type == "DW16" and sparsify == "threshold":
            pe = rng.integers(-3, 4, size=(n, 16)).astype(np.float32)
        else:
            pe = rng.normal(size=(n, 16)).astype(np.float32)
        # a cache directory each: neither package reads what the other
        # computed (HYP caches its distances)
        for side in ("t", "j"):
            (tmp_path / side / "pos_encodings").mkdir(parents=True)
            for typ in ("DW16", "DW64"):
                np.savez(tmp_path / side / "pos_encodings" / f"Cora_{typ}.npz",
                         pe=pe)
        kw = dict(dataset="Cora", pos_enc_type=pos_enc_type, gdc_k=5,
                  gdc_sparsification=sparsify, pos_dist_quantile=0.02,
                  edge_pad_multiple=16)
        got = tknn.apply_pos_dist_rewire(tg, Config(**kw),
                                         str(tmp_path / "t"), device="cpu")
        want = jknn.apply_pos_dist_rewire(jg, JConfig(**kw),
                                          str(tmp_path / "j"))
        assert got.num_nodes == n and got.capacity % 16 == 0
        np.testing.assert_array_equal(np.stack(_valid_edges(got)),
                                      np.stack(_valid_edges(want)))
        if sparsify == "topk":
            assert prepare_graph(Config(**NL), got).rev is None
        with pytest.raises(ValueError, match="DW\\*/HYP\\*"):
            tknn.apply_pos_dist_rewire(tg, Config(**dict(
                kw, pos_enc_type="GDC")), str(tmp_path / "t"), device="cpu")

    def test_loader_rewires(self, tmp_path):
        """``get_dataset`` with ``rewiring="pos_enc_knn"`` rebuilds the
        stand-in's edges from its encodings' nearest neighbours."""
        cfg = best_params["Cora"].replace(rewiring="pos_enc_knn",
                                          pos_enc_type="DW16", gdc_k=4)
        base = get_dataset(cfg.replace(rewiring=None), str(tmp_path),
                           device="cpu")
        n = base.graph.num_nodes
        pe = np.random.default_rng(13).normal(size=(n, 16)).astype(
            np.float32)
        (tmp_path / "pos_encodings").mkdir()
        np.savez(tmp_path / "pos_encodings" / "Cora_DW16.npz", pe=pe)
        d = get_dataset(cfg, str(tmp_path), device="cpu")
        r, c = _valid_edges(d.graph)
        want = tknn.knn_graph(pe, 4, device="cpu")
        assert _edge_set(r, c) == _edge_set(*want)


def test_blend_configs_are_supported():
    for cfg in (best_params["Cora"].replace(beltrami=True),
                best_params["ogbn-arxiv"].replace(beltrami=True),
                best_params["Cora"].replace(rewiring="pos_enc_knn"),
                Config(**NL).replace(rewiring="pos_enc_knn")):
        check_supported(cfg)
    with pytest.raises(ValueError, match="mix_features"):
        check_supported(Config(**NL).replace(mix_features=True))


# ---------------------------------------------------------------------------
# the split-space attention
# ---------------------------------------------------------------------------

NL = dict(function="transformer", block="constant", attention_norm_idx=0,
          square_plus=False, self_loop_weight=1.0, add_source=True,
          beltrami=True, attention_type="exp_kernel", feat_hidden_dim=FH,
          pos_enc_hidden_dim=PH, hidden_dim=FH + PH, attention_dim=ATT,
          heads=H)


def _random_att(att, rng):
    """The split-space layer's projections drawn off their 1e-5 constant
    init (nonuniform attention) and its four scalars away from 1."""
    for k in ("Qx", "Kx", "Qp", "Kp"):
        att[k]["w"] = (0.3 * rng.normal(size=att[k]["w"].shape)).astype(
            np.float32)
        att[k]["b"] = (0.1 * rng.normal(size=att[k]["b"].shape)).astype(
            np.float32)
    for k, v in (("output_var_x", 1.3), ("lengthscale_x", 0.8),
                 ("output_var_p", 0.9), ("lengthscale_p", 1.4)):
        att[k] = np.float32([v])


@pytest.mark.parametrize("labels", [0, 3])
def test_scores_and_attention_match_jax(labels):
    """Raw scores and the normalised attention of the split-space layer
    over a state [features | positions | labels], at 1e-5 of scale."""
    row, col, n = _sbm_edges(50)
    kw = dict(NL, attention_norm_idx=1, square_plus=True)
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    jg, tg = _graph_pair(row, col, n)
    jg, tg = jblocks.prepare_graph(jcfg, jg), prepare_graph(tcfg, tg)
    d = FH + PH + labels
    rng = np.random.default_rng(14)
    att = jax.tree.map(np.asarray, jattention.init_transformer_attention(
        jax.random.PRNGKey(0), jcfg, d))
    _random_att(att, rng)
    layer = tattention.TransformerAttention(tcfg, d)
    layer.load_state_dict(params_from_jax(att))
    assert layer.Qx.w.shape == (FH + labels, ATT)
    assert layer.Qp.w.shape == (PH, ATT)
    x = rng.normal(size=(n, d)).astype(np.float32)
    want_s, _ = jattention.transformer_scores(
        jax.tree.map(jnp.asarray, att), jcfg, jnp.asarray(x), jg)
    got_s = tattention.transformer_scores(layer, tcfg, torch.tensor(x), tg)
    m = tg.mask.numpy()
    assert _rel(got_s.detach().numpy()[m], np.asarray(want_s)[m]) < 1e-5
    want, _ = jattention.apply_transformer_attention(
        jax.tree.map(jnp.asarray, att), jcfg, jnp.asarray(x), jg)
    got = tattention.apply_transformer_attention(layer, tcfg,
                                                 torch.tensor(x), tg)
    assert _rel(got.detach().numpy()[m], np.asarray(want)[m]) < 1e-5


def test_packed_projections():
    """``pack_beltrami``'s [D, 2 ATT] projections give (Qx x_feat ‖ Qp
    x_pos) and (Kx ‖ Kp) over a state with labels, exactly the composed
    layer's q and k."""
    tcfg = Config(**NL)
    d = FH + PH + 3
    layer = tattention.TransformerAttention(tcfg, d)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn(20, d, generator=gen)
    qw, qb, kw, kb = tfunctions.pack_beltrami(layer, tcfg, d)
    assert qw.shape == (d, 2 * ATT)
    q, k = tattention.query_key(layer, tcfg, x)
    assert _rel(x @ qw + qb, q.detach().numpy()) < 1e-6
    assert _rel(x @ kw + kb, k.detach().numpy()) < 1e-6


def _directed(seed, n=40, e=160):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e).astype(np.int32)
    c = rng.integers(1, n, e).astype(np.int32)
    keep = r != c
    return r[keep], c[keep], n


def _symmetric(seed, n=40, e=100):
    r, c, n = _directed(seed, n, e)
    return np.concatenate([r, c]), np.concatenate([c, r]), n


def _rhs_pair(graph, labels=0, **kw):
    """make_rhs in both packages over one graph from one JAX init of the
    split-space ODE function; returns a callable that checks the value
    (1e-5 of scale) and every gradient, the four scalars' included (1e-4 of
    each leaf's scale), of ``sum(rhs(x) * probe)``."""
    kw = dict(NL, **kw)
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    row, col, n = graph
    jg, tg = _graph_pair(row, col, n)
    jg, tg = jblocks.prepare_graph(jcfg, jg), prepare_graph(tcfg, tg)
    d = FH + PH + labels
    rng = np.random.default_rng(15)
    p = jax.tree.map(np.asarray, jfunctions.init_func_params(
        jax.random.PRNGKey(1), jcfg, d))
    p["alpha_train"], p["beta_train"] = np.float32(0.3), np.float32(0.2)
    _random_att(p["att"], rng)
    func = tfunctions.ODEFunc(tcfg, d)
    func.load_state_dict(params_from_jax(p))
    x = rng.normal(size=(n, d)).astype(np.float32)
    x0 = rng.normal(size=(n, d)).astype(np.float32)
    probe = rng.normal(size=(n, d)).astype(np.float32)
    jaux = jfunctions.FuncAux(None, jnp.asarray(x0), jg.weight)
    taux = tfunctions.FuncAux(None, torch.tensor(x0), tg.weight)
    jrhs = jfunctions.make_rhs(jcfg, jg)

    def jloss(pp, xx):
        out = jrhs(pp, jaux, 0.0, xx)
        return jnp.sum(out * probe), out

    (_, want), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, p),
                                             jnp.asarray(x))

    def check(eval_fold=False, live=True):
        """``live``: the four scalars' and Kp's gradients must be far from
        0 (above 1e-3 of the largest gradient), so that they are held to
        their own scale."""
        trhs = tfunctions.make_rhs(tcfg, tg, eval_fold=eval_fold)
        if eval_fold:
            with torch.no_grad():
                out = trhs(func, taux, 0.0, torch.tensor(x))
            assert _rel(out, want) < 1e-5
            return tg
        xt = torch.tensor(x, requires_grad=True)
        func.zero_grad()
        out = trhs(func, taux, 0.0, xt)
        torch.sum(out * torch.tensor(probe)).backward()
        assert _rel(out, want) < 1e-5
        assert _rel(xt.grad, gx) < 1e-4
        wantp = params_from_jax(jax.tree.map(np.asarray, gp))
        got = {k: v.grad for k, v in func.named_parameters()}
        top = max(float(v.abs().max()) for v in wantp.values())
        for k in ("att.output_var_x", "att.lengthscale_x",
                  "att.output_var_p", "att.lengthscale_p", "att.Kp.w"):
            assert not live or float(wantp[k].abs().max()) > 1e-3 * top, k
        for k, wv in wantp.items():
            g = got[k] if got[k] is not None else torch.zeros_like(wv)
            scale = float(wv.abs().max())
            bound = 1e-4 * (scale if scale > 1e-3 * top else top)
            assert float((g - wv).abs().max()) <= bound, k
        return tg

    return check


def _calls(monkeypatch, module, names):
    """Count the calls of ``module``'s functions ``names``."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(module, name)

        def counting(*a, _name=name, _real=real, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, name, counting)
    return counts


class TestFusedEngines:
    """The fused RHS with the ``exp_kernel_beltrami`` score (the plain
    versions of K6, K9, K8 without dxg, K17, K12-K14) against the JAX
    package's f32 XLA composition of the split-space attention."""

    @pytest.mark.parametrize("labels", [0, 3])
    def test_rows_symmetric(self, labels, monkeypatch):
        """K6 forward, K9 backward."""
        calls = _calls(monkeypatch, kernels.fused_rhs,
                       ("fused_rhs_fwd", "fused_rhs_bwd_sym"))
        tg = _rhs_pair(_symmetric(20), labels)()
        assert tg.rev is not None and all(calls.values())

    def test_rows_directed(self, monkeypatch):
        """K6 forward, the column-plan backward: K8 without dxg, K17."""
        calls = _calls(monkeypatch, kernels.fused_rhs,
                       ("fused_rhs_bwd", "fused_rhs_bwd_col",
                        "fused_rhs_bwd_sym"))
        tg = _rhs_pair(_directed(21))()
        assert tg.rev is None
        assert calls["fused_rhs_bwd_col"] and calls["fused_rhs_bwd"]
        assert not calls["fused_rhs_bwd_sym"]

    def test_rows_sym_backward_off(self, monkeypatch):
        """``sym_backward=False`` takes K8 without dxg and K17 on a
        symmetric graph too."""
        calls = _calls(monkeypatch, kernels.fused_rhs,
                       ("fused_rhs_bwd_col", "fused_rhs_bwd_sym"))
        _rhs_pair(_symmetric(22), sym_backward=False)()
        assert calls["fused_rhs_bwd_col"] and not calls["fused_rhs_bwd_sym"]

    @pytest.mark.parametrize("labels", [0, 3])
    def test_columns(self, labels, monkeypatch):
        """The softmax over columns: K12 and K13, then K12 weighted and
        K14, whose mirror trick scores each reverse edge (q at the
        gathered node against k at the resident one) with Kp away from
        Qp."""
        calls = _calls(monkeypatch, kernels.norm1,
                       ("norm1_den", "norm1_fwd", "norm1_bwd"))
        _rhs_pair(_symmetric(23), labels, attention_norm_idx=1)()
        assert all(calls.values())

    def test_eval_fold(self, monkeypatch):
        """The no-grad solves' RHS: alpha (ax - x) folded into K6."""
        calls = _calls(monkeypatch, kernels.fused_rhs, ("fused_rhs_fwd",))
        _rhs_pair(_symmetric(24), 3)(eval_fold=True)
        assert calls["fused_rhs_fwd"]

    def test_composed_paths(self):
        """Squareplus and the reweighted scores compose the split-space
        scores and aggregate on K10/K11."""
        for kw in (dict(square_plus=True), dict(reweight_attention=True),
                   dict(attention_norm_idx=1, square_plus=True)):
            _rhs_pair(_symmetric(25), **kw)(live=False)
        _rhs_pair(_directed(26), attention_norm_idx=1)(live=False)

    @pytest.mark.parametrize("bad", ["var", "att"])
    def test_wrappers_reject(self, bad):
        """The score takes two elements of var and ls (the feature and the
        position factor's), and a packed width of two halves of heads
        slices."""
        n, d, att = 6, 4, 2 * ATT
        rowptr = torch.zeros(n + 1, dtype=torch.int32)
        row = col = torch.zeros(0, dtype=torch.int32)
        x, qw, kw = torch.zeros(n, d), torch.zeros(d, att), torch.zeros(d,
                                                                        att)
        qb, kb = torch.zeros(att), torch.zeros(att)
        var, ls, heads = torch.ones(2), torch.ones(2), H
        if bad == "var":
            var = torch.ones(1)
        else:
            heads = 3
        with pytest.raises(ValueError):
            kernels.fused_rhs_fwd(rowptr, row, col, x, qw, qb, kw, kb,
                                  torch.zeros(1), heads=heads,
                                  score="exp_kernel_beltrami", var=var, ls=ls)


# ---------------------------------------------------------------------------
# three epochs of BLEND models
# ---------------------------------------------------------------------------

GATE_DATA = dict(num_nodes=60, num_classes=3, num_features=10, seed=4,
                 edge_pad_multiple=32, num_val=20)
BLEND = dict(beltrami=True, attention_type="exp_kernel", feat_hidden_dim=12,
             pos_enc_hidden_dim=4, hidden_dim=16, attention_dim=16, heads=4,
             input_dropout=0.0, dropout=0.0)
NL_GATE = dict(BLEND, function="transformer", block="constant",
               attention_norm_idx=0, square_plus=False)
GATES = {
    "GRAND-nl rows": (NL_GATE, "GDC"),
    "GRAND-nl columns": (dict(NL_GATE, attention_norm_idx=1), "GDC"),
    "GRAND-nl pos_enc_knn": (dict(NL_GATE, rewiring="pos_enc_knn"), "DW16"),
    "GRAND-l attention block": (BLEND, "GDC"),
    "tuned ogbn-arxiv": (dict(beltrami=True, dropout=0.0), "seeded"),
}
# the tuned ogbn-arxiv row at its full width over its 20,000-node stand-in
# takes ~15 s a training step on one CPU thread here: one epoch, so that
# the file stays near 150 s
EPOCHS = {"tuned ogbn-arxiv": 1}
BACKWARDS = {"fused_rhs": ("fused_rhs_bwd_sym", "fused_rhs_bwd_col"),
             "norm1": ("norm1_bwd",)}


def _gate_data(name, tmp_path):
    """(JAX graph, port dataset, positional encoding, its width) of a
    gate. The SBM stand-in with its GDC encoding; the ``pos_enc_knn``
    graph of a DeepWalk encoding cached once and read by both packages'
    rewiring; the tuned ogbn-arxiv row's 20,000-node stand-in with a seeded
    N(0, 1) encoding of width 64."""
    kw, pe_type = GATES[name]
    if pe_type == "seeded":
        cfg = best_params["ogbn-arxiv"].replace(**kw)
        td = get_dataset(cfg, str(tmp_path), use_lcc=cfg.not_lcc,
                         device="cpu")
        pe = np.random.default_rng(21).normal(
            size=(td.graph.num_nodes, 64)).astype(np.float32)
        pad = cfg.edge_pad_multiple
    else:
        cfg = best_params["Cora"].replace(**kw, pos_enc_type=pe_type,
                                          gdc_k=8)
        td = make_sbm_dataset(**GATE_DATA)
        pad = GATE_DATA["edge_pad_multiple"]
        if pe_type == "GDC":
            pe = tpos.apply_beltrami(td.graph, cfg, device="cpu")
        else:
            pe = np.random.default_rng(22).normal(size=(60, 16)).astype(
                np.float32)
            (tmp_path / "pos_encodings").mkdir()
            np.savez(tmp_path / "pos_encodings" / "Cora_DW16.npz", pe=pe)
            jg = jknn.apply_pos_dist_rewire(
                j_make_graph(*_valid_edges(td.graph), None, num_nodes=60),
                JConfig(**cfg.__dict__), str(tmp_path))
            td.graph = tknn.apply_pos_dist_rewire(td.graph, cfg,
                                                  str(tmp_path), device="cpu")
            np.testing.assert_array_equal(np.stack(_valid_edges(td.graph)),
                                          np.stack(_valid_edges(jg)))
    r, c = _valid_edges(td.graph)
    jg = j_make_graph(r, c, None, num_nodes=td.graph.num_nodes,
                      pad_multiple=pad)
    td.graph = make_graph(r, c, num_nodes=td.graph.num_nodes,
                          pad_multiple=pad)
    return cfg, jg, td, pe


@pytest.fixture(scope="module", params=sorted(GATES))
def gate(request, tmp_path_factory):
    """Three epochs (training steps; ``EPOCHS``) of each package's Trainer
    from one JAX init with random split-space projections, dropout off, the
    positional encoding handed to both: per epoch (loss, forward NFE,
    backward NFE), and the fused backward kernels the port called. Without
    the eval solves: the JAX side's time is XLA compilation."""
    name = request.param
    epochs = EPOCHS.get(name, 3)
    cfg, jg, td, pe = _gate_data(name, tmp_path_factory.mktemp("gate"))
    jcfg = JConfig(**cfg.__dict__)
    nf, nc, pd = td.num_features, td.num_classes, pe.shape[1]
    jm = JEarly(jcfg, nf, nc, jg, pos_enc_dim=pd)
    params, state = jm.init(jax.random.PRNGKey(7))
    params = jax.tree.map(np.asarray, params)
    owner = (params["block"]["func"] if "att" in params["block"]["func"]
             else params["block"])
    rng = np.random.default_rng(8)
    if "Qx" in owner["att"]:
        _random_att(owner["att"], rng)
    for k in ("Q", "K"):       # off the 1e-5 constant init: nonuniform
        if k in owner["att"]:
            owner["att"][k]["w"] = (0.3 * rng.normal(
                size=owner["att"][k]["w"].shape)).astype(np.float32)
    tm = GNNEarlyModel(cfg, nf, nc, td.graph, pos_enc_dim=pd)
    tm.load_state_dict(params_from_jax(params,
                                       jax.tree.map(np.asarray, state)))
    jp, jt = jax.tree.map(jnp.asarray, params), JTrainer(jm)
    opt_state, jlogs = jt.optimizer.init(jp), []
    # one array each: the JAX Trainer keys its compiled step by identity
    x, y, mask = (jnp.asarray(t.numpy()) for t in (td.x, td.y,
                                                    td.train_mask))
    jpe = jnp.asarray(pe)
    for step in range(epochs):
        jp, state, opt_state, loss, st = jt._train_step(
            jp, state, opt_state, x, jpe, y, mask, jax.random.PRNGKey(step))
        bwd = (int(st["bwd_nfe"]) if jcfg.adjoint
               else int(st["accepted"]) * jt._bwd_evals_per_step)
        jlogs.append((float(loss), int(st["nfe"]), bwd))
    counts, real = {}, {}
    for mod, names in BACKWARDS.items():
        for k in names:
            counts[k], real[k] = 0, (getattr(kernels, mod),
                                     getattr(getattr(kernels, mod), k))

            def counting(*a, _k=k, **kw):
                counts[_k] += 1
                return real[_k][1](*a, **kw)

            setattr(getattr(kernels, mod), k, counting)
    trainer, tlogs = Trainer(tm), []
    try:
        for _ in range(epochs):
            loss, st = trainer.train_step(td.x, td.y, td.train_mask,
                                          pos_encoding=torch.tensor(pe))
            tlogs.append((loss, st["nfe"], st["bwd_nfe"]))
    finally:
        for k, (mod, fn) in real.items():
            setattr(mod, k, fn)
    return name, jlogs, tlogs, counts, (tm, jm, params)


class TestThreeEpochs:
    def test_losses(self, gate):
        """rtol 1e-4: three solves and optimizer updates, each differing
        from the JAX package only in the order of float32 sums."""
        name, jlogs, tlogs, _, _ = gate
        assert len(tlogs) == len(jlogs) == EPOCHS.get(name, 3)
        np.testing.assert_allclose([l[0] for l in tlogs],
                                   [l[0] for l in jlogs], rtol=1e-4)
        assert all(math.isfinite(l[0]) for l in tlogs)
        assert len(tlogs) == 1 or tlogs[0][0] != tlogs[-1][0]

    def test_nfe(self, gate):
        """Identical forward and backward NFE per epoch."""
        _, jlogs, tlogs, _, _ = gate
        assert [l[1:] for l in tlogs] == [l[1:] for l in jlogs]
        assert all(fwd > 0 and bwd > 0 for _, fwd, bwd in tlogs)

    def test_backward_engine(self, gate):
        """GRAND-nl's gradient comes from the fused kernel of its graph and
        normalisation: K9 over rows, K14 over columns, K17 over the
        directed ``pos_enc_knn`` graph; GRAND-l takes none."""
        name, _, _, counts, _ = gate
        want = {"GRAND-nl rows": "fused_rhs_bwd_sym",
                "GRAND-nl columns": "norm1_bwd",
                "GRAND-nl pos_enc_knn": "fused_rhs_bwd_col"}.get(name)
        assert {k for k, v in counts.items() if v} == ({want} if want
                                                         else set())

    def test_parameters_round_trip(self, gate):
        """The dual encoder (mx, mp) and the split-space layer's names map
        one to one: the port's state converts back to the JAX tree."""
        _, _, _, _, (tm, jm, params) = gate
        assert ("mx" in params and "mp" in params and "m1" not in params)
        assert tm.mp.w.shape == (jm.cfg.pos_enc_dim,
                                 jm.cfg.pos_enc_hidden_dim)
        back = params_to_jax(tm.state_dict())
        flat = set(params_from_jax(back)) - {"block.func.adjoint_nfe_probe"}
        assert flat == set(params_from_jax(params))


def test_model_needs_the_encoding():
    """A beltrami model refuses a forward without its positional
    encoding; with it the state is feat_hidden_dim + pos_enc_hidden_dim
    wide."""
    d = make_sbm_dataset(**GATE_DATA)
    cfg = best_params["Cora"].replace(**NL_GATE)
    m = GNNModel(cfg, 10, 3, d.graph, pos_enc_dim=5)
    assert m.cfg.pos_enc_dim == 5 and m.core_dim == 16
    with pytest.raises(ValueError, match="positional encoding"):
        m(d.x)
    logits, _ = m(d.x, pos_encoding=torch.randn(60, 5))
    assert logits.shape == (60, 3) and torch.isfinite(logits).all()
