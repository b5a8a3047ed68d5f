"""The PyTorch port's K3/K4 segment normalisation (the plain versions
behind the autograd Function of ``ops.scatter``), the four attention score
families, hard attention's quantile and batch norm, held against the JAX
package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the kernel wrappers run their plain versions; ``chip_smoke.py`` holds
the CUDA kernels against the same plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.models import attention as jatt
from graph_neural_pde_tpu.models.blocks import (masked_quantile as j_quantile,
                                                prepare_graph as j_prepare)
from graph_neural_pde_tpu.models.layers import bn_apply
from graph_neural_pde_tpu.ops import scatter as jsc
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.pallas.stripe import (build_stripe_plan,
                                                    stripe_segment_softmax,
                                                    stripe_segment_squareplus)
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.models.attention import (
    TransformerAttention, apply_transformer_attention, frozen_mean_attention)
from graph_neural_pde_tpu_torch.models.blocks import (masked_quantile,
                                                      prepare_graph)
from graph_neural_pde_tpu_torch.models.layers import BatchNorm
from graph_neural_pde_tpu_torch.ops import scatter as tsc
from graph_neural_pde_tpu_torch.ops.graph import make_graph


def _undirected(seed, n=40, e=90):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e).astype(np.int32)
    c = rng.integers(0, n, e).astype(np.int32)
    keep = r != c
    r, c = r[keep], c[keep]
    return np.concatenate([r, c]), np.concatenate([c, r]), n


# a duplicate multi-edge (0, 1) x2, a pre-existing self loop (4, 4) and a
# node (5) without edges
MULTI = (np.array([0, 0, 1, 1, 2, 3, 4], np.int32),
         np.array([1, 1, 0, 0, 3, 2, 4], np.int32), 6)
GRAPHS = {"random": lambda: _undirected(0), "multi_edge": lambda: MULTI}


def _both_prepared(row, col, n, pad_multiple=16, **cfg_kw):
    kw = dict(function="laplacian", block="attention", self_loop_weight=1.0)
    kw.update(cfg_kw)
    jg = j_prepare(JConfig(**kw), j_make_graph(row, col, None, num_nodes=n,
                                               pad_multiple=pad_multiple))
    tg = prepare_graph(Config(**kw), make_graph(row, col, num_nodes=n,
                                                pad_multiple=pad_multiple))
    return jg, tg


def _grad_close(got, want, rtol):
    """rtol, and an absolute floor of rtol of the largest entry: an entry
    that sums terms of mixed sign keeps their absolute error."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


# ---------------------------------------------------------------------------
# K3 / K4: the plain versions behind ops.scatter, against jax's segment ops
# ---------------------------------------------------------------------------

_SEG_FNS = {
    "softmax": (lambda s, g, k: tsc.segment_softmax(s, g, k),
                lambda s, jg, idx: jsc.segment_softmax(s, idx, jg.num_nodes,
                                                       jg.mask)),
    "squareplus": (lambda s, g, k: tsc.segment_squareplus(s, g, k),
                   lambda s, jg, idx: jsc.segment_squareplus(
                       s, idx, jg.num_nodes, jg.mask)),
    "normalize": (lambda s, g, k: tsc.normalize_attention(s, g, k, g.mask),
                  lambda s, jg, idx: jsc.normalize_attention(
                      s, idx, jg.num_nodes, jg.mask)),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("norm_idx", [0, 1])
@pytest.mark.parametrize("fn", sorted(_SEG_FNS))
def test_segment_norm_matches_jax(fn, norm_idx, graph):
    """Values and gradients of the K3/K4 composition (row segments, or
    column segments through rev) against jax's segment ops over row or col
    indices: rtol 1e-5 (f32 sums in another order). normalize takes
    positive weights, as the hard attention's are."""
    jg, tg = _both_prepared(*GRAPHS[graph]())
    rng = np.random.default_rng(3 + norm_idx)
    s = rng.normal(size=(tg.capacity, 3)).astype(np.float32)
    if fn == "normalize":
        s = np.abs(s) + 0.1
    probe = rng.normal(size=s.shape).astype(np.float32)
    port_fn, jax_fn = _SEG_FNS[fn]
    idx = jg.row if norm_idx == 0 else jg.col
    m = tg.mask.numpy()[:, None]

    def jloss(s_):
        return jnp.sum(jnp.sin(jax_fn(s_, jg, idx)) * probe * m)

    want = np.asarray(jax_fn(jnp.asarray(s), jg, idx))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(s)))
    st = torch.tensor(s, requires_grad=True)
    got = port_fn(st, tg, norm_idx)
    torch.sum(torch.sin(got) * torch.tensor(probe * m)).backward()
    np.testing.assert_allclose(got.detach().numpy(), want * m, rtol=1e-5,
                               atol=1e-7)
    assert np.all(got.detach().numpy()[~m[:, 0]] == 0.0)
    _grad_close(st.grad.numpy(), want_g, 1e-5)


@pytest.mark.parametrize("mode", ["softmax", "normalise"])
def test_segment_norm_bwd_plain_is_the_gradient(mode):
    """K4's plain version against autograd through K3's plain version,
    rtol 1e-5 (+1e-5 of scale: an entry g - sum(g·out) cancels); den is
    the segment sum."""
    _, tg = _both_prepared(*_undirected(2))
    rng = np.random.default_rng(9)
    s = torch.tensor(np.abs(rng.normal(size=(tg.capacity, 2))) + 0.1,
                     dtype=torch.float32, requires_grad=True)
    g = torch.tensor(rng.normal(size=(tg.capacity, 2)), dtype=torch.float32)
    out, den = kernels.segment_norm_plain(tg.rowptr, tg.row, tg.rev, s, mode)
    (want,) = torch.autograd.grad(out, s, g)
    den = den.detach()
    got = kernels.segment_norm_bwd_plain(tg.rowptr, tg.row, tg.rev,
                                         out.detach(), g, den, mode)
    _grad_close(got.numpy(), want.numpy(), 1e-5)
    if mode == "normalise":
        col = tg.col.long()[:tg.num_valid]
        ref = torch.zeros_like(den).index_add(0, col,
                                              s.detach()[:tg.num_valid])
        np.testing.assert_allclose(den.numpy(), ref.numpy(), rtol=1e-6)


class TestSegmentNormWrappers:
    def test_cpu_runs_plain_version_without_launching(self):
        _, tg = _both_prepared(*_undirected(5))
        s = torch.rand(tg.capacity, 4)
        before = (kernels.segment_norm.launches,
                  kernels.segment_norm_bwd.launches)
        for perm in (None, tg.rev):
            out, den = kernels.segment_norm(tg.rowptr, tg.row, perm, s,
                                            "softmax")
            ref = kernels.segment_norm_plain(tg.rowptr, tg.row, perm, s,
                                             "softmax")
            assert torch.equal(out, ref[0]) and torch.equal(den, ref[1])
            kernels.segment_norm_bwd(tg.rowptr, tg.row, perm, out, s, den,
                                     "softmax")
        assert (kernels.segment_norm.launches,
                kernels.segment_norm_bwd.launches) == before

    @pytest.mark.parametrize("bad", ["dtype", "mode", "perm", "device"])
    def test_rejects(self, bad):
        _, tg = _both_prepared(*_undirected(6))
        s, perm, mode = torch.rand(tg.capacity, 2), tg.rev, "normalise"
        if bad == "dtype":
            s = s.double()
        elif bad == "mode":
            mode = "sum"
        elif bad == "perm":
            perm = perm.long()
        else:
            s = s.to("meta")
        with pytest.raises((TypeError, ValueError)):
            kernels.segment_norm(tg.rowptr, tg.row, perm, s, mode)

    def test_non_cpu_non_cuda_device_raises(self):
        _, tg = _both_prepared(*_undirected(7))
        meta = tg.to("meta")
        s = torch.empty((tg.capacity, 2), device="meta")
        den = torch.empty((tg.num_nodes, 2), device="meta")
        with pytest.raises(NotImplementedError):
            kernels.segment_norm(meta.rowptr, meta.row, None, s, "softmax")
        with pytest.raises(NotImplementedError):
            kernels.segment_norm_bwd(meta.rowptr, meta.row, None, s, s, den,
                                     "softmax")

    def test_column_segments_of_a_directed_graph_raise(self):
        """The column segments of a directed graph no longer raise: K3
        walks the CSC view (``colptr``, ``col_perm``), equal to the softmax
        over each column taken directly."""
        row, col, n = np.array([0, 1, 2, 2]), np.array([1, 2, 0, 1]), 3
        tg = make_graph(row, col, num_nodes=n).sort_by_row()
        assert tg.rev is None
        s = torch.rand(tg.capacity, 1)
        got = tsc.segment_softmax(s, tg, 1)
        c = tg.col.long()
        for node in range(n):
            sel = c == node
            want = torch.softmax(s[sel, 0], dim=0)
            assert torch.allclose(got[sel, 0], want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["softmax", "squareplus"])
def test_segment_norm_matches_stripe_kernels_interpret(fn):
    """Against the TPU's stripe segment softmax / squareplus (the P3 stripe
    scatter and P2 row gather, f32 one-hot, Pallas interpret mode on the
    CPU), mapped through the plan's slot order: rtol 1e-5 on values, 1e-4
    on gradients, as tests/test_stripe_softmax.py holds them against the
    exact composition."""
    _, tg = _both_prepared(*_undirected(11))
    n, h = tg.num_nodes, 3
    plan = build_stripe_plan(tg.row.numpy(), tg.mask.numpy(), num_nodes=n,
                             block_n=8, chunk=16)
    idx = np.where(tg.mask.numpy())[0]
    slots = np.asarray(plan.slot_of_edge)[idx]
    rng = np.random.default_rng(12)
    s = rng.normal(size=(tg.capacity, h)).astype(np.float32)
    probe = rng.normal(size=s.shape).astype(np.float32)
    s_s = np.zeros((plan.capacity, h), np.float32)
    s_s[slots] = s[idx]
    probe_s = np.zeros_like(s_s)
    probe_s[slots] = probe[idx]
    row_s = np.zeros(plan.capacity, np.int32)
    row_s[slots] = tg.row.numpy()[idx]
    valid = jnp.asarray(plan.valid)

    def stripe(x):
        if fn == "squareplus":
            return stripe_segment_squareplus(plan, x)
        return stripe_segment_softmax(
            plan, x, lambda: jsc.segment_softmax(x, row_s, n, valid))

    want = np.asarray(stripe(jnp.asarray(s_s)))[slots]
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(
        jnp.where(valid[:, None], stripe(x), 0.0) * probe_s))(
        jnp.asarray(s_s)))[slots]
    st = torch.tensor(s, requires_grad=True)
    port = tsc.segment_squareplus if fn == "squareplus" \
        else tsc.segment_softmax
    got = port(st, tg, 0)
    torch.sum(got * torch.tensor(probe)).backward()
    np.testing.assert_allclose(got.detach().numpy()[idx], want, rtol=1e-5,
                               atol=1e-6)
    _grad_close(st.grad.numpy()[idx], want_g, 1e-4)


# ---------------------------------------------------------------------------
# score families, quantile, batch norm
# ---------------------------------------------------------------------------

def _att_params(jcfg, in_dim, seed):
    """A JAX attention init with random Q/K (and exp_kernel scalars off 1),
    carried into the port. Scores stay O(1)."""
    p = jatt.init_transformer_attention(jax.random.PRNGKey(seed), jcfg,
                                        in_dim)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, p)
    for k in ("Q", "K"):
        p[k]["w"] = 0.3 * rng.normal(size=p[k]["w"].shape).astype(np.float32)
        p[k]["b"] = 0.1 * rng.normal(size=p[k]["b"].shape).astype(np.float32)
    if "output_var" in p:
        p["output_var"] = np.array([1.3], np.float32)
        p["lengthscale"] = np.array([0.8], np.float32)
    tcfg = Config(**{f: getattr(jcfg, f) for f in (
        "heads", "attention_dim", "attention_type", "attention_norm_idx",
        "square_plus", "block", "function")})
    att = TransformerAttention(tcfg, in_dim)
    att.load_state_dict(params_from_jax(p))
    return jax.tree.map(jnp.asarray, p), att, tcfg


@pytest.mark.parametrize("norm_idx", [0, 1])
@pytest.mark.parametrize("attention_type", ["scaled_dot", "cosine_sim",
                                            "pearson", "exp_kernel"])
def test_score_families_match_jax(attention_type, norm_idx):
    """apply_transformer_attention [E, H] (softmax) and the squareplus
    frozen head mean against JAX, rtol 1e-5; the freeze's gradients in Q,
    K and the exp_kernel scalars at rtol 1e-4 (+1e-4 of scale)."""
    jcfg = JConfig(heads=4, attention_dim=16, attention_type=attention_type,
                   attention_norm_idx=norm_idx, block="attention",
                   function="laplacian")
    jg, tg = _both_prepared(*_undirected(8))
    d = 12
    jp, att, tcfg = _att_params(jcfg, d, seed=norm_idx + 5)
    x = np.random.default_rng(17).normal(size=(tg.num_nodes, d)) \
        .astype(np.float32)
    want, _ = jatt.apply_transformer_attention(jp, jcfg, jnp.asarray(x), jg)
    with torch.no_grad():
        got = apply_transformer_attention(att, tcfg, torch.tensor(x), tg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)

    jcfg_sp = jcfg.replace(square_plus=True)
    probe = np.random.default_rng(18).normal(size=tg.capacity) \
        .astype(np.float32)

    def jloss(p):
        return jnp.sum(jatt.frozen_mean_attention(p, jcfg_sp, jnp.asarray(x),
                                                  jg) * probe)

    want_grads = jax.grad(jloss)(jp)
    loss = torch.sum(frozen_mean_attention(att, tcfg.replace(
        square_plus=True), torch.tensor(x), tg) * torch.tensor(probe))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jp)),
                               rtol=1e-5)
    for name, prm in att.named_parameters():
        if prm.grad is None:                  # V, Wout: not in the freeze
            continue
        want_g = want_grads
        for k in name.split("."):
            want_g = want_g[k]
        _grad_close(prm.grad.numpy(), want_g, 1e-4)


def test_masked_quantile_matches_jax_and_torch():
    """Identical to the JAX package's f32 arithmetic, and to
    torch.quantile over the masked entries, with ties at the quantile."""
    rng = np.random.default_rng(21)
    vals = rng.integers(0, 40, 300).astype(np.float32) / 40.0   # ties
    mask = rng.random(300) < 0.8
    for q in (0.0, 0.1, 1.0 - 0.572918052062338, 0.5, 1.0 - 0.9282359956,
              1.0):
        got = masked_quantile(torch.tensor(vals), torch.tensor(mask), q)
        want = j_quantile(jnp.asarray(vals), jnp.asarray(mask), q)
        assert float(got) == float(want)
        ref = torch.quantile(torch.tensor(vals[mask]), q)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_batch_norm_matches_jax_train_and_eval():
    """A training forward (batch statistics, running-state update) and an
    eval forward (running statistics) against bn_apply, rtol 1e-5; the
    training gradient too."""
    rng = np.random.default_rng(4)
    x = (3.0 * rng.normal(size=(50, 6)) + 1.0).astype(np.float32)
    probe = rng.normal(size=x.shape).astype(np.float32)
    params = {"scale": rng.normal(size=6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    state = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32),
             "count": np.zeros((), np.float32)}
    bn = BatchNorm(6)
    bn.load_state_dict(params_from_jax(params, state))

    def jloss(xx):
        y, new = bn_apply(params, state, xx, True)
        return jnp.sum(y * probe), (y, new)

    (_, (jy, jstate)), jgx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt, True)
    torch.sum(y * torch.tensor(probe)).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    _grad_close(xt.grad.numpy(), jgx, 1e-5)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(jstate[k]), rtol=1e-6)
    je, _ = bn_apply(params, jstate, jnp.asarray(x), False)
    with torch.no_grad():
        te = bn(torch.tensor(x), False)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)
