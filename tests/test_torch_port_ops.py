"""The PyTorch port's graph preparation, SpMM (the ``csr_spmm`` and
``edge_dot`` kernels' plain versions behind the autograd engine) and frozen
attention, held against the JAX package on identical numpy inputs.

jax is imported here only; the port itself never imports it. On the CPU the
kernel wrappers run their plain versions, which is what is tested here; the
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.models import attention as jatt
from graph_neural_pde_tpu.models.blocks import (build_stripe_engine,
                                                prepare_graph as j_prepare)
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.spmm import make_stripe_spmm, spmm as j_spmm
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.convert import params_from_jax
from graph_neural_pde_tpu_torch.models.attention import (
    TransformerAttention, frozen_mean_attention)
from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
from graph_neural_pde_tpu_torch.ops.graph import make_graph, reverse_edges
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm, spmm


def _undirected(seed, n=40, e=70, loops=False):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e).astype(np.int32)
    c = rng.integers(0, n, e).astype(np.int32)
    if not loops:
        keep = r != c
        r, c = r[keep], c[keep]
    return np.concatenate([r, c]), np.concatenate([c, r]), n


# a duplicate multi-edge (0, 1) x2, a pre-existing self loop (4, 4) and a
# node (5) without edges
MULTI = (np.array([0, 0, 1, 1, 2, 3, 4], np.int32),
         np.array([1, 1, 0, 0, 3, 2, 4], np.int32), 6)


def _both_prepared(row, col, n, cfg_kw=None, pad_multiple=16):
    kw = dict(function="laplacian", block="attention", self_loop_weight=1.0)
    kw.update(cfg_kw or {})
    jg = j_prepare(JConfig(**kw), j_make_graph(row, col, None, num_nodes=n,
                                               pad_multiple=pad_multiple))
    tg = prepare_graph(Config(**kw), make_graph(row, col, num_nodes=n,
                                                pad_multiple=pad_multiple))
    return jg, tg


def _edge_weights(g, seed):
    """ASYMMETRIC positive weights on valid slots (w[e] != w[rev(e)])."""
    rng = np.random.default_rng(seed)
    return np.where(g.mask.numpy(), rng.random(g.capacity),
                    0.0).astype(np.float32)


def _assert_close_normwise(got, want, rtol):
    """max |got - want| <= rtol * max |want|."""
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= rtol * scale, f"max error {err} > {rtol} * {scale}"


GRAPHS = {"random": lambda: _undirected(0), "multi_edge": lambda: MULTI}


class TestPrepareGraph:
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_matches_jax(self, name):
        """Exact: same stable sort of the same integer keys; the rw weights
        are 1/deg of integer degrees, so they agree bit for bit."""
        jg, tg = _both_prepared(*GRAPHS[name]())
        np.testing.assert_array_equal(tg.row.numpy(), np.asarray(jg.row))
        np.testing.assert_array_equal(tg.col.numpy(), np.asarray(jg.col))
        np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(tg.weight.numpy(),
                                      np.asarray(jg.weight))
        assert tg.rows_sorted and tg.num_nodes == jg.num_nodes

    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_rowptr_and_rev(self, name):
        jg, tg = _both_prepared(*GRAPHS[name]())
        row, col = tg.row.numpy(), tg.col.numpy()
        mask = tg.mask.numpy()
        nv = int(mask.sum())
        # valid edges are the row-sorted prefix that rowptr covers
        assert mask[:nv].all() and not mask[nv:].any()
        np.testing.assert_array_equal(
            tg.rowptr.numpy(),
            np.concatenate([[0], np.cumsum(np.bincount(row[:nv],
                                                       minlength=tg.num_nodes))]))
        rev = tg.rev.numpy()
        vs = np.where(mask)[0]
        assert sorted(rev[vs]) == list(vs)                 # bijection
        np.testing.assert_array_equal(row[rev[vs]], col[vs])
        np.testing.assert_array_equal(col[rev[vs]], row[vs])
        pad = np.where(~mask)[0]
        np.testing.assert_array_equal(rev[pad], pad)        # padding fixed
        loops = vs[row[vs] == col[vs]]
        np.testing.assert_array_equal(rev[loops], loops)    # loops fixed

    def test_rev_absent_for_directed_multiset(self):
        row = np.array([0, 1, 2], np.int64)
        col = np.array([1, 2, 0], np.int64)
        assert reverse_edges(row, col, np.ones(3, bool)) is None


def _spmm_inputs(tg, seed, d=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tg.num_nodes, d)).astype(np.float32)
    w = _edge_weights(tg, seed + 1)
    probe = rng.normal(size=(tg.num_nodes, d)).astype(np.float32)
    return x, w, probe


def _port_value_and_grads(tg, x, w, probe, impl="engine"):
    """Value and gradients through make_spmm (the kernels' autograd
    Function) or through the plain spmm differentiated by autograd."""
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = make_spmm(tg)(xt, wt) if impl == "engine" else spmm(tg, xt, wt)
    torch.sum(torch.sin(out) * torch.tensor(probe)).backward()
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


class TestSpmm:
    @pytest.mark.parametrize("impl", ["engine", "plain"])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_value_and_grads_match_xla(self, name, impl):
        """make_spmm and the plain spmm against JAX's f32 XLA spmm and
        autograd: rtol 1e-5 — the only difference is the order of f32 sums
        (index_add vs segment_sum)."""
        jg, tg = _both_prepared(*GRAPHS[name]())
        x, w, probe = _spmm_inputs(tg, 3)

        def loss(x_, w_):
            return jnp.sum(jnp.sin(j_spmm(jg, x_, weight=w_)) * probe)

        want = np.asarray(j_spmm(jg, jnp.asarray(x), weight=jnp.asarray(w)))
        rx, rw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
        got, gx, gw = _port_value_and_grads(tg, x, w, probe, impl)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gx, np.asarray(rx), rtol=1e-5, atol=1e-6)
        m = tg.mask.numpy()
        if name == "multi_edge":
            # duplicate (u, v) slots are interchangeable under any rev
            # bijection; compare their gradient per (row, col) pair
            key = tg.row.numpy() * tg.num_nodes + tg.col.numpy()
            gw = np.bincount(key[m], weights=gw[m])
            rw_ = np.bincount(key[m], weights=np.asarray(rw)[m])
            np.testing.assert_allclose(gw, rw_, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(gw[m], np.asarray(rw)[m], rtol=1e-5,
                                       atol=1e-6)
            assert np.all(gw[~m] == 0.0)          # padding slots grad-free

    def test_matches_stripe_kernel_interpret(self):
        """Against the TPU stripe kernels (make_stripe_spmm on a
        stripe_fused engine, Pallas interpret mode on the CPU): within 2e-2
        of the largest entry, because that kernel rounds its weighted
        one-hot and its payload to bf16 (stripe.py:523-526). A bf16
        rounding error scales with each summed term, not with the sum, so
        the bound is relative to the array's scale, not element-wise."""
        row, col, n = _undirected(1)
        kw = dict(block="constant", stripe_fused=True, stripe_block_n=8,
                  stripe_chunk=16)
        jg, tg = _both_prepared(row, col, n, kw)
        jcfg = JConfig(function="laplacian", self_loop_weight=1.0, **kw)
        g2, plan = build_stripe_engine(jcfg, jg)
        assert plan.symmetric and plan.rev_slot is not None
        x, w, probe = _spmm_inputs(tg, 5)
        # map the port's (= the JAX prepared graph's) slots onto plan slots
        idx = np.where(tg.mask.numpy())[0]
        slots = np.asarray(plan.slot_of_edge)[idx]
        w_s = np.zeros(plan.capacity, np.float32)
        w_s[slots] = w[idx]
        x_s = np.zeros((g2.num_nodes, x.shape[1]), np.float32)
        x_s[:n] = x
        probe_s = np.zeros_like(x_s)
        probe_s[:n] = probe
        f = make_stripe_spmm(g2, plan)

        def loss(x_, w_):
            return jnp.sum(jnp.sin(f(x_, w_)) * probe_s)

        want = np.asarray(f(jnp.asarray(x_s), jnp.asarray(w_s)))[:n]
        rx, rw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x_s),
                                                jnp.asarray(w_s))
        got, gx, gw = _port_value_and_grads(tg, x, w, probe)
        _assert_close_normwise(got, want, 2e-2)
        _assert_close_normwise(gx, np.asarray(rx)[:n], 2e-2)
        _assert_close_normwise(gw[idx], np.asarray(rw)[slots], 2e-2)


class TestEdgeDot:
    def test_plain_matches_jax_dw(self):
        """edge_dot(ct, x) is dw of <spmm(x, w), ct>: against jax.grad of
        the XLA spmm in w, rtol 1e-5 (f32 sums over D in another order)."""
        jg, tg = _both_prepared(*_undirected(4))
        x, w, ct = _spmm_inputs(tg, 9, d=24)
        rw = jax.grad(lambda w_: jnp.sum(j_spmm(jg, jnp.asarray(x),
                                                weight=w_) * ct))(
            jnp.asarray(w))
        got = kernels.edge_dot(tg.row, tg.col, torch.tensor(ct),
                               torch.tensor(x), tg.num_valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(rw), rtol=1e-5,
                                   atol=1e-6)
        assert np.all(got.numpy()[tg.num_valid:] == 0.0)


class TestWrappers:
    def test_cpu_runs_plain_version_without_launching(self):
        _, tg = _both_prepared(*_undirected(5))
        x, w, _ = _spmm_inputs(tg, 11)
        xt, wt = torch.tensor(x), torch.tensor(w)
        before = (kernels.csr_spmm.launches, kernels.edge_dot.launches)
        out = kernels.csr_spmm(tg.rowptr, tg.row, tg.col, wt, xt)
        ref = kernels.csr_spmm_plain(tg.rowptr, tg.row, tg.col, wt, xt)
        assert torch.equal(out, ref)
        kernels.edge_dot(tg.row, tg.col, xt, xt, tg.num_valid)
        assert (kernels.csr_spmm.launches,
                kernels.edge_dot.launches) == before

    @pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
    def test_csr_spmm_rejects(self, bad):
        _, tg = _both_prepared(*_undirected(6))
        x, w, _ = _spmm_inputs(tg, 13)
        xt, wt = torch.tensor(x), torch.tensor(w)
        rowptr = tg.rowptr
        if bad == "dtype":
            xt = xt.half()
        elif bad == "shape":
            rowptr = rowptr[:-1]
        else:
            xt = xt.to("meta")
        with pytest.raises((TypeError, ValueError)):
            kernels.csr_spmm(rowptr, tg.row, tg.col, wt, xt)

    def test_non_cpu_non_cuda_device_raises(self):
        """A device that is neither the CPU nor CUDA never gets the plain
        version: the wrapper raises."""
        _, tg = _both_prepared(*_undirected(7))
        meta = tg.to("meta")
        x = torch.empty((tg.num_nodes, 4), device="meta")
        w = torch.empty((tg.capacity,), device="meta")
        with pytest.raises(NotImplementedError):
            kernels.csr_spmm(meta.rowptr, meta.row, meta.col, w, x)
        with pytest.raises(NotImplementedError):
            kernels.edge_dot(meta.row, meta.col, x, x, tg.num_valid)


def _att_params(cfg, in_dim, seed):
    """One JAX attention init with random Q/K (the 1e-5 constant init makes
    every score ~0), carried into the port. Scores stay O(1): squareplus
    computes (s - max) + sqrt((s - max)^2 + 4), which cancels for scores far
    below the global max, so large scores would test the formula's
    conditioning rather than the port."""
    p = jatt.init_transformer_attention(jax.random.PRNGKey(seed), cfg, in_dim)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, p)
    for k in ("Q", "K"):
        p[k]["w"] = 0.3 * rng.normal(size=p[k]["w"].shape).astype(np.float32)
        p[k]["b"] = 0.1 * rng.normal(size=p[k]["b"].shape).astype(np.float32)
    att = TransformerAttention(Config(**_att_kw(cfg)), in_dim)
    att.load_state_dict(params_from_jax(p))
    return jax.tree.map(jnp.asarray, p), att


def _att_kw(cfg):
    return dict(heads=cfg.heads, attention_dim=cfg.attention_dim,
                attention_norm_idx=cfg.attention_norm_idx,
                square_plus=cfg.square_plus, block="attention",
                function="laplacian", self_loop_weight=1.0)


class TestFrozenAttention:
    @pytest.mark.parametrize("norm_idx", [0, 1])
    @pytest.mark.parametrize("square_plus", [False, True])
    def test_matches_jax(self, norm_idx, square_plus):
        """Composition branch of frozen_mean_attention: rtol 1e-5 (f32; the
        port normalises all heads at once and sums them, the JAX package
        accumulates head by head)."""
        jcfg = JConfig(heads=4, attention_dim=16,
                       attention_norm_idx=norm_idx, square_plus=square_plus,
                       block="attention", function="laplacian")
        jg, tg = _both_prepared(*_undirected(8), _att_kw(jcfg))
        d = 12
        jp, att = _att_params(jcfg, d, seed=norm_idx + 2 * square_plus)
        x = np.random.default_rng(17).normal(size=(tg.num_nodes, d)) \
            .astype(np.float32)
        want = np.asarray(jatt.frozen_mean_attention(jp, jcfg,
                                                     jnp.asarray(x), jg))
        with torch.no_grad():
            got = frozen_mean_attention(att, Config(**_att_kw(jcfg)),
                                        torch.tensor(x), tg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
