"""The port's multi-device layer (``graph_neural_pde_tpu_torch.parallel``)
against the JAX package's ``parallel/``.

Gloo worlds of 2 and 4 ranks run on the CPU (``torch_parallel_ranks.py``,
which imports no jax), once each for the whole module: every rank runs
every sharded function on its shard, forward and backward, and writes what
it holds. Here the JAX package's shard functions run on a mesh of the same
size (the first 2 or 4 of the 8 virtual CPU devices) on the same inputs,
made from a seed with numpy. Multi-rank collectives are tested here only:
the card check (``chip_smoke.py``) runs a world of one NCCL rank and the
in-process split.

Tolerances, of the reference's largest entry: 1e-5 against the float32 XLA
functions, forward and gradients (the sums run in other orders); 2e-2
forward and 3e-2 gradients against the JAX stripe kernel (P6) in interpret
mode, its own test's bounds (``test_multichip.py``); under the bf16 ODE
state, x's bfloat16 gradient at 2^-6 against the float32 sum and 2^-5
against the JAX package's bfloat16 one (both packages sum it partly in
bfloat16: ROADMAP R10). Per-edge arrays are in
the slot order of the graph each side was handed; the two packages' graphs
hold the same arrays slot for slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from graph_neural_pde_tpu.config import Config as JConfig
from graph_neural_pde_tpu.models.blocks import prepare_graph as j_prepare
from graph_neural_pde_tpu.ops.graph import make_graph as j_make_graph
from graph_neural_pde_tpu.ops.graph import pad_capacity as j_pad_capacity
from graph_neural_pde_tpu.ops.spmm import spmm as j_spmm
from graph_neural_pde_tpu.parallel import shard_spmm as JS
from graph_neural_pde_tpu.parallel.mesh import make_mesh as j_make_mesh
from graph_neural_pde_tpu.parallel.mesh import shard_graph as j_shard_graph
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.ops.graph import make_graph, pad_capacity
from graph_neural_pde_tpu_torch.parallel import (make_mesh, replicate,
                                                 shard_graph, split_mesh)
from graph_neural_pde_tpu_torch.parallel import shard_spmm as S

WORLDS = (2, 4)
N, E = 67, 400
TIGHT = 1e-5          # against the float32 XLA functions
STRIPE = 2e-2         # against the JAX stripe kernel, forward
STRIPE_GRAD = 3e-2    # and gradients
# x's bfloat16 gradient, summed in bfloat16 in part (R10): against the
# float32 sum, and against the JAX package's own bfloat16 sum
BF16_SUM = {"float32": 2.0 ** -6, "bfloat16": 2.0 ** -5}
# the gradients of the stripe spmm under its bfloat16 payload against the
# JAX package's autodiff, which forms their products in bfloat16 and sums
# them there (the port in float32)
STRIPE_BF16_GRAD = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def close(got, want, tol, what="", scale=None):
    """Max error within ``tol`` of ``scale``, by default the largest entry
    of ``want``; returns the error over the scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"
    return err / scale


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    f32 = np.float32
    inp = dict(
        n=np.array(N), row=rng.integers(0, N, E).astype(np.int32),
        col=rng.integers(0, N, E).astype(np.int32),
        x=rng.normal(size=(N, 16)).astype(f32),
        w=(rng.normal(size=E) ** 2).astype(f32),
        probe=rng.normal(size=(N, 16)).astype(f32),
        qw=(rng.normal(size=(8, 8)) * 0.3).astype(f32),
        qb=(rng.normal(size=8) * 0.1).astype(f32),
        kw=(rng.normal(size=(8, 8)) * 0.3).astype(f32),
        kb=(rng.normal(size=8) * 0.1).astype(f32),
        xf=rng.normal(size=(N, 8)).astype(f32),
        probe_f=rng.normal(size=(N, 8)).astype(f32),
        xb=rng.normal(size=(N, 8)).astype(f32),
        probe_b=rng.normal(size=(N, 8)).astype(f32))
    cap = ranks.prepared(ranks.laplacian_config(),
                         ranks.base_graph(inp)).capacity
    inp["w_prepared"] = (rng.normal(size=cap) ** 2).astype(f32)
    return inp


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Each world's per-rank results, in rank order."""
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"gloo{world}")
        np.savez(d / "inputs.npz", **inputs)
        out[world] = ranks.run_world(world, str(d))
    return out


def j_graph(inp):
    return j_make_graph(inp["row"], inp["col"], None, num_nodes=N,
                        pad_multiple=8)


def replicated(res, key):
    """A replicated result: every rank holds the same array."""
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key])
    return res[0][key]


def row_sharded(res, key):
    return np.concatenate([r[key] for r in res])


def closure(fn):
    return {k: c.cell_contents
            for k, c in zip(fn.__code__.co_freevars, fn.__closure__)}


def jgrad(f, args, argnums, probe):
    return jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * probe), argnums))(
        *args)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_spmm_matches_jax(world, worlds, inputs):
    res, inp = worlds[world], inputs
    mesh = j_make_mesh(world)
    g = j_graph(inp)
    f = JS.make_sharded_spmm(mesh, j_shard_graph(mesh, g))
    x, w, probe = (jnp.asarray(inp[k]) for k in ("x", "w", "probe"))
    close(replicated(res, "ar_out"), jax.jit(f)(x, w), TIGHT, "out")
    dx, dw = jgrad(f, (x, w), (0, 1), probe)
    close(replicated(res, "ar_dx"), dx, TIGHT, "dx")
    close(row_sharded(res, "ar_dw_own"), dw, TIGHT, "dw, sharded w")
    close(replicated(res, "ar_dw_whole"), dw, TIGHT, "dw, replicated w")


@pytest.mark.parametrize("world", WORLDS)
def test_stream_spmm_matches_jax(world, worlds, inputs):
    res, inp = worlds[world], inputs
    f = JS.make_sharded_spmm_stream(j_make_mesh(world), j_graph(inp))
    x, w, probe = (jnp.asarray(inp[k]) for k in ("x", "w", "probe"))
    close(row_sharded(res, "st_out"), jax.jit(f)(x, w), TIGHT, "out")
    dx, dw = jgrad(f, (x, w), (0, 1), probe)
    close(replicated(res, "st_dx"), dx, TIGHT, "dx")
    close(replicated(res, "st_dw"), dw, TIGHT, "dw")


@pytest.mark.parametrize("world", WORLDS)
def test_stream_buckets_identical(world, worlds, inputs):
    """The vectorised bucket builder gives the JAX package's arrays, which
    it fills edge by edge, for both ring schedules."""
    mesh, g = j_make_mesh(world), j_graph(inputs)
    spmm = closure(JS.make_sharded_spmm_stream(mesh, g))
    rhs = closure(JS.make_sharded_fused_rhs_stream(mesh, g, heads=2))
    port = S.stream_buckets(make_graph(inputs["row"], inputs["col"],
                                       num_nodes=N, pad_multiple=8), world)
    for k in ("rowl", "coll", "slot", "mask"):
        got = replicated(worlds[world], f"st_buckets_{k}")
        np.testing.assert_array_equal(got, getattr(port, k))
        want = np.asarray(spmm[f"b_{k}"])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if k != "slot":
            np.testing.assert_array_equal(got, np.asarray(rhs[f"b_{k}"]))


@pytest.mark.parametrize("world", WORLDS)
def test_chained_matvecs(world, worlds, inputs):
    """Three chained matvecs on the ring, the row-sharded output fed back
    as the next input (the JAX package's chained test)."""
    f = JS.make_sharded_spmm_stream(j_make_mesh(world), j_graph(inputs))
    x, w = jnp.asarray(inputs["x"]), jnp.asarray(inputs["w"])

    @jax.jit
    def chain(x_):
        for _ in range(3):
            x_ = f(x_, w) + 0.1 * x_
        return x_

    close(row_sharded(worlds[world], "st_chain"), chain(x), TIGHT, "chain")


@pytest.mark.parametrize("world", WORLDS)
def test_stripe_spmm_matches_jax(world, worlds, inputs):
    """P6 per rank: against the float32 oracle ``ops.spmm.spmm`` and the
    JAX stripe spmm (its Pallas scatter in interpret mode); prints the
    measured differences."""
    res, inp = worlds[world], inputs
    jcfg = JConfig(block="constant", function="laplacian",
                   self_loop_weight=1.0)
    g = j_prepare(jcfg, j_graph(inp))
    cap = g.capacity               # the port pads one more multiple of 4
    x, probe = jnp.asarray(inp["x"]), jnp.asarray(inp["probe"])
    w = jnp.asarray(inp["w_prepared"][:cap])
    tp = ranks.prepared(ranks.laplacian_config(), ranks.base_graph(inp))
    for a in ("row", "col", "mask"):
        np.testing.assert_array_equal(getattr(tp, a).numpy()[:cap],
                                      np.asarray(getattr(g, a)))
    assert not tp.mask[cap:].any()

    def oracle(x_, w_):
        return j_spmm(g, x_, weight=w_)

    stripe = JS.make_sharded_stripe_spmm(j_make_mesh(world), g, block_n=8,
                                         chunk=16)
    out = replicated(res, "stripe_out")
    rel_o = close(out, oracle(x, w), TIGHT, "out vs oracle")
    rel_s = close(out, jax.jit(stripe)(x, w), STRIPE, "out vs stripe")
    dx, dw = replicated(res, "stripe_dx"), replicated(res, "stripe_dw")
    assert not dw[cap:].any()
    for want, tol, name in ((jgrad(oracle, (x, w), (0, 1), probe), TIGHT,
                             "oracle"),
                            (jgrad(stripe, (x, w), (0, 1), probe),
                             STRIPE_GRAD, "stripe")):
        close(dx, want[0], tol, f"dx vs {name}")
        close(dw[:cap], want[1], tol, f"dw vs {name}")
    print(f"world {world}: stripe spmm vs oracle {rel_o:.2e}, vs the JAX "
          f"stripe kernel {rel_s:.2e} of scale")
    lo_hi = np.stack([r["stripe_lo_hi"] for r in res])
    bounds = np.linspace(0, int(tp.num_valid), world + 1).astype(int)
    np.testing.assert_array_equal(lo_hi, np.stack([bounds[:-1],
                                                   bounds[1:]], 1))


def _bf16(a):
    """``a`` rounded to bfloat16 in value, the identity in the gradient."""
    return a + jax.lax.stop_gradient(
        a.astype(jnp.bfloat16).astype(jnp.float32) - a)


@jax.custom_vjp
def _cotangent_to_bf16(a):
    """The identity, whose cotangent is rounded to bfloat16 (what P6's
    gather hands back under the bf16 payload)."""
    return a


_cotangent_to_bf16.defvjp(
    lambda a: (a, None),
    lambda _, ct: (ct.astype(jnp.bfloat16).astype(jnp.float32),))


@pytest.mark.parametrize("world", WORLDS)
def test_stripe_spmm_bf16_payload_matches_jax(world, worlds, inputs):
    """P6 per rank under the bfloat16 payload (B1 item 6): each rank's
    payload the bf16 product ``x_b[col] * w_b``, K1 in table mode summing
    it in float32, K20 writing ct[row] rounded to bfloat16. The output
    against the JAX ``make_sharded_stripe_spmm(payload_dtype=bf16)`` on a
    mesh of the same size (its Pallas scatter in interpret mode, whose
    one-hot products of bf16 values are exact) at 1e-5 of scale; both
    gradients against a jnp composition with the same forward casts and
    the cotangent of the payload rounded as P6's gather rounds it, every
    other cast the identity (1e-5), and against the JAX stripe's own
    autodiff, which forms the gradients' products in bfloat16 and sums
    them there, at ``STRIPE_BF16_GRAD`` of their scale (the gaps
    printed)."""
    res, inp = worlds[world], inputs
    jcfg = JConfig(block="constant", function="laplacian",
                   self_loop_weight=1.0)
    g = j_prepare(jcfg, j_graph(inp))
    cap = g.capacity
    x, probe = jnp.asarray(inp["x"]), jnp.asarray(inp["probe"])
    w = jnp.asarray(inp["w_prepared"][:cap])
    stripe = JS.make_sharded_stripe_spmm(j_make_mesh(world), g, block_n=8,
                                         chunk=16, payload_dtype=jnp.bfloat16)

    def composition(x_, w_):
        vals = _bf16(_bf16(x_)[g.col] * _bf16(w_)[:, None])
        vals = _cotangent_to_bf16(jnp.where(g.mask[:, None], vals, 0.0))
        return jax.ops.segment_sum(vals, g.row, num_segments=N)

    out = replicated(res, "stripe_bf16_out")
    rel = close(out, stripe(x, w), TIGHT, "bf16 out vs stripe")
    close(out, composition(x, w), TIGHT, "bf16 out vs composition")
    dx, dw = (replicated(res, "stripe_bf16_dx"),
              replicated(res, "stripe_bf16_dw"))
    assert not dw[cap:].any()
    # eager: under jit XLA may drop a bf16 rounding that is cast straight
    # back to float32
    cdx, cdw = jax.grad(lambda *a: jnp.sum(composition(*a) * probe),
                        (0, 1))(x, w)
    close(dx, cdx, TIGHT, "bf16 dx vs composition")
    close(dw[:cap], cdw, TIGHT, "bf16 dw vs composition")
    jdx, jdw = jgrad(stripe, (x, w), (0, 1), probe)
    rel_x = close(dx, jdx, STRIPE_BF16_GRAD, "bf16 dx vs stripe")
    rel_w = close(dw[:cap], jdw, STRIPE_BF16_GRAD, "bf16 dw vs stripe")
    print(f"world {world}: stripe spmm under the bf16 payload vs the JAX "
          f"one: out {rel:.2e}, its autodiff's dx {rel_x:.2e}, dw "
          f"{rel_w:.2e} of scale")


def j_params(inp):
    return tuple(jnp.asarray(inp[k]) for k in ("qw", "qb", "kw", "kb"))


@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_fused_rhs_matches_jax(world, square_plus, worlds, inputs):
    """K18 per rank (its plain version here), psum, division; and the ring
    schedule in torch ops: forward and the gradients in qw, qb, kw, kb and
    x against ``jax.grad``, each gradient to 1e-5 of the largest (kb's is
    0 under the softmax, rounding noise in both packages)."""
    res, inp = worlds[world], inputs
    mesh, g = j_make_mesh(world), j_graph(inp)
    args = j_params(inp) + (jnp.asarray(inp["xf"]),)
    probe = jnp.asarray(inp["probe_f"])
    tag = f"sp{int(square_plus)}"
    for kind, make in (("fa", JS.make_sharded_fused_rhs),
                       ("fs", JS.make_sharded_fused_rhs_stream)):
        f = make(mesh, g, heads=2, square_plus=square_plus)
        outs = (replicated(res, f"{kind}_{tag}_out") if kind == "fa"
                else row_sharded(res, f"{kind}_{tag}_out"))
        close(outs, jax.jit(f)(*args), TIGHT, f"{kind} out")
        wants = jgrad(f, args, (0, 1, 2, 3, 4), probe)
        top = max(float(jnp.abs(g_).max()) for g_ in wants)
        for i, want in enumerate(wants):
            close(replicated(res, f"{kind}_{tag}_d{i}"), want, TIGHT,
                  f"{kind} d{i}", scale=top)


@pytest.mark.parametrize("world", WORLDS)
def test_fused_rhs_stream_chained(world, worlds, inputs):
    f = JS.make_sharded_fused_rhs_stream(j_make_mesh(world),
                                         j_graph(inputs), heads=2)
    params = j_params(inputs)

    @jax.jit
    def chain(x_):
        for _ in range(3):
            x_ = x_ + 0.25 * (f(*params, x_) - x_)
        return x_

    close(row_sharded(worlds[world], "fs_chain"),
          chain(jnp.asarray(inputs["xf"])), TIGHT, "chain")


@pytest.mark.parametrize("world", WORLDS)
def test_dispatchers_match_jax(world, worlds, inputs):
    """Both modes of both dispatchers hand every rank the whole result,
    as the JAX dispatchers return one global array, and take the whole
    inputs: forward and gradients against ``jax.grad`` of the JAX
    dispatchers."""
    res, inp = worlds[world], inputs
    mesh, g = j_make_mesh(world), j_graph(inp)
    x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])
    args = j_params(inp) + (jnp.asarray(inp["xf"]),)
    probe, probe_f = jnp.asarray(inp["probe"]), jnp.asarray(inp["probe_f"])
    for mode in ("allreduce", "stream"):
        cfg = JConfig(shard_spmm_mode=mode)
        f = JS.make_sharded_spmm_for(cfg, mesh, g)
        close(replicated(res, f"spmm_for_{mode}"), jax.jit(f)(x, w), TIGHT,
              mode)
        for name, want in zip(("dx", "dw"),
                              jgrad(f, (x, w), (0, 1), probe)):
            close(replicated(res, f"spmm_for_{mode}_{name}"), want, TIGHT,
                  f"{mode} {name}")
        f = JS.make_sharded_fused_rhs_for(cfg, mesh, g, heads=2)
        close(replicated(res, f"fused_for_{mode}"), jax.jit(f)(*args),
              TIGHT, mode)
        wants = jgrad(f, args, (0, 1, 2, 3, 4), probe_f)
        top = max(float(jnp.abs(g_).max()) for g_ in wants)
        for i, want in enumerate(wants):
            close(replicated(res, f"fused_for_{mode}_d{i}"), want, TIGHT,
                  f"{mode} fused d{i}", scale=top)


def jvjp(f, args, probe):
    """f's output and the gradients of sum(f * probe) in every argument,
    in one jitted call."""
    def run(*a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(probe)
    return jax.jit(run)(*args)


def j_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("world", WORLDS)
def test_dispatchers_bf16_state_match_jax(world, worlds, inputs):
    """Both dispatchers in both modes on a bfloat16 x (the bf16 ODE
    state): forward and gradients against the JAX dispatchers on the same
    bf16 x. JAX promotes x to float32 at each use, so the outputs and the
    gradients of w and of the projections are float32 sums: 1e-5 of scale
    (the outputs are those of x widened, bit for bit, in JAX). x's
    gradient is bfloat16 on both sides, and both round each edge's
    cotangent of x[col] to bfloat16 and sum it there (JAX's autodiff, the
    port's autograd of its bf16 gather, and the all-reduce of bf16
    partials; ROADMAP R10), where K1 and K8's per-head mode sum in float32:
    it is held against jax.grad at x widened to float32 (the float32 sum:
    2^-6 of scale; measured up to 7.4e-3) and against JAX's own bfloat16
    gradient (2^-5; measured up to 2.0e-2, where JAX's own distance from
    the float32 sum reaches 1.3e-2). Prints the measured differences."""
    res, inp = worlds[world], inputs
    mesh, g = j_make_mesh(world), j_graph(inp)
    w = jnp.asarray(inp["w"])
    probe, probe_f = jnp.asarray(inp["probe"]), jnp.asarray(inp["probe_f"])
    params = j_params(inp)
    for mode in ("allreduce", "stream"):
        cfg = JConfig(shard_spmm_mode=mode)
        f = JS.make_sharded_spmm_for(cfg, mesh, g)
        got = [replicated(res, f"bf16_spmm_{mode}{k}")
               for k in ("", "_dx", "_dw")]
        refs = [jvjp(f, (x, w), probe)
                for x in (j_bf16(inp["x"]), j_bf16(inp["x"]).astype(
                    jnp.float32))]
        for out, (dx, dw) in refs:
            close(got[0], out, TIGHT, f"{mode} spmm")
            close(got[2], dw, TIGHT, f"{mode} spmm dw")
            rel = close(got[1], f32(dx), BF16_SUM[dx.dtype.name], "spmm dx")
            print(f"world {world} {mode} spmm dx against JAX's "
                  f"{dx.dtype.name} gradient: {rel:.3e} of scale")
        f = JS.make_sharded_fused_rhs_for(cfg, mesh, g, heads=2)
        got = [replicated(res, f"bf16_fused_{mode}")] + [
            replicated(res, f"bf16_fused_{mode}_d{i}") for i in range(5)]
        refs = [jvjp(f, params + (x,), probe_f)
                for x in (j_bf16(inp["xf"]), j_bf16(inp["xf"]).astype(
                    jnp.float32))]
        for out, wants in refs:
            close(got[0], out, TIGHT, f"{mode} fused")
            top = max(float(jnp.abs(g_).max()) for g_ in wants[:4])
            for i in range(4):
                close(got[1 + i], wants[i], TIGHT, f"{mode} fused d{i}",
                      scale=top)
            dx = wants[4]
            rel = close(got[5], f32(dx), BF16_SUM[dx.dtype.name], "fused dx")
            print(f"world {world} {mode} fused dx against JAX's "
                  f"{dx.dtype.name} gradient: {rel:.3e} of scale")


@pytest.mark.parametrize("world", WORLDS)
def test_dispatchers_payload_only_run_float32(world, worlds):
    """Under the bfloat16 payload with a float32 state the dispatchers run
    as in float32, bit for bit (the JAX dispatchers ignore the payload):
    forward and every gradient."""
    res = worlds[world]
    for mode in ("allreduce", "stream"):
        for kind, f32_key, grads_ in (("spmm", f"spmm_for_{mode}",
                                       ("_dx", "_dw")),
                                      ("fused", f"fused_for_{mode}",
                                       tuple(f"_d{i}" for i in range(5)))):
            for suffix in ("",) + grads_:
                np.testing.assert_array_equal(
                    replicated(res, f"pay_{kind}_{mode}{suffix}"),
                    replicated(res, f32_key + suffix))


def test_unknown_mode_raises():
    g = make_graph(np.arange(8), np.arange(8), num_nodes=8)
    mesh = split_mesh(2, "cpu")
    cfg = Config(shard_spmm_mode="nope")
    with pytest.raises(ValueError, match="shard_spmm_mode"):
        S.make_sharded_spmm_for(cfg, mesh, g)
    with pytest.raises(ValueError, match="shard_spmm_mode"):
        S.make_sharded_fused_rhs_for(cfg, mesh, g, heads=2)


@pytest.fixture(scope="module")
def single_device_blocks(inputs):
    """The unsharded blocks (the port's default engine) the sharded runs
    are held against."""
    g = ranks.base_graph(inputs)
    probe = ranks.leaf(inputs["probe_b"], False)
    out = {}
    for name, cfg in (("lap", ranks.laplacian_config()),
                      ("att", ranks.attention_config())):
        out[name] = ranks.block_run(cfg, ranks.prepared(cfg, g),
                                    ranks.leaf(inputs["xb"]), probe)
    return out


@pytest.mark.parametrize("engine", ["ar", "stripe", "stream"])
@pytest.mark.parametrize("block", ["lap", "att"])
@pytest.mark.parametrize("world", WORLDS)
def test_block_forward_sharded_matches_single_device(
        world, block, engine, worlds, single_device_blocks):
    """A sharded ``spmm_fn`` in ``block_forward`` (the all-reduce and
    stripe schedules, and the ring schedule through its dispatcher, which
    all-gathers its rows): the constant laplacian block (rk4) and the tuned
    Cora row's attention block (dopri5; its frozen attention reaches the
    sharded engine as a replicated w, whose gradient is summed over the
    ranks) against the unsharded block: z, the
    gradients in x and every block parameter (each to 1e-5 of the largest:
    some are rounding noise around 0), and the NFE."""
    res = worlds[world]
    (z, *grads), stats = single_device_blocks[block]
    close(replicated(res, f"block_{block}_{engine}_0"), z, TIGHT, "z")
    top = max(float(np.abs(g_).max()) for g_ in grads)
    for i, want in enumerate(grads, 1):
        close(replicated(res, f"block_{block}_{engine}_{i}"), want, TIGHT,
              f"gradient {i}", scale=top)
    assert int(replicated(res, f"block_{block}_{engine}_nfe")) == int(
        stats["nfe"])


def test_pad_capacity_matches_jax(inputs):
    jg = j_graph(inputs)
    tg = make_graph(inputs["row"], inputs["col"], num_nodes=N,
                    pad_multiple=8)
    for multiple in (3, 8, 48):
        jp, tp = j_pad_capacity(jg, multiple), pad_capacity(tg, multiple)
        assert tp.capacity == jp.capacity and tp.capacity % multiple == 0
        for a in ("row", "col", "weight", "mask"):
            np.testing.assert_array_equal(getattr(tp, a).numpy(),
                                          np.asarray(getattr(jp, a)))
    sg = pad_capacity(tg.sort_by_row(), 48)
    assert not sg.rows_sorted and sg.rowptr is None and sg.colptr is None
    resorted = sg.sort_by_row()
    assert resorted.capacity == 432 and int(resorted.rowptr[-1]) == E
    assert pad_capacity(tg, 8) is tg


def test_shard_graph_slices_and_refuses_an_uneven_capacity(inputs):
    g = make_graph(inputs["row"], inputs["col"], num_nodes=N,
                   pad_multiple=8)
    shards = shard_graph(split_mesh(4, "cpu"), g)
    assert [s.capacity for s in shards] == [100] * 4
    np.testing.assert_array_equal(torch.cat([s.col for s in shards]).numpy(),
                                  g.col.numpy())
    with pytest.raises(ValueError, match="not divisible"):
        shard_graph(split_mesh(3, "cpu"), g)


def test_split_mesh_matches_the_gloo_worlds(worlds, inputs):
    """The in-process split (every rank's body in turn, partials summed in
    rank order) computes what the gloo worlds compute."""
    g = ranks.base_graph(inputs)
    gp = ranks.prepared(ranks.laplacian_config(), g)
    x = torch.tensor(inputs["x"])
    for world in WORLDS:
        mesh = split_mesh(world, "cpu")
        res = worlds[world]
        close(S.make_sharded_stripe_spmm(mesh, gp)(
            x, torch.tensor(inputs["w_prepared"])).numpy(),
            replicated(res, "stripe_out"), TIGHT, "stripe")
        close(S.make_sharded_spmm_stream(mesh, g)(
            x, torch.tensor(inputs["w"])).numpy(),
            row_sharded(res, "st_out"), TIGHT, "stream")


def test_make_mesh_refuses_what_it_cannot_build(tmp_path):
    with pytest.raises(ValueError, match="init_method"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="only 1"):
        try:
            make_mesh(2, "cpu", init_method=f"file://{tmp_path / 'init'}",
                      rank=0, world_size=1)
        finally:
            torch.distributed.destroy_process_group()
    with pytest.raises(ValueError, match="cuda"):
        split_mesh(2, "xla")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        S.make_sharded_stripe_spmm(split_mesh(2, "cpu"),
                                   make_graph([0], [0], num_nodes=1)
                                   .sort_by_row(),
                                   payload_dtype=torch.float16)


def test_replicate_moves_every_tensor():
    tree = {"a": torch.ones(2), "b": [torch.zeros(3), 4]}
    out = replicate(split_mesh(2, "cpu"), tree)
    assert torch.equal(out["a"], tree["a"]) and out["b"][1] == 4
    assert torch.equal(out["b"][0], tree["b"][0])
