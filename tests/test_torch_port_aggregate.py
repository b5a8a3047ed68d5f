"""The PyTorch port's bench slice against the JAX package: the plain
versions of K18 ``fused_aggregate`` (the numerators and denominators of the
attention RHS over a per-edge payload), K19 ``fused_score_max`` and K8's
per-head-cotangent mode ``fused_rhs_bwd_heads``, the differentiable
``fused_rhs_aggregate`` they make up and its hand-derived backward
``fused_bwd_composition``, against the Pallas kernels they replace
(interpret mode on a small stripe plan, as ``tests/test_backward_kernel.py``
builds it) and float32 references; and the port's bench entry.

The JAX payload, its cotangent and the stripe plan are per SLOT (padding
slots where ``plan.valid`` is false); the port's are per edge of the
row-sorted CSR prefix, mapped onto each other through
``plan.slot_of_edge``. The JAX den is [N, max(8, H)] with zero columns
past H; the port's is [N, H]. Inputs come from seeded numpy generators and
go through both packages. On the CPU every wrapper runs its plain version,
which ``chip_smoke.py`` holds the kernels to on the card.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu.ops.pallas.stripe import build_stripe_plan
from graph_neural_pde_tpu_torch import bench, kernels
from graph_neural_pde_tpu_torch.kernels import fused_rhs as tfused
from graph_neural_pde_tpu_torch.ops.graph import make_graph

SCORES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel",
          "exp_kernel_beltrami")
SCALARS = {"exp_kernel": (1.3, 0.8), "exp_kernel_beltrami": (1.1, 0.9, 0.8,
                                                             1.2)}
N, E, D, ATT, H = 48, 400, 8, 8, 2
HP = max(8, H)


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The tensors here are tiny, and the suite runs several workers at
    once: torch's intra-op thread pool only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want, scale=None):
    """Largest error relative to ``scale``, by default the reference
    array's largest entry."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    scale = np.abs(want).max() + 1e-30 if scale is None else scale
    return float(np.abs(got - want).max() / scale)


class Case:
    """One graph and one set of inputs in both packages: ``E`` edges at
    sorted uniform rows over ``N`` nodes, the JAX stripe plan over them
    (block_n 8, chunk 16) and the port's row-sorted graph of the same
    edges, a per-edge payload x_g, node states, projections (packed to
    2 ATT for exp_kernel_beltrami) and the score's scalars."""

    def __init__(self, score="scaled_dot", seed=0, n=N, e=E):
        self.score, self.n, self.e = score, n, e
        rng = np.random.default_rng(seed)
        row = np.sort(rng.integers(0, n, e))
        col = rng.integers(0, n, e)
        self.plan = build_stripe_plan(row, num_nodes=n, block_n=8, chunk=16)
        assert self.plan.num_nodes == n
        self.slot = np.asarray(self.plan.slot_of_edge)
        self.rows_of_slot = (np.repeat(np.asarray(self.plan.chunk_rows),
                                       self.plan.chunk) * self.plan.block_n
                             + np.asarray(self.plan.row_local))
        self.g = make_graph(row, col, num_nodes=n).sort_by_row()
        self.row = row
        att = 2 * ATT if score == "exp_kernel_beltrami" else ATT
        f32 = np.float32
        self.x_n = (0.4 * rng.normal(size=(n, D))).astype(f32)
        self.x_g = (0.4 * rng.normal(size=(e, D))).astype(f32)
        self.qw = (0.3 * rng.normal(size=(D, att))).astype(f32)
        self.kw = (0.3 * rng.normal(size=(D, att))).astype(f32)
        self.qb = (0.1 * rng.normal(size=att)).astype(f32)
        self.kb = (0.1 * rng.normal(size=att)).astype(f32)
        self.gmax = np.array([0.1], f32)
        self.sp = np.array(SCALARS.get(score, ()), f32)
        self.ct_num = rng.normal(size=(n, H * D)).astype(f32)
        self.ct_den = rng.normal(size=(n, H)).astype(f32)

    # -- JAX side ----------------------------------------------------------
    def slots(self, a):
        """A per-edge array [E, ...] as the plan's per-slot one."""
        out = np.zeros((self.plan.capacity,) + a.shape[1:], a.dtype)
        out[self.slot] = a
        return jnp.asarray(out)

    def j_sp(self):
        return tuple(jnp.asarray(v) for v in self.sp)

    def j_ops(self):
        """(qw, qb, kw, kb, x_n, x_g per slot, gmax)."""
        return (*(jnp.asarray(a) for a in (self.qw, self.qb, self.kw,
                                           self.kb, self.x_n)),
                self.slots(self.x_g), jnp.asarray(self.gmax[0]))

    def j_cts(self):
        ct_den = np.zeros((self.n, HP), np.float32)
        ct_den[:, :H] = self.ct_den
        return jnp.asarray(self.ct_num), jnp.asarray(ct_den)

    # -- port side ---------------------------------------------------------
    def t_sp(self, grad=False, dtype=torch.float32):
        return tuple(torch.tensor([v], dtype=dtype, requires_grad=grad)
                     for v in self.sp)

    def t_ops(self, grad=False, dtype=torch.float32):
        """(qw, qb, kw, kb, x_n, x_g, gmax)."""
        return tuple(torch.tensor(a, dtype=dtype, requires_grad=grad)
                     for a in (self.qw, self.qb, self.kw, self.kb, self.x_n,
                               self.x_g, self.gmax))

    def t_scalars(self):
        """(var, ls) as the kernels take them."""
        return tfused.score_scalars(self.score, self.t_sp())

    def t_cts(self):
        return torch.tensor(self.ct_num), torch.tensor(self.ct_den)


def _f32_stripe(monkeypatch):
    """Run the JAX composition's stripe gathers and scatter with float32
    operands: they default to bfloat16 (``stripe.py:381, 431, 667``), which
    would make the float32 reference a bfloat16 one."""
    for name in ("_stripe_gather_call", "_stripe_gather2_call",
                 "_stripe_scatter_call"):
        fn = getattr(jfused, name)
        monkeypatch.setattr(jfused, name,
                            lambda *a, _fn=fn, **k: _fn(*a, **dict(
                                k, dtype=jnp.float32)))


def _np_aggregate(c, us):
    """num [N, H·D], den [N, H] summed in float32 numpy from per-slot,
    per-head weights ``us`` (each [cap])."""
    m = np.asarray(c.plan.valid)
    xg = np.asarray(c.slots(c.x_g))
    num = np.zeros((c.n, H * c.x_g.shape[1]), np.float32)
    den = np.zeros((c.n, H), np.float32)
    for h in range(H):
        u = np.asarray(us[h], np.float32)
        np.add.at(num[:, h * D:(h + 1) * D], c.rows_of_slot[m],
                  u[m, None] * xg[m])
        np.add.at(den[:, h], c.rows_of_slot[m], u[m])
    return num, den


class TestAggregate:
    """K18's plain version (``fused_aggregate``)."""

    @pytest.mark.parametrize("square_plus", [False, True])
    def test_matches_f32_numpy_over_scores_u(self, square_plus):
        """(a): against a float32 numpy sum of the u of the JAX package's
        ``_scores_u`` (zero per-edge shifts keep its q gather float32)."""
        c = Case("scaled_dot", seed=1)
        qw, qb, kw, kb, x_n, x_g, gmax = c.j_ops()
        zeros = tuple(jnp.zeros(c.plan.capacity) for _ in range(H))
        _, _, us, _ = jfused._scores_u(c.plan, x_n @ qw + qb, kw, kb, x_g,
                                       gmax, H, square_plus, shifts=zeros)
        want_num, want_den = _np_aggregate(c, us)
        qw, qb, kw, kb, x_n, x_g, gmax = c.t_ops()
        num, den = kernels.fused_aggregate(
            c.g.rowptr, c.g.row, x_n, x_g, qw, qb, kw, kb, gmax, heads=H,
            score="scaled_dot", square_plus=square_plus)
        assert num.shape == (N, H * D) and den.shape == (N, H)
        assert _rel(num, want_num) < 1e-5
        assert _rel(den, want_den) < 1e-5

    @pytest.mark.parametrize("score", SCORES)
    def test_matches_pallas(self, score):
        """(b): against ``fused_rhs_aggregate`` in interpret mode (bfloat16
        inside the kernel: 3e-2 of scale) and against ``_fused_call`` in
        float32 (1e-5)."""
        c = Case(score, seed=2)
        var, ls = c.t_scalars()
        qw, qb, kw, kb, x_n, x_g, gmax = c.t_ops()
        num, den = kernels.fused_aggregate(
            c.g.rowptr, c.g.row, x_n, x_g, qw, qb, kw, kb, gmax, heads=H,
            score=score, var=var, ls=ls)
        jn, jd = jfused.fused_rhs_aggregate(c.plan, H, False, score,
                                            *c.j_ops(), c.j_sp())
        assert _rel(num, jn) < 3e-2 and _rel(den, jd[:, :H]) < 3e-2
        jn, jd = jfused._fused_call(c.plan, *c.j_ops(), heads=H,
                                    square_plus=False, dtype=jnp.float32,
                                    interpret=True, score=score,
                                    score_params=c.j_sp())
        assert _rel(num, jn) < 1e-5 and _rel(den, jd[:, :H]) < 1e-5
        assert not np.asarray(jd[:, H:]).any()

    def test_shifts_match_pallas(self):
        """Per-edge shifts [E, H] against the Pallas kernel's per-head shift
        arrays, squareplus (float32 in the kernel, as its shifted mode)."""
        c = Case("scaled_dot", seed=3)
        shifts = np.random.default_rng(4).normal(size=(E, H)).astype(
            np.float32)
        qw, qb, kw, kb, x_n, x_g, gmax = c.t_ops()
        num, den = kernels.fused_aggregate(
            c.g.rowptr, c.g.row, x_n, x_g, qw, qb, kw, kb, gmax, heads=H,
            score="scaled_dot", shifts=torch.tensor(shifts),
            square_plus=True)
        jn, jd = jfused._fused_call(
            c.plan, *c.j_ops(), heads=H, square_plus=True, interpret=True,
            shifts=tuple(c.slots(shifts[:, h]) for h in range(H)))
        assert _rel(num, jn) < 1e-5 and _rel(den, jd[:, :H]) < 1e-5


class TestScoreMax:
    """K19's plain version (``fused_score_max``)."""

    def test_matches_pallas_and_numpy(self):
        """(f): against ``_fused_score_max_impl`` in interpret mode
        (float32: 1e-5 relative) and the float32 numpy maximum (1e-6)."""
        c = Case("scaled_dot", seed=5)
        q = c.x_n @ c.qw + c.qb
        got = kernels.fused_score_max(
            c.g.rowptr, c.g.row, torch.tensor(q), torch.tensor(c.x_g),
            torch.tensor(c.kw), torch.tensor(c.kb), heads=H)
        assert got.shape == (1,)
        jm = jfused._fused_score_max_impl(
            c.plan, jnp.asarray(q), jnp.asarray(c.kw), jnp.asarray(c.kb),
            heads=H, x_g=c.slots(c.x_g), dtype=jnp.float32, interpret=True)
        k_e = c.x_g @ c.kw + c.kb
        s = (q[c.row] * k_e).reshape(E, H, -1).sum(-1) / np.float32(
            math.sqrt(ATT // H))
        assert abs(float(got[0]) - float(jm)) <= 1e-5 * abs(float(jm))
        assert abs(float(got[0]) - float(s.max())) <= 1e-6 * abs(s.max())

    def test_edgeless_graph_gives_zero(self):
        g = make_graph(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       num_nodes=6, pad_multiple=8).sort_by_row()
        got = kernels.fused_score_max(
            g.rowptr, g.row, torch.ones(6, 4), torch.ones(g.capacity, 3),
            torch.ones(3, 4), torch.ones(4), heads=2)
        assert got.tolist() == [0.0]


def _port_grads(c, square_plus=False, dtype=torch.float32):
    """The gradients of fused_rhs_aggregate under (ct_num, ct_den):
    (dqw, dqb, dkw, dkb, dx_n, dx_g, dgmax, *d scalars)."""
    ops, sp = c.t_ops(True, dtype), c.t_sp(True, dtype)
    num, den = kernels.fused_rhs_aggregate(c.g, H, square_plus, c.score,
                                           *ops, sp)
    ct_num, ct_den = (t.to(dtype) for t in c.t_cts())
    return torch.autograd.grad((num, den), [*ops, *sp], (ct_num, ct_den))


class TestBackward:
    """``fused_rhs_aggregate``'s backward: K8's per-head mode."""

    @pytest.mark.parametrize("square_plus", [False, True])
    def test_matches_composition(self, square_plus, monkeypatch):
        """(c): against the JAX package's hand-derived
        ``_fused_bwd_composition`` (scaled_dot; its stripe calls in
        float32), 1e-4 of each array's scale; and the port's own
        ``fused_bwd_composition`` against it."""
        _f32_stripe(monkeypatch)
        c = Case("scaled_dot", seed=6)
        want = jfused._fused_bwd_composition(c.plan, H, square_plus,
                                             c.j_ops(), c.j_cts())
        got = _port_grads(c, square_plus)
        mine = tfused.fused_bwd_composition(c.g, H, square_plus,
                                            c.t_ops(), c.t_cts())
        for i, w in enumerate(want):
            w = np.asarray(w)[c.slot] if i == 5 else w
            assert _rel(got[i], w) < 1e-4, i
            assert _rel(mine[i], w) < 1e-4, i

    @pytest.mark.parametrize("score", SCORES)
    def test_matches_pallas_vjp(self, score):
        """(c): against ``jax.vjp`` of ``fused_rhs_aggregate`` in interpret
        mode (bfloat16 inside: 3e-2 of the largest weight or state
        gradient; each score scalar's of its own size)."""
        c = Case(score, seed=7)
        _, vjp = jax.vjp(
            lambda *a: jfused.fused_rhs_aggregate(c.plan, H, False, score,
                                                  *a[:7], a[7]),
            *c.j_ops(), c.j_sp())
        want = vjp(c.j_cts())
        want = list(want[:5]) + [np.asarray(want[5])[c.slot], want[6]] + \
            list(want[7])
        got = _port_grads(c)
        assert len(got) == len(want)
        scale = max(float(np.abs(np.asarray(want[i])).max())
                    for i in (0, 2, 4, 5))
        for i, (a, b) in enumerate(zip(got, want)):
            s = scale if i < 7 else float(np.abs(np.asarray(b)).max())
            assert _rel(a.detach(), b, s) < 3e-2, i

    @pytest.mark.parametrize("score", SCORES)
    def test_kernel_matches_mega_call(self, score):
        """(e): the per-head mode's plain version against
        ``_fused_bwd_mega_call`` without ``recip_p`` in interpret mode: dq,
        dxg per edge, dkw, dkb, dgmax and the score scalars, each within
        1e-5 of its scale of the float32 kernel and, for scaled_dot and
        exp_kernel_beltrami, 3e-2 of the bfloat16 one. (The bfloat16
        kernel's own distance from the float32 one reaches 5e-2 of scale on
        cosine_sim's dxg, 9e-2 on pearson's and 1e-1 on exp_kernel's
        scalars at these inputs, so it is no reference at 3e-2 there.)"""
        c = Case(score, seed=8)
        var, ls = c.t_scalars()
        qw, qb, kw, kb, x_n, x_g, gmax = c.t_ops()
        got = kernels.fused_rhs_bwd_heads(
            c.g.rowptr, c.g.row, x_n, x_g, qw, qb, kw, kb, gmax, *c.t_cts(),
            heads=H, score=score, var=var, ls=ls)
        assert got[1].shape == (E, D)
        flat = list(got[:5])
        if score in SCALARS:     # dvar, dls in the JAX order of the scalars
            flat += [v for pair in zip(got[5], got[6]) for v in pair]
        refs = [(jnp.float32, 1e-5)]
        if score in ("scaled_dot", "exp_kernel_beltrami"):
            refs.append((jnp.bfloat16, 3e-2))
        for dtype, bound in refs:
            dq, dxg, dkw, dkb, dgmax, dextra = jfused._fused_bwd_mega_call(
                c.plan, *c.j_ops(), *c.j_cts(), heads=H, square_plus=False,
                dtype=dtype, interpret=True, score=score,
                score_params=c.j_sp())
            want = [dq, np.asarray(dxg)[c.slot], dkw, dkb, dgmax, *dextra]
            assert len(flat) == len(want)
            for i, (a, b) in enumerate(zip(flat, want)):
                assert _rel(a, b) < bound, (dtype, i)

    @pytest.mark.parametrize("score", SCORES)
    def test_gradcheck(self, score):
        """(d): ``torch.autograd.gradcheck`` of ``fused_rhs_aggregate`` in
        float64 (the plain versions) on a small graph, squareplus for
        scaled_dot."""
        c = Case(score, seed=9, n=16, e=40)
        ops, sp = c.t_ops(True, torch.float64), c.t_sp(True, torch.float64)
        square_plus = score == "scaled_dot"

        def f(*a):
            return kernels.fused_rhs_aggregate(c.g, H, square_plus, score,
                                               *a[:7], a[7:])

        assert torch.autograd.gradcheck(f, (*ops, *sp), eps=1e-6, atol=1e-6)


class TestWrappers:
    def test_cpu_runs_plain_versions_without_launching(self):
        c = Case("scaled_dot")
        before = [k.launches for k in kernels.KERNELS]
        _port_grads(c)
        q = torch.tensor(c.x_n @ c.qw + c.qb)
        kernels.fused_score_max(c.g.rowptr, c.g.row, q, *c.t_ops()[5:6],
                                *c.t_ops()[2:4], heads=H)
        assert [k.launches for k in kernels.KERNELS] == before
        for k in (kernels.fused_aggregate, kernels.fused_score_max,
                  kernels.fused_rhs_bwd_heads):
            assert k in kernels.KERNELS

    @pytest.mark.parametrize("bad", ["payload shape", "ct_num shape",
                                     "dtype", "meta"])
    def test_rejects(self, bad):
        c = Case("scaled_dot")
        qw, qb, kw, kb, x_n, x_g, gmax = c.t_ops()
        ct_num, ct_den = c.t_cts()
        rowptr, row = c.g.rowptr, c.g.row
        err = (TypeError, ValueError)
        if bad == "payload shape":
            x_g = x_g[:-1].contiguous()
        elif bad == "ct_num shape":
            ct_num = ct_num[:, :D].contiguous()
        elif bad == "dtype":
            x_g = x_g.double()
        else:
            err = NotImplementedError
            rowptr, row, qw, qb, kw, kb, x_n, x_g, gmax, ct_num, ct_den = (
                t.to("meta") for t in (rowptr, row, qw, qb, kw, kb, x_n, x_g,
                                       gmax, ct_num, ct_den))
        with pytest.raises(err):
            kernels.fused_rhs_bwd_heads(rowptr, row, x_n, x_g, qw, qb, kw,
                                        kb, gmax, ct_num, ct_den, heads=H,
                                        score="scaled_dot")
        if bad != "ct_num shape":
            with pytest.raises(err):
                kernels.fused_aggregate(rowptr, row, x_n, x_g, qw, qb, kw,
                                        kb, gmax, heads=H,
                                        score="scaled_dot")

    def test_score_max_rejects_heads(self):
        c = Case("scaled_dot")
        q = torch.zeros(N, ATT)
        with pytest.raises(ValueError):
            kernels.fused_score_max(c.g.rowptr, c.g.row, q,
                                    torch.zeros(E, D), torch.zeros(D, ATT),
                                    torch.zeros(ATT), heads=3)


class TestBench:
    def test_graph_matches_jax_bench(self):
        """(g): the port's build_benchmark draws the JAX bench's graph and
        features exactly."""
        import bench as jbench
        sizes = dict(num_nodes=60, num_edges=150, hidden=8, attention_dim=8,
                     heads=2, seed=3)
        _, _, _, jx, jg, jnf, jnc = jbench.build_benchmark(**sizes)
        model, x, g, nf, nc = bench.build_benchmark(**sizes, device="cpu")
        assert (nf, nc) == (jnf, jnc)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        for name in ("row", "col", "mask"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(jg, name)))
        assert model.cfg.hidden_dim == 8 and model.cfg.heads == 2

    def test_main_passes_oracles_and_prints_one_line(self, capsys):
        """(h): ``main`` on the CPU at a toy size passes both oracles and
        prints one JSON line with the JAX bench's keys (without
        ``vs_baseline`` and the Chebyshev ones)."""
        out = bench.main(device="cpu", num_nodes=200, num_edges=600,
                         hidden=16, attention_dim=8, heads=2, reps=1,
                         batches=1, train_reps=1, train_batches=1)
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1 and json.loads(lines[0]) == out
        keys = {"metric", "value", "unit", "train_edge_updates_per_sec_nfe",
                "grand_nl_cosine_edge_updates_per_sec_nfe",
                "blend_beltrami_edge_updates_per_sec_nfe",
                "grand_nl_norm1_edge_updates_per_sec_nfe",
                "train_norm1_edge_updates_per_sec_nfe", "train_norm1_step_ms",
                "early_stop_eval_ms", "early_stop_nfe",
                "early_stop_overhead_vs_plain_fwd"}
        for mode in ("remat", "adjoint"):
            keys |= {f"train_step_ms_{mode}", f"train_warm_compile_s_{mode}",
                     f"train_grand_l_{mode}_edge_updates_per_sec_nfe",
                     f"train_grand_l_{mode}_step_ms"}
        assert set(out) == keys
        assert out["metric"] == "grand_nl_arxiv_edge_updates_per_sec_nfe"
        # a first step's seconds may round to 0.0 at this size
        assert all(v > 0 for k, v in out.items()
                   if k not in ("metric", "unit") and "compile" not in k)
        assert all(out[f"train_warm_compile_s_{m}"] >= 0
                   for m in ("remat", "adjoint"))

    def test_main_needs_a_card_unless_asked_for_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            bench.main()
