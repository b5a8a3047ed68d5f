"""The PyTorch port's per-edge attention aggregate under the bfloat16
payload against the JAX package: the plain versions of K18
``fused_aggregate``, K19 ``fused_score_max`` and K8's per-head mode
``fused_rhs_bwd_heads`` over a bfloat16 payload x_g beside a float32 or a
bfloat16 (the bf16 ODE state) x_n, and the differentiable
``fused_rhs_aggregate`` they make up.

The JAX package runs the same bf16 arrays through P8 ``_fused_call``, P9
``_fused_score_max_impl`` and P11 ``_fused_bwd_mega_call`` in interpret
mode. At ``dtype=jnp.float32`` those widen each bf16 row and project
k_e = x_g Kw + kb in float32, unrounded, as the port does: 1e-5 of scale.
At their default bf16 in-kernel dtype they round every MXU operand: 3e-2
(for the per-head backward on scaled_dot and exp_kernel_beltrami only,
as ``test_torch_port_aggregate.py`` measured the bf16 kernel's own
distance on the other families). The op's gradients come back in their
inputs' dtypes, as the JAX ``_fused_bwd`` casts them: a bfloat16 gradient
is held within one bf16 step (the spacing of bf16 values in the binade of
the reference's largest entry), every float32 one at 1e-5 (1e-4 against
the hand-derived composition). The plan and the slot <-> edge map are
``test_torch_port_aggregate.py``'s, on a smaller graph.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.ops.pallas import fused_rhs as jfused
from graph_neural_pde_tpu.ops.pallas.stripe import build_stripe_plan
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.kernels import fused_rhs as tfused
from graph_neural_pde_tpu_torch.ops.graph import make_graph

SCORES = ("scaled_dot", "cosine_sim", "exp_kernel_beltrami")
SCALARS = {"exp_kernel_beltrami": (1.1, 0.9, 0.8, 1.2)}
N, E, D, ATT, H = 32, 240, 8, 8, 2
HP = max(8, H)
ROWS = ("float32", "bfloat16")          # the dtype of x_n
TIGHT, BF16_KERNEL = 1e-5, 3e-2


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
    if torch.is_tensor(got):
        got = got.detach().double().numpy()
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    scale = np.abs(want).max() + 1e-30 if scale is None else scale
    return float(np.abs(got - want).max() / scale)


def _bf16(a):
    """float32 ``a`` rounded to bfloat16 (to nearest even), as float32."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _bf16_step(want) -> float:
    """One bfloat16 step at the largest |want|."""
    top = float(np.abs(np.asarray(want, np.float64)).max())
    return 2.0 ** (math.floor(math.log2(top)) - 7)


class Case:
    """One graph and one set of inputs in both packages (the stripe plan,
    block_n 8 and chunk 16, and the port's row-sorted graph of the same
    edges), with x_g and, for ``row="bfloat16"``, x_n holding
    bfloat16 values."""

    def __init__(self, score="scaled_dot", seed=0, row="float32"):
        self.score, self.row_dtype = score, row
        rng = np.random.default_rng(seed)
        row_i = np.sort(rng.integers(0, N, E))
        col = rng.integers(0, N, E)
        self.plan = build_stripe_plan(row_i, num_nodes=N, block_n=8,
                                      chunk=16)
        self.slot = np.asarray(self.plan.slot_of_edge)
        self.g = make_graph(row_i, col, num_nodes=N).sort_by_row()
        att = 2 * ATT if score == "exp_kernel_beltrami" else ATT
        f32 = np.float32
        self.x_n = (0.4 * rng.normal(size=(N, D))).astype(f32)
        if row == "bfloat16":
            self.x_n = _bf16(self.x_n)
        self.x_g = _bf16((0.4 * rng.normal(size=(E, D))).astype(f32))
        self.qw = (0.3 * rng.normal(size=(D, att))).astype(f32)
        self.kw = (0.3 * rng.normal(size=(D, att))).astype(f32)
        self.qb = (0.1 * rng.normal(size=att)).astype(f32)
        self.kb = (0.1 * rng.normal(size=att)).astype(f32)
        self.gmax = np.array([0.1], f32)
        self.sp = np.array(SCALARS.get(score, ()), f32)
        self.ct_num = rng.normal(size=(N, H * D)).astype(f32)
        self.ct_den = rng.normal(size=(N, H)).astype(f32)

    # -- JAX side: x_g per slot and x_n in bfloat16 where the case says --
    def slots(self, a):
        out = np.zeros((self.plan.capacity,) + a.shape[1:], a.dtype)
        out[self.slot] = a
        return out

    def j_ops(self):
        """(qw, qb, kw, kb, x_n, x_g per slot, gmax)."""
        x_n = jnp.asarray(self.x_n)
        if self.row_dtype == "bfloat16":
            x_n = x_n.astype(jnp.bfloat16)
        return (*(jnp.asarray(a) for a in (self.qw, self.qb, self.kw,
                                           self.kb)),
                x_n, jnp.asarray(self.slots(self.x_g), jnp.bfloat16),
                jnp.asarray(self.gmax[0]))

    def j_sp(self):
        return tuple(jnp.asarray(v) for v in self.sp)

    def j_cts(self):
        ct_den = np.zeros((N, HP), np.float32)
        ct_den[:, :H] = self.ct_den
        return jnp.asarray(self.ct_num), jnp.asarray(ct_den)

    # -- port side ---------------------------------------------------------
    def t_ops(self, grad=False):
        """(qw, qb, kw, kb, x_n, x_g, gmax); x_g bfloat16, x_n as the case
        says."""
        ops = [torch.tensor(a) for a in (self.qw, self.qb, self.kw, self.kb,
                                         self.x_n, self.x_g, self.gmax)]
        ops[5] = ops[5].to(torch.bfloat16)
        ops[4] = ops[4].to(getattr(torch, self.row_dtype))
        return tuple(t.requires_grad_(grad) for t in ops)

    def t_kernel_ops(self):
        """The kernels' order: (x_n, x_g, qw, qb, kw, kb, gmax)."""
        qw, qb, kw, kb, x_n, x_g, gmax = self.t_ops()
        return x_n, x_g, qw, qb, kw, kb, gmax

    def t_sp(self, grad=False):
        return tuple(torch.tensor([v], requires_grad=grad) for v in self.sp)

    def t_scalars(self):
        return tfused.score_scalars(self.score, self.t_sp())

    def t_cts(self):
        return torch.tensor(self.ct_num), torch.tensor(self.ct_den)


def _f32_kernels(monkeypatch):
    """The JAX op's Pallas calls at ``dtype=float32`` (the bf16 payload
    widened, k_e unrounded) instead of their bf16 default."""
    for name in ("_fused_call", "_fused_bwd_mega_call"):
        fn = getattr(jfused, name)
        monkeypatch.setattr(jfused, name,
                            lambda *a, _fn=fn, **k: _fn(*a, **dict(
                                k, dtype=jnp.float32)))


def _f32_stripe(monkeypatch):
    """The JAX composition's stripe calls in float32 (their default is
    bfloat16), as ``test_torch_port_aggregate.py`` runs them."""
    for name in ("_stripe_gather_call", "_stripe_gather2_call",
                 "_stripe_scatter_call"):
        fn = getattr(jfused, name)
        monkeypatch.setattr(jfused, name,
                            lambda *a, _fn=fn, **k: _fn(*a, **dict(
                                k, dtype=jnp.float32)))


class TestAggregate:
    """K18's plain version on the bfloat16 payload."""

    @pytest.mark.parametrize("row", ROWS)
    @pytest.mark.parametrize("score", SCORES)
    def test_matches_pallas(self, score, row):
        c = Case(score, seed=1, row=row)
        var, ls = c.t_scalars()
        num, den = kernels.fused_aggregate(
            c.g.rowptr, c.g.row, *c.t_kernel_ops(), heads=H, score=score, var=var,
            ls=ls)
        assert num.dtype == den.dtype == torch.float32
        for dtype, tol in ((jnp.float32, TIGHT),
                           (jnp.bfloat16, BF16_KERNEL)):
            jn, jd = jfused._fused_call(
                c.plan, *c.j_ops(), heads=H, square_plus=False, dtype=dtype,
                interpret=True, score=score, score_params=c.j_sp())
            assert _rel(num, jn) < tol and _rel(den, jd[:, :H]) < tol, dtype

    @pytest.mark.parametrize("row", ROWS)
    def test_shifts_match_pallas(self, row):
        """Per-edge shifts (the exact mode: the Pallas kernel forces its
        in-kernel dtype to float32 and reads the bf16 payload as given),
        squareplus."""
        c = Case("scaled_dot", seed=2, row=row)
        shifts = np.random.default_rng(4).normal(size=(E, H)).astype(
            np.float32)
        num, den = kernels.fused_aggregate(
            c.g.rowptr, c.g.row, *c.t_kernel_ops(), heads=H, score="scaled_dot",
            shifts=torch.tensor(shifts), square_plus=True)
        jn, jd = jfused._fused_call(
            c.plan, *c.j_ops(), heads=H, square_plus=True, interpret=True,
            shifts=tuple(jnp.asarray(c.slots(shifts[:, h]))
                         for h in range(H)))
        assert _rel(num, jn) < TIGHT and _rel(den, jd[:, :H]) < TIGHT


class TestScoreMax:
    def test_matches_pallas(self):
        """K19 over the bfloat16 payload, q float32."""
        c = Case("scaled_dot", seed=3)
        q = c.x_n @ c.qw + c.qb
        got = kernels.fused_score_max(
            c.g.rowptr, c.g.row, torch.tensor(q),
            torch.tensor(c.x_g).to(torch.bfloat16), torch.tensor(c.kw),
            torch.tensor(c.kb), heads=H)
        for dtype, tol in ((jnp.float32, TIGHT),
                           (jnp.bfloat16, BF16_KERNEL)):
            jm = jfused._fused_score_max_impl(
                c.plan, jnp.asarray(q), jnp.asarray(c.kw), jnp.asarray(c.kb),
                heads=H, x_g=jnp.asarray(c.slots(c.x_g), jnp.bfloat16),
                dtype=dtype, interpret=True)
            assert abs(float(got[0]) - float(jm)) <= tol * abs(float(jm))


class TestBwdHeads:
    """K8's per-head mode (plain version) on the bfloat16 payload."""

    @pytest.mark.parametrize("row", ROWS)
    @pytest.mark.parametrize("score", SCORES)
    def test_matches_mega_call(self, score, row):
        """dq, dxg per edge (float32: the kernel's own outputs), dkw, dkb,
        dgmax and the score scalars."""
        c = Case(score, seed=5, row=row)
        var, ls = c.t_scalars()
        got = kernels.fused_rhs_bwd_heads(
            c.g.rowptr, c.g.row, *c.t_kernel_ops(), *c.t_cts(), heads=H,
            score=score, var=var, ls=ls)
        assert got[1].dtype == torch.float32 and got[1].shape == (E, D)
        flat = list(got[:5])
        if score in SCALARS:     # dvar, dls in the JAX order of the scalars
            flat += [v for pair in zip(got[5], got[6]) for v in pair]
        refs = [(jnp.float32, TIGHT)]
        if score != "cosine_sim":
            refs.append((jnp.bfloat16, BF16_KERNEL))
        for dtype, tol in refs:
            dq, dxg, dkw, dkb, dgmax, dextra = jfused._fused_bwd_mega_call(
                c.plan, *c.j_ops(), *c.j_cts(), heads=H, square_plus=False,
                dtype=dtype, interpret=True, score=score,
                score_params=c.j_sp())
            want = [dq, np.asarray(dxg)[c.slot], dkw, dkb, dgmax, *dextra]
            assert len(flat) == len(want)
            for i, (a, b) in enumerate(zip(flat, want)):
                assert _rel(a, b) < tol, (dtype, i)


def _port_op(c, square_plus=False):
    """fused_rhs_aggregate's (num, den) and its gradients under (ct_num,
    ct_den): (dqw, dqb, dkw, dkb, dx_n, dx_g, dgmax, *d scalars)."""
    ops, sp = c.t_ops(True), c.t_sp(True)
    num, den = kernels.fused_rhs_aggregate(c.g, H, square_plus, c.score,
                                           *ops, sp)
    grads = torch.autograd.grad((num, den), [*ops, *sp], c.t_cts())
    return num, den, grads


def _check_grad(i, got, want, dtype, scale):
    """Gradient i against the reference: a bfloat16 one within one bf16
    step, a float32 one within 1e-5 of ``scale``."""
    if dtype == torch.bfloat16:
        assert got.dtype == torch.bfloat16, i
        err = np.abs(got.double().numpy() - np.asarray(want, np.float64))
        assert err.max() <= _bf16_step(want), i
    else:
        assert got.dtype == torch.float32, i
        assert _rel(got, want, scale) < TIGHT, i


class TestOp:
    """``fused_rhs_aggregate`` on the bfloat16 payload."""

    @pytest.mark.parametrize("row", ROWS)
    @pytest.mark.parametrize("score", SCORES)
    def test_matches_jax_vjp(self, score, row, monkeypatch):
        """Values and every gradient against ``jax.vjp`` of the JAX op on
        the same bf16 inputs, its Pallas calls at float32 (the gradients
        of x_n and x_g come back in their dtypes on both sides)."""
        _f32_kernels(monkeypatch)
        c = Case(score, seed=7, row=row)
        (jn, jd), vjp = jax.vjp(
            lambda *a: jfused.fused_rhs_aggregate(c.plan, H, False, score,
                                                  *a[:7], a[7]),
            *c.j_ops(), c.j_sp())
        want = vjp(c.j_cts())
        want = [*want[:5], np.asarray(want[5].astype(jnp.float32))[c.slot],
                want[6], *want[7]]
        num, den, got = _port_op(c)
        assert _rel(num, jn) < TIGHT and _rel(den, jd[:, :H]) < TIGHT
        assert len(got) == len(want)
        dtypes = [torch.float32] * len(got)
        dtypes[4] = getattr(torch, row)
        dtypes[5] = torch.bfloat16
        scale = max(float(np.abs(np.asarray(want[i], np.float64)).max())
                    for i in (0, 2))
        for i, (a, b) in enumerate(zip(got, want)):
            s = scale if i < 7 else float(np.abs(np.asarray(b)).max())
            _check_grad(i, a.detach(), np.asarray(b, np.float32), dtypes[i],
                        s)

    @pytest.mark.parametrize("row", ROWS)
    @pytest.mark.parametrize("square_plus", [False, True])
    def test_matches_composition(self, square_plus, row, monkeypatch):
        """Against the JAX package's hand-derived ``_fused_bwd_composition``
        (scaled_dot; its stripe calls in float32): the float32 gradients
        at 1e-4 of each one's scale, the bfloat16 ones within one bf16
        step; and the port's own ``fused_bwd_composition`` the same."""
        _f32_stripe(monkeypatch)
        c = Case("scaled_dot", seed=8, row=row)
        want = jfused._fused_bwd_composition(c.plan, H, square_plus,
                                             c.j_ops(), c.j_cts())
        _, _, got = _port_op(c, square_plus)
        mine = tfused.fused_bwd_composition(c.g, H, square_plus, c.t_ops(),
                                            c.t_cts())
        for i, w in enumerate(want):
            w = np.asarray(w.astype(jnp.float32))
            w = w[c.slot] if i == 5 else w
            for ours in (got[i].detach(), mine[i]):
                if ours.dtype == torch.bfloat16:
                    err = np.abs(ours.double().numpy() - w).max()
                    assert err <= _bf16_step(w), i
                else:
                    assert _rel(ours, w) < 1e-4, i
            assert got[i].dtype == mine[i].dtype, i


class TestRoutes:
    def test_cpu_counts_no_launch(self):
        """On the CPU the wrappers run their plain versions: no launch and
        no bf16 launch is counted, and the three kernels count their bf16
        launches apart."""
        c = Case("scaled_dot")
        mods = (kernels.fused_aggregate, kernels.fused_score_max,
                kernels.fused_rhs_bwd_heads)
        assert all(k in kernels.BF16_KERNELS for k in mods)
        before = [(k.launches, k.bf16_launches) for k in mods]
        _port_op(c)
        assert [(k.launches, k.bf16_launches) for k in mods] == before

    @pytest.mark.parametrize("bad", ["float16 payload",
                                     "bf16 x_n beside a float32 payload",
                                     "payload shape"])
    def test_kernels_refuse_what_they_lack(self, bad):
        """A payload other than float32 or bfloat16, and a bfloat16 row side
        beside a float32 payload (no kernel reads that pair), raise: nothing
        is widened to reach the float32 kernel."""
        c = Case("scaled_dot")
        qw, qb, kw, kb, x_n, x_g, gmax = c.t_ops()
        err = TypeError
        if bad == "float16 payload":
            x_g = x_g.to(torch.float16)
        elif bad == "payload shape":
            x_g, err = x_g[:-1].contiguous(), ValueError
        else:
            x_n, x_g = x_n.to(torch.bfloat16), x_g.float()
        with pytest.raises(err):
            kernels.fused_aggregate(c.g.rowptr, c.g.row, x_n, x_g, qw, qb,
                                    kw, kb, gmax, heads=H,
                                    score="scaled_dot")
        with pytest.raises(err):
            kernels.fused_rhs_bwd_heads(c.g.rowptr, c.g.row, x_n, x_g, qw,
                                        qb, kw, kb, gmax, *c.t_cts(),
                                        heads=H, score="scaled_dot")
        if bad != "bf16 x_n beside a float32 payload":
            with pytest.raises(err):
                kernels.fused_score_max(c.g.rowptr, c.g.row, x_n @ qw, x_g,
                                        kw, kb, heads=H)
