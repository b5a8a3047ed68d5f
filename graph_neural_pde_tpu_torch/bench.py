"""The bench entry of the port: GRAND-nl edge throughput at ogbn-arxiv
scale on the card (the JAX package's ``bench.py``).

    python -m graph_neural_pde_tpu_torch.bench [--device cuda|cpu]

It first holds the port's kernels against independent oracles on the
device (:func:`verify_kernels_on_device`,
:func:`verify_score_families_on_device`), then times the GRAND-nl
architecture of ``config.GRAND_NL_BENCH`` over the seeded random graph at
ogbn-arxiv's size (169,343 nodes, 1,166,243 pairs both ways, plus
self-loops) and prints ONE JSON line with the JAX bench's keys:

* ``value``: the forward's edge updates per second times NFE, valid edges
  x NFE / the fastest mean forward time (``metric``, ``unit``);
* ``train_*``: one optimizer step under ``remat`` and under the rk4
  adjoint (the better rate, each step's ms, each first step's seconds);
* ``train_grand_l_*``: the same step of the GRAND-l family (frozen
  attention, laplacian) under remat and under the adjoint;
* ``train_norm1_*``: the step with the softmax over columns (remat);
* the forward rates of cosine_sim, of BLEND's split-space score over a
  seeded N(0, 1) encoding and of the softmax over columns;
* ``early_stop_*``: the early-stop evaluator's time, NFE and its time over
  the plain forward's.

Precision. The model runs at the JAX bench's precision
(``bench.py:93-95``): the bfloat16 payload and the bfloat16 rk4 state
(``config.GRAND_NL_BENCH``). That holds for every key: ``value``,
``train_*``, ``train_grand_l_*``, ``train_norm1_*``, the cosine_sim, BLEND
and column-softmax forwards and ``early_stop_*`` (whose solver keeps a
float32 state, as the JAX package's does).

How it differs from the JAX bench. The oracles hold at 1e-4 of scale
where the JAX bench's bfloat16 kernels hold at 3e-2: the oracles of the
primary op, of the column-plan engine and of the softmax over columns read
the same bf16-rounded column table as the kernels, and those of the
per-edge aggregate (K18, K19, K8's per-head mode) the same bfloat16
payload, so only the order of float32 sums separates the two (the
payload's bfloat16 gradient, rounded once on each side, within one bf16
step). A failed oracle or
secondary raises: nothing falls back to
an unfolded engine, no secondary's failure is caught, and no tunnel or
compile-cache guard exists (nothing here compiles). ``vs_baseline`` (an
estimated rate of another card) and the Chebyshev keys (its solver is
ROADMAP Queue 1 item 17) are left out. ``train_warm_compile_s_<mode>`` is
the first step's seconds (the kernels' build at a first call, the caching
allocator's first requests). The stripe gather of the JAX oracle (TPU
kernel P2 alone) has no kernel of its own here: K1 and K2 fuse it into
the SpMM and the edge dot, and ``chip_smoke.py`` holds those. Without
``--device cpu`` (the tests' sizes, through :func:`main`'s keywords) it
runs on the card, and raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from graph_neural_pde_tpu_torch.config import GRAND_NL_BENCH
from graph_neural_pde_tpu_torch.data.synthetic import (
    make_random_graph_dataset)
from graph_neural_pde_tpu_torch.kernels import (
    column_sum, dual_scatter, fused_aggregate, fused_bwd_composition,
    fused_rhs_aggregate, fused_rhs_f, fused_score_max, make_fused_ax_colplan,
    make_fused_ax_norm1, make_fused_ax_sym)
from graph_neural_pde_tpu_torch.models.gnn import GNNModel
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.ops.graph import make_graph
from graph_neural_pde_tpu_torch.training.train import Trainer

ORACLE_TOL = 1e-4       # of the reference's scale (float32 throughout)


def build_benchmark(num_nodes=169_343, num_edges=1_166_243, hidden=128,
                    attention_dim=32, heads=2, seed=0, device="cuda"):
    """The JAX bench's graph and features (the same numpy draws and
    symmetrisation, ``data.synthetic.make_random_graph_dataset``) and its
    GRAND-nl model at its precision (bfloat16 payload and state) on
    ``device``. Returns (model, x, the raw
    graph, num_features, num_classes)."""
    data = make_random_graph_dataset(num_nodes, num_edges, num_features=128,
                                     num_classes=40, seed=seed,
                                     edge_pad_multiple=1024)
    cfg = GRAND_NL_BENCH.replace(hidden_dim=hidden,
                                 attention_dim=attention_dim, heads=heads,
                                 seed=seed)
    model = GNNModel(cfg, data.num_features, data.num_classes, data.graph,
                     device=device)
    return (model, data.x.to(device), data.graph, data.num_features,
            data.num_classes)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_forward(model, x, reps=5, batches=3, pos=None):
    """(NFE, the fastest of ``batches`` mean times of ``reps`` no-grad
    forwards in seconds, the first forward's seconds)."""
    def forward():
        with torch.no_grad():
            return model(x, training=False, pos_encoding=pos)

    t0 = time.perf_counter()
    logits, stats = forward()
    _sync(x.device)
    first_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("bench forward: non-finite logits")
    best = math.inf
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            forward()
        _sync(x.device)
        best = min(best, (time.perf_counter() - t0) / reps)
    return int(stats["nfe"]), best, first_s


def _time_train(model, x, y, mask, reps=3, batches=2):
    """One full optimizer step (forward, backward, update): (forward NFE,
    the fastest mean step time in seconds, the first step's seconds,
    backward NFE)."""
    trainer = Trainer(model)
    t0 = time.perf_counter()
    loss, stats = trainer.train_step(x, y, mask)
    _sync(x.device)
    first_s = time.perf_counter() - t0
    best = math.inf
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            loss, _ = trainer.train_step(x, y, mask)
        _sync(x.device)
        best = min(best, (time.perf_counter() - t0) / reps)
    if not math.isfinite(loss):
        raise AssertionError(f"bench train step: loss {loss}")
    return int(stats["nfe"]), best, first_s, int(stats["bwd_nfe"])


# ---------------------------------------------------------------------------
# on-device oracles
# ---------------------------------------------------------------------------

def _check(name, got, want, scale=None, tol=ORACLE_TOL) -> float:
    """Raise unless ``got`` is finite and within ``tol`` of ``scale`` (by
    default the largest |want|) of ``want``; returns the relative error."""
    got = torch.as_tensor(got).detach().double().cpu()
    want = torch.as_tensor(want).detach().double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got.reshape(-1) - want.reshape(-1)).abs().max())
    scale = float(want.abs().max()) + 1e-9 if scale is None else scale
    if err / scale >= tol:
        raise AssertionError(f"{name}: max error {err:.3e} is "
                             f"{err / scale:.3e} of scale {scale:.3e}")
    return err / scale


def _check_bf16_step(name, got, want) -> None:
    """Raise unless ``got`` and ``want`` are bfloat16 and lie within one
    bfloat16 step of each other: the spacing of bfloat16 values in the
    binade of want's largest entry (two float32 sums that agree far below
    it may round one step apart)."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: {got.dtype} and {want.dtype}, not "
                             "bfloat16")
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    step = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    err = float((got - want).abs().max())
    if not err <= step:
        raise AssertionError(f"{name}: max error {err:.3e} above one "
                             f"bfloat16 step {step:.3e}")


def _sorted_graph(row, col, n, dev):
    """The row-sorted graph of the pairs (row, col) on ``dev``: rowptr, the
    reverse-edge map when the multiset is symmetric, the CSC view."""
    return make_graph(row, col, num_nodes=n).sort_by_row().to(dev)


def _symmetric_pairs(rng, n, e):
    r0 = rng.integers(0, n, e // 2)
    c0 = rng.integers(0, n, e // 2)
    rs, cs = np.concatenate([r0, c0]), np.concatenate([c0, r0])
    order = np.argsort(rs, kind="stable")
    return rs[order], cs[order]


def _bf16_st(t):
    """``t`` rounded to bfloat16 in value, the identity in its gradient
    (the kernels' backward takes each cast as the identity)."""
    return t + (t.to(torch.bfloat16).float() - t).detach()


def _normalised_ax(g, x, qw, qb, kw, kb, heads, score, sp, norm_cols,
                   probe, bf16=False):
    """sum(ax * probe) of the attention RHS composed of plain torch ops
    over the edges of ``g`` (the oracle the fused engines' autograd is held
    to): softmax normalised over rows, or over columns (``norm_cols``).
    With ``bf16`` the column side reads the bf16 payload as the kernels
    do: values from x rounded to bfloat16, k = bf16(bf16(x_b Kw_b) + kb_b)
    with Kw and kb rounded too, the product summed in float64; over columns
    the denominators sum the scores of that same table."""
    n, d = x.shape
    nv = g.num_valid
    r, c = g.row[:nv].long(), g.col[:nv].long()
    q = x @ qw + qb
    if bf16:
        xb = _bf16_st(x)
        prod = (xb.double() @ _bf16_st(kw).double()).float()
        k = _bf16_st(_bf16_st(prod) + _bf16_st(kb))
        xg, ke = xb[c], k[c]
    else:
        xg = x[c]
        ke = xg @ kw + kb
    s = _torch_scores(q[r], ke, heads, score, sp)
    uu = torch.exp(s)
    idx = c if norm_cols else r
    ax = 0.0
    for h in range(heads):
        dh = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(
            0, idx, uu[:, h])
        w = uu[:, h] / (dh[idx] + 1e-16)
        ax = ax + torch.zeros_like(x).index_add(0, r, w[:, None] * xg)
    return torch.sum(ax / heads * probe)


def _check_grads(label, names, got, want):
    """Every gradient against the oracle's, scaled by the largest oracle
    gradient of the weights and of x (a bias's true gradient under a row
    softmax is ~0, so its own scale would be cancellation noise)."""
    w_scale = max(float(want[i].abs().max()) for i in (0, 2, 4)) + 1e-9
    for name, a, b in zip(names, got, want):
        _check(f"{label} {name}", a, b, scale=w_scale)


def verify_kernels_on_device(device="cuda") -> None:
    """The port's kernels against independent oracles on ``device``, as
    the JAX bench holds its compiled kernels (its ``bench.py:150-400``):
    K10 ``dual_scatter`` (the JAX oracle's scatter2) and K18
    ``fused_aggregate`` with the shift of K19 ``fused_score_max`` (P8, P9)
    against numpy; the backward of ``fused_rhs_aggregate``, K8's per-head
    mode, against the hand-derived ``fused_bwd_composition``: all three
    over the bfloat16 payload x_g beside float32 node rows, as the JAX
    bench feeds P8, P9 and P11 (the oracle and the composition read the
    same bf16 values, with k_e unrounded, and every output is held at
    ORACLE_TOL but the gradient of x_g: bfloat16 on both sides, as the JAX
    op and composition return it, within one bf16 step); K1 as the
    column sum over the CSC view (the column-plan dx) against numpy; the
    column-plan and symmetric engines' gradients (``make_fused_ax_colplan``
    and ``make_fused_ax_sym``, the primary op, both with the bfloat16
    payload, as the JAX bench runs them, and against a composition that
    reads the same bf16-rounded column table) against autograd of a torch
    composition; and the folded epilogue (``fused_rhs_f``, float32 and
    bfloat16). Raises on the first that fails."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    n, e, d, att, heads = 512, 4096, 128, 64, 2
    d_k = att // heads
    row = np.sort(rng.integers(0, n, e))
    col = rng.integers(0, n, e)
    g = _sorted_graph(row, col, n, dev)
    cap = g.capacity

    def dev_t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    # ---- the dual scatter (K10) against numpy --------------------------
    tab = rng.normal(size=(n, d))
    u = np.abs(rng.normal(size=(cap, heads)))
    u[e:] = 0.0
    num, den = dual_scatter(g.rowptr, g.row, g.col, dev_t(u), dev_t(tab),
                            pieces=g.scatter_pieces)
    wn = np.zeros((n, heads * d))
    for h in range(heads):
        np.add.at(wn[:, h * d:(h + 1) * d], row, u[:e, h, None] * tab[col])
    wd = np.zeros((n, heads))
    np.add.at(wd, row, u[:e])
    _check("scatter2 num (K10)", num, wn)
    _check("scatter2 den (K10)", den, wd)

    # ---- P8 + P9: K19's shift, K18's aggregate, against numpy ----------
    x_nodes = rng.normal(size=(n, d)) * 0.5
    qw, qb, kw, kb = (rng.normal(size=s) * 0.1
                      for s in ((d, att), (att,), (d, att), (att,)))
    vals = rng.normal(size=(cap, d))
    vals[e:] = 0.0
    # the payload in bfloat16, and the values the oracles read
    x_t, x_g = dev_t(x_nodes), dev_t(vals).to(torch.bfloat16)
    vals = x_g.double().cpu().numpy()
    qw_t, qb_t, kw_t, kb_t = map(dev_t, (qw, qb, kw, kb))
    q_t = x_t @ qw_t + qb_t
    gm = fused_score_max(g.rowptr, g.row, q_t, x_g, kw_t, kb_t, heads=heads,
                         pieces=g.scatter_pieces)
    fn, fd = fused_aggregate(g.rowptr, g.row, x_t, x_g, qw_t, qb_t, kw_t,
                             kb_t, gm, heads=heads, score="scaled_dot",
                             pieces=g.scatter_pieces)
    src = (x_nodes @ qw + qb)[row]
    k_e = vals[:e] @ kw + kb
    s = (src * k_e).reshape(-1, heads, d_k).sum(-1) / np.sqrt(d_k)
    _check("fused score max (K19)", gm, np.array([s.max()]))
    uu = np.exp(s - float(gm))
    wnum = np.zeros((n, heads * d))
    wden = np.zeros((n, heads))
    np.add.at(wnum, row, (uu[:, :, None] * vals[:e, None, :]).reshape(
        -1, heads * d))
    np.add.at(wden, row, uu)
    _check("fused num (K18)", fn, wnum)
    _check("fused den (K18)", fd, wden)

    # ---- backward: K8's per-head mode against the composition ----------
    ct_num = dev_t(rng.normal(size=(n, heads * d)))
    ct_den = dev_t(rng.normal(size=(n, heads)))
    gmax0 = torch.zeros(1, device=dev)
    leaves = [t.clone().requires_grad_(True)
              for t in (qw_t, qb_t, kw_t, kb_t, x_t, x_g, gmax0)]
    got = torch.autograd.grad(
        fused_rhs_aggregate(g, heads, False, "scaled_dot", *leaves),
        leaves, (ct_num, ct_den))
    want = fused_bwd_composition(g, heads, False,
                                 tuple(t.detach() for t in leaves),
                                 (ct_num, ct_den))
    for name, a, b in zip(("dqw", "dqb", "dkw", "dkb", "dx_n", "dx_g",
                           "dgmax"), got, want):
        check = _check_bf16_step if name == "dx_g" else _check
        check(f"mega bwd (K8 per head) {name}", a, b)

    # ---- the column-plan dx: K1 over the CSC view against numpy --------
    ct = rng.normal(size=(cap, d))
    ct[e:] = 0.0
    dxw = np.zeros((n, d))
    np.add.at(dxw, col, ct[:e])
    _check("col-plan dx (K1 over the CSC view)", column_sum(g, dev_t(ct)),
           dxw)

    # ---- the column-plan and symmetric gradients, end to end -----------
    probe = dev_t(rng.normal(size=(n, d)))
    names = ("dqw", "dqb", "dkw", "dkb", "dx")
    bf16 = torch.bfloat16
    op = make_fused_ax_colplan(g, heads, False, "scaled_dot", bf16)
    rs, cs = _symmetric_pairs(rng, n, e)
    g_s = _sorted_graph(rs, cs, n, dev)
    if g_s.rev is None:
        raise AssertionError("the symmetric toy graph has no reverse edges")
    probe_s = dev_t(rng.normal(size=(n, d)))
    op_sym = make_fused_ax_sym(g_s, heads, False, "scaled_dot", bf16)
    for label, graph, engine, weights in (
            ("colplan e2e (bf16 payload)", g, op, probe),
            ("sym e2e (bf16 payload)", g_s, op_sym, probe_s)):
        leaves = [t.clone().requires_grad_(True)
                  for t in (qw_t, qb_t, kw_t, kb_t, x_t)]
        ax, _ = engine(*leaves, gmax0, ())
        v_op = torch.sum(ax * weights)
        v_ref = _normalised_ax(graph, leaves[4], *leaves[:4], heads,
                               "scaled_dot", (), False, weights, bf16=True)
        _check(f"{label} fwd", v_op, v_ref)
        got = torch.autograd.grad(v_op, leaves)
        want = torch.autograd.grad(v_ref, leaves)
        _check_grads(label, names, got, want)

    # ---- the folded epilogue: f = alpha (ax - x) in K6's last write ----
    alpha = torch.tensor(0.73, device=dev)
    with torch.no_grad():
        f_fold = fused_rhs_f(g, heads, "scaled_dot", qw_t, qb_t, kw_t, kb_t,
                             x_t, alpha)
        ax_ref, _ = make_fused_ax_colplan(g, heads, False, "scaled_dot")(
            qw_t, qb_t, kw_t, kb_t, x_t, gmax0, ())
        f_fold_b = fused_rhs_f(g_s, heads, "scaled_dot", qw_t, qb_t, kw_t,
                               kb_t, x_t, alpha, payload_dtype=bf16)
        ax_ref_b, _ = op_sym(qw_t, qb_t, kw_t, kb_t, x_t, gmax0, ())
    _check("folded epilogue f", f_fold, alpha * (ax_ref - x_t))
    _check("folded epilogue f (bf16 payload)", f_fold_b,
           alpha * (ax_ref_b - x_t))
    print("# kernels verified on-device (dual scatter K10, fused aggregate "
          "K18 with the score max K19, folded epilogue; K8's per-head "
          "backward, col-plan dx by K1, col-plan + sym e2e gradient paths "
          "with the bf16 payload)",
          file=sys.stderr)


def _torch_scores(src, ke, heads, score, sp):
    """The oracle's scores [E, H] for every fused family from q rows
    ``src`` and k rows ``ke`` [E, ATT] (the JAX bench's ``_xla_scores``;
    reference function_transformer_attention.py:193-206)."""
    att = src.shape[1]
    if score == "exp_kernel_beltrami":
        half = att // 2
        dk = half // heads
        varx, lsx, varp, lsp = sp

        def per(a, b):
            diff = (a - b).reshape(-1, heads, dk)
            return torch.sum(diff * diff, dim=-1)

        dx2 = per(src[:, :half], ke[:, :half])
        dp2 = per(src[:, half:], ke[:, half:])
        return ((varx * varx) * torch.exp(-dx2 / (2.0 * lsx * lsx))
                * (varp * varp) * torch.exp(-dp2 / (2.0 * lsp * lsp)))
    dk = att // heads
    a, b = src.reshape(-1, heads, dk), ke.reshape(-1, heads, dk)
    if score == "exp_kernel":
        var, ls = sp
        d2 = torch.sum((a - b) ** 2, dim=-1)
        return var * var * torch.exp(-d2 / (2.0 * ls * ls))
    if score == "pearson":
        a = a - a.mean(-1, keepdim=True)
        b = b - b.mean(-1, keepdim=True)
    dot = torch.sum(a * b, dim=-1)
    if score == "scaled_dot":
        return dot / math.sqrt(dk)
    eps = 1e-5
    na = torch.clamp_min(torch.sqrt(torch.clamp_min(
        torch.sum(a * a, -1), 0.0)), eps)
    nb = torch.clamp_min(torch.sqrt(torch.clamp_min(
        torch.sum(b * b, -1), 0.0)), eps)
    return dot / (na * nb)


def verify_score_families_on_device(device="cuda") -> None:
    """The score families beyond scaled_dot through the column-plan engine
    (cosine_sim, pearson, exp_kernel, exp_kernel_beltrami with their
    scalars) and the softmax over columns (``make_fused_ax_norm1``,
    K12-K14: scaled_dot and cosine_sim), both with the bfloat16 payload,
    each forward value and gradient against autograd of the torch
    composition reading the same bf16-rounded column table, on a symmetric
    toy graph on ``device`` (the JAX bench's ``bench.py:441-581``). Raises
    on the first that fails."""
    dev = torch.device(device)
    rng = np.random.default_rng(1)
    n, e, d, att, heads = 512, 4096, 128, 64, 2
    rs, cs = _symmetric_pairs(rng, n, e)
    g = _sorted_graph(rs, cs, n, dev)
    if g.rev is None:
        raise AssertionError("the symmetric toy graph has no reverse edges")
    x_nodes = torch.tensor(rng.normal(size=(n, d)) * 0.5,
                           dtype=torch.float32, device=dev)
    probe = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                         device=dev)
    gmax0 = torch.zeros(1, device=dev)
    scalars = {"cosine_sim": (), "pearson": (), "exp_kernel": (1.1, 0.9),
               "exp_kernel_beltrami": (1.1, 0.9, 0.8, 1.2)}
    checked = []
    cases = [(score, False) for score in scalars]
    cases += [("scaled_dot", True), ("cosine_sim", True)]
    for score, norm_cols in cases:
        att_w = 2 * att if score == "exp_kernel_beltrami" else att
        weights = tuple(torch.tensor(rng.normal(size=shape) * 0.1,
                                     dtype=torch.float32, device=dev)
                        for shape in ((d, att_w), (att_w,), (d, att_w),
                                      (att_w,)))
        sp = tuple(torch.tensor([v], device=dev)
                   for v in scalars.get(score, ()))
        make = make_fused_ax_norm1 if norm_cols else make_fused_ax_colplan
        op = make(g, heads, False, score, torch.bfloat16)
        leaves = [t.clone().requires_grad_(True)
                  for t in (*weights, x_nodes, *sp)]
        w_l, x_l, sp_l = leaves[:4], leaves[4], tuple(leaves[5:])
        ax, _ = op(*w_l, x_l, gmax0, sp_l)
        v_op = torch.sum(ax * probe)
        v_ref = _normalised_ax(g, x_l, *w_l, heads, score, sp_l, norm_cols,
                               probe, bf16=True)
        label = f"{'norm1/' if norm_cols else ''}{score} (bf16 payload)"
        _check(f"{label} fwd", v_op, v_ref)
        got = torch.autograd.grad(v_op, leaves)
        want = torch.autograd.grad(v_ref, leaves)
        _check_grads(f"{label} e2e grad", [f"leaf {i}" for i in
                                           range(len(leaves))], got, want)
        checked.append(label)
    print(f"# score families verified on-device (fwd + e2e grad): "
          f"{', '.join(checked)}", file=sys.stderr)


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------

def main(device="cuda", num_nodes=169_343, num_edges=1_166_243, hidden=128,
         attention_dim=32, heads=2, seed=0, reps=5, batches=3, train_reps=3,
         train_batches=2) -> dict:
    """Verify the kernels, then time the bench at the given sizes on
    ``device`` (the card unless the caller asks for the CPU). Prints the
    JSON line and returns it as a dict."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card "
                           "(main(device='cpu') runs it on the CPU)")
    verify_kernels_on_device(dev)
    verify_score_families_on_device(dev)
    model, x, g_raw, nf, nc = build_benchmark(
        num_nodes, num_edges, hidden, attention_dim, heads, seed, dev)
    cfg = model.cfg
    e_valid = model.graph.num_valid

    nfe, dt, first_s = _time_forward(model, x, reps, batches)
    edge_updates_per_sec = nfe * e_valid / dt

    # one full optimizer step of the same model, under both memory modes
    rng_t = np.random.default_rng(1)
    n = x.shape[0]
    y = torch.as_tensor(rng_t.integers(0, nc, size=n), device=dev)
    mask = torch.as_tensor(rng_t.random(n) < 0.5, device=dev)
    train = {}
    for mode, over in (("remat", dict(remat=True)),
                       ("adjoint", dict(adjoint=True, adjoint_method="rk4",
                                        adjoint_step_size=1.0))):
        m_t = GNNModel(cfg.replace(**over), nf, nc, g_raw, device=dev)
        nfe_t, dt_t, first_t, bwd_t = _time_train(m_t, x, y, mask,
                                                  train_reps, train_batches)
        train[mode] = (nfe_t * e_valid / dt_t, dt_t * 1e3, first_t)
        print(f"# train[{mode}]: {dt_t * 1e3:.0f} ms/step fwd_nfe={nfe_t} "
              f"bwd_nfe={bwd_t} rate={train[mode][0] / 1e6:.1f}M "
              f"first step {first_t:.1f}s", file=sys.stderr)

    # the GRAND-l family of every tuned row: attention frozen at t=0, the
    # laplacian RHS
    grand_l = {}
    base_l = cfg.replace(block="attention", function="laplacian", seed=11)
    for mode, over in (
            ("remat", dict(method="rk4", step_size=1.0, remat=True)),
            ("adjoint", dict(method="rk4", step_size=1.0, adjoint=True,
                             adjoint_method="rk4", adjoint_step_size=1.0))):
        m_l = GNNModel(base_l.replace(**over), nf, nc, g_raw, device=dev)
        nfe_l, dt_l, _, bwd_l = _time_train(m_l, x, y, mask, train_reps,
                                            train_batches)
        grand_l[mode] = (nfe_l * e_valid / dt_l, dt_l * 1e3)
        print(f"# train_grand_l[{mode}]: {dt_l * 1e3:.0f} ms/step "
              f"fwd_nfe={nfe_l} bwd_nfe={bwd_l} "
              f"rate={grand_l[mode][0] / 1e6:.1f}M", file=sys.stderr)

    # the softmax over columns (the tuned Cora, Citeseer and CoauthorCS
    # rows' axis): one step under remat
    m_n1 = GNNModel(cfg.replace(attention_norm_idx=1, remat=True), nf, nc,
                    g_raw, device=dev)
    nfe_n1, dt_n1, _, bwd_n1 = _time_train(m_n1, x, y, mask, train_reps,
                                           train_batches)
    norm1_train = (nfe_n1 * e_valid / dt_n1, dt_n1 * 1e3)
    print(f"# train_norm1[remat]: {dt_n1 * 1e3:.0f} ms/step fwd_nfe={nfe_n1} "
          f"bwd_nfe={bwd_n1} rate={norm1_train[0] / 1e6:.1f}M",
          file=sys.stderr)

    # forwards of a score family beyond scaled_dot, of BLEND's split-space
    # score over a seeded encoding (at hidden 128: features 96, positions
    # 32 in one 128-wide state) and of the softmax over columns
    m_c = GNNModel(cfg.replace(attention_type="cosine_sim"), nf, nc, g_raw,
                   device=dev)
    nfe_c, dt_c, _ = _time_forward(m_c, x, reps, batches)
    cosine_rate = nfe_c * e_valid / dt_c
    print(f"# cosine_sim secondary: {cosine_rate / 1e6:.1f}M "
          f"({dt_c * 1e3:.0f} ms fwd)", file=sys.stderr)
    pe_dim = hidden // 4
    cfg_b = cfg.replace(beltrami=True, attention_type="exp_kernel",
                        feat_hidden_dim=hidden - pe_dim,
                        pos_enc_hidden_dim=pe_dim, seed=3)
    m_b = GNNModel(cfg_b, nf, nc, g_raw, device=dev, pos_enc_dim=pe_dim)
    pos_b = torch.tensor(np.random.default_rng(7).normal(size=(n, pe_dim)),
                         dtype=torch.float32, device=dev)
    nfe_b, dt_b, _ = _time_forward(m_b, x, reps, batches, pos=pos_b)
    beltrami_rate = nfe_b * e_valid / dt_b
    print(f"# beltrami exp_kernel secondary: {beltrami_rate / 1e6:.1f}M "
          f"({dt_b * 1e3:.0f} ms fwd, nfe={nfe_b})", file=sys.stderr)
    m_n = GNNModel(cfg.replace(attention_norm_idx=1), nf, nc, g_raw,
                   device=dev)
    nfe_n, dt_n, _ = _time_forward(m_n, x, reps, batches)
    norm1_rate = nfe_n * e_valid / dt_n
    print(f"# norm_idx=1 secondary: {norm1_rate / 1e6:.1f}M "
          f"({dt_n * 1e3:.0f} ms fwd, nfe={nfe_n})", file=sys.stderr)

    # the early-stop evaluator at bench scale: the in-solver evaluation's
    # time against the plain forward's
    m_e = GNNEarlyModel(cfg, nf, nc, g_raw, device=dev)
    masks_e = (mask, torch.as_tensor(rng_t.random(n) < 0.25, device=dev),
               torch.as_tensor(rng_t.random(n) < 0.25, device=dev))
    _, best_e, stats_e = m_e.apply_early(x, y, masks_e)
    _sync(dev)
    best_t = math.inf
    for _ in range(train_batches):
        t0 = time.perf_counter()
        for _ in range(train_reps):
            _, best_e, stats_e = m_e.apply_early(x, y, masks_e)
        _sync(dev)
        best_t = min(best_t, (time.perf_counter() - t0) / train_reps)
    early_nfe = int(stats_e["nfe"])
    print(f"# early-stop eval: {best_t * 1e3:.0f} ms (nfe={early_nfe}, "
          f"{best_t / dt:.2f}x the plain forward), best_val="
          f"{best_e.val:.4f} best_test={best_e.test:.4f} "
          f"best_time={best_e.time:.2f}", file=sys.stderr)

    out = {
        "metric": "grand_nl_arxiv_edge_updates_per_sec_nfe",
        "value": round(edge_updates_per_sec, 1),
        "unit": "edge·NFE/s",
        "train_edge_updates_per_sec_nfe": round(
            max(rate for rate, _, _ in train.values()), 1),
    }
    for mode, (_, ms, _) in train.items():
        out[f"train_step_ms_{mode}"] = round(ms, 1)
    for mode, (_, _, secs) in train.items():
        out[f"train_warm_compile_s_{mode}"] = round(secs, 1)
    out["grand_nl_cosine_edge_updates_per_sec_nfe"] = round(cosine_rate, 1)
    out["blend_beltrami_edge_updates_per_sec_nfe"] = round(beltrami_rate, 1)
    out["grand_nl_norm1_edge_updates_per_sec_nfe"] = round(norm1_rate, 1)
    for mode, (rate, ms) in grand_l.items():
        out[f"train_grand_l_{mode}_edge_updates_per_sec_nfe"] = round(rate, 1)
        out[f"train_grand_l_{mode}_step_ms"] = round(ms, 1)
    out["train_norm1_edge_updates_per_sec_nfe"] = round(norm1_train[0], 1)
    out["train_norm1_step_ms"] = round(norm1_train[1], 1)
    out["early_stop_eval_ms"] = round(best_t * 1e3, 1)
    out["early_stop_nfe"] = early_nfe
    out["early_stop_overhead_vs_plain_fwd"] = round(best_t / dt, 3)
    print(json.dumps(out), flush=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# nfe={nfe} edges={e_valid} fwd={dt * 1e3:.1f}ms "
          f"first forward={first_s:.1f}s device={name}", file=sys.stderr)
    return out


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu")
    main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    _main()
