#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass (any failure exits nonzero):

1. environment: the card's name and power limit (nvidia-smi) and torch's
   device name; exits 2 without a CUDA device;
2. build: compiles the port's CUDA kernels from ``graph_neural_pde_tpu_torch/
   csrc`` (nvcc, sm_90a) and prints the build time;
3. kernels against their plain PyTorch versions, on the card, at max error
   <= 1e-5 of the largest reference entry (float32; the sums only run in
   another order). K1 ``csr_spmm`` forward, K1 as the backward ``dx``
   (weights permuted to the reverse edges, against A^T ct by index_add over
   columns) and K2 ``edge_dot`` as ``dw``, at two shapes: the prepared Cora
   stand-in at D=80 and an arxiv-scale symmetric random graph (169,343
   nodes, ~2.3M directed edges plus self-loops) at D=128. K3
   ``segment_norm`` (softmax and normalise, over rows and over columns
   through the reverse-edge map) and K4 ``segment_norm_bwd`` (both modes,
   rows and columns), on the prepared Computers stand-in at H=4 and the
   arxiv-scale graph at H=1 and H=8; two K3 launches on the same input must
   be bit-identical. K6 ``fused_rhs_fwd`` (plain with its numerators, with
   per-edge shifts, folded), K7 ``fused_rowmax``, K8 ``fused_rhs_bwd`` and
   K9 ``fused_rhs_bwd_sym`` (every output; K8 and K9 against the plain
   version evaluated in float64 on the same float32 inputs, so that the
   bound holds the kernel's rounding and not the reference's), for all four
   score families on the Cora stand-in at D=16, ATT=16, H=4 and for
   scaled_dot at the two real shapes: the Cora stand-in at D=80, ATT=128,
   H=8 and the arxiv-scale graph at D=128, ATT=32, H=2; two K9 launches
   must be bit-identical. Each check is timed: device time per call
   (torch.profiler, mean of 20 calls; all device work of the call, so the
   wrapper's output memset counts) and time per call seen from the host
   (CUDA events around one call, median of 20; at small shapes this is the
   host's launch cost). Beside each time stands the least time the card
   could take for the same work (``bound``: the larger of the compulsory
   bytes over 3.35 TB/s and the float32 operations over 67 TFLOP/s, from
   this run's shapes) and, where one PyTorch call computes the same
   function, that call's time (``library``);
4. end to end on small inputs, card against CPU (the plain versions, which
   the CPU test suite holds against the JAX package), from the same
   weights: tuned Cora at reduced width (one training forward and backward,
   and the early-stop eval), and tuned Computers at reduced width (hard
   attention and the continuous adjoint with its dopri5 backward solve),
   and the Cora GRAND-nl config (transformer function) at reduced width;
5. main paths, each through ``graph_neural_pde_tpu_torch.run`` at full
   width, every kernel launch counter reset just before each run and read
   just after: tuned Cora for 2 training epochs (each followed by an eval
   step and the early-stop eval) twice, to record whether two runs agree
   bit for bit; tuned Computers (hard attention, continuous adjoint) and
   tuned Pubmed (row squareplus attention, continuous adjoint) for 2
   epochs each; (a) the GRAND-nl architecture of ``bench.py`` in float32
   on the random graph at ogbn-arxiv's size for 2 epochs with eval; (b)
   the tuned Cora row as GRAND-nl (transformer function, constant block,
   row softmax) for 3 epochs with the early-stop eval; (c) the same model
   with Q and K drawn so large that the unshifted softmax overflows, which
   must poison, re-solve with the exact softmax and stay finite. Each run
   must launch the kernels its path runs, and all eight counters must grow.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REL_BOUND = 1e-5
SCORE_FAMILIES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 20):
    """Mean device time of one call of ``fn``: the summed duration of the
    kernels, memsets and copies it puts on the card, from torch.profiler.
    None when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3


def compare(name, got, want):
    """Max abs error and max error relative to the largest reference entry;
    raises above REL_BOUND."""
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    abs_err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = abs_err / max(scale, 1e-30)
    if rel > REL_BOUND:
        raise AssertionError(f"{name}: max error {abs_err:.3e} is "
                             f"{rel:.3e} of max |ref| {scale:.3e} "
                             f"> {REL_BOUND}")
    return abs_err, rel


def prepared_graph(row: str, data_dir: str):
    """The tuned row's dataset (its SBM stand-in without raw files),
    prepared as its block prepares it."""
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.datasets import get_dataset
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    cfg = best_params[row]
    d = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc)
    return prepare_graph(cfg, d.graph)


def arxiv_scale_graph(seed: int):
    """Symmetric random graph at ogbn-arxiv's node count and ~2.3M directed
    edges, prepared as the attention block prepares its graph."""
    import numpy as np
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    from graph_neural_pde_tpu_torch.ops.graph import make_graph
    n, pairs = 169_343, 1_150_000
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, pairs)
    v = rng.integers(0, n, pairs)
    keep = u != v
    u, v = u[keep], v[keep]
    g = make_graph(np.concatenate([u, v]), np.concatenate([v, u]),
                   num_nodes=n, pad_multiple=512)
    return prepare_graph(best_params["Cora"], g)


def check_kernels(shape_name, g, d, seed, dev="cuda"):
    """K1 forward, K1 as dx, K2 as dw against their plain versions."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import (csr_spmm, csr_spmm_plain,
                                                    edge_dot, edge_dot_plain)
    dev = torch.device(dev)
    g = g.to(dev)
    n, nv = g.num_nodes, g.num_valid
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev)
    ct = torch.randn((n, d), generator=gen, device=dev)
    # asymmetric positive weights on valid slots, as the frozen attention
    w = torch.rand((g.capacity,), generator=gen, device=dev) * g.mask
    w_rev = w[g.rev.long()]
    row_l, col_l = g.row.long()[:nv], g.col.long()[:nv]

    def dx_plain():
        return torch.zeros_like(ct).index_add(0, col_l,
                                              ct[row_l] * w[:nv, None])

    # the yardsticks: one PyTorch call each, used nowhere in the port
    csr = torch.sparse_csr_tensor(g.rowptr, g.col[:nv], w[:nv], size=(n, n))
    pattern = torch.sparse_csr_tensor(g.rowptr, g.col[:nv],
                                      torch.zeros_like(w[:nv]), size=(n, n))
    x_t = x.t().contiguous()
    # K1 reads rowptr, col, w and x and writes out; K2 reads row, col and
    # both tables and writes one float per edge; 2 flop per edge and feature
    spmm_work = (4 * (n + 1 + 2 * nv + 2 * n * d), 2 * nv * d)
    dot_work = (4 * (3 * nv + 2 * n * d), 2 * nv * d)
    cases = (
        ("csr_spmm", "forward A_w x",
         lambda: csr_spmm(g.rowptr, g.row, g.col, w, x),
         lambda: csr_spmm_plain(g.rowptr, g.row, g.col, w, x), spmm_work,
         lambda: csr @ x),
        ("csr_spmm", "backward dx = A_w^T ct",
         lambda: csr_spmm(g.rowptr, g.row, g.col, w_rev, ct), dx_plain,
         spmm_work, None),
        ("edge_dot", "backward dw = ct[row].x[col]",
         lambda: edge_dot(g.row, g.col, ct, x, nv),
         lambda: edge_dot_plain(g.row, g.col, ct, x, nv), dot_work,
         lambda: torch.sparse.sampled_addmm(pattern, ct, x_t, beta=0.0)),
    )
    return [time_case(kname, what, shape_name, f"N={n} E={nv} D={d}", kern,
                      plain, work, library)
            for kname, what, kern, plain, work, library in cases]


PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores


def time_case(kname, what, shape_name, dims, kern, plain, work, library=None,
              reference=None, timed=True):
    """Check one kernel call against its plain version and time both.
    ``work`` is (compulsory bytes, float32 operations) of the call, from
    its shapes; ``library`` an optional single PyTorch call computing the
    same function; ``reference`` an optional stricter stand-in for the
    plain version in the comparison (the timed calls stay ``kern`` and
    ``plain``). ``timed=False`` only compares."""
    got, want = kern(), (reference or plain)()
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    errs = [compare(f"{kname} {what} [{i}] @ {shape_name} {dims}", g_, w_)
            for i, (g_, w_) in enumerate(zip(got, want))]
    abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    head = (f"[kernels] {kname:17s} {what:34s} {shape_name:14s} {dims}: "
            f"max_abs_err={abs_err:.3e} rel={rel:.3e}")
    row = dict(kernel=kname, check=what, shape=shape_name, dims=dims,
               max_abs_err=abs_err, max_rel_err=rel)
    if not timed:
        print(head, flush=True)
        return row
    call_k, call_p = median_ms(kern), median_ms(plain)
    dev_k, dev_p = device_ms(kern), device_ms(plain)
    measured = dev_k is not None and dev_p is not None
    lib_ms = None
    if library is not None:
        lib_ms = device_ms(library) if measured else median_ms(library)
    n_bytes, flops = work
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    dev_txt = (f"device {dev_k:.4f} ms, plain {dev_p:.4f} ms; "
               if measured else "device time not measured; ")
    lib_txt = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    print(f"{head}; {dev_txt}per call kernel {call_k:.4f} ms, plain "
          f"{call_p:.4f} ms; bound {bound_ms:.5f} ms by {bound_by} "
          f"({n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP){lib_txt}",
          flush=True)
    return dict(row, ms=dev_k if measured else call_k,
                plain_ms=dev_p if measured else call_p, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def check_segment_kernels(shape_name, g, h, seed, dev="cuda"):
    """K3 in both modes over rows and over columns (perm = rev) and K4 in
    both modes, against their plain versions; two K3 launches on one input
    must be bit-identical."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import (segment_norm,
                                                    segment_norm_bwd,
                                                    segment_norm_bwd_plain,
                                                    segment_norm_plain)
    dev = torch.device(dev)
    g = g.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn((g.capacity, h), generator=gen, device=dev)
    ct = torch.randn((g.capacity, h), generator=gen, device=dev)
    # normalise takes positive weights (squareplus values, attention)
    weights = torch.rand((g.capacity, h), generator=gen, device=dev) + 0.05
    rows = []
    for mode, s in (("softmax", scores), ("normalise", weights)):
        for seg, perm in (("rows", None), ("columns", g.rev)):
            args = (g.rowptr, g.row, perm)
            first, den = segment_norm(*args, s, mode)
            again = segment_norm(*args, s, mode)
            if not (torch.equal(first, again[0]) and torch.equal(den,
                                                                 again[1])):
                raise AssertionError(f"segment_norm {mode} {seg} @ "
                                     f"{shape_name}: two launches differ")
            n, nv = g.num_nodes, g.num_valid
            dims = f"N={n} E={nv} H={h}"
            idx = n + 1 + (nv if perm is not None else 0)
            # K3 reads s and writes out and den; K4 reads out, g and den and
            # writes ds; a handful of operations per edge and head
            rows.append(time_case(
                "segment_norm", f"{mode} over {seg}", shape_name, dims,
                lambda: segment_norm(*args, s, mode)[0],
                lambda: segment_norm_plain(*args, s, mode)[0],
                (4 * (idx + 2 * nv * h + n * h), 4 * nv * h)))
            rows.append(time_case(
                "segment_norm_bwd", f"{mode} over {seg}", shape_name, dims,
                lambda: segment_norm_bwd(*args, first, ct, den, mode),
                lambda: segment_norm_bwd_plain(*args, first, ct, den, mode),
                (4 * (idx + 3 * nv * h + n * h), 5 * nv * h)))
    print(f"[kernels] segment_norm @ {shape_name} H={h}: two launches "
          f"bit-identical in every mode", flush=True)
    return rows


def check_fused_kernels(shape_name, g, d, att, h, score, seed, timed=True,
                        dev="cuda"):
    """K6 (plain with numerators, shifted, folded), K7, K8 and K9 (every
    output) against their plain versions; two K9 launches must be
    bit-identical. ``timed=False`` only compares."""
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    dev = torch.device(dev)
    g = g.to(dev)
    n, nv, cap = g.num_nodes, g.num_valid, g.capacity
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # projections with O(1) rows, so the scores stay O(1)
    x = randn(n, d)
    qw, kw = randn(d, att, scale=d ** -0.5), randn(d, att, scale=d ** -0.5)
    qb, kb = randn(att, scale=0.1), randn(att, scale=0.1)
    gmax = torch.full((1,), 0.25, device=dev)
    alpha = torch.full((1,), 0.37, device=dev)
    shifts = randn(cap, h, scale=0.5)
    sp = {}
    if score == "exp_kernel":
        sp = dict(var=torch.full((1,), 1.3, device=dev),
                  ls=torch.full((1,), 0.8, device=dev))
    csr = (g.rowptr, g.row, g.col)
    ops = (x, qw, qb, kw, kb, gmax)
    kw_f = dict(heads=h, score=score, **sp)
    ct_ax = randn(n, d)
    # den's cotangent positive, so that the sums over all edges (dgmax, the
    # exp_kernel scalars) do not cancel and their own size is a fair scale
    ct_den = 1.0 + randn(n, h, scale=0.1)
    _, den, _ = K.fused_rhs_fwd(*csr, *ops, **kw_f)
    recip_p = (1.0 / (h * (den + 1e-16))).contiguous()
    cts = (ct_ax, recip_p, ct_den)

    def f64(t):
        return t.double() if t.is_floating_point() else t

    def plain64(fn, **kw):
        """The plain version in float64 on the same float32 inputs."""
        kw = {k: (f64(v) if torch.is_tensor(v) else v) for k, v in kw.items()}
        out = fn(*csr, *map(f64, ops), *map(f64, cts), **kw)
        return tuple(o.float() for o in out if o is not None)

    def some(out):
        return tuple(o for o in out if o is not None)

    # compulsory bytes: indices, x, the projections' weights (inputs read
    # once, outputs written once; the scratch tables do not count);
    # float32 operations: every node's q and k projections, and per edge
    # the scores and the aggregation (see the note in csrc/fused_rhs.cu)
    base_bytes = 4 * (n + 1 + nv + n * d + 2 * d * att + 2 * att)
    proj = 2 * d * att
    fwd_ops = 2 * n * proj + nv * (2 * att + 2 * h * d)
    node_b = 4 * n * (d + 2 * h)             # ct_ax, recip_p, ct_den
    cases = [
        ("fused_rhs_fwd", "ax, den, num",
         lambda: some(K.fused_rhs_fwd(*csr, *ops, want_num=True, **kw_f)),
         lambda: some(K.fused_rhs_fwd_plain(*csr, *ops, want_num=True,
                                            **kw_f)),
         (base_bytes + 4 * n * (d + h + h * d), fwd_ops), None),
        ("fused_rhs_fwd", "ax, den with per-edge shifts",
         lambda: some(K.fused_rhs_fwd(*csr, *ops, shifts=shifts, **kw_f)),
         lambda: some(K.fused_rhs_fwd_plain(*csr, *ops, shifts=shifts,
                                            **kw_f)),
         (base_bytes + 4 * (nv * h + n * (d + h)), fwd_ops), None),
        ("fused_rhs_fwd", "folded f = alpha (ax - x)",
         lambda: some(K.fused_rhs_fwd(*csr, *ops, alpha=alpha, **kw_f)),
         lambda: some(K.fused_rhs_fwd_plain(*csr, *ops, alpha=alpha,
                                            **kw_f)),
         (base_bytes + 4 * n * (d + h), fwd_ops + 2 * n * d), None),
        ("fused_rhs_bwd", "dq, dxg, dkw, dkb, dgmax[, dvar, dls]",
         lambda: some(K.fused_rhs_bwd(*csr, *ops, *cts, shifts=shifts,
                                      **kw_f)),
         lambda: some(K.fused_rhs_bwd_plain(*csr, *ops, *cts, shifts=shifts,
                                            **kw_f)),
         # per edge still dk_e Kw^T and x_c^T dk_e
         (base_bytes + node_b + 4 * (nv * h + n * att + nv * d + d * att),
          2 * n * proj + nv * (2 * proj + 6 * att + 4 * d)),
         lambda: plain64(K.fused_rhs_bwd_plain, shifts=shifts, **kw_f)),
        ("fused_rhs_bwd_sym", "dq, dxrow, dkw, dkb, dgmax[, dvar, dls]",
         lambda: some(K.fused_rhs_bwd_sym(*csr, *ops, *cts, **kw_f)),
         lambda: some(K.fused_rhs_bwd_sym_plain(*csr, *ops, *cts, **kw_f)),
         # per node q, k, dk Kw^T and x^T dk; per edge two scores' worth
         (base_bytes + node_b + 4 * (n * att + n * d + d * att),
          4 * n * proj + nv * (10 * att + 6 * d)),
         lambda: plain64(K.fused_rhs_bwd_sym_plain, **kw_f)),
    ]
    if score == "scaled_dot":
        cases.insert(3, (
            "fused_rowmax", "row maxima of the scores",
            lambda: K.fused_rowmax(*csr, *ops[:5], heads=h),
            lambda: K.fused_rowmax_plain(*csr, *ops[:5], heads=h),
            (base_bytes + 4 * n * h, 2 * n * proj + nv * 2 * att),
            None))
    dims = f"N={n} E={nv} D={d} ATT={att} H={h} {score}"
    rows = [time_case(kname, what, shape_name, dims, kern, plain, work,
                      reference=ref, timed=timed)
            for kname, what, kern, plain, work, ref in cases]
    first = K.fused_rhs_bwd_sym(*csr, *ops, *cts, **kw_f)
    again = K.fused_rhs_bwd_sym(*csr, *ops, *cts, **kw_f)
    if not all(torch.equal(a, b) for a, b in zip(some(first), some(again))):
        raise AssertionError(f"fused_rhs_bwd_sym {score} @ {shape_name}: two "
                             f"launches differ")
    print(f"[kernels] fused_rhs_bwd_sym @ {shape_name} {score}: two launches "
          f"bit-identical in every output", flush=True)
    return rows


def grand_nl_cora():
    """The tuned Cora row as GRAND-nl: attention recomputed at every RHS
    evaluation (transformer function over the constant block) with the row
    softmax that the fused kernels take."""
    from graph_neural_pde_tpu_torch.config import best_params
    return best_params["Cora"].replace(
        function="transformer", block="constant", attention_norm_idx=0,
        square_plus=False)


def attention_layer(model):
    """The attention layer whose Q and K decide the model's attention."""
    func_att = getattr(model.block.func, "att", None)
    return func_att if func_att is not None else model.block.att


def check_small_end_to_end(row: str, base=None, devices=("cpu", "cuda")):
    """A tuned row (or ``base``) at reduced width on a 300-node SBM: the
    card's kernel path against the CPU's plain path, same weights and
    inputs."""
    import torch
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
    from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
    from graph_neural_pde_tpu_torch.training.train import cross_entropy_loss
    cfg = (base or best_params[row]).replace(
        hidden_dim=16, attention_dim=16, heads=4, input_dropout=0.0,
        dropout=0.0)
    d = make_sbm_dataset(num_nodes=300, num_classes=4, num_features=24,
                         seed=3, num_val=60)
    gen = torch.Generator().manual_seed(5)
    results = {}
    state = None
    for dev in devices:
        m = GNNEarlyModel(cfg, 24, 4, d.graph, device=dev)
        if state is None:
            # random Q/K so the frozen attention is not uniform
            with torch.no_grad():
                att = attention_layer(m)
                for lin in (att.Q, att.K):
                    lin.w.copy_(0.3 * torch.randn(lin.w.shape, generator=gen))
            state = {k: v.cpu().clone() for k, v in m.state_dict().items()}
        m.load_state_dict(state)
        x, y = d.x.to(dev), d.y.to(dev)
        masks = tuple(t.to(dev) for t in (d.train_mask, d.val_mask,
                                          d.test_mask))
        logits, stats = m(x, training=True)
        loss = cross_entropy_loss(logits, y, masks[0])
        loss.backward()
        _, best, es_stats = m.apply_early(x, y, masks)
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()
                 if p.grad is not None}
        results[dev] = (logits.detach().cpu(), float(loss.detach()), stats, best,
                        es_stats, grads)
    (lc, loss_c, st_c, best_c, es_c, g_c) = results[devices[0]]
    (lg, loss_g, st_g, best_g, es_g, g_g) = results[devices[1]]
    es_counts = ("accepted", "rejected", "nfe")
    counts = es_counts + (("bwd_accepted", "bwd_rejected", "bwd_nfe")
                          if cfg.adjoint else ())
    if [st_c[k] for k in counts] != [st_g[k] for k in counts]:
        raise AssertionError(f"solver steps differ: cpu {st_c} cuda {st_g}")
    if [es_c[k] for k in es_counts] != [es_g[k] for k in es_counts]:
        raise AssertionError(f"early-stop steps differ: {es_c} vs {es_g}")
    if not torch.allclose(lg, lc, rtol=1e-4, atol=1e-5):
        raise AssertionError("logits differ between cuda and cpu")
    if not math.isclose(loss_g, loss_c, rel_tol=1e-4):
        raise AssertionError(f"loss cuda {loss_g} vs cpu {loss_c}")
    # a leaf whose true gradient is 0 (K's bias under a row softmax) holds
    # only rounding noise: 1e-6 of the largest gradient is allowed everywhere
    top = max(float(v.abs().max()) for v in g_c.values())
    for k in g_c:
        scale = float(g_c[k].abs().max())
        if not torch.allclose(g_g[k], g_c[k], rtol=1e-3,
                              atol=1e-4 * scale + 1e-6 * top):
            raise AssertionError(
                f"gradient {k} differs between cuda and cpu by "
                f"{float((g_g[k] - g_c[k]).abs().max()):.3e} (leaf scale "
                f"{scale:.3e}, largest gradient {top:.3e})")
    print(f"[small] {row} cuda vs cpu: loss {loss_g:.6f} vs {loss_c:.6f}, "
          f"steps {dict((k, st_g[k]) for k in counts)}, early-stop best val "
          f"{best_g.val:.4f} vs {best_c.val:.4f} at t* {best_g.time:.4f} vs "
          f"{best_c.time:.4f}: agree (logits rtol 1e-4, grads rtol 1e-3)",
          flush=True)


GRAND_L_KERNELS = ("csr_spmm", "edge_dot", "segment_norm",
                   "segment_norm_bwd")
ALL_KERNELS = GRAND_L_KERNELS + ("fused_rhs_fwd", "fused_rowmax",
                                 "fused_rhs_bwd", "fused_rhs_bwd_sym")


def counted(label: str, expected, fn):
    """Run ``fn`` with every kernel launch counter set to 0 just before and
    read just after; each kernel in ``expected`` must have been launched.
    Returns (fn's result, launch counts, seconds)."""
    import torch
    from graph_neural_pde_tpu_torch import kernels
    for k in kernels.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on {label}")
    return res, launches, secs


def drive_poisoned_path(cfg, data_dir: str, seed: int):
    """The forced poison: ``cfg``'s model with Q and K redrawn so large
    that the unshifted softmax overflows at every evaluation. Each solve
    (train, eval and early-stop eval, ``cfg.epoch - 1`` epochs) must detect
    the poison, re-solve with the exact softmax (K7's row maxima, K6 with
    shifts, K8 in the backward) and come back finite."""
    import torch
    from graph_neural_pde_tpu_torch import run
    s = run.setup(cfg, data_dir, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    att = attention_layer(s.model)
    with torch.no_grad():
        for lin in (att.Q, att.K):
            lin.w.copy_(10.0 * torch.randn(lin.w.shape, generator=gen))
    losses = []
    for _ in range(1, cfg.epoch):
        loss, stats = s.trainer.train_step(s.x, s.y, s.masks[0])
        accs, logits, _ = s.trainer.eval_step(s.x, s.y, s.masks)
        zT, snap, _ = s.model.apply_early(s.x, s.y, s.masks)
        if not (math.isfinite(loss) and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(zT).all()) and stats["nfe"] > 0):
            raise AssertionError(f"poisoned path did not recover: loss "
                                 f"{loss}, stats {stats}")
        losses.append(loss)
    grads = [p.grad for p in s.model.parameters() if p.grad is not None]
    if not all(bool(torch.isfinite(g_).all()) for g_ in grads):
        raise AssertionError("poisoned path: non-finite gradient")
    return losses


def drive_main_path(label: str, cfg, data_dir: str, expected):
    """``run.main`` on one config on the card, with every kernel launch
    counter set to 0 just before and read just after. Checks the epoch logs
    and that each kernel in ``expected`` was launched. Returns (result,
    launch counts)."""
    from graph_neural_pde_tpu_torch import run
    res, launches, secs = counted(
        label, expected,
        lambda: run.main(cfg, data_dir=data_dir, device="cuda"))
    epochs = cfg.epoch - 1
    print(f"[main] {epochs} epochs of {label} in {secs:.2f} s; "
          f"kernel launches {launches}", flush=True)
    if len(res.logs) != epochs:
        raise AssertionError(f"expected {epochs} epochs, got "
                             f"{len(res.logs)}")
    for log in res.logs:
        if not (math.isfinite(log.loss) and log.fwd_nfe > 0
                and log.bwd_nfe > 0):
            raise AssertionError(f"bad epoch log {log}")
    if not 0.0 < res.best["val_acc"] <= 1.0:
        raise AssertionError(f"bad best {res.best}")
    return res, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from graph_neural_pde_tpu_torch.config import GRAND_NL_BENCH, best_params
    from graph_neural_pde_tpu_torch.kernels import build

    # 1. environment
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[env] nvidia-smi: {smi}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    print(f"[build] {lib_path.name}: {time.perf_counter() - t0:.2f} s",
          flush=True)

    with tempfile.TemporaryDirectory() as data_dir:
        # 3. kernels against their plain versions
        cora_g = prepared_graph("Cora", data_dir)
        rows = check_kernels("cora-standin", cora_g,
                             best_params["Cora"].hidden_dim, args.seed)
        rows += check_segment_kernels(
            "computers-standin", prepared_graph("Computers", data_dir),
            best_params["Computers"].heads, args.seed + 2)
        nl, bench = grand_nl_cora(), GRAND_NL_BENCH
        rows += check_fused_kernels("cora-standin", cora_g, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 20)
        for i, score in enumerate(SCORE_FAMILIES):
            rows += check_fused_kernels("cora-small", cora_g, 16, 16, 4,
                                        score, args.seed + 30 + i,
                                        timed=False)
        t0 = time.perf_counter()
        big = arxiv_scale_graph(args.seed)
        print(f"[kernels] arxiv-scale graph built on the host in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows += check_kernels("arxiv-scale", big, 128, args.seed + 1)
        for h in (1, 8):
            rows += check_segment_kernels("arxiv-scale", big, h,
                                          args.seed + 3 + h)
        rows += check_fused_kernels("arxiv-scale", big, bench.hidden_dim,
                                    bench.attention_dim, bench.heads,
                                    "scaled_dot", args.seed + 21)
        del big
        torch.cuda.empty_cache()

        # 4. end to end on small inputs, card vs CPU
        check_small_end_to_end("Cora")
        check_small_end_to_end("Computers")
        check_small_end_to_end("Cora GRAND-nl", base=nl)

        # 5. the main paths
        fused = ("fused_rhs_fwd", "fused_rhs_bwd_sym")
        paths = (
            ("tuned Cora", best_params["Cora"].replace(epoch=3),
             GRAND_L_KERNELS),
            ("tuned Cora again", best_params["Cora"].replace(epoch=3),
             GRAND_L_KERNELS),
            ("tuned Computers", best_params["Computers"].replace(epoch=3),
             ("csr_spmm", "edge_dot", "segment_norm")),
            ("tuned Pubmed", best_params["Pubmed"].replace(epoch=3),
             GRAND_L_KERNELS),
            ("GRAND-nl arxiv-scale (a)", bench.replace(epoch=3,
                                                       seed=args.seed), fused),
            ("GRAND-nl Cora (b)", nl.replace(epoch=4), fused),
        )
        results, per_path = [], {}
        launches = dict.fromkeys(ALL_KERNELS, 0)
        for label, cfg, expected in paths:
            res, counts = drive_main_path(label, cfg, data_dir, expected)
            results.append(res)
            per_path[label] = counts
        label = "GRAND-nl Cora forced poison (c)"
        losses, counts, secs = counted(
            label, ("fused_rhs_fwd", "fused_rowmax", "fused_rhs_bwd"),
            lambda: drive_poisoned_path(nl.replace(epoch=3), data_dir,
                                        args.seed + 40))
        per_path[label] = counts
        print(f"[main] 2 epochs of {label} in {secs:.2f} s, losses {losses}; "
              f"kernel launches {counts}", flush=True)
        for counts in per_path.values():
            for k, v in counts.items():
                launches[k] += v
    cora_losses = [[log.loss for log in r.logs] for r in results[:2]]
    print(f"[main] two runs of tuned Cora agree bit for bit: "
          f"{cora_losses[0] == cora_losses[1]} (losses {cora_losses[0]} and "
          f"{cora_losses[1]})", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main paths")

    pallas = "graph_neural_pde_tpu/ops/pallas/"
    sources = {"csr_spmm": ("csr_spmm.cu", "stripe.py:513"),
               "edge_dot": ("edge_dot.cu", "stripe.py:363"),
               "segment_norm": ("segment_norm.cu", "stripe.py:412"),
               "segment_norm_bwd": ("segment_norm.cu", "stripe.py:412"),
               "fused_rhs_fwd": ("fused_rhs.cu", "fused_rhs.py:280"),
               "fused_rowmax": ("fused_rhs.cu", "fused_rhs.py:654"),
               "fused_rhs_bwd": ("fused_rhs.cu", "fused_rhs.py:742"),
               "fused_rhs_bwd_sym": ("fused_rhs.cu", "fused_rhs.py:1341")}
    summary = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "ms" in r]
        main_shape = timed[0]         # the first check at a main path's shape
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        summary.append({
            "name": name, "route": "cuda",
            "source": f"graph_neural_pde_tpu_torch/csrc/{src}",
            "replaces": pallas + replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # the bound is on this one: error over the largest reference entry
            "max_rel_err": max(r["max_rel_err"] for r in mine),
            **{k: main_shape[k] for k in keys},
            "shape": f"{main_shape['shape']} {main_shape['dims']}",
            "launches_by_path": {p: c[name] for p, c in per_path.items()},
            "other_checks": [
                {k: r[k] for k in ("check", "shape", "dims") + keys}
                for r in timed[1:]]})
    print(nvidia_smi(), flush=True)     # the card's name and power limit
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
