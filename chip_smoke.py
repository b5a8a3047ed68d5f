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
   be bit-identical. Each check is timed: device time per call
   (torch.profiler, mean of 20 calls; all device work of the call, so the
   wrapper's output memset counts) and time per call seen from the host
   (CUDA events around one call, median of 20; at small shapes this is the
   host's launch cost);
4. end to end on small inputs, card against CPU (the plain versions, which
   the CPU test suite holds against the JAX package), from the same
   weights: tuned Cora at reduced width (one training forward and backward,
   and the early-stop eval), and tuned Computers at reduced width (hard
   attention and the continuous adjoint with its dopri5 backward solve);
5. main paths, each through ``graph_neural_pde_tpu_torch.run.main`` over
   the SBM stand-ins at full width, every kernel launch counter reset just
   before each run and read just after: tuned Cora for 3 training epochs
   (each followed by an eval step and the early-stop eval) twice, to
   record whether two runs agree bit for bit; tuned Computers (hard
   attention, continuous adjoint) for 3 epochs; tuned Pubmed (row
   squareplus attention, continuous adjoint) for 2 epochs. Each run must
   launch the kernels its path runs, and all four counters must grow.

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

    cases = (
        ("csr_spmm", "forward A_w x",
         lambda: csr_spmm(g.rowptr, g.row, g.col, w, x),
         lambda: csr_spmm_plain(g.rowptr, g.row, g.col, w, x)),
        ("csr_spmm", "backward dx = A_w^T ct",
         lambda: csr_spmm(g.rowptr, g.row, g.col, w_rev, ct), dx_plain),
        ("edge_dot", "backward dw = ct[row].x[col]",
         lambda: edge_dot(g.row, g.col, ct, x, nv),
         lambda: edge_dot_plain(g.row, g.col, ct, x, nv)),
    )
    return [time_case(kname, what, shape_name, f"N={n} E={nv} D={d}", kern,
                      plain) for kname, what, kern, plain in cases]


def time_case(kname, what, shape_name, dims, kern, plain):
    """Check one kernel call against its plain version and time both."""
    abs_err, rel = compare(f"{kname} {what} @ {shape_name}", kern(), plain())
    call_k, call_p = median_ms(kern), median_ms(plain)
    dev_k, dev_p = device_ms(kern), device_ms(plain)
    measured = dev_k is not None and dev_p is not None
    dev_txt = (f"device {dev_k:.4f} ms, plain {dev_p:.4f} ms; "
               if measured else "device time not measured; ")
    print(f"[kernels] {kname:16s} {what:34s} {shape_name:14s} {dims}: "
          f"max_abs_err={abs_err:.3e} rel={rel:.3e}; {dev_txt}per call "
          f"kernel {call_k:.4f} ms, plain {call_p:.4f} ms", flush=True)
    return dict(kernel=kname, check=what, shape=shape_name,
                max_abs_err=abs_err, ms=dev_k if measured else call_k,
                plain_ms=dev_p if measured else call_p)


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
            dims = f"N={g.num_nodes} E={g.num_valid} H={h}"
            rows.append(time_case(
                "segment_norm", f"{mode} over {seg}", shape_name, dims,
                lambda: segment_norm(*args, s, mode)[0],
                lambda: segment_norm_plain(*args, s, mode)[0]))
            rows.append(time_case(
                "segment_norm_bwd", f"{mode} over {seg}", shape_name, dims,
                lambda: segment_norm_bwd(*args, first, ct, den, mode),
                lambda: segment_norm_bwd_plain(*args, first, ct, den, mode)))
    print(f"[kernels] segment_norm @ {shape_name} H={h}: two launches "
          f"bit-identical in every mode", flush=True)
    return rows


def check_small_end_to_end(row: str, devices=("cpu", "cuda")):
    """A tuned row at reduced width on a 300-node SBM: the card's kernel
    path against the CPU's plain path, same weights and inputs."""
    import torch
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
    from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
    from graph_neural_pde_tpu_torch.training.train import cross_entropy_loss
    cfg = best_params[row].replace(hidden_dim=16, attention_dim=16,
                                   heads=4, input_dropout=0.0, dropout=0.0)
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
                for lin in (m.block.att.Q, m.block.att.K):
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
    for k in g_c:
        scale = float(g_c[k].abs().max())
        if not torch.allclose(g_g[k], g_c[k], rtol=1e-3,
                              atol=1e-4 * max(scale, 1e-30)):
            raise AssertionError(f"gradient {k} differs between cuda and cpu")
    print(f"[small] {row} cuda vs cpu: loss {loss_g:.6f} vs {loss_c:.6f}, "
          f"steps {dict((k, st_g[k]) for k in counts)}, early-stop best val "
          f"{best_g.val:.4f} vs {best_c.val:.4f} at t* {best_g.time:.4f} vs "
          f"{best_c.time:.4f}: agree (logits rtol 1e-4, grads rtol 1e-3)",
          flush=True)


ALL_KERNELS = ("csr_spmm", "edge_dot", "segment_norm", "segment_norm_bwd")


def drive_main_path(cfg, data_dir: str, expected):
    """``run.main`` on one tuned config on the card, with every kernel
    launch counter set to 0 just before and read just after. Checks the
    epoch logs and that each kernel in ``expected`` was launched. Returns
    (result, launch counts)."""
    import torch
    from graph_neural_pde_tpu_torch import kernels, run
    for k in kernels.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    res = run.main(cfg, data_dir=data_dir, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    epochs = cfg.epoch - 1
    print(f"[main] {epochs} epochs of tuned {cfg.dataset} in {secs:.2f} s; "
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
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the tuned "
                                 f"{cfg.dataset} path")
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
    from graph_neural_pde_tpu_torch.config import best_params
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
        rows = check_kernels("cora-standin", prepared_graph("Cora", data_dir),
                             best_params["Cora"].hidden_dim, args.seed)
        rows += check_segment_kernels(
            "computers-standin", prepared_graph("Computers", data_dir),
            best_params["Computers"].heads, args.seed + 2)
        t0 = time.perf_counter()
        big = arxiv_scale_graph(args.seed)
        print(f"[kernels] arxiv-scale graph built on the host in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows += check_kernels("arxiv-scale", big, 128, args.seed + 1)
        for h in (1, 8):
            rows += check_segment_kernels("arxiv-scale", big, h,
                                          args.seed + 3 + h)
        del big
        torch.cuda.empty_cache()

        # 4. end to end on small inputs, card vs CPU
        check_small_end_to_end("Cora")
        check_small_end_to_end("Computers")

        # 5. the main paths
        paths = (("Cora", 4, ALL_KERNELS), ("Cora", 4, ALL_KERNELS),
                 ("Computers", 4, ("csr_spmm", "edge_dot", "segment_norm")),
                 ("Pubmed", 3, ALL_KERNELS))
        results, launches = [], dict.fromkeys(ALL_KERNELS, 0)
        for row, epoch, expected in paths:
            res, counts = drive_main_path(
                best_params[row].replace(epoch=epoch), data_dir, expected)
            results.append(res)
            for k, v in counts.items():
                launches[k] += v
    cora_losses = [[log.loss for log in r.logs] for r in results[:2]]
    print(f"[main] two runs of tuned Cora agree bit for bit: "
          f"{cora_losses[0] == cora_losses[1]} (losses {cora_losses[0]} and "
          f"{cora_losses[1]})", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main paths")

    sources = {"csr_spmm": ("csr_spmm.cu", "stripe.py:513"),
               "edge_dot": ("edge_dot.cu", "stripe.py:363"),
               "segment_norm": ("segment_norm.cu", "stripe.py:412"),
               "segment_norm_bwd": ("segment_norm.cu", "stripe.py:412")}
    summary = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        main_shape = mine[0]          # the first check at the main path's shape
        summary.append({"name": name, "route": "cuda",
                        "source": f"graph_neural_pde_tpu_torch/csrc/{src}",
                        "replaces": ("graph_neural_pde_tpu/ops/pallas/"
                                     + replaces),
                        "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": main_shape["ms"],
                        "plain_ms": main_shape["plain_ms"]})
    print(nvidia_smi(), flush=True)     # the card's name and power limit
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
