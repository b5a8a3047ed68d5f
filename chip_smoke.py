#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass (any failure exits nonzero):

1. environment: the card's name and power limit (nvidia-smi) and torch's
   device name; exits 2 without a CUDA device;
2. build: compiles the port's CUDA kernels from ``graph_neural_pde_tpu_torch/
   csrc`` (nvcc, sm_90a) and prints the build time;
3. kernels against their plain PyTorch versions, on the card, at two
   shapes: the main path's own graph (the prepared Cora stand-in, D=80) and
   an arxiv-scale symmetric random graph (169,343 nodes, ~2.3M directed
   edges plus self-loops, D=128). Checks K1 ``csr_spmm`` forward, K1 as the
   backward ``dx`` (weights permuted to the reverse edges, against A^T ct
   by index_add over columns) and K2 ``edge_dot`` as ``dw``, at max error
   <= 1e-5 of the largest reference entry (float32; the sums only run in
   another order), and times each: device time per call (torch.profiler,
   mean of 20 calls; all device work of the call, so the wrapper's output
   memset counts) and time per call seen from the host (CUDA events around
   one call, median of 20; at small shapes this is the host's launch cost);
4. end to end on a small input: one forward, early-stop eval and training
   step of the tuned Cora model at reduced width on the card, held against
   the same model on the CPU (the plain versions, which the CPU test suite
   holds against the JAX package);
5. main path: ``graph_neural_pde_tpu_torch.run.main`` on tuned Cora
   (``best_params["Cora"]``, epoch=4, so 3 training epochs, each followed by
   an eval step and the early-stop eval) over the SBM stand-in, with both
   kernels' launch counters reset just before and required to grow.

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


def cora_graph(data_dir: str):
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.datasets import get_dataset
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    cfg = best_params["Cora"]
    d = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc)
    return prepare_graph(cfg, d.graph)


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

    rows = []
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
    for kname, what, kern, plain in cases:
        abs_err, rel = compare(f"{kname} {what} @ {shape_name}", kern(),
                               plain())
        call_k, call_p = median_ms(kern), median_ms(plain)
        dev_k, dev_p = device_ms(kern), device_ms(plain)
        measured = dev_k is not None and dev_p is not None
        rows.append(dict(kernel=kname, check=what, shape=shape_name,
                         max_abs_err=abs_err,
                         ms=dev_k if measured else call_k,
                         plain_ms=dev_p if measured else call_p))
        dev_txt = (f"device {dev_k:.4f} ms, plain {dev_p:.4f} ms; "
                   if measured else "device time not measured; ")
        print(f"[kernels] {kname:9s} {what:30s} {shape_name:12s} N={n} "
              f"E={nv} D={d}: max_abs_err={abs_err:.3e} rel={rel:.3e}; "
              f"{dev_txt}per call kernel {call_k:.4f} ms, plain "
              f"{call_p:.4f} ms", flush=True)
    return rows


def check_small_end_to_end(devices=("cpu", "cuda")):
    """Tuned Cora at reduced width on a 300-node SBM: the card's kernel path
    against the CPU's plain path, same weights and inputs."""
    import torch
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
    from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
    from graph_neural_pde_tpu_torch.training.train import cross_entropy_loss
    cfg = best_params["Cora"].replace(hidden_dim=16, attention_dim=16,
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
    counts = ("accepted", "rejected", "nfe")
    if [st_c[k] for k in counts] != [st_g[k] for k in counts]:
        raise AssertionError(f"solver steps differ: cpu {st_c} cuda {st_g}")
    if [es_c[k] for k in counts] != [es_g[k] for k in counts]:
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
    print(f"[small] cuda vs cpu: loss {loss_g:.6f} vs {loss_c:.6f}, "
          f"steps {[st_g[k] for k in counts]}, early-stop best val "
          f"{best_g.val:.4f} vs {best_c.val:.4f} at t* {best_g.time:.4f} vs "
          f"{best_c.time:.4f}: agree (logits rtol 1e-4, grads rtol 1e-3)",
          flush=True)


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
    from graph_neural_pde_tpu_torch import kernels, run
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
        rows = check_kernels("cora-standin", cora_graph(data_dir),
                             best_params["Cora"].hidden_dim, args.seed)
        t0 = time.perf_counter()
        big = arxiv_scale_graph(args.seed)
        print(f"[kernels] arxiv-scale graph built on the host in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows += check_kernels("arxiv-scale", big, 128, args.seed + 1)
        del big
        torch.cuda.empty_cache()

        # 4. end to end on a small input, card vs CPU
        check_small_end_to_end()

        # 5. the main path
        for k in kernels.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        res = run.main(best_params["Cora"].replace(epoch=4),
                       data_dir=data_dir, device="cuda")
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
    print(f"[main] 3 epochs of tuned Cora in {main_s:.2f} s; kernel "
          f"launches {launches}", flush=True)
    if len(res.logs) != 3:
        raise AssertionError(f"expected 3 epochs, got {len(res.logs)}")
    for log in res.logs:
        if not (math.isfinite(log.loss) and log.fwd_nfe > 0
                and log.bwd_nfe > 0):
            raise AssertionError(f"bad epoch log {log}")
    if not 0.0 < res.best["val_acc"] <= 1.0:
        raise AssertionError(f"bad best {res.best}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    sources = {"csr_spmm": ("graph_neural_pde_tpu_torch/csrc/csr_spmm.cu",
                            "graph_neural_pde_tpu/ops/pallas/stripe.py:513"),
               "edge_dot": ("graph_neural_pde_tpu_torch/csrc/edge_dot.cu",
                            "graph_neural_pde_tpu/ops/pallas/stripe.py:363")}
    summary = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        main_shape = mine[0]          # the first check at the main path's shape
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
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
