"""Gather and scatter probes on the card: the H100 counterparts of the
JAX package's TPU probes ``examples/perf_probe1.py`` and
``examples/perf_probe13_vmem_gather.py``.

    python -m graph_neural_pde_tpu_torch.probes.gather [--seed N]

One line per data point: the time of one call on the card (CUDA events,
median of 20 after 3 warm-up calls), ns per row, the card's name and its
power limit. Without a CUDA device it exits nonzero.

* probe 1 (N = 169,343 nodes, E = 2,332,486 row-sorted random edges):
  A, the random row gather ``table[col]`` at widths 64-256 in float32 and
  bfloat16 (``torch.index_select``, a library call, as XLA's gather was on
  the TPU); B, the sorted segment sum at widths 128 and 258 (K1
  ``csr_spmm`` in table mode beside ``torch.segment_reduce``); C/D, the
  stripe scatter and its gather (the P6 pair: K1 in table mode and K20
  ``row_gather``). On the TPU C built its one-hot on the fly and D
  precomputed it, over a sweep of block and chunk sizes; on this card the
  precomputed plan is the CSR row pointer, so C and D are one function,
  and the sweep (a Mosaic artifact) is dropped.
* probe 13 (2,703,360 rows): A, ``torch.index_select`` from a [N, 128]
  bfloat16 table; B, K21 ``smem_gather`` from a float32 table [T, 128] held
  in shared memory, T in {8, 64, 448, 512} (T = 512, 256 KB, does not fit:
  the wrapper's refusal is printed, as the TPU probe printed Mosaic's
  fault); C, K21 from a bfloat16 table [512, 128].
* the answer to ``PERF.md``'s question: at arxiv scale (a symmetric random
  graph of 169,343 nodes and 2,469,337 edges with self-loops, D = 128,
  ATT = 32, H = 2), the row gather ``x[col]`` alone beside K6, K9, K13 and
  K14.

Each kernel is held against its plain version (1e-5 of scale; bit for bit
for the gathers) before it is timed; a disagreement raises. ``card``,
``time_ms``, ``agree`` and ``arxiv_scale_graph`` are also ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from graph_neural_pde_tpu_torch import kernels as K
from graph_neural_pde_tpu_torch.kernels.shard_scatter import ScatterPlan
from graph_neural_pde_tpu_torch.kernels.smem_gather import table_fits

N = 169_343
E1 = 2_332_486                      # probe 1's edges
E13 = 2_640 * 1_024                 # probe 13's rows: 2,640 chunks x 1,024
REL = 1e-5


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call on the card (CUDA events)."""
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
    return sorted(times)[reps // 2]


class Report:
    """Prints one line per data point, with the card's name and power
    limit."""

    def __init__(self, device_line: str):
        self.device_line = device_line

    def __call__(self, label: str, ms: float, rows: int):
        print(f"[probe] {label}: {ms:.4f} ms ({ms * 1e6 / rows:.3f} ns/row) "
              f"[{self.device_line}]", flush=True)


def agree(name, got, want, bound: float = REL):
    """(max abs error, that error over ``want``'s largest entry) of a
    kernel's output; raises if ``got`` is not finite or the second exceeds
    ``bound``."""
    if got.is_cuda:
        torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / max(scale, 1e-30)
    if rel > bound:
        raise AssertionError(f"{name}: max error {err:.3e} is {rel:.3e} of "
                             f"max |ref| {scale:.3e} > {bound}")
    return err, rel


def probe1_edges(seed: int):
    """Probe 1's edges: E1 sorted uniform rows and uniform columns over N
    nodes, drawn as the TPU probe draws them."""
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, N, size=E1).astype(np.int32))
    col = rng.integers(0, N, size=E1).astype(np.int32)
    return row, col


def probe1(report: Report, dev, seed: int):
    row, col = probe1_edges(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    col_d = torch.from_numpy(col).to(dev)
    for width in (64, 128, 192, 256):
        for dtype in (torch.float32, torch.bfloat16):
            tab = torch.randn((N, width), generator=gen, device=dev).to(dtype)
            report(f"1A index_select gather w={width} "
                   f"{str(dtype).split('.')[1]} (library)",
                   time_ms(lambda: torch.index_select(tab, 0, col_d)), E1)
            del tab
    plan = ScatterPlan.from_rows(row, N, dev)
    lengths = torch.from_numpy(np.bincount(row, minlength=N)).to(dev)
    for width in (128, 258):
        vals = torch.randn((E1, width), generator=gen, device=dev)
        table = torch.randn((N, width), generator=gen, device=dev)

        def scatter():
            return K.csr_spmm(plan.rowptr, plan.row, plan.slots, plan.valid,
                              vals, table=True, n_edges=plan.n_valid)

        def segment_reduce():
            return torch.segment_reduce(vals, "sum", lengths=lengths)

        def gather():
            return K.row_gather(plan.rowptr, plan.row, table, E1)

        agree(f"K1 table mode w={width}", scatter(),
              K.csr_spmm_plain(plan.rowptr, plan.row, plan.slots, plan.valid,
                               vals))
        agree(f"K1 table mode w={width} vs segment_reduce", scatter(),
              segment_reduce())
        if not torch.equal(gather(), K.row_gather_plain(plan.rowptr, plan.row,
                                                        table)):
            raise AssertionError(f"K20 w={width} differs from its plain "
                                 f"version")
        report(f"1B segment sum w={width} f32: K1 table mode",
               time_ms(scatter), E1)
        report(f"1B segment sum w={width} f32: torch.segment_reduce "
               f"(library)", time_ms(segment_reduce), E1)
        report(f"1C/D stripe scatter w={width} f32: K1 table mode",
               time_ms(scatter), E1)
        report(f"1C/D stripe gather w={width} f32: K20 row_gather",
               time_ms(gather), E1)
        report(f"1C/D stripe gather w={width} f32: index_select (library)",
               time_ms(lambda: torch.index_select(table, 0,
                                                  plan.row.long())), E1)
        del vals, table


def probe13(report: Report, dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tab = torch.randn((N, 128), generator=gen, device=dev).bfloat16()
    idx = torch.randint(0, N, (E13,), generator=gen, device=dev,
                        dtype=torch.int32)
    report(f"13A index_select gather [{N},128] bf16 x {E13} rows (library)",
           time_ms(lambda: torch.index_select(tab, 0, idx)), E13)
    del tab
    for t_rows, dtype, tag in ((8, torch.float32, "B"),
                               (64, torch.float32, "B"),
                               (448, torch.float32, "B"),
                               (512, torch.float32, "B"),
                               (512, torch.bfloat16, "C")):
        small = torch.randn((t_rows, 128), generator=gen,
                            device=dev).to(dtype)
        ids = torch.randint(0, t_rows, (E13,), generator=gen, device=dev,
                            dtype=torch.int32)
        name = (f"13{tag} smem_gather tab[{t_rows},128] "
                f"{str(dtype).split('.')[1]} x {E13} rows")
        if not table_fits(small):
            # the expected refusal: no block's shared memory holds it
            try:
                K.smem_gather(ids, small)
            except ValueError as err:
                print(f"[probe] {name}: refused: {err}", flush=True)
                continue
            raise AssertionError(f"{name}: a table that does not fit in "
                                 f"shared memory was accepted")
        got = K.smem_gather(ids, small)
        if not torch.equal(got, K.smem_gather_plain(ids, small)):
            raise AssertionError(f"{name}: differs from index_select")
        report(f"{name}: K21", time_ms(lambda: K.smem_gather(ids, small)),
               E13)
        report(f"{name}: index_select (library)",
               time_ms(lambda: K.smem_gather_plain(ids, small)), E13)


def arxiv_scale_graph(seed: int):
    """A symmetric random graph at ogbn-arxiv's node count (1,150,000
    random pairs both ways, self-loops added), prepared as the attention
    block prepares its graph."""
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    from graph_neural_pde_tpu_torch.ops.graph import make_graph
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N, 1_150_000)
    v = rng.integers(0, N, 1_150_000)
    keep = u != v
    u, v = u[keep], v[keep]
    g = make_graph(np.concatenate([u, v]), np.concatenate([v, u]),
                   num_nodes=N, pad_multiple=512)
    return prepare_graph(best_params["Cora"], g)


def gather_answer(report: Report, dev, seed: int, graph=None, d=128, att=32,
                  h=2):
    """The row gather x[col] alone at arxiv scale beside the fused kernels
    that contain it: K6 (forward), K9 (backward), K13 (forward over
    columns), K14 (its backward), over ``graph`` (by default
    :func:`arxiv_scale_graph`)."""
    g = (arxiv_scale_graph(seed) if graph is None else graph).to(dev)
    n, nv = g.num_nodes, g.num_valid
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(n, d)
    ops = (x, randn(d, att, scale=d ** -0.5), randn(att, scale=0.1),
           randn(d, att, scale=d ** -0.5), randn(att, scale=0.1),
           torch.full((1,), 0.25, device=dev))
    csr = (g.rowptr, g.row, g.col)
    kw = dict(heads=h, score="scaled_dot")
    ct_ax, ct_den = randn(n, d), 1.0 + randn(n, h, scale=0.1)
    kw_p = dict(kw, pieces=g.row_pieces)
    _, den, _ = K.fused_rhs_fwd(*csr, *ops, **kw_p)
    recip_p = (1.0 / (h * (den + 1e-16))).contiguous()
    recip = (1.0 / (K.norm1_den(*csr, *ops, **kw_p) + 1e-16)).contiguous()
    recip1 = (recip / h).contiguous()
    col = g.col[:nv].long()
    times = {
        "x[col] gather": time_ms(lambda: torch.index_select(x, 0, col)),
        "K6 fused_rhs_fwd": time_ms(lambda: K.fused_rhs_fwd(*csr, *ops,
                                                            **kw_p)),
        "K9 fused_rhs_bwd_sym": time_ms(
            lambda: K.fused_rhs_bwd_sym(*csr, *ops, ct_ax, recip_p, ct_den,
                                        **kw_p)),
        "K13 norm1_fwd": time_ms(lambda: K.norm1_fwd(*csr, *ops, recip,
                                                     **kw_p)),
        "K14 norm1_bwd": time_ms(
            lambda: K.norm1_bwd(*csr, *ops, ct_ax, recip1, ct_den, **kw_p)),
    }
    for label, ms in times.items():
        report(f"arxiv scale N={n} E={nv} D={d} ATT={att} H={h}: {label}",
               ms, nv)
    base = times["x[col] gather"]
    print("[probe] answer: at arxiv scale the x[col] gather alone takes "
          f"{base:.4f} ms; " + ", ".join(
              f"{k.split()[0]} {v:.4f} ms = {v / base:.2f}x"
              for k, v in times.items() if k != "x[col] gather"),
          flush=True)


def main(argv=None, device="cuda", graph=None) -> None:
    """Run every probe on ``device``; raises without a CUDA device.
    ``graph``: the arxiv-scale graph of the answer, if the caller holds
    one (:func:`arxiv_scale_graph` builds it otherwise)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probes.gather: no CUDA device; the probes "
                           "measure the card")
    dev = torch.device(device)
    report = Report(card())
    print(f"[probe] {torch.cuda.get_device_name(dev)}; "
          f"{report.device_line}", flush=True)
    probe1(report, dev, args.seed)
    probe13(report, dev, args.seed)
    torch.cuda.empty_cache()
    gather_answer(report, dev, args.seed, graph)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("probes.gather: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        sys.exit(2)
    main()
