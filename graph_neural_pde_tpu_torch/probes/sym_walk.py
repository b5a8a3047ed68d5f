"""The symmetric backward row walk of K9 ``fused_rhs_bwd_sym`` and K14
``norm1_bwd`` on the card: what the compiler made of it, and its time at
every shape of its ``PERF.md`` rows.

    python graph_neural_pde_tpu_torch/probes/sym_walk.py [--root DIR]
        [--report] [--variants] [--shapes cora,arxiv,blend] [--seed N]

* ``--root DIR``: import the package of the checkout at DIR (another
  commit unpacked beside this one), so that two trees are timed by the
  same script in one run on one card; by default this file's checkout.
* ``--report``: builds that tree's kernels with ``nvcc -Xptxas -v`` and
  prints, for each kernel of the walk, its registers, stack and spills,
  the resident warps per SM they allow, and counts of its SASS
  instructions by kind (``cuobjdump -sass``); the SASS itself goes to
  ``chiprun_out/sym_walk_sass_<tag>.txt.gz``.
* then, at each shape: K9 and K14 held against their plain versions in
  float64 (1e-5 of scale) and timed (CUDA events, median of 20 calls
  after 3), and each call's device time split by kernel (torch.profiler,
  mean of 10), float32 and on the bfloat16 column table: the Cora
  stand-in at D=80 ATT=128 H=8 (float32 row side), the arxiv-scale graph
  at D=128 ATT=32 H=2 and at BLEND's D=128 ATT=2x32 H=2 (the bf16 state's
  bfloat16 row side);
* ``--variants``: also the walk's row pieces of other lengths
  (``VARIANTS``: whole rows, pieces of 8 edges) at each shape, where the
  tree's K9 takes ``pieces``.

Every line names the card and its power limit. Without a CUDA device it
exits nonzero.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gzip
import inspect
import io
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SHAPES = ("cora", "arxiv", "blend")
# the walk's variants beside its default, the rows cut into pieces of at
# most COL_PIECE edges (Graph.row_pieces): edges a piece, or None for
# whole rows
VARIANTS = {"whole rows": None, "pieces of 8": 8}
WALK_KERNELS = ("fused_rhs_bwd_sym", "norm1_bwd", "sym_merge")


def _import_tree(root):
    if root is not None:
        sys.path.insert(0, str(Path(root).resolve()))
    else:
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import graph_neural_pde_tpu_torch as pkg
    return Path(pkg.__file__).resolve().parent


def _resident_warps(regs: int) -> int:
    """Warps an SM keeps resident for a kernel of four-warp blocks by its
    registers: 64 at most, registers allocated 8 a thread at a time from
    65,536."""
    by_regs = 65536 // (32 * (-(-max(regs, 1) // 8) * 8))
    return 4 * min(64 // 4, by_regs // 4)


def report(tag: str, out_dir: Path, kernels=WALK_KERNELS,
           stem: str = "sym_walk") -> None:
    """ptxas's report and SASS counts of the kernels whose names hold one
    of ``kernels``, from the tree's own library build
    (``kernels.build.build(verbose=True)``); the SASS goes to
    ``out_dir/<stem>_sass_<tag>.txt.gz``."""
    from graph_neural_pde_tpu_torch.kernels import build
    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    if build.library_path().exists():
        build.library_path().unlink()
    out, t0 = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(out):
        lib = build.build(verbose=True)
    print(f"[build] {tag}: every kernel built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    text = out.getvalue()
    # ptxas: "Compiling entry function 'NAME'", then its stack / spill line
    # and its "Used N registers" line
    entries = re.split(r"Compiling entry function '", text)[1:]
    for block in entries:
        name = block.split("'", 1)[0]
        if not any(k in name for k in kernels):
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        print(f"[ptxas] {tag} {name}: registers "
              f"{regs.group(1) if regs else '?'}; stack / spill stores / "
              f"spill loads {spill.groups() if spill else '?'}; resident "
              f"warps per SM by registers "
              f"{_resident_warps(int(regs.group(1))) if regs else '?'}",
              flush=True)
    functions = re.split(r"\n\s*Function : ", sass)[1:]
    out_dir.mkdir(parents=True, exist_ok=True)
    dump = out_dir / f"{stem}_sass_{tag}.txt.gz"
    with gzip.open(dump, "wt") as f:
        for fn in functions:
            name = fn.split("\n", 1)[0].strip()
            if not any(k in name for k in kernels):
                continue
            f.write(f"Function : {fn}\n")
            ops = collections.Counter(
                m.group(1).split(".")[0]
                for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                     r"([A-Z][A-Z0-9_.]+)", fn))
            kinds = {k: ops[k] for k in ("LDG", "LDS", "STS", "STG", "SHFL",
                                         "WARPSYNC", "BAR", "MUFU", "FFMA",
                                         "BRA") if ops[k]}
            print(f"[sass] {tag} {name}: {sum(ops.values())} instructions; "
                  f"{kinds}", flush=True)
    print(f"[sass] {tag}: the kernels' SASS in {dump}", flush=True)


def _operands(g, d, att, h, score, seed, dev):
    """Seeded operands as ``chip_smoke.py``'s ``rhs_operands`` draws them
    (BLEND's projections block-structured, 3/4 of x's columns features)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    n = g.num_nodes
    x = randn(n, d)
    qw, kw = randn(d, att, scale=d ** -0.5), randn(d, att, scale=d ** -0.5)
    sp = {}
    if score == "exp_kernel_beltrami":
        feat = (3 * d) // 4
        for w in (qw, kw):
            w[feat:, :att // 2] = 0.0
            w[:feat, att // 2:] = 0.0
        sp = dict(var=torch.tensor([1.3, 0.9], device=dev),
                  ls=torch.tensor([0.8, 1.4], device=dev))
    ops = (x, qw, randn(att, scale=0.1), kw, randn(att, scale=0.1),
           torch.full((1,), 0.25, device=dev))
    ct_ax, ct_den = randn(n, d), 1.0 + randn(n, h, scale=0.1)
    return ops, ct_ax, ct_den, sp


def breakdown(fn, reps: int = 10) -> str:
    """Device time of one call of ``fn`` by kernel (torch.profiler, the
    mean over ``reps`` calls after a warm-up call), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = collections.Counter()
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "",
                      e.key).split("(")[0]
        if us:
            times[name[:60]] += us / reps / 1e3
    return "; ".join(f"{k} {v:.4f} ms" for k, v in times.most_common())


def time_walks(graphs, args, dev, line: str) -> None:
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.ops.graph import column_pieces
    from graph_neural_pde_tpu_torch.probes.gather import agree, time_ms
    takes_pieces = "pieces" in inspect.signature(K.fused_rhs_bwd_sym).parameters
    variants = VARIANTS if args.variants and takes_pieces else {}
    shapes = {"cora": ("cora", 80, 128, 8, "scaled_dot", False),
              "arxiv": ("arxiv", 128, 32, 2, "scaled_dot", True),
              "blend": ("arxiv", 128, 64, 2, "exp_kernel_beltrami", True)}
    for name in args.shapes.split(","):
        gname, d, att, h, score, row_b16 = shapes[name]
        g = graphs[gname]
        csr = (g.rowptr, g.row, g.col)
        for mode in ("f32", "bf16"):
            ops, ct_ax, ct_den, sp = _operands(g, d, att, h, score,
                                               args.seed, dev)
            kw = dict(heads=h, score=score, **sp)
            if mode == "bf16":
                kw["xcol"] = ops[0].to(torch.bfloat16)
                if row_b16:
                    ops = (kw["xcol"],) + ops[1:]
            _, den, _ = K.fused_rhs_fwd(*csr, *ops, **kw)
            recip_p = (1.0 / (h * (den + 1e-16))).contiguous()
            recip = 1.0 / (K.norm1_den(*csr, *ops, **kw) + 1e-16)
            cts = {"fused_rhs_bwd_sym": (ct_ax, recip_p, ct_den),
                   "norm1_bwd": (ct_ax, (recip / h).contiguous(), ct_den)}
            side = ("" if mode == "f32" else
                    " bf16 table, " + ("bf16" if row_b16 else "f32")
                    + " row side")
            dims = (f"N={g.num_nodes} E={g.num_valid} D={d} ATT={att} H={h} "
                    f"{score}{side}")
            for kname in ("fused_rhs_bwd_sym", "norm1_bwd"):
                fn = getattr(K, kname)
                plain = getattr(K, kname + "_plain")

                def f64(t):
                    return (t.double() if torch.is_tensor(t)
                            and t.is_floating_point()
                            and t.dtype != torch.bfloat16 else t)

                want = [o.float() for o in plain(
                    *csr, *map(f64, ops), *map(f64, cts[kname]),
                    **{k: f64(v) for k, v in kw.items()}) if o is not None]
                runs = {"default": dict(pieces=g.row_pieces)
                        if takes_pieces else {}}
                for vname, piece in variants.items():
                    runs[vname] = dict(pieces=column_pieces(
                        g.rowptr, piece or 1 << 30))
                for vname, vkw in runs.items():
                    def call(vkw=vkw):
                        return fn(*csr, *ops, *cts[kname], **kw, **vkw)
                    got = [o for o in call() if o is not None]
                    err = max(agree(f"{kname} {vname} {name}{side}", a, b)[1]
                              for a, b in zip(got, want))
                    again = [o for o in call() if o is not None]
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    if not same:
                        raise AssertionError(f"{kname} {vname} @ {dims}: two "
                                             "launches differ")
                    ms = time_ms(call)
                    print(f"[walk] {args.tag} {kname} {vname} @ {name} "
                          f"{dims}: {ms:.4f} ms (rel err {err:.2e}, "
                          f"relaunch bit-identical) [{line}]", flush=True)
                    if vname == "default":
                        print(f"[walk] {args.tag} {kname} @ {name}{side}: "
                              f"device time a call by kernel "
                              f"{breakdown(call)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    pkg_dir = _import_tree(args.root)
    import torch
    if not torch.cuda.is_available():
        print("probes.sym_walk: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    from graph_neural_pde_tpu_torch.probes.gather import (arxiv_scale_graph,
                                                          card)
    line = card()
    print(f"[walk] {args.tag}: package {pkg_dir}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    out_dir = Path(os.getcwd()) / "chiprun_out"
    if args.report:
        report(args.tag, out_dir)
    from graph_neural_pde_tpu_torch.kernels import build
    build.library()
    dev = torch.device("cuda")
    graphs = {}
    want = set(args.shapes.split(","))
    if "cora" in want:
        from graph_neural_pde_tpu_torch.config import best_params
        from graph_neural_pde_tpu_torch.data.datasets import get_dataset
        from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
        cfg = best_params["Cora"]
        with tempfile.TemporaryDirectory() as data_dir:
            data = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc)
            graphs["cora"] = prepare_graph(cfg, data.graph).to(dev)
    if want & {"arxiv", "blend"}:
        graphs["arxiv"] = arxiv_scale_graph(args.seed).to(dev)
    for gname, g in graphs.items():
        deg = (g.rowptr[1:] - g.rowptr[:-1]).float()
        print(f"[walk] graph {gname}: N={g.num_nodes} E={g.num_valid}, "
              f"degree mean {deg.mean().item():.2f} max "
              f"{int(deg.max().item())}", flush=True)
    time_walks(graphs, args, dev, line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
