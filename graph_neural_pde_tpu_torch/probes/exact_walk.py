"""The exact re-solve's own kernels on the card, K7 ``fused_rowmax`` and K8
``fused_rhs_bwd`` with its per-edge dxg: what the compiler made of them,
their whole-call times at every shape of their ``PERF.md`` rows and each
call split by kernel, and the paths that run them.

    python graph_neural_pde_tpu_torch/probes/exact_walk.py [--root DIR]
        [--tag T] [--report] [--out DIR] [--seed N]
        [--shapes cora,hub,arxiv,blend,knn,gdc,arxiv_dir]
        [--paths c,x] [--epochs N]

* ``--root DIR``: import the package of the checkout at DIR (another
  commit unpacked beside this one, e.g. the parent), so that two trees are
  timed by the same script in one chip call; by default this file's
  checkout. A tree whose K7 takes no ``pieces`` (before its walk over row
  pieces) is called without them. Run parent, PR, PR, parent.
* ``--report``: builds that tree's kernels with ``nvcc -Xptxas -v`` and
  prints, for each kernel of K7 and K8 with dxg (the walks, their merges,
  the dxg pass; the parent's one K8 kernel), its registers,
  stack and spills, the resident warps per SM they allow and counts of its
  SASS instructions by kind; the SASS goes to
  ``DIR/exact_walk_sass_<tag>.txt.gz`` (``--out``, by default
  ``build/probes``; ``probes/sym_walk.py``'s ``report``).
* then, at each shape, float32 and on the bfloat16 column table: K7, and
  K8 with dxg with K7's maxima as its per-edge shifts (the exact mode),
  each held to its plain version in float64 (1e-5 of scale), launched
  twice (bit-identical), timed whole-call (device time, ``chip_smoke.py``'s
  ``device_ms``, 20 calls) beside its plain version in float32, and split
  by kernel (torch.profiler, mean of 10: the node projections, the walk,
  the merge of multi-piece rows, the dxg pass, dKw). The shapes
  (``SHAPES``): the Cora stand-in at D=80 ATT=128 H=8 (float32 row side),
  the same with a hub row of degree 360 (``chip_smoke.py``'s cora-hub),
  the arxiv-scale graph at D=128 ATT=32 H=2 and at BLEND's D=128 ATT=2x32
  H=2 (the bf16 state's bfloat16 row side), the Cora stand-in rewired by
  pos_enc_knn at BLEND's D=64+32 ATT=2x128 H=8 and by GDC at D=80 ATT=128
  H=8 (float32 row side), and ogbn-arxiv-synthetic's pairs one way only at
  D=128 ATT=32 H=2 (bfloat16 row side).
* ``--paths c,x``: instead of the above, the tree trains
  ``chip_smoke.py``'s forced poisons (``drive_poisoned_path``'s models):
  (c) Cora GRAND-nl in float32, (x) Cora GRAND-nl and ``GRAND_NL_BENCH``
  at bench precision (``xc`` and ``xa`` apart). A warm-up epoch, then
  ``--epochs`` epochs under ``profile.py``'s profiler: per epoch the wall
  time, the device's busy time and idle share, and the launches and
  device ms of K7, K8 with dxg (its walk, merge and dxg pass), K6, the
  node projections, dKw and K1.

Every line names the card and its power limit; the numbers also go to
``--out``/exact_walk_<tag>.json. Without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BELTRAMI = "exp_kernel_beltrami"
# graph, D, ATT, H, score, a bfloat16 row side beside the bf16 table, the
# feature columns of BLEND's x
SHAPES = {"cora": ("cora", 80, 128, 8, "scaled_dot", False, None),
          "hub": ("hub", 80, 128, 8, "scaled_dot", False, None),
          "arxiv": ("arxiv", 128, 32, 2, "scaled_dot", True, None),
          "blend": ("arxiv", 128, 64, 2, BELTRAMI, True, 96),
          "knn": ("knn", 96, 256, 8, BELTRAMI, False, 64),
          "gdc": ("gdc", 80, 128, 8, "scaled_dot", False, None),
          "arxiv_dir": ("arxiv_dir", 128, 32, 2, "scaled_dot", True, None)}
EXACT_KERNELS = ("fused_rowmax", "fused_rhs_bwd_edges", "edge_project",
                 "fused_rhs_bwd_kernel")
# the kernels a path's epoch is split into: name -> substrings of the
# device events' names (both trees: the parent's K8 was one kernel)
GROUPS = {"K7": ("fused_rowmax",),
          "K8 with dxg": ("fused_rhs_bwd_kernel", "fused_rhs_bwd_edges",
                          "edge_project"),
          "K6": ("fused_rhs_fwd",),
          "projections": ("node_project",),
          "dKw": ("outer_reduce",),
          "K1": ("csr_spmm",)}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f64(t):
    import torch
    return (t.double() if torch.is_tensor(t) and t.is_floating_point()
            and t.dtype != torch.bfloat16 else t)


def _outputs(out):
    return [o for o in (out if isinstance(out, tuple) else (out,))
            if o is not None]


def graphs_for(names, seed, dev, cs, data_dir):
    """The graphs the shapes ``names`` need, on ``dev``."""
    from graph_neural_pde_tpu_torch.probes.gather import arxiv_scale_graph
    from graph_neural_pde_tpu_torch.probes.den_walk import \
        directed_arxiv_graph
    want = {SHAPES[s][0] for s in names}
    out = {}
    if want & {"cora", "hub"}:
        cora = cs.prepared_graph("Cora", data_dir)
        out["cora"] = cora.to(dev)
        if "hub" in want:
            out["hub"] = cs.hub_graph(cora, 360, seed + 230).to(dev)
    if "knn" in want:
        out["knn"] = cs.prepared_graph("Cora", data_dir,
                                       rewiring="pos_enc_knn",
                                       pos_enc_type="DW64").to(dev)
    if "gdc" in want:
        from graph_neural_pde_tpu_torch.config import best_params
        out["gdc"] = cs.gdc_graph(best_params["Cora"].replace(
            rewiring="gdc"), data_dir).to(dev)
    if "arxiv" in want:
        out["arxiv"] = arxiv_scale_graph(seed).to(dev)
    if "arxiv_dir" in want:
        out["arxiv_dir"] = directed_arxiv_graph(seed).to(dev)
    return out


def time_kernels(args, cs, sw, line, record) -> None:
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.probes.gather import agree
    dev = torch.device("cuda")
    names = args.shapes.split(",")
    pieces_k7 = "pieces" in inspect.signature(K.fused_rowmax).parameters
    with tempfile.TemporaryDirectory() as data_dir:
        graphs = graphs_for(names, args.seed, dev, cs, data_dir)
    for name in names:
        gname, d, att, h, score, row_b16, feat = SHAPES[name]
        g = graphs[gname]
        pc = g.row_pieces
        print(f"[exact] graph {name}: N={g.num_nodes} E={g.num_valid} "
              f"{pc.n_pieces} row pieces ({pc.n_multi} rows of several, "
              f"longest row {pc.longest} edges)", flush=True)
        for mode in ("f32", "bf16"):
            _, _, csr, ops, kw_f = cs.rhs_operands(g, d, att, h, score,
                                                   args.seed + 7, dev, feat)
            kw_x = {}
            if mode == "bf16":
                kw_x = dict(xcol=ops[0].to(torch.bfloat16))
                if row_b16:
                    ops = (kw_x["xcol"],) + ops[1:]
            side = ("" if mode == "f32" else
                    " bf16 table, " + ("bf16" if row_b16 else "f32")
                    + " row side")
            dims = f"N={g.num_nodes} E={g.num_valid} D={d} ATT={att} H={h} " \
                   f"{score}{side}"
            n = g.num_nodes
            gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
            ct_ax = torch.randn((n, d), generator=gen, device=dev)
            ct_den = 1.0 + 0.1 * torch.randn((n, h), generator=gen,
                                             device=dev)
            kw_p = dict(pieces=pc) if pieces_k7 else {}
            if score == "scaled_dot":
                smax = K.fused_rowmax(*csr, *ops[:5], heads=h, **kw_x,
                                      **kw_p)
                shifts = smax[g.row.long()].contiguous()
            else:
                shifts = (0.5 * torch.randn((g.capacity, h), generator=gen,
                                            device=dev)).contiguous()
            _, den, _ = K.fused_rhs_fwd(*csr, *ops, shifts=shifts,
                                        pieces=pc, **kw_x, **kw_f)
            recip_p = (1.0 / (h * (den + 1e-16))).contiguous()
            cts = (ct_ax, recip_p, ct_den)
            cases = [("fused_rhs_bwd with dxg",
                      lambda: K.fused_rhs_bwd(*csr, *ops, *cts, shifts=shifts,
                                              pieces=pc, **kw_x, **kw_f),
                      lambda: K.fused_rhs_bwd_plain(*csr, *ops, *cts,
                                                    shifts=shifts, **kw_x,
                                                    **kw_f),
                      lambda: K.fused_rhs_bwd_plain(
                          *csr, *map(_f64, ops), *map(_f64, cts),
                          shifts=_f64(shifts), **kw_x,
                          **{k: _f64(v) for k, v in kw_f.items()}))]
            if score == "scaled_dot":
                cases.insert(0, (
                    "fused_rowmax",
                    lambda: K.fused_rowmax(*csr, *ops[:5], heads=h, **kw_x,
                                           **kw_p),
                    lambda: K.fused_rowmax_plain(*csr, *ops[:5], heads=h,
                                                 **kw_x),
                    lambda: K.fused_rowmax_plain(*csr, *map(_f64, ops[:5]),
                                                 heads=h, **kw_x)))
            for case, kern, plain, ref in cases:
                got = _outputs(kern())
                want = [o.float() for o in _outputs(ref())]
                rel = max(agree(f"{case} @ {name}{side}", a, b)[1]
                          for a, b in zip(got, want))
                again = _outputs(kern())
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{case} @ {name} {dims}: two "
                                         "launches differ")
                ms = cs.device_ms(kern, reps=20)
                plain_ms = cs.device_ms(plain, reps=5)
                split = sw.breakdown(kern)
                print(f"[exact] {args.tag} {case} @ {name} {dims}: "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms (rel err "
                      f"{rel:.2e} against float64, relaunch "
                      f"bit-identical) [{line}]", flush=True)
                print(f"[exact] {args.tag} {case} @ {name}{side}: device "
                      f"time a call by kernel {split}", flush=True)
                record(kind="kernel", case=case, shape=name, dims=dims,
                       ms=ms, plain_ms=plain_ms, rel_err=rel, split=split)
            del ops, cts, shifts, ct_ax
            torch.cuda.empty_cache()


def profile_paths(args, cs, line, record) -> None:
    """(c) and (x) under the profiler (see the module docstring)."""
    import torch
    from torch.autograd import DeviceType
    from graph_neural_pde_tpu_torch import profile as prof
    from graph_neural_pde_tpu_torch import run
    from graph_neural_pde_tpu_torch.config import GRAND_NL_BENCH
    nl = cs.grand_nl_cora()
    bench = dict(rhs_payload_dtype="bfloat16", dtype="bfloat16",
                 method="rk4", step_size=1.0)
    cfgs = {"c": [("c", nl)],
            "x": [("xc", nl.replace(**bench)),
                  ("xa", GRAND_NL_BENCH.replace(seed=args.seed))]}
    with tempfile.TemporaryDirectory() as data_dir:
        for key in args.paths.split(","):
            for label, cfg in cfgs[key]:
                s = run.setup(cfg, data_dir, device="cuda")
                gen = torch.Generator().manual_seed(args.seed + 40)
                att = cs.attention_layer(s.model)
                with torch.no_grad():         # drive_poisoned_path's poison
                    for lin in (att.Q, att.K):
                        lin.w.copy_(10.0 * torch.randn(lin.w.shape,
                                                       generator=gen))
                s.trainer.train_step(s.x, s.y, s.masks[0])
                s.trainer.eval_step(s.x, s.y, s.masks)
                if not s.cfg.no_early:
                    s.model.apply_early(s.x, s.y, s.masks)
                torch.cuda.synchronize()
                phase_s, p = prof.profile_epochs(s, args.epochs)
                summ = prof.summarise(phase_s, p, args.epochs)
                dev = [e for e in p.events()
                       if e.device_type == DeviceType.CUDA]
                row = dict(path=label, epoch_ms=summ["wall_ms_per_epoch"],
                           device_busy_ms=summ["device_busy_ms_per_epoch"],
                           idle_share=summ["device_idle_share"])
                for group, keys in GROUPS.items():
                    hits = [e for e in dev if any(k in e.name for k in keys)]
                    firsts = [e for e in hits if "merge" not in e.name
                              and "edge_project" not in e.name]
                    row[f"{group} launches"] = len(firsts) / args.epochs
                    row[f"{group} ms"] = sum(
                        e.time_range.elapsed_us()
                        for e in hits) / args.epochs / 1e3
                print(f"[paths] {args.tag} ({label}) per epoch: "
                      + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                  else f"{k} {v}" for k, v in row.items()
                                  if k != "path") + f" [{line}]", flush=True)
                record(kind="path", **row)
                del s
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "probes"))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--paths", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve()
    sw = _load("_sym_walk_probe", here.with_name("sym_walk.py"))
    pkg_dir = sw._import_tree(args.root)
    import torch
    if not torch.cuda.is_available():
        print("probes.exact_walk: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _load("_chip_smoke", ROOT / "chip_smoke.py")
    from graph_neural_pde_tpu_torch.probes.gather import card
    line = card()
    print(f"[exact] {args.tag}: package {pkg_dir}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    if args.report:
        sw.report(args.tag, Path(args.out), EXACT_KERNELS, "exact_walk")
    from graph_neural_pde_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    print(f"[exact] {args.tag}: library ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results = []

    def record(**row):
        results.append(dict(row, tree=args.tag, card=line))

    if args.paths is not None:
        profile_paths(args, cs, line, record)
    else:
        time_kernels(args, cs, sw, line, record)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    kind = "paths" if args.paths is not None else "kernels"
    dump = out / f"exact_walk_{kind}_{args.tag}.json"
    dump.write_text(json.dumps(results, indent=1))
    print(f"[exact] results in {dump}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
