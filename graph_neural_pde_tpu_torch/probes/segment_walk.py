"""K3 ``segment_norm`` and K4 ``segment_norm_bwd`` on the card: what the
compiler made of their walk, and their times at every shape of their
``PERF.md`` rows, beside another tree's kernels and the library calls in
the same process.

    python graph_neural_pde_tpu_torch/probes/segment_walk.py [--root DIR]
        [--tag T] [--out DIR] [--shapes cora,cora-hub,...] [--seed N]
        [--sessions N] [--no-candidates] [--no-variants]
        [--paths cora,m,computers] [--epochs N]

* ``csrc/segment_norm.cu`` of this checkout and, with ``--root DIR``, of
  the checkout at DIR (the parent commit unpacked beside this one) are
  each compiled alone with ``nvcc -Xptxas -v`` (``probes/lanes.py``'s
  ``Tree``), both at once, and called through their C entry points (argument lists read from the sources; a tree whose entry
  point takes no pieces is the parent's warp a segment, whose wrapper
  zero-filled out and ds first, which the probe does too). ptxas's
  registers, stack and spills of every instantiation are printed.
* At each shape (``SHAPES``) and layout (rows; columns through ``rev``;
  columns over the CSC view), in both modes: K3 and K4 held to their plain
  versions in float64 (1e-5 of scale), relaunched (bit-identical), and
  timed as whole calls (device time from torch.profiler, ``chip_smoke
  .py``'s ``device_ms``): the chooser's pick (``kernels/lanes.py``'s
  ``segment_design``), unless ``--no-candidates`` every other lane group
  built, and unless ``--no-variants`` the segments cut into pieces of the
  other length (64 where the graph's are 32, and the reverse: a wider
  group holding more of a long segment) at the chooser's lane group for
  them. Then the other tree's kernel, this one's and, in softmax mode, the
  library call (``torch.sparse.softmax`` over an [N, N, H] COO tensor for
  K3, its backward ``torch._sparse_softmax_backward_data`` for K4) in
  ``--sessions`` profiler sessions each, in turns (``probes/lanes.py``'s
  ``sessions``), their medians compared.
* ``--paths cora,m,computers``: instead of the above, the model paths of
  the tree at ``--root`` (this checkout by default; its kernels built in
  it): K3 and K4's launches and device ms per epoch of the tuned Cora row,
  (m) (the tuned Cora row over GDC) and the tuned Computers row,
  ``profile.py``'s epochs after one warm-up epoch, with the device's busy
  and idle time and the memsets' ms.

Shapes: the Cora stand-in at the tuned row's H=8 (the main path's shape),
the same with a hub row of degree 360 (``chip_smoke.py``'s cora-hub), the
Computers stand-in at its H=4, the arxiv-scale graph at H=8 and H=1, the
GDC-rewired Cora stand-in at H=8 and arxiv's pairs one way only (arxiv
dir.) at H=8, both over the CSC view. Every line names the card and its
power limit; the numbers and ptxas's report also go to
``--out``/segment_walk_<tag>.json (by default ``build/probes``). Without a
CUDA device it exits nonzero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# shape: graph, heads, layouts
SHAPES = {"cora": ("cora", 8, ("rows", "columns")),
          "cora-hub": ("cora-hub", 8, ("rows", "columns")),
          "computers": ("computers", 4, ("rows", "columns")),
          "arxiv": ("arxiv", 8, ("rows", "columns")),
          "arxiv-h1": ("arxiv", 1, ("rows", "columns")),
          "cora-gdc": ("cora-gdc", 8, ("csc",)),
          "arxiv-dir": ("arxiv-dir", 8, ("csc",))}
LANES = (4, 8, 16, 32)
MODES = ("softmax", "normalise")
REL = 1e-5


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_graphs(keys, data_dir: str, seed: int, dev, cs):
    """The graphs of ``keys``, prepared as their blocks prepare them."""
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.probes.gather import arxiv_scale_graph
    makers = {
        "cora": lambda: cs.prepared_graph("Cora", data_dir),
        "cora-hub": lambda: cs.hub_graph(cs.prepared_graph("Cora", data_dir),
                                         360, seed + 230),
        "computers": lambda: cs.prepared_graph("Computers", data_dir),
        "arxiv": lambda: arxiv_scale_graph(seed),
        "cora-gdc": lambda: cs.gdc_graph(
            best_params["Cora"].replace(rewiring="gdc"), data_dir),
        "arxiv-dir": lambda: cs.directed_random_graph(169_343, 1_166_243,
                                                      seed),
    }
    return {k: makers[k]().to(dev) for k in dict.fromkeys(keys)}


def layout_of(g, layout):
    """(segptr, seg, perm, K3 / K4's pieces) of a layout."""
    if layout == "rows":
        return g.rowptr, g.row, None, g.row_segments
    if layout == "columns":
        return g.rowptr, g.row, g.rev, g.row_segments
    return g.colptr, g.col_by_col, g.col_perm, g.col_segments


def new_api(tree) -> bool:
    """Whether the tree's K3 takes the segments' pieces."""
    return len(tree.args["segment_norm"]) > 9


def k3_call(tree, lay, s, mode, group=None, vec=None, pieces=None):
    """K3 of ``tree`` on one layout: (out, den). The new walk takes the
    pieces (``pieces``, else the layout's) and (G, V) (the chooser's where
    not given); the parent's, a warp a segment, zero-fills out first."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.lanes import segment_design
    segptr, _, perm, pc = lay
    n, h = segptr.shape[0] - 1, s.shape[1]
    m = 0 if mode == "softmax" else 1
    den = torch.empty((n, h), device=s.device)
    pp = None if perm is None else perm.data_ptr()
    if not new_api(tree):
        out = torch.zeros_like(s)
        tree.call("segment_norm", segptr.data_ptr(), pp, s.data_ptr(),
                  out.data_ptr(), den.data_ptr(), n, h, m)
        return out, den
    pc = pieces or pc
    out = torch.empty_like(s)
    part = torch.empty((max(pc.n_slots, 1), 2 * h), device=s.device)
    g0, v0 = segment_design(h, pc.n_edges / max(n, 1), s, out, den, part,
                            piece=pc.piece)
    tree.call("segment_norm", pc.ptr.data_ptr(), pc.col.data_ptr(),
              pc.slot.data_ptr(), pc.multi_piece.data_ptr(),
              segptr.data_ptr(), pp, s.data_ptr(), out.data_ptr(),
              den.data_ptr(), part.data_ptr(), n, pc.n_pieces, pc.n_slots,
              pc.piece, s.shape[0], h, m, group or g0, vec or v0)
    return out, den


def k4_call(tree, lay, out, g, den, mode, group=None, vec=None,
            pieces=None):
    """K4 of ``tree`` on one layout: ds (as ``k3_call``)."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.lanes import segment_design
    segptr, _, perm, pc = lay
    n, h = segptr.shape[0] - 1, g.shape[1]
    m = 0 if mode == "softmax" else 1
    pp = None if perm is None else perm.data_ptr()
    if not new_api(tree):
        ds = torch.zeros_like(g)
        tree.call("segment_norm_bwd", segptr.data_ptr(), pp, out.data_ptr(),
                  g.data_ptr(), den.data_ptr(), ds.data_ptr(), n, h, m)
        return ds
    pc = pieces or pc
    ds = torch.empty_like(g)
    part = torch.empty((max(pc.n_slots, 1), h), device=g.device)
    g0, v0 = segment_design(h, pc.n_edges / max(n, 1), out, g, den, ds,
                            part, piece=pc.piece)
    tree.call("segment_norm_bwd", pc.ptr.data_ptr(), pc.col.data_ptr(),
              pc.slot.data_ptr(), pc.multi_piece.data_ptr(),
              segptr.data_ptr(), pp, out.data_ptr(), g.data_ptr(),
              den.data_ptr(), ds.data_ptr(), part.data_ptr(), n,
              pc.n_pieces, pc.n_slots, pc.piece, g.shape[0], h, m,
              group or g0, vec or v0)
    return ds


def library_calls(g, lay, s, out, ct, layout):
    """K3's and K4's library calls in softmax mode: ``torch.sparse.softmax``
    over each row (dim 1) or column (dim 0) of the [N, N, H] COO tensor
    of the valid edges' scores, coalesced (set-up, untimed; duplicate
    edges' scores summed), and its backward on the same coalesced
    indices."""
    import torch
    nv, n, h = g.num_valid, g.num_nodes, s.shape[1]
    idx = torch.stack([g.row[:nv].long(), g.col[:nv].long()])
    coo = torch.sparse_coo_tensor(idx, s[:nv], (n, n, h)).coalesce()
    dim = 1 if layout == "rows" else 0
    soft = torch.sparse.softmax(coo, dim=dim)
    gcoo = torch.sparse_coo_tensor(soft.indices(), ct[:soft.values().shape[0]],
                                   soft.shape).coalesce()
    return (lambda: torch.sparse.softmax(coo, dim=dim),
            lambda: torch._sparse_softmax_backward_data(gcoo, soft, dim,
                                                        coo))


def run_shape(shape, g, h, layout, trees, args, cs, line, record):
    """Every check and timing of one shape and layout (see the module
    docstring)."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.lanes import (SEGMENT_MEMBERS,
                                                          SEGMENT_PIECES,
                                                          segment_design)
    from graph_neural_pde_tpu_torch.kernels.segment_norm import (
        segment_norm_bwd_plain, segment_norm_plain)
    from graph_neural_pde_tpu_torch.ops.graph import column_pieces
    from graph_neural_pde_tpu_torch.probes.gather import agree
    mine, other = trees[0], (trees[1] if len(trees) > 1 else None)
    dev = g.row.device
    lay = layout_of(g, layout)
    segptr, seg, perm, pc = lay
    n, nv, cap = segptr.shape[0] - 1, g.num_valid, g.capacity
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    scores = torch.randn((cap, h), generator=gen, device=dev)
    weights = torch.rand((cap, h), generator=gen, device=dev) + 0.05
    ct = torch.randn((cap, h), generator=gen, device=dev)
    mean = pc.n_edges / max(n, 1)
    g0, v0 = segment_design(h, mean, scores, piece=pc.piece)
    print(f"[segment] {shape} {layout}: N={n} E={nv} capacity {cap} H={h}; "
          f"segment_design G={g0} V={v0} (mean segment {mean:.2f}); "
          f"{pc.n_pieces} pieces of <= {pc.piece}, {pc.n_multi} segments "
          f"of several ({pc.n_slots} pieces), longest {pc.longest}",
          flush=True)
    other_piece = next(p for p in SEGMENT_PIECES if p != pc.piece)
    alt = column_pieces(segptr, other_piece, device=dev)
    g_alt, _ = segment_design(h, mean, scores, piece=other_piece)
    idx_bytes = 4 * (n + 1 + (nv if perm is not None else 0))
    for mode in MODES:
        s = scores if mode == "softmax" else weights
        want_out, want_den = (t.float() for t in segment_norm_plain(
            segptr, seg, perm, s.double(), mode))
        out = want_out
        want_ds = segment_norm_bwd_plain(segptr, seg, perm, out.double(),
                                         ct.double(), want_den.double(),
                                         mode).float()
        runs = [("pr", mine, None, None)]
        if not args.no_candidates:
            runs += [(f"pr G={c}", mine, c, None) for c in LANES
                     if c != g0 and pc.piece // c <= SEGMENT_MEMBERS]
        if not args.no_variants:
            runs.append((f"pr pieces of {other_piece}", mine, g_alt, alt))
        if other is not None:
            runs = ([("other", other, None, None)] + runs
                    + [("other again", other, None, None)])
        k3_bytes = idx_bytes + 4 * (nv * h + cap * h + n * h)
        k4_bytes = idx_bytes + 4 * (2 * nv * h + cap * h
                                    + (n * h if mode != "softmax" else 0))
        times = {"K3": {}, "K4": {}}
        for label, tree, grp, pcs in runs:
            def k3(tree=tree, grp=grp, pcs=pcs):
                return k3_call(tree, lay, s, mode, grp, None, pcs)

            def k4(tree=tree, grp=grp, pcs=pcs):
                return k4_call(tree, lay, out, ct, want_den, mode, grp, None,
                               pcs)
            got = k3()
            e3 = max(agree(f"K3 {label} {mode} {shape} {layout} [{i}]", a,
                           b, REL) for i, (a, b) in enumerate(
                               zip(got, (want_out, want_den))))
            ds = k4()
            e4 = agree(f"K4 {label} {mode} {shape} {layout}", ds, want_ds,
                       REL)
            again = k3()
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])
                    and torch.equal(ds, k4())):
                raise AssertionError(f"{label} {mode} {shape} {layout}: two "
                                     "launches differ")
            for k, fn, nb in (("K3", k3, k3_bytes), ("K4", k4, k4_bytes)):
                ms = cs.device_ms(fn, reps=20)
                times[k][label] = ms
                print(f"[segment] {k} {label} {mode} @ {shape} {layout} "
                      f"G={grp or g0}: {ms:.4f} ms (bound "
                      f"{nb / cs.PEAK_BYTES_PER_S * 1e3:.5f} ms by bytes, "
                      f"{nb / 1e6:.2f} MB; rel err "
                      f"{(e3 if k == 'K3' else e4)[1]:.2e}; relaunch "
                      f"bit-identical) [{line}]", flush=True)
        row = record(shape=shape, layout=layout, mode=mode, heads=h,
                     nodes=n, edges=nv, group=g0, vec=v0, mean=mean,
                     pieces=pc.n_pieces, multi=pc.n_multi,
                     multi_pieces=pc.n_slots, longest=pc.longest,
                     k3_ms=times["K3"], k4_ms=times["K4"],
                     k3_bound_ms=k3_bytes / cs.PEAK_BYTES_PER_S * 1e3,
                     k4_bound_ms=k4_bytes / cs.PEAK_BYTES_PER_S * 1e3)
        if not args.sessions:
            continue
        lib3 = lib4 = None
        if mode == "softmax":
            lib3, lib4 = library_calls(g, lay, s, out, ct, layout)
        for k, fn_pr, fn_other, lib in (
                ("K3", lambda: k3_call(mine, lay, s, mode),
                 other and (lambda: k3_call(other, lay, s, mode)), lib3),
                ("K4", lambda: k4_call(mine, lay, out, ct, want_den, mode),
                 other and (lambda: k4_call(other, lay, out, ct, want_den,
                                            mode)), lib4)):
            fns = [(f"parent {k}", fn_other)] if fn_other else []
            fns += [(k, fn_pr)]
            if lib is not None:
                names = cs.device_kernel_names(lib)
                print(f"[sessions] {k} {mode} {shape} {layout}: the library "
                      f"call's device kernels {names}", flush=True)
                fns += [("library", lib)]
            row[f"{k.lower()}_sessions"] = LANES_PROBE.sessions(
                fns, args.sessions, cs, line, f"{k} {mode} {shape} {layout}")
        row["others_pr"] = [nm for nm in cs.device_kernel_names(
            lambda: (k3_call(mine, lay, s, mode),
                     k4_call(mine, lay, out, ct, want_den, mode)))
            if "segment_norm" not in nm]
        print(f"[segment] {mode} {shape} {layout}: device operations of "
              f"this tree's K3 and K4 calls besides their kernels (memsets, "
              f"fills): {row['others_pr']}", flush=True)


LANES_PROBE = None


def profile_paths(args, tree: Path) -> int:
    """K3 and K4 on the model paths of the tree at ``tree`` per epoch (see
    the module docstring)."""
    import torch
    from torch.autograd import DeviceType
    from graph_neural_pde_tpu_torch import run
    from graph_neural_pde_tpu_torch import profile as prof
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.probes.gather import card
    line = card()
    print(f"[paths] {args.tag}: package {tree}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    cfgs = {"cora": best_params["Cora"],
            "m": best_params["Cora"].replace(rewiring="gdc"),
            "computers": best_params["Computers"]}
    results = []
    with tempfile.TemporaryDirectory() as data_dir:
        for name in args.paths.split(","):
            s = run.setup(cfgs[name], data_dir, device="cuda")
            pe = s.pos_encoding
            s.trainer.train_step(s.x, s.y, s.masks[0], pos_encoding=pe)
            s.trainer.eval_step(s.x, s.y, s.masks, pe)
            if not s.cfg.no_early:
                s.model.apply_early(s.x, s.y, s.masks, pe)
            torch.cuda.synchronize()
            phase_s, p = prof.profile_epochs(s, args.epochs)
            summ = prof.summarise(phase_s, p, args.epochs)
            ks = summ["kernels"]
            memset_us = sum(e.time_range.elapsed_us() for e in p.events()
                            if e.device_type == DeviceType.CUDA
                            and "emset" in e.name)
            row = dict(path=name, tree=args.tag, card=line,
                       epoch_ms=summ["wall_ms_per_epoch"],
                       device_busy_ms=summ["device_busy_ms_per_epoch"],
                       idle_share=summ["device_idle_share"],
                       memset_ms=memset_us / args.epochs / 1e3)
            for tag, kname in (("k3", "segment_norm"),
                               ("k4", "segment_norm_bwd")):
                row[f"{tag}_launches"] = ks[kname]["launches_per_epoch"]
                row[f"{tag}_ms"] = ks[kname]["device_ms_per_epoch"]
            results.append(row)
            print(f"[paths] {args.tag} ({name}) per epoch: "
                  + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                              else f"{k} {v}" for k, v in row.items()
                              if k not in ("path", "tree", "card"))
                  + f" [{line}]", flush=True)
            del s
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dump = out / f"segment_paths_{args.tag}.json"
    dump.write_text(json.dumps(results, indent=1))
    print(f"[paths] results in {dump}", flush=True)
    return 0


def main(argv=None) -> int:
    global LANES_PROBE
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="parent")
    ap.add_argument("--out", default=os.path.join("build", "probes"))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--no-candidates", action="store_true")
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--paths", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    tree = ROOT if args.paths is None or args.root is None else Path(
        args.root).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("probes.segment_walk: no CUDA device "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if args.paths is not None:
        return profile_paths(args, tree)
    from graph_neural_pde_tpu_torch.kernels import build
    from graph_neural_pde_tpu_torch.probes.gather import card
    LANES_PROBE = _load("_lanes_probe", Path(__file__).with_name("lanes.py"))
    cs = _load("_chip_smoke", ROOT / "chip_smoke.py")
    line = card()
    print(f"[segment] {torch.cuda.get_device_name(0)}; {line}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    LANES_PROBE.LIB_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    src = ("segment_norm",)
    trees = [LANES_PROBE.Tree("seg pr", ROOT, nvcc, sources=src)]
    if args.root is not None:
        trees.append(LANES_PROBE.Tree(f"seg {args.tag}",
                                      Path(args.root).resolve(), nvcc,
                                      sources=src))
    t0 = time.perf_counter()
    LANES_PROBE.build_trees(trees)
    print(f"[build] {', '.join(t.tag for t in trees)}: built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results = []

    def record(**row):
        row["card"] = line
        results.append(row)
        return row

    shapes = args.shapes.split(",")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as data_dir:
        graphs = make_graphs([SHAPES[s][0] for s in shapes], data_dir,
                             args.seed, dev, cs)
    for shape in shapes:
        key, h, layouts = SHAPES[shape]
        for layout in layouts:
            run_shape(shape, graphs[key], h, layout, trees, args, cs, line,
                      record)
    dump = out / f"segment_walk_{args.tag}.json"
    dump.write_text(json.dumps(dict(
        ptxas=[r for t in trees for r in t.ptxas],
        results=results), indent=1))
    print(f"[segment] results in {dump}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
