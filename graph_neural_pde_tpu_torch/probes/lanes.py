"""K1 ``csr_spmm``, K2 ``edge_dot``, K10 ``dual_scatter`` and K11
``dual_gather`` on the card: their lane groups, what the compiler made of
them, and their times at every shape of their ``PERF.md`` rows, beside
another tree's kernels in the same process.

    python graph_neural_pde_tpu_torch/probes/lanes.py [--root DIR]
        [--tag T] [--out DIR] [--shapes mnist,cifar,...,dual-arxiv]
        [--seed N] [--no-candidates] [--variants] [--paths l,cora,d,e,f]
        [--epochs N]

* The sources of the kernels asked for (``csrc/csr_spmm.cu``,
  ``csrc/edge_dot.cu``; ``csrc/dual_scatter.cu``, ``csrc/dual_gather.cu``
  for the ``dual-*`` shapes) of this checkout and, with ``--root DIR``, of
  the checkout at DIR (the parent commit unpacked beside this one) are
  each compiled alone with ``nvcc -Xptxas -v`` into a small library under
  ``build/probes``, all at once, and called through their C entry
  points, whose argument lists are read from the sources: the other
  tree's wrappers are emulated (K2's and K11's zeroed outputs included),
  so both trees run on the same inputs in one process. ptxas's
  registers, stack and spills of every instantiation are printed.
* At each K1 / K2 shape: K1 (the node state, or K11's dx as a table over
  the CSC view) and K2 (dw, padding slots included) held against their
  plain versions in float64 (1e-5 of scale), relaunched (bit-identical),
  the new output compared bit for bit with the other tree's, and timed as
  whole calls (device time from torch.profiler, ``chip_smoke.py``'s
  ``device_ms``: K2's memset in the other tree counts), the other tree
  before and after this one's; beside them the library call
  (``torch.sparse.mm``, ``torch.sparse.sampled_addmm``) on float32 tables.
* At each ``dual-*`` shape (``DUAL_SHAPES``: D=16 H=4, the Cora stand-in
  D=80 H=8, the same with a hub row of degree 360, the GDC-rewired Cora
  stand-in, arxiv scale D=128 H=2 and its pairs one way only; float32 and
  the bfloat16 table): K10 and K11 the same way (K11's du only on a
  directed graph), beside their library calls (``run_dual``), and also
  walked over whole rows in place of ``Graph.row_pieces``.
* Unless ``--no-candidates``, every lane group that covers the row in one
  pass (K1, K10, K11) or at most a warp (K2) is timed beside the
  chooser's pick (``kernels/lanes.py``): the measurement that sets the
  chooser.
* ``--paths l,cora,d,e,f``: instead of the above, the model paths of the
  tree at ``--root`` (this checkout by default; its kernels built in it),
  ``profile_paths``: K1's and K2's launches and device ms per batch of the
  image CLI on the default engine (l), and per epoch of the tuned Cora
  row, (d), (e) and (f), with K1's launches in table mode and K10's and
  K11's launches and ms.
* ``--variants``: K1 also built with other edge batches
  (``K1_VARIANTS``: ``-D`` values of ``csrc/csr_spmm.cu``'s
  ``GNPDE_CSR_BATCH`` and ``GNPDE_CSR_BATCH_REGS``), K10 and K11 with
  other batches, heads a pass and du and dx in two walks
  (``DUAL_VARIANTS``), timed at the chooser's lanes.

Shapes: the image CLI's batches (64 MNIST grids, D=1; 64 CIFAR grids with
diagonals, D=3), the Cora and ogbn-arxiv stand-ins after rcm (D=80,
D=162), an 8-neighbour 412 x 411 grid (D=128), the Cora stand-in (D=80,
also on a bfloat16 table), the arxiv-scale graph (D=128, also bf16), and
K11's dx in table mode on the Cora stand-in (H=8: width 10) and at arxiv
scale (H=2: width 64); the ``dual-*`` shapes above. Every line names the
card and its power limit; the numbers and ptxas's report also go to
``--out``/lanes_<tag>.json (by default ``build/probes``). Without a CUDA
device it exits nonzero.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LIB_DIR = ROOT / "build" / "probes"
SOURCES = ("csr_spmm", "edge_dot")
# K10 and K11's sources (the parent's K11 is in dual_scatter.cu)
DUAL_SOURCES = ("dual_scatter", "dual_gather")
SHAPES = ("mnist", "cifar", "cora-rcm", "arxiv-rcm", "grid", "cora",
          "arxiv", "cora-table", "arxiv-table")
# K10 / K11: graph, D, H, the tables timed ("dual-arxiv-dir": directed, K11
# writes du only)
DUAL_SHAPES = {"dual-small": ("cora", 16, 4, ("f32", "bf16")),
               "dual-cora": ("cora", 80, 8, ("f32", "bf16")),
               "dual-hub": ("cora-hub", 80, 8, ("f32",)),
               "dual-gdc": ("cora-gdc", 80, 8, ("f32",)),
               "dual-arxiv": ("arxiv", 128, 2, ("f32", "bf16")),
               "dual-arxiv-dir": ("arxiv-dir", 128, 2, ("f32",))}
REL = 1e-5
POW2 = (1, 2, 4, 8, 16, 32)
# K1 built with other edge batches (csrc/csr_spmm.cu): the batch of edges
# whose x rows load at once, at most, and the registers they may take
K1_VARIANTS = {"no batch": ("GNPDE_CSR_BATCH=1",),
               "batch in 8 registers": ("GNPDE_CSR_BATCH_REGS=8",),
               "batch in 32 registers": ("GNPDE_CSR_BATCH_REGS=32",)}
# K10 / K11 built with other values of csrc/dual_common.cuh's,
# dual_scatter.cu's and dual_gather.cu's defines: (sources, defines)
DUAL_VARIANTS = {
    "K10 batch in 12 registers": (("dual_scatter",),
                                  ("GNPDE_DUAL_BATCH_REGS=12",)),
    "K11 du batch in 16 registers": (("dual_gather",),
                                     ("GNPDE_GATHER_BATCH_REGS=16",)),
    "32 floats of heads a lane": (DUAL_SOURCES, ("GNPDE_DUAL_ACC=32",))}


def _chip_smoke():
    """``chip_smoke.py`` of this checkout (its ``device_ms``)."""
    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry_args(src: str, name: str):
    """ctypes argument types of ``extern "C" int <name>(...)`` in a
    source: pointers and ints, in order."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    if m is None:
        raise RuntimeError(f"{name}: no C entry point in the source")
    out = []
    for arg in m.group(1).split(","):
        out.append(ctypes.c_void_p if "*" in arg else ctypes.c_int)
    return out


class Tree:
    """One checkout's kernels, each source built alone and loaded by
    ctypes; ``entries`` maps each C entry point's name (``gnpde_<name>``)
    to the source that defines it (a tree without a source skips it: the
    parent's K11 lives in ``dual_scatter.cu``)."""

    def __init__(self, tag: str, root: Path, nvcc: str, defines=(),
                 sources=SOURCES):
        self.tag, self.root = tag, root
        self.csrc = root / "graph_neural_pde_tpu_torch" / "csrc"
        self.sources = [s for s in sources
                        if (self.csrc / f"{s}.cu").exists()]
        self.libs, self.cmds, self.args, self.entries = {}, {}, {}, {}
        flags = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
                 *(f"-D{d}" for d in defines))
        for s in self.sources:
            src = self.csrc / f"{s}.cu"
            lib = LIB_DIR / f"lanes_{tag}_{s}.so"
            self.cmds[s] = [nvcc, *flags, "-shared", "-o", str(lib), str(src)]
            self.libs[s] = lib
            text = src.read_text()
            for name in re.findall(r'extern "C" int gnpde_(\w+)\(', text):
                self.entries[name] = s
                self.args[name] = _entry_args(text, f"gnpde_{name}")

    def load(self, logs):
        self.fns, self.ptxas = {}, []
        for s in self.sources:
            self.ptxas += report_ptxas(self.tag, logs[s])
        for name, s in self.entries.items():
            fn = getattr(ctypes.CDLL(str(self.libs[s])), f"gnpde_{name}")
            fn.argtypes = self.args[name]
            fn.restype = ctypes.c_int
            self.fns[name] = fn

    def new_api(self, s: str) -> bool:
        """Whether the entry point takes lanes and a vector width (K1,
        K2) or the rows' pieces (K10, K11)."""
        return len(self.args[s]) > {"dual_scatter": 12,
                                    "dual_gather": 15}.get(s, 9)

    def call(self, s, *args):
        import torch
        stream = torch.cuda.current_stream().cuda_stream
        code = self.fns[s](*args, stream)
        if code:
            raise RuntimeError(f"{self.tag} {s}: cudaError_t {code}")


def report_ptxas(tag: str, log: str) -> list:
    """Registers, stack and spills of each kernel ptxas compiled, printed
    and returned."""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    rows = []
    for block in re.split(r"Compiling entry function '", log)[1:]:
        name = block.split("'", 1)[0]
        if os.path.exists(filt):
            name = subprocess.run([filt, name], capture_output=True,
                                  text=True).stdout.strip() or name
        name = re.sub(r"\(int\)|void |\(anonymous namespace\)::|<unnamed>::",
                      "", name.split("(int const*")[0])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        rows.append(dict(tree=tag, kernel=name,
                         registers=int(regs.group(1)) if regs else None,
                         stack_spills=spill.groups() if spill else None))
        print(f"[ptxas] {tag} {name}: registers "
              f"{regs.group(1) if regs else '?'}; stack / spill stores / "
              f"spill loads {spill.groups() if spill else '?'}", flush=True)
    return rows


def build_trees(trees) -> None:
    procs = {(t.tag, s): subprocess.Popen(
        t.cmds[s], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for t in trees for s in t.sources}
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for k, p in procs.items():
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {k}:\n{logs[k]}")
    for t in trees:
        t.load({s: logs[(t.tag, s)] for s in t.sources})


def image_config():
    """The image CLI's configuration (``training/run_image.py``), as
    ``chip_smoke.py``'s ``image_config``."""
    from graph_neural_pde_tpu_torch.config import Config
    return Config(block="constant", function="laplacian", method="rk4",
                  step_size=1.0, time=3.0, input_dropout=0.0, dropout=0.0,
                  lr=0.01, decay=0.0, self_loop_weight=1.0)


def graphs_for(shapes, data_dir: str, seed: int, dev, cs=None):
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.datasets import get_dataset
    from graph_neural_pde_tpu_torch.data.image import batched_grid_graph
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    from graph_neural_pde_tpu_torch.probes.gather import arxiv_scale_graph

    def tuned(row, **over):
        cfg = best_params[row].replace(**over)
        d = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc)
        return prepare_graph(cfg, d.graph)

    makers = {
        "mnist": lambda: prepare_graph(image_config(), batched_grid_graph(
            64, 28, 28, False)),
        "cifar": lambda: prepare_graph(image_config(), batched_grid_graph(
            64, 32, 32, True)),
        "grid": lambda: prepare_graph(image_config(), batched_grid_graph(
            1, 412, 411, True)),
        "cora-rcm": lambda: tuned("Cora", node_reorder="rcm"),
        "arxiv-rcm": lambda: tuned("ogbn-arxiv", node_reorder="rcm"),
        "cora": lambda: tuned("Cora"),
        "arxiv": lambda: arxiv_scale_graph(seed),
        # chip_smoke.py's: the Cora stand-in with a hub row of degree 360,
        # the GDC-rewired Cora stand-in, arxiv's pairs one way only
        "cora-hub": lambda: cs.hub_graph(tuned("Cora"), 360, seed + 230),
        "cora-gdc": lambda: cs.gdc_graph(
            best_params["Cora"].replace(rewiring="gdc"), data_dir),
        "arxiv-dir": lambda: cs.directed_random_graph(169_343, 1_166_243,
                                                      seed),
    }
    made = {}
    for s in shapes:
        key = (DUAL_SHAPES[s][0] if s in DUAL_SHAPES
               else s.replace("-table", ""))
        if key not in made:
            made[key] = makers[key]().to(dev)
    return made


# graph, D (or D and H in table mode), the table dtypes timed
def shape_dims(name):
    from graph_neural_pde_tpu_torch.config import best_params
    return {"mnist": ("mnist", 1, None), "cifar": ("cifar", 3, None),
            "cora-rcm": ("cora-rcm", best_params["Cora"].hidden_dim, None),
            "arxiv-rcm": ("arxiv-rcm", best_params["ogbn-arxiv"].hidden_dim,
                          None),
            "grid": ("grid", 128, None), "cora": ("cora", 80, None),
            "arxiv": ("arxiv", 128, None), "cora-table": ("cora", 80, 8),
            "arxiv-table": ("arxiv", 128, 2)}[name]


def candidates(kernel: str, dim: int, vec: int):
    """Lane groups to time beside the chooser's: K1's that cover the row
    in one pass, K2's up to a warp."""
    from graph_neural_pde_tpu_torch.kernels.lanes import VECS_PER_LANE
    vecs = max(dim // vec, 1)
    if kernel == "csr_spmm":
        one_pass = [g for g in POW2 if g * VECS_PER_LANE >= vecs]
        return one_pass or [32]
    return [g for g in POW2 if g <= max(vecs, 1)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="parent")
    ap.add_argument("--out", default=os.path.join("build", "probes"))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-candidates", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--paths", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    tree = ROOT if args.paths is None or args.root is None else Path(
        args.root).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("probes.lanes: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if args.paths is not None:
        return profile_paths(args, tree)
    from graph_neural_pde_tpu_torch.kernels import build
    from graph_neural_pde_tpu_torch.kernels.lanes import lanes
    from graph_neural_pde_tpu_torch.kernels.csr_spmm import csr_spmm_plain
    from graph_neural_pde_tpu_torch.kernels.edge_dot import edge_dot_plain
    from graph_neural_pde_tpu_torch.probes.gather import card, time_ms
    cs = _chip_smoke()
    line = card()
    print(f"[lanes] {torch.cuda.get_device_name(0)}; {line}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    shapes = args.shapes.split(",")
    dual_shapes = [sh for sh in shapes if sh in DUAL_SHAPES]
    shapes = [sh for sh in shapes if sh not in DUAL_SHAPES]
    sources = (SOURCES if shapes else ()) + (
        DUAL_SOURCES if dual_shapes else ())
    trees = [Tree("pr", ROOT, nvcc, sources=sources)]
    if args.root is not None:
        trees.append(Tree(args.tag, Path(args.root).resolve(), nvcc,
                          sources=sources))
    variants = [Tree(f"pr {name}", ROOT, nvcc, defines,
                     sources=("csr_spmm",))
                for name, defines in (K1_VARIANTS.items()
                                      if args.variants and shapes else ())]
    dual_variants = [Tree(f"pr {name}", ROOT, nvcc, defines, sources=srcs)
                     for name, (srcs, defines) in (
                         DUAL_VARIANTS.items()
                         if args.variants and dual_shapes else ())]
    t0 = time.perf_counter()
    build_trees(trees + variants + dual_variants)
    print(f"[build] {', '.join(t.tag for t in trees)}: "
          f"{', '.join(sources)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mine, other = trees[0], (trees[1] if len(trees) > 1 else None)
    dev = torch.device("cuda")
    results = []
    with tempfile.TemporaryDirectory() as data_dir:
        graphs = graphs_for(shapes + dual_shapes, data_dir, args.seed, dev,
                            cs)
    for gname, g in graphs.items():
        deg = (g.rowptr[1:] - g.rowptr[:-1]).float()
        print(f"[lanes] graph {gname}: N={g.num_nodes} E={g.num_valid} "
              f"capacity {g.capacity}, degree mean {deg.mean().item():.2f} "
              f"max {int(deg.max().item())}", flush=True)

    def record(**row):
        row["card"] = line
        results.append(row)
        return row

    def timed(fn):
        """Device time of one call; CUDA events where the profiler sees
        no device activity."""
        ms = cs.device_ms(fn, reps=20)
        return ms if ms is not None else time_ms(fn)

    for shape in shapes:
        gname, d, heads = shape_dims(shape)
        g = graphs[gname]
        n, nv, cap = g.num_nodes, g.num_valid, g.capacity
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        modes = (torch.float32, torch.bfloat16) if shape in (
            "cora", "arxiv") else (torch.float32,)
        for table in modes:
            tag = "" if table == torch.float32 else " bf16"
            if heads is None:
                x = torch.randn((n, d), generator=gen, device=dev).to(table)
                w = torch.rand((cap,), generator=gen, device=dev) * g.mask
                csr = (g.rowptr, g.row, g.col, w, x)
                width, rows = d, n
            else:
                # K11's dx as column_head_sum lays it out (kernels/
                # dual_scatter.py): the [N*H, D/H] table over the CSC view
                u = ((torch.rand((cap, heads), generator=gen, device=dev)
                      + 0.05) * g.mask[:, None])
                ct_num = torch.randn((n, d), generator=gen, device=dev)
                hs = torch.arange(heads, dtype=torch.int32, device=dev)
                idx = (g.row_by_col[:, None] * heads + hs).reshape(-1)
                seg = g.col_by_col.repeat_interleave(heads)
                wt = u[g.col_perm.long()].reshape(-1).contiguous()
                x = ct_num.view(n * heads, d // heads)
                csr = ((g.colptr * heads).contiguous(), seg, idx, wt, x)
                width, rows = d // heads, n
            rowptr, _, col, w_, x_ = csr
            want = csr_spmm_plain(*csr[:3], w_.double(),
                                  x_.float().double()).float()
            dims = (f"N={n} E={nv} D={d}" + (f" H={heads} table width "
                                             f"{width}" if heads else "")
                    + tag)
            dt = 0 if table == torch.float32 else 1
            outs = {}

            def k1(tree, group=None, vec=None):
                o = torch.empty((rows, width), device=dev)
                ptrs = (rowptr.data_ptr(), col.data_ptr(), w_.data_ptr(),
                        x_.data_ptr(), o.data_ptr())
                if tree.new_api("csr_spmm"):
                    tree.call("csr_spmm", *ptrs, rows, width, group, vec, dt)
                else:
                    tree.call("csr_spmm", *ptrs, rows, width, dt)
                return o

            g1, v1 = lanes("csr_spmm", width, x_)
            print(f"[lanes] K1 {shape}{tag}: chooser G={g1} V={v1} "
                  f"(row width {width})", flush=True)
            runs = [("pr", mine, g1, v1)]
            runs += [(t.tag, t, g1, v1) for t in variants]
            if not args.no_candidates:
                runs += [(f"pr G={c}", mine, c, v1)
                         for c in candidates("csr_spmm", width, v1)
                         if c != g1]
            times = {}
            order = ([("other", other, None, None)] if other else []) + runs \
                + ([("other again", other, None, None)] if other else [])
            for label, tree, grp, vec in order:
                def call(tree=tree, grp=grp, vec=vec):
                    return k1(tree, grp, vec)
                got = call()
                err, rel = cs_agree(f"K1 {label} {shape}{tag}", got, want)
                if not torch.equal(got, call()):
                    raise AssertionError(f"K1 {label} @ {shape}{tag}: two "
                                         "launches differ")
                outs[label] = got
                times[label] = timed(call)
                print(f"[lanes] K1 {label} @ {shape} {dims} G={grp} V={vec}: "
                      f"{times[label]:.4f} ms (rel err {rel:.2e}, relaunch "
                      f"bit-identical) [{line}]", flush=True)
            lib = None
            if table == torch.float32:
                mat = torch.sparse_csr_tensor(rowptr, col[:int(rowptr[-1])],
                                              w_[:int(rowptr[-1])],
                                              size=(rows, x_.shape[0]))
                lib = timed(lambda: mat @ x_)
            same = (torch.equal(outs["pr"], outs["other"]) if other
                    else None)
            print(f"[lanes] K1 {shape}{tag}: chooser {times['pr']:.4f} ms"
                  + (f", other tree {times['other']:.4f} / "
                     f"{times['other again']:.4f} ms, outputs bit-identical "
                     f"to it: {same}" if other else "")
                  + (f", library {lib:.4f} ms" if lib is not None else "")
                  + f" [{line}]", flush=True)
            record(kernel="csr_spmm", shape=shape + tag, dims=dims,
                   group=g1, vec=v1, ms=times, library_ms=lib,
                   same_as_other=same)
            if heads is not None:
                continue
            # K2: dw = ct[row] . x[col] over every slot
            ct = torch.randn((n, d), generator=gen, device=dev)
            want2 = edge_dot_plain(g.row, g.col, ct.double(),
                                   x.float().double(), nv).float()

            def k2(tree, group=None, vec=None):
                ptrs = (g.row.data_ptr(), g.col.data_ptr(), ct.data_ptr(),
                        x.data_ptr())
                if tree.new_api("edge_dot"):
                    o = torch.empty((cap,), device=dev)
                    tree.call("edge_dot", *ptrs, o.data_ptr(), nv, cap, d,
                              group, vec, dt)
                else:
                    o = torch.zeros((cap,), device=dev)
                    tree.call("edge_dot", *ptrs, o.data_ptr(), nv, d, dt)
                return o

            l2, v2 = lanes("edge_dot", d, ct, x)
            print(f"[lanes] K2 {shape}{tag}: chooser L={l2} V={v2}",
                  flush=True)
            runs = [("pr", mine, l2, v2)]
            if not args.no_candidates:
                runs += [(f"pr L={c}", mine, c, v2)
                         for c in candidates("edge_dot", d, v2) if c != l2]
            order = ([("other", other, None, None)] if other else []) + runs \
                + ([("other again", other, None, None)] if other else [])
            times, outs = {}, {}
            for label, tree, grp, vec in order:
                def call(tree=tree, grp=grp, vec=vec):
                    return k2(tree, grp, vec)
                got = call()
                err, rel = cs_agree(f"K2 {label} {shape}{tag}", got, want2)
                if nv < cap and bool((got[nv:] != 0).any()):
                    raise AssertionError(f"K2 {label} @ {shape}: nonzero "
                                         "padding slots")
                if not torch.equal(got, call()):
                    raise AssertionError(f"K2 {label} @ {shape}{tag}: two "
                                         "launches differ")
                outs[label] = got
                times[label] = timed(call)
                print(f"[lanes] K2 {label} @ {shape} {dims} L={grp} V={vec}: "
                      f"{times[label]:.4f} ms (rel err {rel:.2e}, relaunch "
                      f"bit-identical) [{line}]", flush=True)
            lib = None
            if table == torch.float32:
                pattern = torch.sparse_csr_tensor(
                    g.rowptr, g.col[:nv], torch.zeros((nv,), device=dev),
                    size=(n, n))
                x_t = x.t().contiguous()
                lib = timed(lambda: torch.sparse.sampled_addmm(
                    pattern, ct, x_t, beta=0.0))
            diff = (float((outs["pr"] - outs["other"]).abs().max())
                    if other else None)
            print(f"[lanes] K2 {shape}{tag}: chooser {times['pr']:.4f} ms"
                  + (f", other tree {times['other']:.4f} / "
                     f"{times['other again']:.4f} ms, largest difference "
                     f"from it {diff:.3e}" if other else "")
                  + (f", library {lib:.4f} ms" if lib is not None else "")
                  + f" [{line}]", flush=True)
            record(kernel="edge_dot", shape=shape + tag, dims=dims,
                   group=l2, vec=v2, ms=times, library_ms=lib,
                   max_diff_from_other=diff)
    for shape in dual_shapes:
        run_dual(shape, graphs[DUAL_SHAPES[shape][0]], mine, other,
                 dual_variants, args, line, cs, record, timed)
    dump = out / f"lanes_{args.tag}.json"
    dump.write_text(json.dumps(dict(
        ptxas=[r for t in trees + dual_variants for r in t.ptxas],
        results=results), indent=1))
    print(f"[lanes] results in {dump}", flush=True)
    return 0


def dual_candidates(dim: int, vec: int):
    """K10 / K11's lane groups built for 16-byte vectors that cover the row
    in one pass (at most 2 vectors a lane)."""
    vecs = max(dim // vec, 1)
    return [g for g in POW2 if g >= 4 and 2 * g >= vecs]


def run_dual(shape, g, mine, other, variants, args, line, cs, record,
             timed):
    """K10 and K11 at one of ``DUAL_SHAPES``: each tree's kernels on the
    same inputs (the other tree through its own C entry points: rows, not
    pieces, and K11's du zeroed first, as its wrapper did), held to their
    plain versions in float64 (1e-5 of scale), relaunched bit-identical,
    the outputs compared with the other tree's, and timed: the other tree,
    the chooser's pick, the variants, every candidate lane group, whole
    rows in place of the graph's row pieces, the other tree again; beside
    them the library calls (float32)."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import build
    from graph_neural_pde_tpu_torch.kernels.dual_scatter import (
        dual_gather_plain, dual_scatter_plain, scatter_part_floats)
    from graph_neural_pde_tpu_torch.kernels.lanes import lanes
    from graph_neural_pde_tpu_torch.ops.graph import column_pieces
    _, d, h, tables = DUAL_SHAPES[shape]
    dev = g.rowptr.device
    n, cap, nv = g.num_nodes, g.capacity, g.num_valid
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    u = ((torch.rand((cap, h), generator=gen, device=dev) + 0.05)
         * g.mask[:, None])
    x32 = torch.randn((n, d), generator=gen, device=dev)
    ct_num = torch.randn((n, h * d), generator=gen, device=dev)
    ct_den = torch.randn((n, h), generator=gen, device=dev)
    rev = g.rev
    whole = column_pieces(g.rowptr, piece=1 << 30)
    deg = (g.rowptr[1:] - g.rowptr[:-1])
    print(f"[dual] {shape}: N={n} E={nv} D={d} H={h}, "
          f"{'symmetric' if rev is not None else 'directed'}, longest row "
          f"{int(deg.max())}; {g.row_pieces.n_pieces} pieces of up to 32 "
          f"edges, {g.row_pieces.n_multi} rows of several; K10's "
          f"{g.scatter_pieces.n_pieces}, {g.scatter_pieces.n_multi} rows of "
          f"several", flush=True)
    ptr = build.ptr

    def pieces_of(pc):
        return (pc.ptr.data_ptr(), pc.col.data_ptr(), pc.slot.data_ptr(),
                pc.multi_col.data_ptr(), pc.multi_ptr.data_ptr())

    for tname in tables:
        x = x32 if tname == "f32" else x32.to(torch.bfloat16)
        dt = 0 if tname == "f32" else 1
        tag = "" if tname == "f32" else " bf16"
        csr = (g.rowptr, g.row, g.col)
        want10 = dual_scatter_plain(*csr, u.double(), x.double())
        want11 = dual_gather_plain(*csr, u.double(), x.double(),
                                   ct_num.double(), ct_den.double(),
                                   want_dx=rev is not None)

        def k10(tree, lane_pairs, pc):
            num = torch.empty((n, h * d), device=dev)
            den = torch.empty((n, h), device=dev)
            if tree.new_api("dual_scatter"):
                group, vec = lane_pairs[0]
                part = (torch.empty((pc.n_slots, scatter_part_floats(d, h)),
                                    device=dev) if pc.n_multi else None)
                tree.call("dual_scatter", *pieces_of(pc), g.col.data_ptr(),
                          u.data_ptr(), x.data_ptr(), num.data_ptr(),
                          den.data_ptr(), ptr(part), n, pc.n_pieces,
                          pc.n_multi, d, h, group, vec, dt)
            else:
                tree.call("dual_scatter", g.rowptr.data_ptr(),
                          g.col.data_ptr(), u.data_ptr(), x.data_ptr(),
                          num.data_ptr(), den.data_ptr(), n, d, h, dt)
            return num, den

        def k11(tree, lane_pairs, pc):
            new = tree.new_api("dual_gather")
            du = torch.empty_like(u) if new else torch.zeros_like(u)
            dx = None if rev is None else torch.empty((n, d), device=dev)
            if new:
                (group, vec), (dx_group, dx_vec) = lane_pairs
                part = (torch.empty((pc.n_slots, d), device=dev)
                        if pc.n_multi and rev is not None else None)
                tree.call("dual_gather", *pieces_of(pc), g.col.data_ptr(),
                          ptr(rev), u.data_ptr(), x.data_ptr(),
                          ct_num.data_ptr(), ct_den.data_ptr(),
                          du.data_ptr(), ptr(dx), ptr(part), n, pc.n_pieces,
                          pc.n_multi, cap, d, h, group, vec, dx_group,
                          dx_vec, dt)
            else:
                tree.call("dual_gather", g.rowptr.data_ptr(),
                          g.col.data_ptr(), ptr(rev), u.data_ptr(),
                          x.data_ptr(), ct_num.data_ptr(),
                          ct_den.data_ptr(), du.data_ptr(), ptr(dx), n, d,
                          h, dt)
            return (du,) if dx is None else (du, dx)

        lib = {}
        if tname == "f32":
            k10_lib, du_lib, dx_lib = cs.dual_library(g, u, x, ct_num,
                                                      ct_den)
            lib = {"K10": timed(k10_lib), "K11 du": timed(du_lib)}
            if rev is not None:
                lib["K11 dx"] = timed(dx_lib)
            lib["K11"] = lib["K11 du"] + lib.get("K11 dx", 0.0)
        for kname, fn, want, label in (
                ("dual_scatter", k10, want10, "K10"),
                ("dual_gather", k11, want11, "K11")):
            want = tuple(w for w in want if w is not None)
            # the chooser's (G, V): K10's, or K11's du walk's and dx walk's
            pairs = ((lanes(kname, d, x, heads=h),)
                     if kname == "dual_scatter"
                     else (lanes(kname, d, x, ct_num),
                           lanes(kname, d, ct_num)))
            (group, vec) = pairs[0]
            # K10 walks rows of up to SCATTER_WHOLE edges whole and cuts
            # longer ones, K11 cuts every row into pieces of COL_PIECE;
            # each also over whole rows, K10 over K11's pieces too
            pieces = (g.scatter_pieces if kname == "dual_scatter"
                      else g.row_pieces)
            runs = [("pr", mine, pairs, pieces)]
            runs += [(t.tag, t, pairs, pieces) for t in variants
                     if kname in t.entries]
            if not args.no_candidates and vec * x.element_size() == 16:
                runs += [(f"pr G={c}", mine, ((c, vec),) + pairs[1:],
                          pieces)
                         for c in dual_candidates(d, vec) if c != group]
            if (not args.no_candidates and len(pairs) > 1
                    and pairs[1][1] > 1 and rev is not None):
                runs += [(f"pr dx G={c}", mine, (pairs[0], (c, pairs[1][1])),
                          pieces)
                         for c in dual_candidates(d, pairs[1][1])
                         if c != pairs[1][0]]
            runs.append(("pr whole rows", mine, pairs, whole))
            if kname == "dual_scatter":
                runs.append(("pr pieces of 32", mine, pairs, g.row_pieces))
            order = ([("other", other, None, None)] if other
                     else []) + runs + (
                [("other again", other, None, None)] if other else [])
            times, outs = {}, {}
            for lbl, tree, lane_pairs, pc in order:
                def call(tree=tree, lane_pairs=lane_pairs, pc=pc):
                    return fn(tree, lane_pairs, pc)
                got = call()
                rel = max(cs_agree(f"{label} {lbl} {shape}{tag} [{i}]", a,
                                   b)[1]
                          for i, (a, b) in enumerate(zip(got, want)))
                again = call()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label} {lbl} @ {shape}{tag}: "
                                         "two launches differ")
                if label == "K11" and nv < cap and bool(
                        (got[0][nv:] != 0).any()):
                    raise AssertionError(f"K11 {lbl} @ {shape}{tag}: "
                                         "nonzero padding slots")
                outs[lbl] = got
                times[lbl] = timed(call)
                print(f"[dual] {label} {lbl} @ {shape}{tag} (G, V) "
                      f"{lane_pairs}: "
                      f"{times[lbl]:.4f} ms (rel err {rel:.2e}, relaunch "
                      f"bit-identical) [{line}]", flush=True)
            diff = (max(float((a - b).abs().max()) for a, b in zip(
                outs["pr"], outs["other"])) if other else None)
            lib_ms = lib.get(label)
            print(f"[dual] {label} {shape}{tag}: chooser (G, V) {pairs} "
                  f"{times['pr']:.4f} ms"
                  + (f", other tree {times['other']:.4f} / "
                     f"{times['other again']:.4f} ms, largest difference "
                     f"from it {diff:.3e}" if other else "")
                  + (f", library {lib_ms:.4f} ms" if lib_ms else "")
                  + (f" (du {lib['K11 du']:.4f} + dx "
                     f"{lib.get('K11 dx', 0.0):.4f})"
                     if label == "K11" and lib else "")
                  + f" [{line}]", flush=True)
            record(kernel=kname, shape=shape + tag,
                   dims=f"N={n} E={nv} D={d} H={h}{tag}", lanes=pairs,
                   ms=times, library_ms=lib_ms,
                   library_parts={k: v for k, v in lib.items()
                                  if k.startswith(label)},
                   max_diff_from_other=diff)


def profile_paths(args, tree: Path) -> int:
    """K1 and K2 on the model paths of the tree at ``tree``: (l), the image
    CLI on the default engine (``train_image``, one epoch of 4 batches of
    64 stand-in MNIST images, after one such call), per batch; the tuned
    Cora row and (d), (e), (f) (``chip_smoke.py``'s GRAND-nl squareplus and
    GAT on the Cora stand-in, squareplus at bench.py's widths in float32 on
    ogbn-arxiv-synthetic) per epoch, ``profile.py``'s epochs after one
    warm-up epoch: launches and device ms of K1, K2, K10 and K11 (each
    with its second pass's time, ``profile.SECOND_PASSES``), and K1's
    launches in table mode (its wrapper's count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from graph_neural_pde_tpu_torch import kernels, run
    from graph_neural_pde_tpu_torch import profile as prof
    from graph_neural_pde_tpu_torch.config import (FLOAT32, GRAND_NL_BENCH,
                                                   best_params)
    from graph_neural_pde_tpu_torch.probes.gather import card
    from graph_neural_pde_tpu_torch.training.run_image import train_image
    line = card()
    print(f"[paths] {args.tag}: package {tree}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    nl = best_params["Cora"].replace(function="transformer",
                                     block="constant", attention_norm_idx=0,
                                     square_plus=False)
    cfgs = {"cora": best_params["Cora"], "d": nl.replace(square_plus=True),
            "e": nl.replace(function="GAT"),
            "f": GRAND_NL_BENCH.replace(square_plus=True, **FLOAT32)}
    k1 = kernels.csr_spmm
    results = []
    with tempfile.TemporaryDirectory() as data_dir:
        for name in args.paths.split(","):
            if name == "l":
                def drive():
                    train_image(image_config(), data_dir, "MNIST", 64, 1,
                                max_batches=4, verbose=False, device="cuda")
                    torch.cuda.synchronize()
                drive()
                before = k1.launches
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    drive()
                events = [e for e in p.events()
                          if e.device_type == DeviceType.CUDA
                          and "csr_spmm_kernel" in e.name]
                row = dict(path="l", per="batch",
                           k1_launches=(k1.launches - before) / 4,
                           k1_device_launches=len(events) / 4,
                           k1_ms=sum(e.time_range.elapsed_us()
                                     for e in events) / 4 / 1e3)
            else:
                s = run.setup(cfgs[name], data_dir, device="cuda")
                pe = s.pos_encoding
                s.trainer.train_step(s.x, s.y, s.masks[0], pos_encoding=pe)
                s.trainer.eval_step(s.x, s.y, s.masks, pe)
                if not s.cfg.no_early:
                    s.model.apply_early(s.x, s.y, s.masks, pe)
                torch.cuda.synchronize()
                before = k1.table_launches
                phase_s, p = prof.profile_epochs(s, args.epochs)
                summ = prof.summarise(phase_s, p, args.epochs)
                ks = summ["kernels"]
                row = dict(path=name, per="epoch",
                           k1_launches=ks["csr_spmm"]["launches_per_epoch"],
                           k1_ms=ks["csr_spmm"]["device_ms_per_epoch"],
                           k1_table_launches=(k1.table_launches - before)
                           / args.epochs,
                           k2_launches=ks["edge_dot"]["launches_per_epoch"],
                           k2_ms=ks["edge_dot"]["device_ms_per_epoch"],
                           k10_launches=ks["dual_scatter"][
                               "launches_per_epoch"],
                           k10_ms=ks["dual_scatter"]["device_ms_per_epoch"],
                           k11_launches=ks["dual_gather"][
                               "launches_per_epoch"],
                           k11_ms=ks["dual_gather"]["device_ms_per_epoch"],
                           epoch_ms=summ["wall_ms_per_epoch"],
                           device_busy_ms=summ["device_busy_ms_per_epoch"],
                           idle_share=summ["device_idle_share"])
            row.update(tree=args.tag, card=line)
            results.append(row)
            print(f"[paths] {args.tag} ({name}) per {row['per']}: "
                  + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                              else f"{k} {v}" for k, v in row.items()
                              if k not in ("path", "per", "tree", "card"))
                  + f" [{line}]", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dump = out / f"lanes_paths_{args.tag}.json"
    dump.write_text(json.dumps(results, indent=1))
    print(f"[paths] results in {dump}", flush=True)
    return 0


def cs_agree(name, got, want):
    from graph_neural_pde_tpu_torch.probes.gather import agree
    return agree(name, got, want, REL)


if __name__ == "__main__":
    sys.exit(main())
