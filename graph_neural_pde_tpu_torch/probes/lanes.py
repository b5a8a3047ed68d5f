"""K1 ``csr_spmm``, K2 ``edge_dot``, K16 ``blocked_sddmm``, K10
``dual_scatter`` and K11 ``dual_gather`` on the card: their lane groups,
what the compiler made of them, and their times at every shape of their
``PERF.md`` rows, beside another tree's kernels and the library calls in
the same process.

    python graph_neural_pde_tpu_torch/probes/lanes.py [--root DIR]
        [--tag T] [--out DIR] [--shapes mnist,cifar,...,dual-arxiv]
        [--seed N] [--no-candidates] [--variants] [--sessions N]
        [--paths l,cora,d,e,f,j] [--epochs N]

* The sources of the kernels asked for (``csrc/csr_spmm.cu``,
  ``csrc/edge_dot.cu``, ``csrc/blocked.cu``; ``csrc/dual_scatter.cu``,
  ``csrc/dual_gather.cu`` for the ``dual-*`` shapes) of this checkout and,
  with ``--root DIR``, of the checkout at DIR (the parent commit unpacked
  beside this one) are each compiled alone with ``nvcc -Xptxas -v`` into
  a small library under ``build/probes``, all at once, and called through
  their C entry points, whose argument lists are read from the sources:
  the other tree's wrappers are emulated (its own lane choosers, K2's and
  K11's zeroed outputs), so both trees run on the same inputs in one
  process. ptxas's registers, stack and spills of every instantiation are
  printed.
* At each K1 shape: K1 over the node state (``rows``, with K2's dw
  beside it), as the column sum dx = A_w^T ct over a directed graph's CSC
  view (``columns``: GDC Cora, arxiv's pairs one way only), as K11's dx in
  table mode (``table``: ``column_head_sum``'s [N*H, D/H] table over the
  CSC view) and as P6's table-mode scatter on ranks 0 and 3 of a 4-way
  split (``ranks``), each held against its plain version in float64 (1e-5
  of scale), relaunched (bit-identical), compared bit for bit with the
  other tree's, and timed as whole calls (device time from
  torch.profiler, ``chip_smoke.py``'s ``device_ms``), the other tree
  before and after this one's, beside the library call
  (``torch.sparse.mm``, ``torch.segment_reduce``) on float32 tables. At
  the ``SESSION_SHAPES`` (the column sum at arxiv dir. and K11's dx at
  arxiv) the parent's K1, this K1 and ``torch.sparse.mm`` are then timed
  in ``--sessions`` profiler sessions each, in turns, the order reversed
  every other round, each session printed, and the library call's device
  kernels named.
* At the five blocked shapes (``BLOCKED_SHAPES``): K16 over the graph's
  block plan (block_n = chunk = 1024) the same way, padding slots
  included, beside ``torch.sparse.sampled_addmm``; K2 on the same
  row-sorted graph just before it.
* At each ``dual-*`` shape (``DUAL_SHAPES``: D=16 H=4, the Cora stand-in
  D=80 H=8, the same with a hub row of degree 360, the GDC-rewired Cora
  stand-in, arxiv scale D=128 H=2 and its pairs one way only; float32 and
  the bfloat16 table): K10 and K11 the same way (K11's du only on a
  directed graph), beside their library calls (``run_dual``), and also
  walked over whole rows in place of ``Graph.row_pieces``.
* Unless ``--no-candidates``, every lane group that covers the row in one
  pass (K1, K10, K11) or at most a warp (K2, K16) is timed beside the
  chooser's pick (``kernels/lanes.py``), and K1 also at the other staging
  depth: the measurements that set the choosers.
* ``--paths l,cora,d,e,f,j``: instead of the above, the model paths of the
  tree at ``--root`` (this checkout by default; its kernels built in it),
  ``profile_paths``: K1's and K2's launches and device ms per batch of the
  image CLI on the default engine (l), and per epoch of the tuned Cora
  row, (d), (e), (f) and (j) (the tuned Cora row on the blocked engine
  after rcm), with K1's launches in table mode and K10's, K11's, K15's and
  K16's launches and ms.
* ``--variants``: K1 also built with other edge batches (``K1_VARIANTS``:
  ``-D`` values of ``csrc/csr_spmm.cu``'s ``GNPDE_CSR_BATCH`` and
  ``GNPDE_CSR_BATCH_REGS``), K10 and K11 with other batches, heads a pass
  and du and dx in two walks (``DUAL_VARIANTS``), timed at the choosers'
  picks.

Shapes: the image CLI's batches (64 MNIST grids, D=1; 64 CIFAR grids with
diagonals, D=3), the Cora and ogbn-arxiv stand-ins after rcm (D=80,
D=162), an 8-neighbour 412 x 411 grid (D=128), the Cora stand-in (D=80,
also on a bfloat16 table), the arxiv-scale graph (D=128, also bf16), K11's
dx in table mode on the Cora stand-in (H=8: width 10) and at arxiv scale
(H=2: width 64), the column sums of the GDC-rewired Cora stand-in (D=80)
and of arxiv's pairs one way only (arxiv dir., D=128), and P6's scatter
on two ranks of the arxiv-scale 4-way split (D=128); the ``dual-*``
shapes above. Every line names the card and its power limit; the numbers
and ptxas's report also go to ``--out``/lanes_<tag>.json (by default
``build/probes``). Without a CUDA device it exits nonzero.
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
SOURCES = ("csr_spmm", "edge_dot", "blocked")
# K10 and K11's sources (the parent's K11 is in dual_scatter.cu)
DUAL_SOURCES = ("dual_scatter", "dual_gather")
SHAPES = ("mnist", "cifar", "cora-rcm", "arxiv-rcm", "grid", "cora",
          "arxiv", "cora-table", "arxiv-table", "cora-gdc", "arxiv-dir",
          "arxiv-ranks")
# K16 runs at these K1 / K2 shapes (chip_smoke.py's blocked graphs)
BLOCKED_SHAPES = ("mnist", "cifar", "cora-rcm", "arxiv-rcm", "grid")
# K1 and torch.sparse.mm in alternating profiler sessions (Part 0)
SESSION_SHAPES = ("arxiv-dir", "arxiv-table")
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
K1_VARIANTS = {"batch in 8 registers": ("GNPDE_CSR_BATCH_REGS=8",),
               "batch of 8 in 32 registers": ("GNPDE_CSR_BATCH=8",
                                              "GNPDE_CSR_BATCH_REGS=32")}
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


def build_trees(trees, optional=()) -> list:
    """Every tree's sources built at once; a tree of ``optional`` (the
    variants) that fails to build is reported and left out, any other
    failure raises with the first errors of every failed source. Returns
    the trees built."""
    procs = {(t.tag, s): subprocess.Popen(
        t.cmds[s], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for t in trees for s in t.sources}
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    failed = {k for k, p in procs.items() if p.returncode}
    errors = {k: [ln for ln in logs[k].splitlines() if "error" in ln][:12]
              for k in failed}
    for k in failed:
        print(f"[build] nvcc failed for {k}: " + "\n".join(errors[k]),
              flush=True)
    fatal = [k for k in failed if not any(t.tag == k[0] for t in optional)]
    if fatal:
        raise RuntimeError(f"nvcc failed for {fatal}")
    built = [t for t in trees
             if not any((t.tag, s) in failed for s in t.sources)]
    for t in built:
        t.load({s: logs[(t.tag, s)] for s in t.sources})
    return built


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
        key = DUAL_SHAPES[s][0] if s in DUAL_SHAPES else shape_dims(s)[0]
        if key not in made:
            made[key] = makers[key]().to(dev)
    return made


# K1's shapes: graph, D, K11's heads (table mode), and what K1 walks:
# "rows" the node state over the CSR (with K2's dw beside it), "columns"
# the column sum dx = A_w^T ct over the CSC view, "table" K11's dx as
# column_head_sum lays it out (the [N*H, D/H] table over the CSC view),
# "ranks" P6's table-mode scatter on ranks 0 and 3 of a 4-way split
def shape_dims(name):
    from graph_neural_pde_tpu_torch.config import best_params
    return {"mnist": ("mnist", 1, None, "rows"),
            "cifar": ("cifar", 3, None, "rows"),
            "cora-rcm": ("cora-rcm", best_params["Cora"].hidden_dim, None,
                         "rows"),
            "arxiv-rcm": ("arxiv-rcm",
                          best_params["ogbn-arxiv"].hidden_dim, None,
                          "rows"),
            "grid": ("grid", 128, None, "rows"),
            "cora": ("cora", 80, None, "rows"),
            "arxiv": ("arxiv", 128, None, "rows"),
            "cora-table": ("cora", 80, 8, "table"),
            "arxiv-table": ("arxiv", 128, 2, "table"),
            "cora-gdc": ("cora-gdc", 80, None, "columns"),
            "arxiv-dir": ("arxiv-dir", 128, None, "columns"),
            "arxiv-ranks": ("arxiv", 128, None, "ranks")}[name]


def candidates(kernel: str, dim: int, vec: int):
    """Lane groups to time beside the chooser's: K1's that cover the row
    in one pass, K2's (and K16's) up to a warp."""
    from graph_neural_pde_tpu_torch.kernels.lanes import VECS_PER_LANE
    vecs = max(dim // vec, 1)
    if kernel == "csr_spmm":
        one_pass = [g for g in POW2 if g * VECS_PER_LANE >= vecs]
        return one_pass or [32]
    return [g for g in POW2 if g <= max(vecs, 1)]


def k1_operands(shape, g, gen, dev):
    """K1's operand sets at one shape: (tag, (rowptr, row, col, w, x), rows,
    width, valid edges, library call or None). The library calls:
    ``torch.sparse.mm`` of the CSR (rows), of the transposed CSR (columns),
    of the [N, N*H] matrix (table); ``torch.segment_reduce`` (ranks)."""
    import torch
    _, d, heads, walk = shape_dims(shape)
    n, nv, cap = g.num_nodes, g.num_valid, g.capacity
    sets = []
    if walk == "rows":
        w = torch.rand((cap,), generator=gen, device=dev) * g.mask
        x32 = torch.randn((n, d), generator=gen, device=dev)
        mat = torch.sparse_csr_tensor(g.rowptr, g.col[:nv], w[:nv],
                                      size=(n, n))
        sets.append(("", (g.rowptr, g.row, g.col, w, x32), n, d, nv,
                     lambda: mat @ x32))
        if shape in ("cora", "arxiv"):
            xb = x32.to(torch.bfloat16)
            sets.append((" bf16", (g.rowptr, g.row, g.col, w, xb), n, d, nv,
                         None))
    elif walk == "columns":
        ct = torch.randn((n, d), generator=gen, device=dev)
        w = torch.rand((cap,), generator=gen, device=dev) * g.mask
        w_col = w[g.col_perm.long()]
        mat = torch.sparse_csr_tensor(g.colptr, g.row_by_col[:nv],
                                      w_col[:nv], size=(n, n))
        sets.append(("", (g.colptr, g.col_by_col, g.row_by_col, w_col, ct),
                     n, d, nv, lambda: torch.sparse.mm(mat, ct)))
    elif walk == "table":
        u = ((torch.rand((cap, heads), generator=gen, device=dev) + 0.05)
             * g.mask[:, None])
        ct_num = torch.randn((n, d), generator=gen, device=dev)
        hs = torch.arange(heads, dtype=torch.int32, device=dev)
        idx = (g.row_by_col[:, None] * heads + hs).reshape(-1)
        seg = g.col_by_col.repeat_interleave(heads)
        wt = u[g.col_perm.long()].reshape(-1).contiguous()
        x = ct_num.view(n * heads, d // heads)
        ptr = (g.colptr * heads).contiguous()
        mat = torch.sparse_csr_tensor(ptr, idx[:nv * heads],
                                      wt[:nv * heads], size=(n, n * heads))
        sets.append(("", (ptr, seg, idx, wt, x), n, d // heads, nv * heads,
                     lambda: torch.sparse.mm(mat, x)))
    else:
        from graph_neural_pde_tpu_torch.parallel import split_mesh
        from graph_neural_pde_tpu_torch.parallel.shard_spmm import \
            stripe_shards
        shards = stripe_shards(split_mesh(4, dev), g)
        for r in (0, 3):
            plan = shards[r].plan
            vals = torch.randn((plan.n_valid, d), generator=gen, device=dev)
            lengths = (plan.rowptr[1:] - plan.rowptr[:-1]).long()
            sets.append((f" rank {r}", (plan.rowptr, plan.row, plan.slots,
                                        plan.valid, vals),
                         plan.num_nodes, d, plan.n_valid,
                         lambda vals=vals, lengths=lengths:
                         torch.segment_reduce(vals, "sum",
                                              lengths=lengths)))
    return sets


def sessions(label_fns, n, cs, line, tag):
    """Part 0's yardstick: each (label, fn) timed in ``n`` profiler
    sessions (``chip_smoke.py``'s ``device_ms``, 20 calls each) in turns,
    the order reversed every other round; every session's time printed,
    and each label's first, median, fastest and slowest."""
    import statistics
    times = {label: [] for label, _ in label_fns}
    for i in range(n):
        order = label_fns if i % 2 == 0 else label_fns[::-1]
        for label, fn in order:
            ms = cs.device_ms(fn, reps=20)
            times[label].append(ms)
            turn = "forward" if i % 2 == 0 else "reversed"
            print(f"[sessions] {tag} round {i} ({turn} order) {label}: "
                  f"{ms:.4f} ms [{line}]", flush=True)
    summary = {}
    for label, ts in times.items():
        summary[label] = dict(sessions=ts, first=ts[0],
                              median=statistics.median(ts), fastest=min(ts),
                              slowest=max(ts))
        print(f"[sessions] {tag} {label}: first {ts[0]:.4f}, median "
              f"{statistics.median(ts):.4f}, fastest {min(ts):.4f}, "
              f"slowest {max(ts):.4f} ms over {n} sessions [{line}]",
              flush=True)
    return summary


def k1_call(tree, csr, rows, width, dt, group=None, vec=None, stage=None):
    """One K1 launch of ``tree`` on ``csr`` through its own C entry point,
    with the arguments it takes (an older one takes no staging depth, or
    no lanes either); the tree's own chooser where ``group`` is None."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.lanes import lanes
    rowptr, _, col, w, x = csr
    o = torch.empty((rows, width), device=x.device)
    ptrs = (rowptr.data_ptr(), col.data_ptr(), w.data_ptr(), x.data_ptr(),
            o.data_ptr())
    arity = len(tree.args["csr_spmm"])
    if arity == 12:
        tree.call("csr_spmm", *ptrs, rows, width, group, vec, stage, dt)
    elif arity == 11:
        if group is None:       # the lanes alone, as its wrapper chose them
            group, vec = lanes("csr_spmm", width, x)
        tree.call("csr_spmm", *ptrs, rows, width, group, vec, dt)
    else:
        tree.call("csr_spmm", *ptrs, rows, width, dt)
    return o


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="parent")
    ap.add_argument("--out", default=os.path.join("build", "probes"))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-candidates", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--sessions", type=int, default=5)
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
    from graph_neural_pde_tpu_torch.kernels.csr_spmm import csr_spmm_plain
    from graph_neural_pde_tpu_torch.kernels.edge_dot import edge_dot_plain
    from graph_neural_pde_tpu_torch.kernels.lanes import (CSR_LONG_STAGE,
                                                          csr_design)
    from graph_neural_pde_tpu_torch.probes.gather import card, time_ms
    cs = _chip_smoke()
    line = card()
    print(f"[lanes] {torch.cuda.get_device_name(0)}; {line}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
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
    built = build_trees(trees + variants + dual_variants,
                        optional=variants + dual_variants)
    variants = [t for t in variants if t in built]
    dual_variants = [t for t in dual_variants if t in built]
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
        cols = ""
        if g.colptr is not None:
            cdeg = (g.colptr[1:] - g.colptr[:-1]).float()
            cols = (f", column length mean {cdeg.mean().item():.2f} max "
                    f"{int(cdeg.max().item())}")
        print(f"[lanes] graph {gname}: N={g.num_nodes} E={g.num_valid} "
              f"capacity {g.capacity}, row length mean "
              f"{deg.mean().item():.2f} max {int(deg.max().item())}{cols}",
              flush=True)

    def record(**row):
        row["card"] = line
        results.append(row)
        return row

    def timed(fn):
        """Device time of one call; CUDA events where the profiler sees
        no device activity."""
        ms = cs.device_ms(fn, reps=20)
        return ms if ms is not None else time_ms(fn)

    def bracket(runs):
        """The other tree first and last around ``runs``."""
        return ([("other", other) + (None,) * (len(runs[0]) - 2)] if other
                else []) + runs + (
            [("other again", other) + (None,) * (len(runs[0]) - 2)]
            if other else [])

    for shape in shapes:
        gname, d, heads, walk_kind = shape_dims(shape)
        g = graphs[gname]
        n, nv, cap = g.num_nodes, g.num_valid, g.capacity
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        for tag, csr, rows, width, edges, lib_fn in k1_operands(shape, g,
                                                               gen, dev):
            x_ = csr[4]
            dt = 0 if x_.dtype == torch.float32 else 1
            want = csr_spmm_plain(*csr[:3], csr[3].double(),
                                  x_.float().double()).float()
            dims = (f"rows={rows} E={edges} D={d}"
                    + (f" H={heads} table width {width}" if heads else "")
                    + f" ({walk_kind}){tag}")
            g1, v1, s1 = csr_design(width, edges / rows, x_)
            print(f"[lanes] K1 {shape}{tag}: chooser G={g1} V={v1} S={s1} "
                  f"(row width {width}, mean row {edges / rows:.2f} edges)",
                  flush=True)
            s_other = CSR_LONG_STAGE if s1 == 1 else 1
            runs = [("pr", mine, g1, v1, s1),
                    (f"pr S={s_other}", mine, g1, v1, s_other)]
            runs += [(t.tag, t, g1, v1, s1) for t in variants]
            if not args.no_candidates:
                runs += [(f"pr G={c}", mine, c, v1, s1)
                         for c in candidates("csr_spmm", width, v1)
                         if c != g1]
            times, outs = {}, {}
            for label, tree, grp, vec, stg in bracket(runs):
                def call(tree=tree, grp=grp, vec=vec, stg=stg):
                    return k1_call(tree, csr, rows, width, dt, grp, vec, stg)
                got = call()
                err, rel = cs_agree(f"K1 {label} {shape}{tag}", got, want)
                if not torch.equal(got, call()):
                    raise AssertionError(f"K1 {label} @ {shape}{tag}: two "
                                         "launches differ")
                outs[label] = got
                times[label] = timed(call)
                print(f"[lanes] K1 {label} @ {shape} {dims} G={grp} V={vec} "
                      f"S={stg}: {times[label]:.4f} ms (rel err {rel:.2e}, "
                      f"relaunch bit-identical) [{line}]", flush=True)
            lib = timed(lib_fn) if lib_fn is not None else None
            same = {label: torch.equal(o, outs["other"])
                    for label, o in outs.items()} if other else None
            print(f"[lanes] K1 {shape}{tag}: chooser {times['pr']:.4f} ms"
                  + (f", other tree {times['other']:.4f} / "
                     f"{times['other again']:.4f} ms, every output "
                     f"bit-identical to it: {all(same.values())}"
                     if other else "")
                  + (f", library {lib:.4f} ms" if lib is not None else "")
                  + f" [{line}]", flush=True)
            row = record(kernel="csr_spmm", shape=shape + tag, dims=dims,
                         group=g1, vec=v1, stage=s1, ms=times,
                         library_ms=lib, same_as_other=same)
            if lib_fn is not None and shape in SESSION_SHAPES \
                    and args.sessions:
                names = cs.device_kernel_names(lib_fn)
                print(f"[sessions] {shape}{tag}: the library call's device "
                      f"kernels {names}", flush=True)
                fns = ([("parent K1", lambda: k1_call(other, csr, rows,
                                                      width, dt))]
                       if other else [])
                fns += [("K1", lambda: k1_call(mine, csr, rows, width, dt,
                                               g1, v1, s1)),
                        ("torch.sparse.mm", lib_fn)]
                row["sessions"] = sessions(fns, args.sessions, cs, line,
                                           shape + tag)
                row["library_kernels"] = names
        if walk_kind != "rows":
            continue
        x = torch.randn((n, d), generator=gen, device=dev)
        ct = torch.randn((n, d), generator=gen, device=dev)
        run_k2(shape, g, d, ct, x, mine, other, args, line, record, timed,
               bracket)
        if shape in BLOCKED_SHAPES:
            run_k16(shape, g, d, ct, x, mine, other, args, line, record,
                    timed, bracket)
    for shape in dual_shapes:
        run_dual(shape, graphs[DUAL_SHAPES[shape][0]], mine, other,
                 dual_variants, args, line, cs, record, timed)
    dump = out / f"lanes_{args.tag}.json"
    dump.write_text(json.dumps(dict(
        ptxas=[r for t in trees + variants + dual_variants
               for r in t.ptxas],
        results=results), indent=1))
    print(f"[lanes] results in {dump}", flush=True)
    return 0


def run_k2(shape, g, d, ct, x, mine, other, args, line, record, timed,
           bracket):
    """K2's dw = ct[row] . x[col] over every slot of a row-sorted graph,
    the chooser's L and each candidate, beside the other tree's and
    ``torch.sparse.sampled_addmm``."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.edge_dot import edge_dot_plain
    from graph_neural_pde_tpu_torch.kernels.lanes import lanes
    dev = x.device
    n, nv, cap = g.num_nodes, g.num_valid, g.capacity
    want = edge_dot_plain(g.row, g.col, ct.double(), x.double(), nv).float()
    dims = f"N={n} E={nv} D={d}"

    def k2(tree, group=None, vec=None):
        ptrs = (g.row.data_ptr(), g.col.data_ptr(), ct.data_ptr(),
                x.data_ptr())
        if group is None:           # K2's chooser, the same in both trees
            group, vec = lanes("edge_dot", d, ct, x)
        if tree.new_api("edge_dot"):
            o = torch.empty((cap,), device=dev)
            tree.call("edge_dot", *ptrs, o.data_ptr(), nv, cap, d, group,
                      vec, 0)
        else:
            o = torch.zeros((cap,), device=dev)
            tree.call("edge_dot", *ptrs, o.data_ptr(), nv, d, 0)
        return o

    l2, v2 = lanes("edge_dot", d, ct, x)
    print(f"[lanes] K2 {shape}: chooser L={l2} V={v2}", flush=True)
    runs = [("pr", mine, l2, v2)]
    if not args.no_candidates:
        runs += [(f"pr L={c}", mine, c, v2)
                 for c in candidates("edge_dot", d, v2) if c != l2]
    times, outs = {}, {}
    for label, tree, grp, vec in bracket(runs):
        def call(tree=tree, grp=grp, vec=vec):
            return k2(tree, grp, vec)
        got = call()
        err, rel = cs_agree(f"K2 {label} {shape}", got, want)
        if nv < cap and bool((got[nv:] != 0).any()):
            raise AssertionError(f"K2 {label} @ {shape}: nonzero padding "
                                 "slots")
        if not torch.equal(got, call()):
            raise AssertionError(f"K2 {label} @ {shape}: two launches "
                                 "differ")
        outs[label] = got
        times[label] = timed(call)
        print(f"[lanes] K2 {label} @ {shape} {dims} L={grp} V={vec}: "
              f"{times[label]:.4f} ms (rel err {rel:.2e}, relaunch "
              f"bit-identical) [{line}]", flush=True)
    pattern = torch.sparse_csr_tensor(g.rowptr, g.col[:nv],
                                      torch.zeros((nv,), device=dev),
                                      size=(n, n))
    x_t = x.t().contiguous()
    lib = timed(lambda: torch.sparse.sampled_addmm(pattern, ct, x_t,
                                                   beta=0.0))
    diff = (float((outs["pr"] - outs["other"]).abs().max()) if other
            else None)
    print(f"[lanes] K2 {shape}: chooser {times['pr']:.4f} ms"
          + (f", other tree {times['other']:.4f} / "
             f"{times['other again']:.4f} ms, largest difference from it "
             f"{diff:.3e}" if other else "")
          + f", library {lib:.4f} ms [{line}]", flush=True)
    record(kernel="edge_dot", shape=shape, dims=dims, group=l2, vec=v2,
           ms=times, library_ms=lib, max_diff_from_other=diff)


def run_k16(shape, g, d, ct, x, mine, other, args, line, record, timed,
            bracket):
    """K16 over the block plan of the graph's valid edges (block_n = chunk
    = 1024, as ``chip_smoke.py`` plans them): held to its plain version in
    float64 (1e-5 of scale, padding slots included), relaunched
    bit-identical; the chooser's L and every candidate, the other tree's,
    and ``torch.sparse.sampled_addmm`` on the same pattern."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.blocked import (
        blocked_layout, blocked_sddmm_plain, make_plan_pair)
    from graph_neural_pde_tpu_torch.kernels.lanes import lanes
    from graph_neural_pde_tpu_torch.ops.reorder import plan_occupancy
    dev = x.device
    nv = g.num_valid
    plans = make_plan_pair(g.row[:nv].cpu().numpy(),
                           g.col[:nv].cpu().numpy(), num_nodes=g.num_nodes,
                           block_n=1024, chunk=1024)
    lay = blocked_layout(plans.fwd, dev)
    npad, cap = lay.num_nodes, lay.capacity
    n_chunks = lay.chunk_rows.shape[0]
    a = torch.zeros((npad, d), device=dev)
    b = torch.zeros((npad, d), device=dev)
    a[:g.num_nodes], b[:g.num_nodes] = ct, x
    want = blocked_sddmm_plain(lay, a.double(), b.double()).float()
    n_pad = int(cap - lay.slot.shape[0])
    occ = plan_occupancy(plans.fwd)
    dims = (f"N_pad={npad} slots={cap - n_pad} cap={cap} ({n_pad} "
            f"padding, {occ['n_chunks']} chunks) D={d}")
    ptr = lambda t: t.data_ptr()  # noqa: E731

    def k16(tree, group=None, vec=None):
        o = torch.empty((cap,), device=dev)
        if len(tree.args["blocked_sddmm"]) == 13:   # every slot, no vectors
            tree.call("blocked_sddmm", ptr(lay.chunk_rows),
                      ptr(lay.chunk_cols), ptr(lay.row_local),
                      ptr(lay.col_local), ptr(a), ptr(b), ptr(o), cap,
                      lay.chunk, lay.block_n, d,
                      1 << (min(d, 32).bit_length() - 1))
        else:
            tree.call("blocked_sddmm", ptr(lay.row), ptr(lay.col),
                      ptr(lay.slot), ptr(lay.chunk_rows),
                      ptr(lay.chunk_cols), ptr(lay.chunk_valid), ptr(a),
                      ptr(b), ptr(o), lay.slot.shape[0], n_chunks,
                      lay.chunk, lay.block_n, d, group, vec)
        return o

    l16, v16 = lanes("edge_dot", d, a, b)       # K16's: K2's
    print(f"[k16] {shape}: chooser L={l16} V={v16}; {dims}", flush=True)
    runs = [("pr", mine, l16, v16)]
    if not args.no_candidates:
        runs += [(f"pr L={c}", mine, c, v16)
                 for c in candidates("edge_dot", d, v16) if c != l16]
    times, outs = {}, {}
    for label, tree, grp, vec in bracket(runs):
        def call(tree=tree, grp=grp, vec=vec):
            return k16(tree, grp, vec)
        got = call()
        err, rel = cs_agree(f"K16 {label} {shape}", got, want)
        if not torch.equal(got, call()):
            raise AssertionError(f"K16 {label} @ {shape}: two launches "
                                 "differ")
        outs[label] = got
        times[label] = timed(call)
        print(f"[k16] K16 {label} @ {shape} {dims} L={grp} V={vec}: "
              f"{times[label]:.4f} ms (rel err {rel:.2e}, relaunch "
              f"bit-identical) [{line}]", flush=True)
    vrows = torch.as_tensor(plans.fwd.row[plans.fwd.valid], device=dev)
    vcols = torch.as_tensor(plans.fwd.col[plans.fwd.valid], device=dev)
    idx = torch.stack([vrows.long(), vcols.long()])
    pattern = torch.sparse_coo_tensor(
        idx, torch.ones(idx.shape[1], device=dev), (npad, npad)) \
        .coalesce().to_sparse_csr()
    b_t = b.t().contiguous()
    lib = timed(lambda: torch.sparse.sampled_addmm(pattern, a, b_t,
                                                   beta=0.0))
    diff = (float((outs["pr"] - outs["other"]).abs().max()) if other
            else None)
    print(f"[k16] K16 {shape}: chooser {times['pr']:.4f} ms"
          + (f", other tree {times['other']:.4f} / "
             f"{times['other again']:.4f} ms, largest difference from it "
             f"{diff:.3e}" if other else "")
          + f", library {lib:.4f} ms [{line}]", flush=True)
    record(kernel="blocked_sddmm", shape=shape, dims=dims, group=l16,
           vec=v16, ms=times, library_ms=lib, max_diff_from_other=diff,
           padding_slots=n_pad, chunks=n_chunks)


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
    Cora row, (d), (e), (f) (``chip_smoke.py``'s GRAND-nl squareplus and
    GAT on the Cora stand-in, squareplus at bench.py's widths in float32 on
    ogbn-arxiv-synthetic) and (j) (the tuned Cora row on the blocked engine
    after rcm) per epoch, ``profile.py``'s epochs after one warm-up epoch:
    launches and device ms of K1, K2, K10, K11, K15 and K16 where the path
    runs them (each with its second pass's time, ``profile.SECOND_PASSES``),
    and K1's launches in table mode (its wrapper's count)."""
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
            "f": GRAND_NL_BENCH.replace(square_plus=True, **FLOAT32),
            "j": best_params["Cora"].replace(spmm_impl="pallas_blocked",
                                             node_reorder="rcm")}
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
                           k1_table_launches=(k1.table_launches - before)
                           / args.epochs,
                           epoch_ms=summ["wall_ms_per_epoch"],
                           device_busy_ms=summ["device_busy_ms_per_epoch"],
                           idle_share=summ["device_idle_share"])
                for tag, kname in PATH_KERNELS:
                    if kname in ks:
                        row[f"{tag}_launches"] = ks[kname][
                            "launches_per_epoch"]
                        row[f"{tag}_ms"] = ks[kname]["device_ms_per_epoch"]
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


# the kernels --paths reports, each launches and device ms per epoch
PATH_KERNELS = (("k1", "csr_spmm"), ("k2", "edge_dot"),
                ("k10", "dual_scatter"), ("k11", "dual_gather"),
                ("k15", "blocked_spmm"), ("k16", "blocked_sddmm"))


def cs_agree(name, got, want):
    from graph_neural_pde_tpu_torch.probes.gather import agree
    return agree(name, got, want, REL)


if __name__ == "__main__":
    sys.exit(main())
