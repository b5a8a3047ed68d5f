"""The node projections and the dKw / dKb reduction (``csrc/dense.cuh``)
on the card: what the compiler made of them, and their whole-call times
at the shapes of their ``PERF.md`` rows, beside another tree's in the
same process.

    python graph_neural_pde_tpu_torch/probes/dense.py [--root DIR]
        [--tag T] [--out DIR] [--shapes cora,arxiv,...] [--seed N]
        [--waves 1,4] [--variants] [--paths a,q,v] [--epochs N]
        [--fused cora,arxiv,blend,bf16,directed]

* A small source that includes a checkout's ``csrc/fused_common.cuh`` and
  exposes its ``launch_tables`` and ``launch_outer_reduce`` (the device
  code every fused entry point runs) is compiled with ``nvcc -Xptxas -v``
  for this checkout and, with ``--root DIR``, for the checkout at DIR (the
  parent commit unpacked beside this one), both at once; ptxas's
  registers, stack and spills of each instantiation are printed. The
  other tree's reduction is called as its wrappers called it (partials
  zeroed first, ``min(2048, rows / 64)`` blocks).
* Node tables (``TABLE_SHAPES``: the Cora stand-in's N at D=80 ATT=128,
  arxiv scale at D=128 ATT=32 and at BLEND's ATT=64, kNN Cora BLEND at
  D=96 ATT=256) in the three TABLES modes (0 float32; 1 a float32 x beside
  the bfloat16 column table; 2 both bfloat16): held to the float64 plain
  version (1e-5 of scale), the bfloat16 k table bit for bit, this tree's
  tables against the other's bit for bit, relaunched bit-identical, timed
  (whole call, device time from torch.profiler as ``chip_smoke.py``'s
  ``device_ms``), beside two ``torch.addmm`` calls (float32 only).
* The reduction (``REDUCE_SHAPES``: over the nodes, K9 / K14 / K17's form,
  at the same four widths, float32 and bfloat16 x; over arxiv dir.'s
  slots gathered through a random column index, K8 with dxg's form; over
  the bench oracle's 4,096 payload rows at D=128 ATT=64, K8's per-head
  form): both trees held to the float64 plain version (each error
  printed: the other tree sums with Kahan chains of ~83 terms, this one in
  stages of 32 rows), relaunched bit-identical, timed at
  ``kernels.dense.reduce_blocks`` and at ``--waves`` other block counts
  (blocks an SM), beside ``torch.mm(x.T, dk)`` and ``dk.sum(0)`` (float32
  x, not gathered).
* ``--variants``: this checkout also built with ``VARIANTS``' defines of
  ``csrc/dense.cuh`` (the pipelines' stages), each checked and timed
  beside it.
* ``--paths a,q,v``: instead of the above, the tree's own package
  (``--root``, this checkout by default; its kernels built in it) trains
  ``PERF.md``'s paths (a) (``GRAND_NL_BENCH`` in float32), (q) (a) at
  BLEND widths over the seeded encoding, (v) (a) at bench precision:
  ``profile.py``'s epochs after a warm-up epoch, per epoch the launches
  and device ms of the projections, the reduction, the fused kernels'
  walks (their merges included), the fills (the zeroed partials and
  scratch) and the epoch. Run parent, PR, PR, parent in one call.
* ``--fused``: instead of the above, the tree's own package (as with
  ``--paths``) runs ``chip_smoke.py``'s checks of the fused kernels, each
  whole call held to its plain version and timed (device time): K6, K7,
  K8, K9 (``check_fused_kernels``) and K12-K14 (``check_norm1_kernels``)
  on the Cora stand-in at D=80 ATT=128 H=8 (``cora``), at arxiv scale at
  D=128 ATT=32 H=2 (``arxiv``), at BLEND's ATT=2 x 32 (``blend``) and on
  the bfloat16 column table with the bench's bfloat16 row side
  (``bf16``), and K17 with K8 without dxg on the directed arxiv-scale
  graph (``directed``, ``check_column_rhs_kernels``). Run parent, PR, PR,
  parent in one call, as with ``--paths``.

Every line names the card and its power limit; the numbers and ptxas's
report also go to ``--out``/dense_<tag>.json (``build/probes`` by
default). Without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LIB_DIR = ROOT / "build" / "probes"
REL = 1e-5

SHIM = r"""
#include "fused_common.cuh"

extern "C" int probe_tables(const void* x, const void* xcol, const void* qw,
                            const void* qb, const void* kw, const void* kb,
                            void* qtab, void* ktab, int n, int dim, int att,
                            int tables, void* stream) {
  cudaError_t err = launch_tables(tables, x, tables == kTablesF32 ? x : xcol,
                                  qw, qb, kw, kb, qtab, ktab, n, dim, att,
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_reduce(const void* x, const void* idx, const void* dk,
                            void* partials, int rows, int dim, int att,
                            int blocks, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_outer_reduce(static_cast<const __nv_bfloat16*>(x),
                        static_cast<const int*>(idx),
                        static_cast<const float*>(dk),
                        static_cast<float*>(partials), rows, blocks, dim,
                        att, s);
  else
    launch_outer_reduce(static_cast<const float*>(x),
                        static_cast<const int*>(idx),
                        static_cast<const float*>(dk),
                        static_cast<float*>(partials), rows, blocks, dim,
                        att, s);
  return static_cast<int>(cudaGetLastError());
}
"""

# name: (N, D, ATT)
TABLE_SHAPES = {"tiny": (64, 80, 128), "tiny-d32": (64, 32, 128),
                "tiny-d128": (64, 128, 128),
                "cora": (2_708, 80, 128), "arxiv": (169_343, 128, 32),
                "arxiv-blend": (169_343, 128, 64),
                "knn-blend": (2_708, 96, 256)}
# name: (rows, x rows, D, ATT, gathered)
REDUCE_SHAPES = {"tiny": (32, 32, 80, 128, False),
                 "cora": (2_708, 2_708, 80, 128, False),
                 "arxiv": (169_343, 169_343, 128, 32, False),
                 "arxiv-blend": (169_343, 169_343, 128, 64, False),
                 "knn-blend": (2_708, 2_708, 96, 256, False),
                 "arxiv-dir-slots": (1_335_579, 169_343, 128, 32, True),
                 "oracle-edges": (4_096, 4_096, 128, 64, False)}
# name: defines of csrc/dense.cuh
VARIANTS = {"stages 2": ("GNPDE_PROJ_STAGES=2", "GNPDE_REDUCE_STAGES=2"),
            "stages 4": ("GNPDE_PROJ_STAGES=4", "GNPDE_REDUCE_STAGES=4")}
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def _chip_smoke():
    """``chip_smoke.py`` of this probe's checkout (its ``device_ms`` and
    checks), whichever tree's package is imported."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Tree:
    """One checkout's ``launch_tables`` and ``launch_outer_reduce``,
    compiled into a small library of their own."""

    def __init__(self, tag: str, root: Path, nvcc: str, defines=()):
        self.tag, self.root = tag, root
        csrc = root / "graph_neural_pde_tpu_torch" / "csrc"
        self.new = (csrc / "dense.cuh").exists()
        stem = "dense_shim_" + tag.replace(" ", "_")
        self.src = LIB_DIR / f"{stem}.cu"
        self.lib = LIB_DIR / f"{stem}.so"
        self.cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-lineinfo", "-Xptxas=-v", f"-I{csrc}",
                    *(f"-D{d}" for d in defines), "-shared", "-o",
                    str(self.lib), str(self.src)]

    def load(self, log: str):
        from graph_neural_pde_tpu_torch.probes.lanes import report_ptxas
        self.ptxas = [r for r in report_ptxas(self.tag, log)
                      if "node_project" in r["kernel"]
                      or "outer_reduce" in r["kernel"]]
        lib = ctypes.CDLL(str(self.lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        self.tables_fn = lib.probe_tables
        self.tables_fn.argtypes = [p] * 8 + [i] * 4 + [p]
        self.reduce_fn = lib.probe_reduce
        self.reduce_fn.argtypes = [p] * 4 + [i] * 5 + [p]
        for fn in (self.tables_fn, self.reduce_fn):
            fn.restype = ctypes.c_int

    def _check(self, what, code):
        if code:
            raise RuntimeError(f"{self.tag} {what}: cudaError_t {code}")

    def tables(self, x, xcol, qw, qb, kw, kb, q, k, mode):
        import torch
        n, d = x.shape
        stream = torch.cuda.current_stream().cuda_stream
        self._check("tables", self.tables_fn(
            x.data_ptr(), xcol.data_ptr() if xcol is not None else None,
            qw.data_ptr(), qb.data_ptr(), kw.data_ptr(), kb.data_ptr(),
            q.data_ptr(), k.data_ptr(), n, d, qw.shape[1], mode, stream))

    def reduce(self, x, idx, dk, blocks=None):
        """The whole call as this tree's wrappers make it: (dkw, dkb)."""
        import torch
        from graph_neural_pde_tpu_torch.kernels.dense import (dk_sums,
                                                              reduce_blocks,
                                                              sm_count)
        rows, att = dk.shape
        d = x.shape[1]
        if self.new:
            blocks = blocks or reduce_blocks(rows, d, att, sm_count(x.device))
            partials = torch.empty((blocks, d + 1, att), dtype=torch.float32,
                                   device=x.device)
        else:
            blocks = max(1, min(2048, -(-rows // 64)))
            partials = torch.zeros((blocks, d + 1, att), dtype=torch.float32,
                                   device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        self._check("reduce", self.reduce_fn(
            x.data_ptr(), idx.data_ptr() if idx is not None else None,
            dk.data_ptr(), partials.data_ptr(), rows, d, att, blocks,
            int(x.dtype == torch.bfloat16), stream))
        return dk_sums(partials, d)


def build_trees(trees):
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    for t in trees:
        t.src.write_text(SHIM)
    procs = [subprocess.Popen(t.cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for t in trees]
    logs = [p.communicate()[0] for p in procs]
    for t, p, log in zip(trees, procs, logs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {t.tag}:\n{log}")
        t.load(log)


def split_ms(fn, reps: int = 10) -> dict:
    """Device ms of one call of ``fn`` by kernel: the node projections, the
    reduction's first pass, and the rest (memsets, the second pass)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"node_project": 0.0, "outer_reduce": 0.0, "rest": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = next((k for k in ("node_project", "outer_reduce")
                    if f"{k}_kernel" in e.name), "rest")
        out[key] += e.time_range.elapsed_us() / reps / 1e3
    return out


def _bound(n_bytes, flops):
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = flops / PEAK_F32_FLOPS * 1e3
    return max((t_b, "bytes"), (t_o, "operations"))


def _order(trees, other):
    """The timing order: this tree, the other twice, this tree again, then
    the variants."""
    mine, rest = trees[0], [t for t in trees[1:] if t is not other]
    return [mine] + ([other, other, mine] if other else []) + rest


def run_tables(trees, other, shapes, seed, timed, record, line):
    import torch
    from graph_neural_pde_tpu_torch.kernels.dense import (bf16_round,
                                                          node_tables_plain)
    from graph_neural_pde_tpu_torch.probes.gather import agree
    dev = torch.device("cuda")
    mine = trees[0]
    for shape in shapes:
        if shape not in TABLE_SHAPES:
            continue
        n, d, att = TABLE_SHAPES[shape]
        gen = torch.Generator(device=dev).manual_seed(seed)
        x32 = torch.randn((n, d), generator=gen, device=dev)
        qw = torch.randn((d, att), generator=gen, device=dev) / math.sqrt(d)
        kw = torch.randn((d, att), generator=gen, device=dev) / math.sqrt(d)
        qb = 0.1 * torch.randn((att,), generator=gen, device=dev)
        kb = 0.1 * torch.randn((att,), generator=gen, device=dev)
        for mode in (0, 1, 2):
            bf = torch.bfloat16
            x = x32 if mode < 2 else x32.to(bf)
            xcol = None if mode == 0 else x32.to(bf)
            kw_m, kb_m = (kw, kb) if mode == 0 else (
                bf16_round(kw).contiguous(), bf16_round(kb).contiguous())
            q_want, k_want = node_tables_plain(
                x.double(), xcol, qw.double(), qb.double(), kw_m.double(),
                kb_m.double())
            outs = {}
            for t in trees:
                q = torch.empty((n, att), dtype=torch.float32, device=dev)
                k = torch.empty((n, att), dtype=torch.float32 if mode == 0
                                else bf, device=dev)

                def call(t=t, q=q, k=k):
                    t.tables(x, xcol, qw, qb, kw_m, kb_m, q, k, mode)
                    return q, k
                call()
                torch.cuda.synchronize()
                q1, k1 = q.clone(), k.clone()
                call()
                torch.cuda.synchronize()
                if not (torch.equal(q, q1) and torch.equal(k, k1)):
                    raise AssertionError(f"{t.tag} tables {shape} mode "
                                         f"{mode}: two launches differ")
                name = f"{t.tag} tables {shape} mode {mode}"
                errs = [agree(f"{name} q", q, q_want, REL)]
                if mode == 0:
                    errs.append(agree(f"{name} k", k, k_want, REL))
                elif not torch.equal(k, k_want):
                    raise AssertionError(f"{name}: the bf16 k table differs "
                                         "from the plain version's bits")
                outs[t.tag] = (q1, k1, max(e[1] for e in errs), call)
            same = None
            if other is not None:
                a, b = outs[mine.tag], outs[other.tag]
                same = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            esz_x = x.element_size()
            n_bytes = (n * d * esz_x + (n * d * 2 if mode == 1 else 0)
                       + 2 * d * att * 4 + 2 * att * 4
                       + n * att * 4 + n * att * (4 if mode == 0 else 2))
            bound, by = _bound(n_bytes, 4 * n * d * att)
            lib_ms = None
            if mode == 0:
                lib_ms = timed(lambda: (torch.addmm(qb, x32, qw),
                                        torch.addmm(kb, x32, kw)))
            times = {}
            for t in _order(trees, other):
                times.setdefault(t.tag, []).append(timed(outs[t.tag][3]))
            split = {t.tag: split_ms(outs[t.tag][3]) for t in trees}
            row = record(kernel="node_project", split_ms=split, shape=shape, mode=mode,
                         dims=f"N={n} D={d} ATT={att}",
                         ms={k_: min(v) for k_, v in times.items()},
                         ms_all=times, bound_ms=bound, bound_by=by,
                         library_ms=lib_ms,
                         rel_err={k_: v[2] for k_, v in outs.items()},
                         bits_equal_other=same)
            print(f"[tables] {shape} N={n} D={d} ATT={att} mode {mode}: "
                  + ", ".join(f"{k_} {v:.4f} ms" for k_, v in
                              row["ms"].items())
                  + f"; bound {bound:.4f} ms by {by}"
                  + ("" if lib_ms is None else f"; 2 x addmm {lib_ms:.4f} ms")
                  + f"; rel err {row['rel_err']}; bits equal to the other "
                  f"tree's: {same} [{line}]", flush=True)


def run_reduce(trees, other, shapes, seed, waves, timed, record, line):
    import torch
    from graph_neural_pde_tpu_torch.kernels.dense import (
        REDUCE_WAVES, outer_reduce_plain, reduce_blocks, reduce_tiles,
        sm_count)
    from graph_neural_pde_tpu_torch.probes.gather import agree
    dev = torch.device("cuda")
    sms = sm_count(dev)
    mine = trees[0]
    for shape in shapes:
        if shape not in REDUCE_SHAPES:
            continue
        rows, nx, d, att, gathered = REDUCE_SHAPES[shape]
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        x32 = torch.randn((nx, d), generator=gen, device=dev)
        dk = torch.randn((rows, att), generator=gen, device=dev)
        idx = (torch.randint(0, nx, (rows,), generator=gen, device=dev,
                             dtype=torch.int32) if gathered else None)
        for xdt in (torch.float32, torch.bfloat16):
            x = x32.to(xdt)
            want = outer_reduce_plain(x.double(), idx, dk.double())
            res, calls = {}, {}
            for t in trees:
                def call(t=t, blocks=None):
                    return t.reduce(x, idx, dk, blocks)
                got = call()
                again = call()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{t.tag} reduce {shape}: two "
                                         "launches differ")
                name = f"{t.tag} reduce {shape} {xdt}"
                errs = [agree(f"{name} dkw", got[0], want[0], REL),
                        agree(f"{name} dkb", got[1], want[1], REL)]
                res[t.tag] = max(e[1] for e in errs)
                calls[t.tag] = call
            n_bytes = (rows * d * x.element_size()
                       + (4 * rows if gathered else 0) + rows * att * 4
                       + (d + 1) * att * 4)
            bound, by = _bound(n_bytes, 2 * rows * d * att + rows * att)
            lib_ms = None
            if xdt == torch.float32 and not gathered:
                xr = x32[:rows]
                lib_ms = timed(lambda: (torch.mm(xr.t(), dk), dk.sum(0)))
            times = {}
            for t in _order(trees, other):
                times.setdefault(t.tag, []).append(timed(calls[t.tag]))
            split = {t.tag: split_ms(calls[t.tag]) for t in trees}
            by_waves = {}
            for w in waves:
                blocks = max(1, -(-w * sms // reduce_tiles(d, att)))
                by_waves[w] = timed(lambda b=blocks: calls[mine.tag](
                    blocks=b))
            tag = "" if xdt == torch.float32 else " bf16 x"
            row = record(kernel="outer_reduce", shape=shape + tag,
                         dims=f"rows={rows} D={d} ATT={att}"
                         + (" gathered" if gathered else ""),
                         blocks=reduce_blocks(rows, d, att, sms),
                         waves=REDUCE_WAVES,
                         ms={k_: min(v) for k_, v in times.items()},
                         ms_all=times, ms_by_waves=by_waves, split_ms=split,
                         bound_ms=bound, bound_by=by, library_ms=lib_ms,
                         rel_err=res)
            print(f"[reduce] {shape}{tag} rows={rows} D={d} ATT={att}: "
                  + ", ".join(f"{k_} {v:.4f} ms" for k_, v in
                              row["ms"].items())
                  + f" ({row['blocks']} blocks); by blocks an SM "
                  + ", ".join(f"{w}: {v:.4f}" for w, v in by_waves.items())
                  + f"; bound {bound:.4f} ms by {by}"
                  + ("" if lib_ms is None else
                     f"; mm + sum {lib_ms:.4f} ms")
                  + f"; rel err {res}; first pass / rest "
                  + ", ".join(f"{k_} {v['outer_reduce']:.4f} / "
                              f"{v['rest']:.4f}" for k_, v in split.items())
                  + f" [{line}]", flush=True)


def profile_paths(args, tree: Path) -> int:
    """(a), (q), (v) of the tree at ``tree``, per epoch (see the module
    docstring)."""
    import torch
    from torch.autograd import DeviceType
    from graph_neural_pde_tpu_torch import run
    from graph_neural_pde_tpu_torch import profile as prof
    from graph_neural_pde_tpu_torch.config import FLOAT32, GRAND_NL_BENCH
    from graph_neural_pde_tpu_torch.probes.gather import card
    line = card()
    print(f"[paths] {args.tag}: package {tree}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    f32 = GRAND_NL_BENCH.replace(**FLOAT32)
    cfgs = {"a": f32,
            "q": f32.replace(beltrami=True, attention_type="exp_kernel",
                             feat_hidden_dim=96, pos_enc_hidden_dim=32,
                             pos_enc_type="DW32"),
            "v": GRAND_NL_BENCH}
    names = ("node_project", "outer_reduce", "fused_rhs_fwd",
             "fused_rhs_bwd_sym", "fused_rhs_bwd_rows", "fused_rhs_bwd_col",
             "norm1_den", "norm1_fwd", "norm1_bwd")
    results = []
    with tempfile.TemporaryDirectory() as data_dir:
        for name in args.paths.split(","):
            cfg = cfgs[name]
            if cfg.beltrami:
                prof.write_gaussian_pos_enc(cfg, data_dir, 7)
            s = run.setup(cfg, data_dir, device="cuda")
            pe = s.pos_encoding
            s.trainer.train_step(s.x, s.y, s.masks[0], pos_encoding=pe)
            s.trainer.eval_step(s.x, s.y, s.masks, pe)
            if not s.cfg.no_early:
                s.model.apply_early(s.x, s.y, s.masks, pe)
            torch.cuda.synchronize()
            phase_s, p = prof.profile_epochs(s, args.epochs)
            summ = prof.summarise(phase_s, p, args.epochs)
            dev = [e for e in p.events() if e.device_type == DeviceType.CUDA]
            row = dict(path=name, tree=args.tag, card=line,
                       epoch_ms=summ["wall_ms_per_epoch"],
                       device_busy_ms=summ["device_busy_ms_per_epoch"],
                       idle_share=summ["device_idle_share"])
            for k in names:
                hits = [e for e in dev if f"{k}_kernel" in e.name
                        or f"{k}_merge_kernel" in e.name]
                launches = sum(f"{k}_kernel" in e.name for e in dev)
                row[f"{k}_launches"] = launches / args.epochs
                row[f"{k}_ms"] = sum(e.time_range.elapsed_us()
                                     for e in hits) / args.epochs / 1e3
            fills = [e for e in dev if "FillFunctor" in e.name]
            row["fill_launches"] = len(fills) / args.epochs
            row["fill_ms"] = sum(e.time_range.elapsed_us()
                                 for e in fills) / args.epochs / 1e3
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
    dump = out / f"dense_paths_{args.tag}.json"
    dump.write_text(json.dumps(results, indent=1))
    print(f"[paths] results in {dump}", flush=True)
    return 0


def fused_calls(args, tree: Path) -> int:
    """The fused kernels' whole calls of the tree at ``tree`` (see the
    module docstring)."""
    import torch
    from graph_neural_pde_tpu_torch.config import FLOAT32, GRAND_NL_BENCH
    from graph_neural_pde_tpu_torch.kernels import build
    from graph_neural_pde_tpu_torch.probes.gather import (arxiv_scale_graph,
                                                          card)
    cs = _chip_smoke()
    line = card()
    print(f"[fused] {args.tag}: package {tree}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"[fused] {args.tag}: library ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    nl, bench = cs.grand_nl_cora(), GRAND_NL_BENCH.replace(**FLOAT32)
    d, att, h = bench.hidden_dim, bench.attention_dim, bench.heads
    which = args.fused.split(",")
    rows = []
    with tempfile.TemporaryDirectory() as data_dir:
        if "cora" in which:
            g = cs.prepared_graph("Cora", data_dir)
            rows += cs.check_fused_kernels("cora-standin", g, nl.hidden_dim,
                                           nl.attention_dim, nl.heads,
                                           "scaled_dot", args.seed + 20)
            rows += cs.check_norm1_kernels("cora-standin", g, nl.hidden_dim,
                                           nl.attention_dim, nl.heads,
                                           "scaled_dot", args.seed + 60)
    if {"arxiv", "blend", "bf16"} & set(which):
        big = arxiv_scale_graph(args.seed)
        if "arxiv" in which:
            rows += cs.check_fused_kernels("arxiv-scale", big, d, att, h,
                                           "scaled_dot", args.seed + 21)
            rows += cs.check_norm1_kernels("arxiv-scale", big, d, att, h,
                                           "scaled_dot", args.seed + 61)
        if "blend" in which:
            rows += cs.check_fused_kernels("arxiv-scale", big, d, 2 * att, h,
                                           cs.BELTRAMI, args.seed + 22)
            rows += cs.check_norm1_kernels("arxiv-scale", big, d, 2 * att, h,
                                           cs.BELTRAMI, args.seed + 62)
        if "bf16" in which:
            bf16 = torch.bfloat16
            rows += cs.check_fused_kernels("arxiv-scale", big, d, att, h,
                                           "scaled_dot", args.seed + 151,
                                           payload=bf16, row_bf16=True)
            rows += cs.check_norm1_kernels("arxiv-scale", big, d, att, h,
                                           "scaled_dot", args.seed + 190,
                                           payload=bf16, row_bf16=True)
        del big
        torch.cuda.empty_cache()
    if "directed" in which:
        big_dir = cs.directed_random_graph(169_343, 1_166_243, args.seed)
        rows += cs.check_column_rhs_kernels("arxiv-directed", big_dir, d,
                                            att, h, "scaled_dot",
                                            args.seed + 98)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dump = out / f"dense_fused_{args.tag}.json"
    dump.write_text(json.dumps([dict(r, tree=args.tag, card=line)
                                for r in rows if "ms" in r], indent=1))
    print(f"[fused] results in {dump}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="parent")
    ap.add_argument("--out", default=os.path.join("build", "probes"))
    ap.add_argument("--shapes", default=",".join(
        dict.fromkeys(list(TABLE_SHAPES) + list(REDUCE_SHAPES))))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--waves", default="1,4")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--paths", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--fused", default=None)
    args = ap.parse_args(argv)
    own = args.paths is not None or args.fused is not None
    tree = ROOT if not own or args.root is None else Path(
        args.root).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("probes.dense: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.paths is not None:
        return profile_paths(args, tree)
    if args.fused is not None:
        return fused_calls(args, tree)
    from graph_neural_pde_tpu_torch.kernels import build
    from graph_neural_pde_tpu_torch.probes.gather import card, time_ms
    cs = _chip_smoke()
    line = card()
    print(f"[dense] {torch.cuda.get_device_name(0)}; {line}", flush=True)
    nvcc = build._nvcc()
    trees = [Tree("pr", ROOT, nvcc)]
    other = None
    if args.root is not None:
        other = Tree(args.tag, Path(args.root).resolve(), nvcc)
        trees.append(other)
    if args.variants:
        trees += [Tree(f"pr {name}", ROOT, nvcc, defines)
                  for name, defines in VARIANTS.items()]
    t0 = time.perf_counter()
    build_trees(trees)
    print(f"[build] {', '.join(t.tag for t in trees)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results = []

    def record(**row):
        row["card"] = line
        results.append(row)
        return row

    def timed(fn):
        ms = cs.device_ms(fn, reps=20)
        return ms if ms is not None else time_ms(fn)

    shapes = args.shapes.split(",")
    waves = [int(w) for w in args.waves.split(",") if w]
    run_tables(trees, other, shapes, args.seed, timed, record, line)
    run_reduce(trees, other, shapes, args.seed, waves, timed, record, line)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dump = out / f"dense_{args.tag}.json"
    dump.write_text(json.dumps(dict(
        results=results, ptxas=[r for t in trees for r in t.ptxas]),
        indent=1))
    print(f"[dense] results in {dump}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
