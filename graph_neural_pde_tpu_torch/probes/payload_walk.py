"""The per-edge payload kernels on the card, K18 ``fused_aggregate`` and K8's
per-head mode ``fused_rhs_bwd_heads`` (and K19 ``fused_score_max`` beside
them): what the compiler made of them, their whole-call times at the shapes
of their ``PERF.md`` rows, each call split by kernel, and path (u)'s device
time in them.

    python graph_neural_pde_tpu_torch/probes/payload_walk.py [--root DIR]
        [--tag T] [--report] [--out DIR] [--seed N]
        [--shapes oracle,cora,hub,arxiv,quarter,blend,hub-cosine,
                  hub-pearson,hub-exp,hub-blend]
        [--kernels aggregate,heads,max] [--modes f32,bf16,bf16-row]
        [--two-pass] [--paths u] [--against DIR --sessions N]

* ``--root DIR``: import the package of the checkout at DIR (another
  commit unpacked beside this one, e.g. the parent), so that two trees are
  timed by the same script in one chip call; by default this file's
  checkout. A tree whose K18 takes no ``pieces`` (before the scaled-dot
  fold) is tagged "parent", one with them "walk". Run parent, PR, PR,
  parent.
* ``--report``: builds that tree's kernels with ``nvcc -Xptxas -v`` and
  prints, for each kernel of K18, K19 and the per-head mode (the walks,
  their merges, the node projections' tile of q, the per-head mode's node
  pass; the parent's kernels of ``fused_payload.cu``), its registers, stack
  and spills, the resident warps per SM they allow and counts of its SASS
  instructions by kind (``probes/sym_walk.py``'s ``report``).
* then, at each shape, with a float32 payload and a bfloat16 one (beside
  a float32 row side; at arxiv also beside the bf16 state's bfloat16 one):
  K18 (scaled_dot) and the per-head mode, held
  to their plain versions in float64 (1e-5 of scale), launched twice
  (bit-identical), timed whole-call (device time, ``chip_smoke.py``'s
  ``device_ms``, 20 calls) and split by kernel (torch.profiler, mean of
  10), and K19 once a payload dtype. The shapes (``SHAPES``): the bench
  oracle's graph (N=512, E=4,096) at D=128 ATT=64 H=2, the Cora stand-in
  at D=80 ATT=128 H=8 and with a hub row of degree 360 (cora-hub), the
  arxiv-scale graph at D=128 ATT=32 H=2, rank 0's quarter of its 4-way
  edge split (path (u)'s shard: all N nodes, a quarter of the edges), and
  BLEND's D=128 ATT=2x32 H=2 at arxiv (exp_kernel_beltrami, whose key each
  edge needs: ``fused_payload.cu`` in both trees, K18 on the tensor-core
  key tile over windows of row pieces where the tree has it), and the four
  key
  families at the Cora GRAND-nl widths over the hub row (``hub-cosine``,
  ``hub-pearson``, ``hub-exp``, ``hub-blend``: D=80 ATT=128 H=8, BLEND's
  two halves packed into the 128). K19 takes the graph's row pieces where
  the tree's wrapper takes ``pieces``. ``--kernels`` picks among K18
  (``aggregate``), the per-head mode (``heads``) and K19 (``max``);
  ``--modes`` among the payload modes (``bf16-row``: a bfloat16 payload
  beside the bf16 state's bfloat16 row side, timed at arxiv, its quarter
  and BLEND).
* ``--two-pass``: beside K18 of a key family, its two-pass variant (the
  node projections' tile writes every edge's key to an [E_pad, ATT] table,
  the walk reads it: ``probes/key_table.cu``, which includes this
  checkout's ``csrc/fused_payload.cu`` and is built alone, its tile as
  ``key_design`` picks it without Kw's parts), held and timed the same way.
* ``--against DIR --sessions N``: instead of the above, K19 and K18's key
  families of this checkout beside those of the checkout at DIR in ONE
  process: DIR's ``csrc/fused_payload.cu`` (where its K19 and its key
  families' K18 lived before they moved to the payload walk and the key
  tile) is built alone with ``nvcc -Xptxas -v`` and called through its C
  entry points as its wrappers called them (their allocations, no Kw
  transposed), on the same inputs; the two outputs held to each other,
  then each timed whole-call in N profiler sessions in turns (DIR's,
  this one's, ...), medians compared, at the ``--shapes`` and ``--modes``
  given (K19 at the scaled-dot shapes, K18 at the key-family ones).
* ``--paths u``: instead of the above, path (u)'s attention RHS under the
  profiler: the in-process 4-way split at arxiv scale (K18 on each rank's
  shard, (a)'s widths) forward, and the Cora stand-in as one rank at the
  Cora GRAND-nl widths forward and backward (K18, the per-head mode); per
  call the device ms of K18, the per-head mode (its walk), its node pass,
  the node projections (q; the parent's and dq before the node pass) and
  dKw (the parent's, and before the node pass).

Every line names the card and its power limit; the numbers also go to
``--out``/payload_walk_<kind>_<tag>.json. Without a CUDA device it exits
nonzero.
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
# graph, D, ATT, H, score
SHAPES = {"oracle": ("oracle", 128, 64, 2, "scaled_dot"),
          "cora": ("cora", 80, 128, 8, "scaled_dot"),
          "hub": ("hub", 80, 128, 8, "scaled_dot"),
          "arxiv": ("arxiv", 128, 32, 2, "scaled_dot"),
          "quarter": ("quarter", 128, 32, 2, "scaled_dot"),
          "blend": ("arxiv", 128, 64, 2, BELTRAMI),
          "hub-cosine": ("hub", 80, 128, 8, "cosine_sim"),
          "hub-pearson": ("hub", 80, 128, 8, "pearson"),
          "hub-exp": ("hub", 80, 128, 8, "exp_kernel"),
          "hub-blend": ("hub", 80, 128, 8, BELTRAMI)}
PAYLOAD_KERNELS = ("payload_", "fused_aggregate", "fused_score_max",
                   "score_max_finish", "fused_rhs_bwd_heads", "node_project",
                   "outer_reduce")
CASES = {"aggregate": "fused_aggregate", "heads": "fused_rhs_bwd_heads",
         "max": "fused_score_max"}
# the kernels a call is split into: name -> substrings of the device
# events' names (both trees)
GROUPS = {"K18": ("payload_aggregate", "fused_aggregate_kernel",
                  "payload_keys"),
          "per-head": ("payload_bwd", "fused_rhs_bwd_heads_kernel"),
          "node pass": ("payload_node",),
          "projections": ("node_project",),
          "dKw": ("outer_reduce",)}


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
    from graph_neural_pde_tpu_torch.ops.graph import pad_capacity
    from graph_neural_pde_tpu_torch.parallel import split_mesh
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import edge_shards
    from graph_neural_pde_tpu_torch.probes.gather import arxiv_scale_graph
    want = {SHAPES[s][0] for s in names}
    out = {}
    if "oracle" in want:
        out["oracle"] = cs.oracle_graph(0).to(dev)
    if want & {"cora", "hub"}:
        cora = cs.prepared_graph("Cora", data_dir)
        out["cora"] = cora.to(dev)
        if "hub" in want:
            out["hub"] = cs.hub_graph(cora, 360, seed + 230).to(dev)
    if want & {"arxiv", "quarter"}:
        big = arxiv_scale_graph(seed)
        out["arxiv"] = big.to(dev)
        if "quarter" in want:
            padded = pad_capacity(big, 4).sort_by_row().to(dev)
            out["quarter"] = edge_shards(split_mesh(4, dev), padded)[0].graph
    return out


def time_kernels(args, cs, sw, line, record) -> None:
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.probes.gather import agree
    dev = torch.device("cuda")
    names = args.shapes.split(",")
    walks = "pieces" in inspect.signature(K.fused_aggregate).parameters
    max_pieces = "pieces" in inspect.signature(K.fused_score_max).parameters
    table_dll = (build_table(Path(args.out), line) if args.two_pass
                 else None)
    kernels_wanted = {CASES[k] for k in args.kernels.split(",")}
    modes_wanted = args.modes.split(",")
    with tempfile.TemporaryDirectory() as data_dir:
        graphs = graphs_for(names, args.seed, dev, cs, data_dir)
    bf = torch.bfloat16
    for name in names:
        gname, d, att, h, score = SHAPES[name]
        g = graphs[gname]
        print(f"[payload] graph {name}: N={g.num_nodes} E={g.num_valid} "
              f"slots {g.capacity}", flush=True)
        modes = [("f32", None, False), ("bf16", bf, False)]
        if name in ("arxiv", "quarter", "blend"):
            modes.append(("bf16 row", bf, True))
        modes = [m for m in modes if m[0].replace(" ", "-") in modes_wanted]
        for mode, payload, row_b16 in modes:
            _, randn, csr, ops, kw_f = cs.rhs_operands(g, d, att, h, score,
                                                       args.seed + 7, dev)
            rowptr, row = csr[:2]
            x, qw, qb, kw, kb, gmax = ops
            x_g = randn(g.capacity, d)
            if payload is not None:
                x_g = x_g.to(payload)
            if row_b16:
                x = x.to(bf)
            n = g.num_nodes
            ct_num = randn(n, h * d)
            ct_den = 1.0 + randn(n, h, scale=0.1)
            agg = (rowptr, row, x, x_g, qw, qb, kw, kb, gmax)
            bwd = agg + (ct_num, ct_den)
            dims = (f"N={n} E={g.num_valid} D={d} ATT={att} H={h} {score} "
                    f"payload {mode}")
            kw_r = dict(pieces=g.scatter_pieces) if walks else {}
            tag = ("parent" if not walks
                   else "walk" if score == "scaled_dot" else "keys")
            cases = [
                ("fused_aggregate",
                 lambda: K.fused_aggregate(*agg, **kw_f, **kw_r),
                 lambda: K.fused_aggregate_plain(*agg, **kw_f),
                 lambda: K.fused_aggregate_plain(
                     *map(_f64, agg), **{k: _f64(v) for k, v in
                                         kw_f.items()})),
                ("fused_rhs_bwd_heads",
                 lambda: K.fused_rhs_bwd_heads(*bwd, **kw_f, **kw_r),
                 lambda: K.fused_rhs_bwd_heads_plain(*bwd, **kw_f),
                 lambda: K.fused_rhs_bwd_heads_plain(
                     *map(_f64, bwd), **{k: _f64(v) for k, v in
                                         kw_f.items()}))]
            if table_dll is not None and score != "scaled_dot":
                cases.append((
                    "fused_aggregate two-pass",
                    two_pass_call(table_dll, g, row, x, x_g, qw, qb, kw, kb,
                                  gmax, h, score, kw_f),
                    cases[0][2], cases[0][3]))
            kw_m = dict(pieces=g.scatter_pieces) if max_pieces else {}
            if score == "scaled_dot":
                q = (x.float() @ qw + qb).contiguous()
                cases.append((
                    "fused_score_max",
                    lambda: K.fused_score_max(rowptr, row, q, x_g, kw,
                                              kb, heads=h, **kw_m),
                    lambda: K.fused_score_max_plain(rowptr, row, q, x_g,
                                                    kw, kb, heads=h),
                    lambda: K.fused_score_max_plain(
                        rowptr, row, q.double(), x_g, kw.double(),
                        kb.double(), heads=h)))
            cases = [c for c in cases
                     if c[0].split()[0] in kernels_wanted]
            for case, kern, plain, ref in cases:
                try:
                    got = _outputs(kern())
                except ValueError as err:     # a parent that cannot run it
                    print(f"[payload] {args.tag} {case} ({tag}) @ {name} "
                          f"{dims}: refused ({err}) [{line}]", flush=True)
                    record(kind="kernel", case=case, route=tag, shape=name,
                           dims=dims, refused=str(err))
                    continue
                want = [o.float() for o in _outputs(ref())]
                rel = max(agree(f"{case} @ {name} {dims} {tag}", a, b)[1]
                          for a, b in zip(got, want))
                again = _outputs(kern())
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{case} @ {name} {dims} {tag}: "
                                         "two launches differ")
                ms = cs.device_ms(kern, reps=20)
                plain_ms = cs.device_ms(plain, reps=5)
                split = sw.breakdown(kern)
                print(f"[payload] {args.tag} {case} ({tag}) @ {name} "
                      f"{dims}: {ms:.4f} ms, plain {plain_ms:.4f} ms (rel "
                      f"err {rel:.2e} against float64, relaunch "
                      f"bit-identical) [{line}]", flush=True)
                print(f"[payload] {args.tag} {case} ({tag}) @ {name} "
                      f"{mode}: device time a call by kernel {split}",
                      flush=True)
                record(kind="kernel", case=case, route=tag, shape=name,
                       dims=dims, ms=ms, plain_ms=plain_ms, rel_err=rel,
                       split=split)
            del agg, bwd, x_g, ct_num, ops
            torch.cuda.empty_cache()


def build_table(out: Path, line: str):
    """``probes/key_table.cu`` (K18's two-pass variant) built alone as a
    shared library, bound with ctypes."""
    import ctypes
    import subprocess
    from graph_neural_pde_tpu_torch.kernels import build
    src = Path(__file__).resolve().with_name("key_table.cu")
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "key_table.so"
    t0 = time.perf_counter()
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                          str(lib), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    print(f"[two-pass] {src} built alone in {time.perf_counter() - t0:.1f} "
          f"s [{line}]", flush=True)
    dll = ctypes.CDLL(str(lib))
    fn = dll.gnpde_probe_payload_keys_table
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return dll


def two_pass_call(dll, g, row, x, x_g, qw, qb, kw, kb, gmax, h, score, sp):
    """A whole call of K18's two-pass variant: q and the [E_pad, ATT] key
    table on the node projections' tile, then the table's walk, its tile
    the largest ``key_design`` would pick without Kw's parts."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import fused_rhs as F
    from graph_neural_pde_tpu_torch.kernels.dense import project
    dev = x.device
    n, d = x.shape
    att = qw.shape[1]
    elem = x_g.element_size()
    pc = g.scatter_pieces
    cap = next(c for per_sm, caps in ((2, F.KEY_CAPS[:3]), (1, F.KEY_CAPS))
               for c in caps
               if per_sm * (F.key_shared(d, att, h, elem, c)["tiles"]
                            + F.KEY_BLOCK_RESERVED) <= F.SM_SHARED_BYTES)
    vec = int(d * elem % 16 == 0 and x_g.data_ptr() % 16 == 0)

    def call():
        q, keys = project(x, qw, qb), project(x_g, kw, kb)
        num = torch.empty((n, h * d), dtype=torch.float32, device=dev)
        den = torch.empty((n, h), dtype=torch.float32, device=dev)
        part = (torch.empty((pc.n_slots, F.payload_stride(d, h)),
                            dtype=torch.float32, device=dev)
                if pc.n_multi else None)
        code = dll.gnpde_probe_payload_keys_table(
            *F._piece_args(pc), row.data_ptr(), x_g.data_ptr(),
            q.data_ptr(), kw.data_ptr(), kb.data_ptr(), gmax.data_ptr(),
            F._ptr(sp.get("var")), F._ptr(sp.get("ls")), None,
            num.data_ptr(), den.data_ptr(), F._ptr(part), keys.data_ptr(),
            n, pc.n_pieces, pc.n_multi, d, att, h, F._flags(score, False),
            pc.n_edges, cap, vec, int(x_g.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise ValueError(f"the two-pass variant refused (cudaError_t "
                             f"{code})")
        return num, den

    return call


# the C entry points of a tree whose K19 and key-family K18 (a warp a row
# projecting each key) are in its csrc/fused_payload.cu: pointers, then
# ints, then the stream
PARENT_ENTRIES = {"gnpde_fused_aggregate": (13, 6),
                  "gnpde_fused_score_max": (7, 5)}


def build_against(src_root: Path, out: Path, line: str):
    """The other tree's csrc/fused_payload.cu alone as a shared library
    (ptxas's report of its K18 / K19 kernels printed), bound with
    ctypes."""
    import ctypes
    import re
    import subprocess
    from graph_neural_pde_tpu_torch.kernels import build
    src = src_root / "graph_neural_pde_tpu_torch" / "csrc" / "fused_payload.cu"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "against_fused_payload.so"
    t0 = time.perf_counter()
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas=-v",
                          "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    text = res.stdout + res.stderr
    print(f"[against] {src} built alone in {time.perf_counter() - t0:.1f} s "
          f"[{line}]", flush=True)
    for block in re.split(r"Compiling entry function '", text)[1:]:
        name = block.split("'", 1)[0]
        if "aggregate" in name or "score_max" in name:
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            print(f"[ptxas] against {name}: registers "
                  f"{regs.group(1) if regs else '?'}, spill stores "
                  f"{spill.group(1) if spill else '?'}", flush=True)
    dll = ctypes.CDLL(str(lib))
    for name, (ptrs, ints) in PARENT_ENTRIES.items():
        fn = getattr(dll, name)
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return dll


def against_calls(dll, g, x, x_g, qw, qb, kw, kb, gmax, h, score, sp):
    """The other tree's K18 (key families) and K19 whole calls, as its
    wrappers made them: (K18 call, K19 call) returning their outputs."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.fused_rhs import SCORES
    dev = x.device
    n, d = x.shape
    att = qw.shape[1]
    bf16 = x_g.dtype == torch.bfloat16
    tables = 0 if not bf16 else (1 if x.dtype == torch.float32 else 2)
    var, ls = sp.get("var"), sp.get("ls")

    def ptr(t):
        return None if t is None else t.data_ptr()

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def k18():
        num = torch.empty((n, h * d), dtype=torch.float32, device=dev)
        den = torch.empty((n, h), dtype=torch.float32, device=dev)
        code = dll.gnpde_fused_aggregate(
            g.rowptr.data_ptr(), x_g.data_ptr(), x.data_ptr(), qw.data_ptr(),
            qb.data_ptr(), kw.data_ptr(), kb.data_ptr(), gmax.data_ptr(),
            ptr(var), ptr(ls), None, num.data_ptr(), den.data_ptr(), n, d,
            att, h, SCORES[score], tables, stream())
        if code:
            raise ValueError(f"the other tree's K18 refused (cudaError_t "
                             f"{code})")
        return num, den

    q = (x.float() @ qw + qb).contiguous()

    def k19():
        partial = torch.empty((max(1, -(-n // 8)),), dtype=torch.float32,
                              device=dev)
        out = torch.empty((1,), dtype=torch.float32, device=dev)
        code = dll.gnpde_fused_score_max(
            g.rowptr.data_ptr(), q.data_ptr(), x_g.data_ptr(), kw.data_ptr(),
            kb.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d, att, h,
            int(bf16), stream())
        if code:
            raise ValueError(f"the other tree's K19 refused (cudaError_t "
                             f"{code})")
        return out

    return k18, k19, q


def session_kernels(args, cs, line, record) -> None:
    """K19 and K18's key families against the other tree's in one process
    (see the module docstring)."""
    import statistics
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.probes.gather import agree
    dev = torch.device("cuda")
    dll = build_against(Path(args.against).resolve(), Path(args.out), line)
    names = args.shapes.split(",")
    modes_wanted = args.modes.split(",")
    with tempfile.TemporaryDirectory() as data_dir:
        graphs = graphs_for(names, args.seed, dev, cs, data_dir)
    bf = torch.bfloat16
    for name in names:
        gname, d, att, h, score = SHAPES[name]
        g = graphs[gname]
        modes = [("f32", None, False), ("bf16", bf, False)]
        if name in ("arxiv", "quarter", "blend"):
            modes.append(("bf16 row", bf, True))
        for mode, payload, row_b16 in modes:
            if mode.replace(" ", "-") not in modes_wanted:
                continue
            _, randn, csr, ops, kw_f = cs.rhs_operands(g, d, att, h, score,
                                                       args.seed + 7, dev)
            rowptr, row = csr[:2]
            x, qw, qb, kw, kb, gmax = ops
            x_g = randn(g.capacity, d)
            if payload is not None:
                x_g = x_g.to(payload)
            if row_b16:
                x = x.to(bf)
            sp = {k: v for k, v in kw_f.items() if k in ("var", "ls")}
            k18_other, k19_other, q = against_calls(
                dll, g, x, x_g, qw, qb, kw, kb, gmax, h, score, sp)
            dims = (f"N={g.num_nodes} E={g.num_valid} D={d} ATT={att} H={h} "
                    f"{score} payload {mode}")
            if score == "scaled_dot":
                case = "fused_score_max"
                mine = (lambda: K.fused_score_max(
                    rowptr, row, q, x_g, kw, kb, heads=h,
                    pieces=g.scatter_pieces))
                other = k19_other
            else:
                case = "fused_aggregate"
                mine = (lambda: K.fused_aggregate(
                    rowptr, row, x, x_g, qw, qb, kw, kb, gmax,
                    pieces=g.scatter_pieces, **kw_f))
                other = k18_other
            try:
                want = _outputs(other())
            except ValueError as err:
                print(f"[sessions] {case} @ {name} {dims}: {err} [{line}]",
                      flush=True)
                record(kind="sessions", case=case, shape=name, dims=dims,
                       refused=str(err))
                continue
            got = _outputs(mine())
            rel = max(agree(f"{case} @ {name} {dims} against the other tree",
                            a, b, 1e-4)[1] for a, b in zip(got, want))
            mine_ms, other_ms = [], []
            for _ in range(args.sessions):
                other_ms.append(cs.device_ms(other, reps=20))
                mine_ms.append(cs.device_ms(mine, reps=20))
            om, mm = statistics.median(other_ms), statistics.median(mine_ms)
            print(f"[sessions] {case} @ {name} {dims}: other tree "
                  f"{' '.join(f'{t:.4f}' for t in other_ms)} (median "
                  f"{om:.4f}), this tree "
                  f"{' '.join(f'{t:.4f}' for t in mine_ms)} (median "
                  f"{mm:.4f}) ms; {om / mm:.2f}x; outputs within "
                  f"{rel:.2e} of each other [{line}]", flush=True)
            record(kind="sessions", case=case, shape=name, dims=dims,
                   other_ms=other_ms, this_ms=mine_ms, other_median=om,
                   this_median=mm, rel=rel)
            del x_g, ops
            torch.cuda.empty_cache()


def profile_paths(args, cs, line, record) -> None:
    """(u)'s attention RHS under the profiler (see the module docstring)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from graph_neural_pde_tpu_torch.config import GRAND_NL_BENCH
    from graph_neural_pde_tpu_torch.ops.graph import pad_capacity
    from graph_neural_pde_tpu_torch.parallel import split_mesh
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import \
        make_sharded_fused_rhs
    from graph_neural_pde_tpu_torch.probes.gather import arxiv_scale_graph
    dev = torch.device("cuda")
    nl = cs.grand_nl_cora()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 50)
    with tempfile.TemporaryDirectory() as data_dir:
        cora = cs.prepared_graph("Cora", data_dir).to(dev)
    big = pad_capacity(arxiv_scale_graph(args.seed), 4).sort_by_row().to(dev)
    runs = [("split arxiv 4 ranks, forward", big, 4, GRAND_NL_BENCH.hidden_dim,
             GRAND_NL_BENCH.attention_dim, GRAND_NL_BENCH.heads, False),
            ("Cora as one rank, forward and backward", cora, 1,
             nl.hidden_dim, nl.attention_dim, nl.heads, True)]
    for label, g, world, d, att, h, backward in runs:
        fn = make_sharded_fused_rhs(split_mesh(world, dev), g, heads=h)
        n = g.num_nodes

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        ops = [randn(d, att, scale=d ** -0.5), randn(att, scale=0.1),
               randn(d, att, scale=d ** -0.5), randn(att, scale=0.1),
               randn(n, d)]
        ct = randn(n, d)

        def call():
            leaves = [t.clone().requires_grad_(backward) for t in ops]
            out = fn(*leaves)
            if backward:
                torch.autograd.grad((out * ct).sum(), leaves)

        call()
        torch.cuda.synchronize()
        reps = 10
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        row = dict(path=f"(u) {label}",
                   device_ms=sum(e.time_range.elapsed_us()
                                 for e in events) / reps / 1e3)
        for group, keys in GROUPS.items():
            hits = [e for e in events if any(k in e.name for k in keys)]
            row[f"{group} ms"] = sum(e.time_range.elapsed_us()
                                     for e in hits) / reps / 1e3
            row[f"{group} launches"] = len(hits) / reps
        print(f"[paths] {args.tag} {row['path']} (N={n} D={d} ATT={att} "
              f"H={h}) a call: " + ", ".join(
                  f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                  for k, v in row.items() if k != "path") + f" [{line}]",
              flush=True)
        record(kind="path", **row)
        del ops, ct, fn
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "probes"))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--kernels", default="aggregate,heads,max")
    ap.add_argument("--modes", default="f32,bf16,bf16-row")
    ap.add_argument("--two-pass", action="store_true")
    ap.add_argument("--paths", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve()
    sw = _load("_sym_walk_probe", here.with_name("sym_walk.py"))
    pkg_dir = sw._import_tree(args.root)
    import torch
    if not torch.cuda.is_available():
        print("probes.payload_walk: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _load("_chip_smoke", ROOT / "chip_smoke.py")
    from graph_neural_pde_tpu_torch.probes.gather import card
    line = card()
    print(f"[payload] {args.tag}: package {pkg_dir}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    if args.report:
        sw.report(args.tag, Path(args.out), PAYLOAD_KERNELS, "payload_walk")
    from graph_neural_pde_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    print(f"[payload] {args.tag}: library ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results = []

    def record(**row):
        results.append(dict(row, tree=args.tag, card=line))

    if args.paths is not None:
        profile_paths(args, cs, line, record)
        kind = "paths"
    elif args.against is not None:
        session_kernels(args, cs, line, record)
        kind = "sessions"
    else:
        time_kernels(args, cs, sw, line, record)
        kind = "kernels"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dump = out / f"payload_walk_{kind}_{args.tag}.json"
    dump.write_text(json.dumps(results, indent=1))
    print(f"[payload] results in {dump}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
