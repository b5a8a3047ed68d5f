"""The per-edge payload kernels on the card, K18 ``fused_aggregate`` and K8's
per-head mode ``fused_rhs_bwd_heads`` (and K19 ``fused_score_max`` beside
them): what the compiler made of them, their whole-call times at the shapes
of their ``PERF.md`` rows, each call split by kernel, and path (u)'s device
time in them.

    python graph_neural_pde_tpu_torch/probes/payload_walk.py [--root DIR]
        [--tag T] [--report] [--out DIR] [--seed N]
        [--shapes oracle,cora,hub,arxiv,quarter,blend] [--paths u]

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
  edge needs: the walk of ``fused_payload.cu`` in both trees).
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
          "blend": ("arxiv", 128, 64, 2, BELTRAMI)}
PAYLOAD_KERNELS = ("payload_", "fused_aggregate", "fused_score_max",
                   "score_max_finish", "fused_rhs_bwd_heads", "node_project",
                   "outer_reduce")
# the kernels a call is split into: name -> substrings of the device
# events' names (both trees)
GROUPS = {"K18": ("payload_aggregate", "fused_aggregate_kernel"),
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
            if score == "scaled_dot":
                q = (x.float() @ qw + qb).contiguous()
                cases.append((
                    "fused_score_max",
                    lambda: K.fused_score_max(rowptr, row, q, x_g, kw,
                                              kb, heads=h),
                    lambda: K.fused_score_max_plain(rowptr, row, q, x_g,
                                                    kw, kb, heads=h),
                    lambda: K.fused_score_max_plain(
                        rowptr, row, q.double(), x_g, kw.double(),
                        kb.double(), heads=h)))
            for case, kern, plain, ref in cases:
                got = _outputs(kern())
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
    ap.add_argument("--paths", default=None)
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
