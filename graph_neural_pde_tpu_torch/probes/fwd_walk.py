"""The forward row walk of K6 ``fused_rhs_fwd`` and K13 ``norm1_fwd``, and
K7 ``fused_rowmax``, which scores the edges as K6 does, on the card: what
the compiler made of them, and their times at every shape of their
``PERF.md`` rows.

    python graph_neural_pde_tpu_torch/probes/fwd_walk.py [--root DIR]
        [--tag T] [--report] [--out DIR] [--variants]
        [--shapes cora,arxiv,blend,knn[,h16,d160,d256]] [--seed N]

* ``--root DIR``: import the package of the checkout at DIR (another
  commit unpacked beside this one), so that two trees are timed by the
  same script in one run on one card; by default this file's checkout.
* ``--report``: builds that tree's kernels with ``nvcc -Xptxas -v`` and
  prints, for each kernel of the three, its registers, stack and spills,
  the resident warps per SM they allow and counts of its SASS
  instructions by kind; the SASS goes to
  ``DIR/fwd_walk_sass_<tag>.txt.gz`` (``--out``, by default
  ``build/probes``; ``probes/sym_walk.py``'s ``report``).
* then, at each shape, float32 and on the bfloat16 column table: K6 with
  its numerators, folded (``alpha (ax - x)``) and, for scaled_dot, shifted
  by K7's row maxima; K7; K13 on the symmetric graphs. Each is held
  against its plain version in float64 (1e-5 of scale), launched twice
  (bit-identical), timed whole-call (CUDA events, median of 20 calls after
  3) and split by kernel (torch.profiler, mean of 10: the walk alone, the
  node projections, the merge of multi-piece rows). The shapes: the Cora
  stand-in at D=80 ATT=128 H=8 (float32 row side), the arxiv-scale graph
  at D=128 ATT=32 H=2 and at BLEND's D=128 ATT=2x32 H=2 (the bf16 state's
  bfloat16 row side), and the Cora stand-in rewired by pos_enc_knn at
  BLEND's D=64+32 ATT=2x128 H=8 (path (s); float32 row side).
* ``--variants``: also the rows cut into pieces of other lengths
  (``VARIANTS``), where the tree's K6 and K13 take ``pieces``.
* ``--shapes``: also ``WIDE`` (not timed by default), the templates no
  PERF.md shape reaches: 16 heads over 2 groups of 8 in registers (Cora,
  D=16 ATT=64, pearson), D=160 over 8 groups of 2 on the kNN graph's
  multi-piece rows (scaled_dot), and the widest, D=256 ATT=2x128 H=32 (16
  groups, exp_kernel_beltrami).

Every line names the card and its power limit. Without a CUDA device it
exits nonzero.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import sys
import tempfile
from pathlib import Path

SHAPES = ("cora", "arxiv", "blend", "knn")
WIDE = ("h16", "d160", "d256")
# the walk's variants beside its default, the rows cut into pieces of at
# most COL_PIECE edges (Graph.row_pieces): edges a piece, or None for
# whole rows
VARIANTS = {"whole rows": None, "pieces of 8": 8}
FWD_KERNELS = ("fused_rhs_fwd", "norm1_fwd", "fused_rowmax", "fwd_merge")
BELTRAMI = "exp_kernel_beltrami"


def _sym_walk():
    """This checkout's ``probes/sym_walk.py`` (its helpers), whichever tree
    ``--root`` imports the package from."""
    spec = importlib.util.spec_from_file_location(
        "_sym_walk_probe", Path(__file__).with_name("sym_walk.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f64(t):
    import torch
    return (t.double() if torch.is_tensor(t) and t.is_floating_point()
            and t.dtype != torch.bfloat16 else t)


def time_walks(graphs, args, dev, line: str, sw) -> None:
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.ops.graph import column_pieces
    from graph_neural_pde_tpu_torch.probes.gather import agree, time_ms
    takes = {k: "pieces" in inspect.signature(getattr(K, k)).parameters
             for k in ("fused_rhs_fwd", "norm1_fwd")}
    # graph, D, ATT, H, score, a bfloat16 row side beside the bf16 table,
    # the feature columns of BLEND's x
    shapes = {"cora": ("cora", 80, 128, 8, "scaled_dot", False, None),
              "arxiv": ("arxiv", 128, 32, 2, "scaled_dot", True, None),
              "blend": ("arxiv", 128, 64, 2, BELTRAMI, True, 96),
              "knn": ("knn", 96, 256, 8, BELTRAMI, False, 64),
              "h16": ("cora", 16, 64, 16, "pearson", False, None),
              "d160": ("knn", 160, 64, 16, "scaled_dot", False, None),
              "d256": ("cora", 256, 256, 32, BELTRAMI, False, None)}
    for name in args.shapes.split(","):
        gname, d, att, h, score, row_b16, feat = shapes[name]
        g = graphs[gname]
        csr = (g.rowptr, g.row, g.col)
        symmetric = g.rev is not None
        for mode in ("f32", "bf16"):
            ops, _, _, sp = sw._operands(g, d, att, h, score, args.seed, dev)
            if feat is not None and feat != (3 * d) // 4:
                qw, kw = ops[1], ops[3]
                gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
                for w in (qw, kw):
                    w.copy_(torch.randn(w.shape, generator=gen, device=dev)
                            * d ** -0.5)
                    w[feat:, :att // 2] = 0.0
                    w[:feat, att // 2:] = 0.0
            kw = dict(heads=h, score=score, **sp)
            if mode == "bf16":
                kw["xcol"] = ops[0].to(torch.bfloat16)
                if row_b16:
                    ops = (kw["xcol"],) + ops[1:]
            side = ("" if mode == "f32" else
                    " bf16 table, " + ("bf16" if row_b16 else "f32")
                    + " row side")
            dims = (f"N={g.num_nodes} E={g.num_valid} D={d} ATT={att} H={h} "
                    f"{score}{side}")
            alpha = torch.full((1,), 0.37, device=dev)
            cases = {
                "fused_rhs_fwd with num": ("fused_rhs_fwd",
                                           dict(want_num=True)),
                "fused_rhs_fwd folded": ("fused_rhs_fwd", dict(alpha=alpha))}
            if score == "scaled_dot":
                smax = K.fused_rowmax(*csr, *ops[:5], heads=h,
                                      xcol=kw.get("xcol"))
                shifts = smax[g.row.long()].contiguous()
                cases["fused_rhs_fwd shifted"] = ("fused_rhs_fwd",
                                                  dict(shifts=shifts))
                cases["fused_rowmax"] = ("fused_rowmax", {})
            if symmetric:
                den = K.norm1_den(*csr, *ops, **kw)
                cases["norm1_fwd"] = ("norm1_fwd",
                                      dict(recip=1.0 / (den + 1e-16)))
            for case, (kname, extra) in cases.items():
                fn, plain = getattr(K, kname), getattr(K, kname + "_plain")
                if kname == "fused_rowmax":
                    args_k = (*csr, *ops[:5])
                    kw_k = dict(heads=h, xcol=kw.get("xcol"))
                elif kname == "norm1_fwd":
                    args_k = (*csr, *ops, extra["recip"])
                    kw_k = dict(kw)
                else:
                    args_k, kw_k = (*csr, *ops), dict(kw, **extra)
                want = plain(*map(_f64, args_k),
                             **{k: _f64(v) for k, v in kw_k.items()})
                want = [o.float() for o in
                        (want if isinstance(want, tuple) else (want,))
                        if o is not None]
                runs = {"default": {}}
                if takes.get(kname):
                    runs["default"] = dict(pieces=g.row_pieces)
                    if args.variants:
                        for vname, piece in VARIANTS.items():
                            runs[vname] = dict(pieces=column_pieces(
                                g.rowptr, piece or 1 << 30))
                for vname, vkw in runs.items():
                    def call(vkw=vkw):
                        out = fn(*args_k, **kw_k, **vkw)
                        return [o for o in (out if isinstance(out, tuple)
                                            else (out,)) if o is not None]
                    got = call()
                    err = max(agree(f"{case} {vname} {name}{side}", a, b)[1]
                              for a, b in zip(got, want))
                    again = call()
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"{case} {vname} @ {dims}: two "
                                             "launches differ")
                    ms = time_ms(call)
                    print(f"[fwd] {args.tag} {case} {vname} @ {name} {dims}: "
                          f"{ms:.4f} ms (rel err {err:.2e}, relaunch "
                          f"bit-identical) [{line}]", flush=True)
                    if vname == "default":
                        print(f"[fwd] {args.tag} {case} @ {name}{side}: "
                              f"device time a call by kernel "
                              f"{sw.breakdown(call)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "probes"))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sw = _sym_walk()
    pkg_dir = sw._import_tree(args.root)
    import torch
    if not torch.cuda.is_available():
        print("probes.fwd_walk: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    from graph_neural_pde_tpu_torch.probes.gather import (arxiv_scale_graph,
                                                          card)
    line = card()
    print(f"[fwd] {args.tag}: package {pkg_dir}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    if args.report:
        sw.report(args.tag, Path(args.out), FWD_KERNELS, "fwd_walk")
    from graph_neural_pde_tpu_torch.kernels import build
    build.library()
    dev = torch.device("cuda")
    graphs = {}
    want = set(args.shapes.split(","))
    if want & set(WIDE):
        want |= {"cora", "knn"}
    if want & {"cora", "knn"}:
        from graph_neural_pde_tpu_torch.config import best_params
        from graph_neural_pde_tpu_torch.data.datasets import get_dataset
        from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
        with tempfile.TemporaryDirectory() as data_dir:
            for gname, over in (("cora", {}),
                                ("knn", dict(rewiring="pos_enc_knn",
                                             pos_enc_type="DW64"))):
                if gname in want:
                    cfg = best_params["Cora"].replace(**over)
                    data = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc)
                    graphs[gname] = prepare_graph(cfg, data.graph).to(dev)
    if want & {"arxiv", "blend"}:
        graphs["arxiv"] = arxiv_scale_graph(args.seed).to(dev)
    for gname, g in graphs.items():
        deg = (g.rowptr[1:] - g.rowptr[:-1]).float()
        pieces = getattr(g, "row_pieces", None)
        cut = ("" if pieces is None else
               f", {pieces.n_pieces} row pieces ({pieces.n_multi} rows of "
               "several)")
        print(f"[fwd] graph {gname}: N={g.num_nodes} E={g.num_valid}, "
              f"degree mean {deg.mean().item():.2f} max "
              f"{int(deg.max().item())}, symmetric {g.rev is not None}{cut}",
              flush=True)
    time_walks(graphs, args, dev, line, sw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
