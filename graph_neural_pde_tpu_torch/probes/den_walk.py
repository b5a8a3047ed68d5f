"""The row walks of K12 ``norm1_den`` (both modes) and of K8
``fused_rhs_bwd`` without its per-edge dxg on the card: what the compiler
made of them, and their times at every shape of their ``PERF.md`` rows.

    python graph_neural_pde_tpu_torch/probes/den_walk.py [--root DIR]
        [--tag T] [--report] [--out DIR] [--variants]
        [--shapes cora,arxiv,blend,gdc,arxiv_dir,arxiv_dir_blend,knn]
        [--seed N]

* ``--root DIR``: import the package of the checkout at DIR (another
  commit unpacked beside this one), so that two trees are timed by the
  same script in one run on one card; by default this file's checkout.
  A tree whose wrappers take no ``pieces`` (the first versions) is called
  without them.
* ``--report``: builds that tree's kernels with ``nvcc -Xptxas -v`` and
  prints, for each kernel of the two walks and their merges, its
  registers, stack and spills, the resident warps per SM they allow and
  counts of its SASS instructions by kind; the SASS goes to
  ``DIR/den_walk_sass_<tag>.txt.gz`` (``--out``, by default
  ``build/probes``; ``probes/sym_walk.py``'s ``report``).
* then, at each shape, float32 and on the bfloat16 column table: K12
  plain and weighted by the cotangent on the symmetric graphs, K8 without
  dxg on the directed ones (the graph's row pieces). Each is held against
  its plain version in float64 (1e-5 of scale), launched twice
  (bit-identical), timed whole-call (CUDA events, median of 20 calls
  after 3) and split by kernel (torch.profiler, mean of 10: the walk
  alone, the node projections, the merge of multi-piece rows) and, for
  K12, the walk alone (handed the node tables a first launch filled,
  ``tabs``, as K13 and K14 are in the model). The
  shapes: the Cora stand-in at D=80 ATT=128 H=8 (float32 row side), the
  arxiv-scale graph at D=128 ATT=32 H=2 and at BLEND's D=128 ATT=2x32 H=2
  (the bf16 state's bfloat16 row side); the Cora stand-in rewired by GDC
  at D=80 ATT=128 H=8, ogbn-arxiv-synthetic's pairs one way only at
  D=128 ATT=32 H=2 and at BLEND's widths (bfloat16 row side), and the
  Cora stand-in rewired by pos_enc_knn at BLEND's D=64+32 ATT=2x128 H=8
  (path (s); float32 row side).
* ``--variants``: also the rows cut into pieces of other lengths
  (``VARIANTS``), where the tree's wrappers take ``pieces``.

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

SHAPES = ("cora", "arxiv", "blend", "gdc", "arxiv_dir", "arxiv_dir_blend",
          "knn")
# graph, D, ATT, H, score, a bfloat16 row side beside the bf16 table, the
# feature columns of BLEND's x
SHAPE_DIMS = {"cora": ("cora", 80, 128, 8, "scaled_dot", False, None),
              "arxiv": ("arxiv", 128, 32, 2, "scaled_dot", True, None),
              "blend": ("arxiv", 128, 64, 2, "exp_kernel_beltrami", True,
                        96),
              "gdc": ("gdc", 80, 128, 8, "scaled_dot", False, None),
              "arxiv_dir": ("arxiv_dir", 128, 32, 2, "scaled_dot", True,
                            None),
              "arxiv_dir_blend": ("arxiv_dir", 128, 64, 2,
                                  "exp_kernel_beltrami", True, 96),
              "knn": ("knn", 96, 256, 8, "exp_kernel_beltrami", False, 64)}
# the walk's variants beside its default, the rows cut into pieces of at
# most COL_PIECE edges (Graph.row_pieces): edges a piece, or None for
# whole rows
VARIANTS = {"whole rows": None, "pieces of 8": 8}
DEN_KERNELS = ("norm1_den", "fused_rhs_bwd_rows", "fused_rhs_bwd_kernel")


def _probe(name: str):
    """This checkout's ``probes/<name>.py`` (its helpers), whichever tree
    ``--root`` imports the package from."""
    spec = importlib.util.spec_from_file_location(
        f"_{name}_probe", Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f64(t):
    import torch
    return (t.double() if torch.is_tensor(t) and t.is_floating_point()
            and t.dtype != torch.bfloat16 else t)


def _cases(K, g, ops, ct_ax, ct_den, kw, h, symmetric):
    """(case, wrapper, positional args, keyword args, plain version) of
    the shape: K12's two modes over a symmetric graph, K8 without dxg
    over a directed one."""
    csr = (g.rowptr, g.row, g.col)
    if symmetric:
        return [("norm1_den plain", K.norm1_den, (*csr, *ops), dict(kw),
                 K.norm1_den_plain),
                ("norm1_den weighted", K.norm1_den, (*csr, *ops),
                 dict(kw, ct=ct_ax), K.norm1_den_plain)]
    _, den, _ = K.fused_rhs_fwd(*csr, *ops, **kw)
    recip_p = (1.0 / (h * (den + 1e-16))).contiguous()
    args = (*csr, *ops, ct_ax, recip_p, ct_den)
    return [("fused_rhs_bwd without dxg", K.fused_rhs_bwd, args,
             dict(kw, want_dxg=False), K.fused_rhs_bwd_plain)]


def time_walks(graphs, args, dev, line: str, sw) -> None:
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.ops.graph import column_pieces
    from graph_neural_pde_tpu_torch.probes.gather import agree, time_ms
    for name in args.shapes.split(","):
        gname, d, att, h, score, row_b16, feat = SHAPE_DIMS[name]
        g = graphs[gname]
        symmetric = g.rev is not None
        for mode in ("f32", "bf16"):
            ops, ct_ax, ct_den, sp = sw._operands(g, d, att, h, score,
                                                  args.seed, dev)
            if feat is not None and feat != (3 * d) // 4:
                gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
                for w in (ops[1], ops[3]):
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
            for case, fn, args_k, kw_k, plain in _cases(
                    K, g, ops, ct_ax, ct_den, kw, h, symmetric):
                want = plain(*map(_f64, args_k),
                             **{k: _f64(v) for k, v in kw_k.items()})
                want = [o.float() for o in
                        (want if isinstance(want, tuple) else (want,))
                        if o is not None]
                takes = "pieces" in inspect.signature(fn).parameters
                runs = {"default": {}}
                if takes:
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
                    print(f"[den] {args.tag} {case} {vname} @ {name} {dims}: "
                          f"{ms:.4f} ms (rel err {err:.2e}, relaunch "
                          f"bit-identical) [{line}]", flush=True)
                    if vname == "default":
                        print(f"[den] {args.tag} {case} @ {name}{side}: "
                              f"device time a call by kernel "
                              f"{sw.breakdown(call)}", flush=True)
                if symmetric and "tabs" in inspect.signature(fn).parameters:
                    # the walk alone: handed the node tables filled by a
                    # first launch, as K13 and K14 are in the model
                    from graph_neural_pde_tpu_torch.kernels.norm1 import \
                        node_tables
                    tabs = node_tables(ops[0], att)
                    fn(*args_k, tabs=tabs, **kw_k, **runs["default"])

                    def walk_only():
                        fn(*args_k, tabs=tabs, **kw_k, **runs["default"])
                    print(f"[den] {args.tag} {case} walk only (tables "
                          f"filled) @ {name} {dims}: "
                          f"{time_ms(walk_only):.4f} ms; by kernel "
                          f"{sw.breakdown(walk_only)} [{line}]", flush=True)


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
    sw = _probe("sym_walk")
    pkg_dir = sw._import_tree(args.root)
    import torch
    if not torch.cuda.is_available():
        print("probes.den_walk: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    from graph_neural_pde_tpu_torch.probes.gather import (arxiv_scale_graph,
                                                          card)
    line = card()
    print(f"[den] {args.tag}: package {pkg_dir}; "
          f"{torch.cuda.get_device_name(0)}; {line}", flush=True)
    if args.report:
        sw.report(args.tag, Path(args.out), DEN_KERNELS, "den_walk")
    from graph_neural_pde_tpu_torch.kernels import build
    build.library()
    dev = torch.device("cuda")
    graphs = {}
    want = {SHAPE_DIMS[s][0] for s in args.shapes.split(",")}
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.datasets import get_dataset
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    with tempfile.TemporaryDirectory() as data_dir:
        for gname, over in (("cora", {}), ("gdc", dict(rewiring="gdc")),
                            ("knn", dict(rewiring="pos_enc_knn",
                                         pos_enc_type="DW64"))):
            if gname in want:
                cfg = best_params["Cora"].replace(**over)
                # GDC's diffusion on the card, as chip_smoke.py runs it
                on = dict(device="cuda") if gname == "gdc" else {}
                data = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc, **on)
                graphs[gname] = prepare_graph(cfg, data.graph).to(dev)
    if "arxiv" in want:
        graphs["arxiv"] = arxiv_scale_graph(args.seed).to(dev)
    if "arxiv_dir" in want:
        graphs["arxiv_dir"] = directed_arxiv_graph(args.seed).to(dev)
    for gname, g in graphs.items():
        deg = (g.rowptr[1:] - g.rowptr[:-1]).float()
        pieces = g.row_pieces
        print(f"[den] graph {gname}: N={g.num_nodes} E={g.num_valid}, "
              f"degree mean {deg.mean().item():.2f} max "
              f"{int(deg.max().item())}, symmetric {g.rev is not None}, "
              f"{pieces.n_pieces} row pieces ({pieces.n_multi} rows of "
              "several)", flush=True)
    time_walks(graphs, args, dev, line, sw)
    return 0


def directed_arxiv_graph(seed: int):
    """ogbn-arxiv-synthetic's 1,166,243 uniform pairs over 169,343 nodes,
    one way only, prepared as the attention block prepares its graph (as
    ``chip_smoke.py``'s ``directed_random_graph`` draws it)."""
    import numpy as np
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    from graph_neural_pde_tpu_torch.ops.graph import make_graph
    n, pairs = 169_343, 1_166_243
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, size=pairs, dtype=np.int64)
    col = rng.integers(0, n, size=pairs, dtype=np.int64)
    g = make_graph(row.astype(np.int32), col.astype(np.int32), num_nodes=n,
                   pad_multiple=512)
    return prepare_graph(best_params["Cora"], g)


if __name__ == "__main__":
    sys.exit(main())
