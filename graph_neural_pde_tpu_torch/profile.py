"""Where the time goes in a tuned training run, on the card.

    python -m graph_neural_pde_tpu_torch.profile [--dataset Cora] \
        [--epochs 3] [--seed 0] [--data_dir DIR] [any Config flag]

Builds the tuned run of ``--dataset`` (``best_params[dataset]`` over the
data in ``--data_dir``, the SBM stand-in when it holds no raw files; the
training CLI's Config flags override it, e.g. ``--function transformer
--block constant --attention_norm_idx 0 --no-square_plus`` for GRAND-nl
(without ``--attention_norm_idx 0`` the row's column softmax, K12-K14;
``--no-fused_attention_agg`` composes it instead), ``--dataset
ogbn-arxiv-synthetic`` takes ``bench.py``'s GRAND-nl architecture, and
``--spmm_impl pallas_blocked --node_reorder rcm`` the blocked SpMM, K15 and
K16; ``--gaussian_pos_enc SEED`` with ``--beltrami`` plants bench.py's
BLEND encoding, see ``write_gaussian_pos_enc``), runs one warm-up epoch,
then profiles ``--epochs``
epochs with ``torch.profiler``. Each epoch is the CLI's: a train step, an
eval step and, for GNNEarly, the early-stop eval. Prints

* the host-clock time of each phase per epoch (each phase ends in a
  device synchronise);
* device busy time (the union of kernel, memcpy and memset intervals) over
  the profiled wall time, and so the device's idle share;
* device time by kernel, with launch counts, and the port's kernels' mean
  device time per launch (K1-K4, K6-K17, matched by their ``__global__``
  names);
* the device time of PyTorch's indexing kernels (the per-edge gathers such
  as q[row] and k[col] of the composed attention scores, and their
  sort-based backward), per epoch and as a share of the device's busy time.

Needs a CUDA device. Numbers from it belong beside the card's name and
power limit, which it prints first.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
import numpy as np
from torch.profiler import ProfilerActivity, profile, record_function

from graph_neural_pde_tpu_torch import kernels, run
from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.data.datasets import get_dataset

PHASES = ("train_step", "eval_step", "early_stop_eval")
# each wrapper's __global__ function is named <wrapper>_kernel; K8 without
# dxg, fused_rhs_bwd_rows_kernel, is listed apart from K8 with dxg
KERNEL_NAMES = tuple(k.__name__ for k in kernels.KERNELS) + (
    "fused_rhs_bwd_rows",) + tuple(k.__name__ for k in kernels.DENSE_KERNELS)
# a wrapper's second pass (or passes): its time counts to the wrapper, its
# launches not
# a wrapper whose first kernel is not named <wrapper>_kernel: K8 with dxg's
# walk (K8 without dxg is "fused_rhs_bwd_rows")
FIRST_PASS = {"fused_rhs_bwd": "fused_rhs_bwd_edges_kernel"}
SECOND_PASSES = {"fused_rhs_bwd": ("fused_rhs_bwd_edges_merge_kernel",
                                   "edge_project_kernel"),
                 "fused_rowmax": "fused_rowmax_merge_kernel",
                 "fused_rhs_bwd_col": "fused_rhs_bwd_col_merge_kernel",
                 "fused_rhs_fwd": "fused_rhs_fwd_merge_kernel",
                 "fused_rhs_bwd_rows": "fused_rhs_bwd_rows_merge_kernel",
                 "fused_rhs_bwd_sym": "fused_rhs_bwd_sym_merge_kernel",
                 "norm1_den": "norm1_den_merge_kernel",
                 "norm1_fwd": "norm1_fwd_merge_kernel",
                 "norm1_bwd": "norm1_bwd_merge_kernel",
                 "dual_scatter": "dual_scatter_merge_kernel",
                 "segment_norm": "segment_norm_merge_kernel",
                 "segment_norm_bwd": "segment_norm_bwd_merge_kernel",
                 "dual_gather": ("dual_gather_dx_kernel",
                                 "dual_gather_merge_kernel")}
# PyTorch's gather (x[index]) and its backward (index_put with accumulate:
# a radix sort of the indices, then a segmented sum)
INDEX_KERNELS = ("index_elementwise_kernel", "vectorized_gather_kernel",
                 "indexing_backward", "index_put", "RadixSort", "radix_sort")


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def write_gaussian_pos_enc(cfg: Config, data_dir: str, seed: int) -> str:
    """Write bench.py's BLEND encoding, N(0, 1) of width
    ``cfg.pos_enc_hidden_dim`` from numpy's ``default_rng(seed)``, one row
    per node of ``cfg.dataset``, as the ``.npz`` cache that
    ``apply_beltrami`` reads for ``cfg.pos_enc_type``. Returns its path."""
    n = get_dataset(cfg.replace(rewiring=None), data_dir,
                    use_lcc=cfg.not_lcc, device="cpu").graph.num_nodes
    path = os.path.join(data_dir, "pos_encodings",
                        f"{cfg.dataset}_{cfg.pos_enc_type}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, pe=np.random.default_rng(seed).normal(
        size=(n, cfg.pos_enc_hidden_dim)).astype(np.float32))
    return path


def profile_epochs(s: run.Setup, epochs: int):
    """Run ``epochs`` profiled epochs; returns (phase seconds, profiler)."""
    phase_s = defaultdict(list)

    def timed(name, fn):
        with record_function(name):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            phase_s[name].append(time.perf_counter() - t0)
        return out

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(epochs):
            timed("train_step",
                  lambda: s.trainer.train_step(s.x, s.y, s.masks[0],
                                               pos_encoding=s.pos_encoding))
            timed("eval_step", lambda: s.trainer.eval_step(
                s.x, s.y, s.masks, s.pos_encoding))
            if not s.cfg.no_early:
                timed("early_stop_eval",
                      lambda: s.model.apply_early(s.x, s.y, s.masks,
                                                  s.pos_encoding))
    return phase_s, prof


def summarise(phase_s, prof, epochs: int) -> dict:
    # device activity only: the phase spans also appear on the device
    # timeline, as user annotations covering whole phases
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in PHASES]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    wall_us = sum(sum(v) for v in phase_s.values()) * 1e6
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    ours = {}
    for label in KERNEL_NAMES:
        needle = FIRST_PASS.get(label, f"{label}_kernel")
        hits = [(n, c, t) for n, (c, t) in by_name.items() if needle in n]
        launches = sum(c for _, c, _ in hits)
        second = SECOND_PASSES.get(label, ())
        second = (second,) if isinstance(second, str) else second
        total = sum(t for _, _, t in hits) + sum(
            t for n, (_, t) in by_name.items()
            if any(s in n for s in second))
        ours[label] = {"launches_per_epoch": launches / epochs,
                       "device_us_per_launch": total / max(launches, 1),
                       "device_ms_per_epoch": total / epochs / 1e3}
    index_ops = {n: (c, t) for n, (c, t) in by_name.items()
                 if any(key in n for key in INDEX_KERNELS)}
    index_us = sum(t for _, t in index_ops.values())
    return {
        "epochs": epochs,
        "phase_ms_per_epoch": {k: 1e3 * sum(v) / len(v)
                               for k, v in phase_s.items()},
        "wall_ms_per_epoch": wall_us / epochs / 1e3,
        "device_busy_ms_per_epoch": busy / epochs / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernels": ours,
        "torch_index_kernels": {
            "launches_per_epoch": sum(c for c, _ in index_ops.values())
            / epochs,
            "device_ms_per_epoch": index_us / epochs / 1e3,
            "share_of_device_busy": index_us / busy,
            "share_of_epoch": index_us / wall_us},
        "top_device_time": [
            {"name": n[:90], "launches": c, "ms": t / 1e3}
            for n, (c, t) in top[:12]],
    }


def main() -> None:
    ap = run.build_parser()
    ap.description = __doc__.split("\n")[0]
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--gaussian_pos_enc", type=int, default=None,
                    metavar="SEED", help="with --beltrami: train over "
                    "bench.py's seeded N(0, 1) encoding "
                    "(write_gaussian_pos_enc), cached in the data directory")
    ap.set_defaults(dataset="Cora", use_best_params=True, data_dir=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    cfg = run.config_from_args(args)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = args.data_dir or tmp
        if args.gaussian_pos_enc is not None:
            path = write_gaussian_pos_enc(cfg, data_dir, args.gaussian_pos_enc)
            print(f"positional encoding: {path}", flush=True)
        s = run.setup(cfg, data_dir, device="cuda")
        pe = s.pos_encoding
        s.trainer.train_step(s.x, s.y, s.masks[0],        # warm-up epoch
                             pos_encoding=pe)
        s.trainer.eval_step(s.x, s.y, s.masks, pe)
        if not cfg.no_early:
            s.model.apply_early(s.x, s.y, s.masks, pe)
        torch.cuda.synchronize()
        phase_s, prof = profile_epochs(s, args.epochs)
    summary = dict(dataset=cfg.dataset, function=cfg.function,
                   block=cfg.block,
                   **summarise(phase_s, prof, args.epochs))
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15), flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
