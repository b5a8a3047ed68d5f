"""Where the time goes in a tuned training run, on the card.

    python -m graph_neural_pde_tpu_torch.profile [--dataset Cora] \
        [--epochs 3] [--seed 0] [--data_dir DIR] [any Config flag]

Builds the tuned run of ``--dataset`` (``best_params[dataset]`` over the
data in ``--data_dir``, the SBM stand-in when it holds no raw files; the
training CLI's Config flags override it, e.g. ``--function transformer
--block constant --attention_norm_idx 0 --no-square_plus`` for GRAND-nl,
and ``--dataset ogbn-arxiv-synthetic`` takes ``bench.py``'s GRAND-nl
architecture), runs one warm-up epoch, then profiles ``--epochs``
epochs with ``torch.profiler``. Each epoch is the CLI's: a train step, an
eval step and, for GNNEarly, the early-stop eval. Prints

* the host-clock time of each phase per epoch (each phase ends in a
  device synchronise);
* device busy time (the union of kernel, memcpy and memset intervals) over
  the profiled wall time, and so the device's idle share;
* device time by kernel, with launch counts, and the port's kernels' mean
  device time per launch.

Needs a CUDA device. Numbers from it belong beside the card's name and
power limit, which it prints first.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from graph_neural_pde_tpu_torch import kernels, run

PHASES = ("train_step", "eval_step", "early_stop_eval")
# each wrapper's __global__ function is named <wrapper>_kernel
KERNEL_NAMES = tuple(k.__name__ for k in kernels.KERNELS)


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
                  lambda: s.trainer.train_step(s.x, s.y, s.masks[0]))
            timed("eval_step", lambda: s.trainer.eval_step(s.x, s.y, s.masks))
            if not s.cfg.no_early:
                timed("early_stop_eval",
                      lambda: s.model.apply_early(s.x, s.y, s.masks))
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
        needle = f"{label}_kernel"
        hits = [(n, c, t) for n, (c, t) in by_name.items() if needle in n]
        launches = sum(c for _, c, _ in hits)
        total = sum(t for _, _, t in hits)
        ours[label] = {"launches_per_epoch": launches / epochs,
                       "device_us_per_launch": total / max(launches, 1),
                       "device_ms_per_epoch": total / epochs / 1e3}
    return {
        "epochs": epochs,
        "phase_ms_per_epoch": {k: 1e3 * sum(v) / len(v)
                               for k, v in phase_s.items()},
        "wall_ms_per_epoch": wall_us / epochs / 1e3,
        "device_busy_ms_per_epoch": busy / epochs / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernels": ours,
        "top_device_time": [
            {"name": n[:90], "launches": c, "ms": t / 1e3}
            for n, (c, t) in top[:12]],
    }


def main() -> None:
    ap = run.build_parser()
    ap.description = __doc__.split("\n")[0]
    ap.add_argument("--epochs", type=int, default=3)
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
        s = run.setup(cfg, args.data_dir or tmp, device="cuda")
        s.trainer.train_step(s.x, s.y, s.masks[0])        # warm-up epoch
        s.trainer.eval_step(s.x, s.y, s.masks)
        if not cfg.no_early:
            s.model.apply_early(s.x, s.y, s.masks)
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
