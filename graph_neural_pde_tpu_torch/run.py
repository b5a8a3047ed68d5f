"""Training CLI of the PyTorch port:
``python -m graph_neural_pde_tpu_torch.run --dataset Cora --use_best_params``.

The port of ``graph_neural_pde_tpu/run.py``: merge the tuned best params
under the command line, load the dataset, build GNN or GNNEarly and run the
epoch loop, with the early-stop integrator's best-val tracking after every
epoch for GNNEarly. Flags are generated from the Config dataclass. Configs
outside the ported slices raise ``NotImplementedError`` naming their
ROADMAP item (``models.gnn.check_supported``).

GRAND-nl (attention recomputed at every evaluation) on a tuned row's data:
``--dataset Cora --use_best_params --function transformer --block constant
--attention_norm_idx 0 --no-square_plus``. ``--dataset ogbn-arxiv-synthetic
--use_best_params`` trains the architecture of the JAX package's
``bench.py`` on its random graph at ogbn-arxiv's size.

One deliberate deviation: the JAX CLI draws the citation graphs' random
development split from an unseeded ``np.random.randint``; the port seeds it
from ``cfg.seed``, so a run is reproducible.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from graph_neural_pde_tpu_torch.config import (GRAND_NL_BENCH, Config,
                                                best_params)
from graph_neural_pde_tpu_torch.data.datasets import (get_dataset,
                                                      set_train_val_test_split)
from graph_neural_pde_tpu_torch.models.gnn import GNNModel, check_supported
from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
from graph_neural_pde_tpu_torch.training.train import EpochLog, Trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--use_best_params", action="store_true",
                        help="merge the tuned per-dataset config underneath "
                             "the command line (best_params.py semantics)")
    for f in dataclasses.fields(Config):
        name = f"--{f.name}"
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=None)
        elif f.name in ("jacobian_norm2", "total_deriv", "kinetic_energy",
                        "directional_penalty"):
            parser.add_argument(name, type=float, default=None)
        elif isinstance(f.default, int):
            parser.add_argument(name, type=int, default=None)
        elif isinstance(f.default, float):
            parser.add_argument(name, type=float, default=None)
        elif isinstance(f.default, str):
            parser.add_argument(name, type=str, default=None)
        elif f.default is None and "str" in str(f.type):
            parser.add_argument(name, type=str, default=None)
    return parser


def config_from_args(args) -> Config:
    tuned = dict(best_params, **{GRAND_NL_BENCH.dataset: GRAND_NL_BENCH})
    base = tuned.get(args.dataset, Config()) if (
        args.use_best_params and args.dataset) else Config()
    overrides = {f.name: getattr(args, f.name)
                 for f in dataclasses.fields(Config)
                 if getattr(args, f.name, None) is not None}
    return base.replace(**overrides)


@dataclass
class RunResult:
    best: dict
    logs: List[EpochLog] = field(default_factory=list)


@dataclass
class Setup:
    """A model, its trainer and its data on one device."""
    cfg: Config
    model: GNNModel
    trainer: Trainer
    x: torch.Tensor
    y: torch.Tensor
    masks: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def setup(cfg: Config, data_dir: str = "./data", device="cuda") -> Setup:
    """Load the dataset and build the model (GNN or GNNEarly by
    cfg.no_early) and its Trainer on ``device``. A CUDA device that is not
    there raises; nothing falls back to the CPU."""
    check_supported(cfg)
    if cfg.geom_gcn_splits:
        raise NotImplementedError(
            "geom_gcn_splits: ROADMAP Queue 1 slice 5 (geom-gcn loaders)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port trains on the card "
            "(run.main(cfg, device='cpu') runs it on the CPU)")
    dataset = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc)

    # random development split for the citation graphs (reference
    # run_GNN.py:237-238), seeded from cfg.seed (see the module docstring)
    if not cfg.planetoid_split and cfg.dataset in ("Cora", "Citeseer",
                                                   "Pubmed"):
        split_seed = int(np.random.RandomState(cfg.seed).randint(0, 1000))
        masks = set_train_val_test_split(split_seed, dataset.y.numpy(), 1500)
        dataset.train_mask, dataset.val_mask, dataset.test_mask = (
            torch.as_tensor(m) for m in masks)

    cls = GNNModel if cfg.no_early else GNNEarlyModel
    model = cls(cfg, dataset.num_features, dataset.num_classes,
                dataset.graph, device=device)
    masks = tuple(m.to(device) for m in (dataset.train_mask,
                                         dataset.val_mask, dataset.test_mask))
    return Setup(cfg, model, Trainer(model), dataset.x.to(device),
                 dataset.y.to(device), masks)


def main(cfg: Config, data_dir: str = "./data", verbose: bool = True,
         device="cuda") -> RunResult:
    """Train cfg.epoch - 1 epochs and report the best-val epoch."""
    s = setup(cfg, data_dir, device)
    if verbose:
        dev = s.x.device
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
        print(f"[device] {dev} {name}".rstrip(), flush=True)
    model, trainer, x, y, masks = s.model, s.trainer, s.x, s.y, s.masks
    result = RunResult(best={"val_acc": 0.0, "test_acc": 0.0,
                             "train_acc": 0.0, "epoch": 0,
                             "best_time": cfg.time})
    best = result.best
    for epoch in range(1, cfg.epoch):
        t0 = time.time()
        loss, tstats = trainer.train_step(x, y, masks[0])
        (tr, va, te), _, _ = trainer.eval_step(x, y, masks)
        best_time = cfg.time
        if va > best["val_acc"]:
            best.update(val_acc=va, test_acc=te, train_acc=tr, epoch=epoch,
                        best_time=cfg.time)
        if not cfg.no_early:
            _, snap, _ = model.apply_early(x, y, masks)
            if snap.val > best["val_acc"]:
                best.update(val_acc=snap.val, test_acc=snap.test,
                            train_acc=snap.train, epoch=epoch,
                            best_time=snap.time)
            best_time = snap.time
        log = EpochLog(epoch, loss, tr, va, te, tstats["nfe"],
                       tstats["bwd_nfe"], time.time() - t0)
        result.logs.append(log)
        if verbose:
            print(f"Epoch: {epoch:03d}, Runtime {log.runtime:.6f}, "
                  f"Loss {loss:.6f}, forward nfe {log.fwd_nfe}, "
                  f"backward nfe {log.bwd_nfe}, "
                  f"Train: {tr:.4f}, Val: {va:.4f}, Test: {te:.4f}, "
                  f"Best time: {best_time:.4f}", flush=True)
    if verbose:
        print(f"best val accuracy {best['val_acc']:.6f} with test accuracy "
              f"{best['test_acc']:.6f} at epoch {best['epoch']} and best time "
              f"{best['best_time']:.6f}", flush=True)
    return result


if __name__ == "__main__":
    parsed = build_parser().parse_args()
    if parsed.num_splits and parsed.num_splits > 1:
        raise NotImplementedError(
            "num_splits > 1: ROADMAP Queue 1 slice 5 item 19 (tooling)")
    main(config_from_args(parsed), data_dir=parsed.data_dir)
