"""Image-diffusion training CLI (PyTorch port of ``training/run_image.py``).

``python -m graph_neural_pde_tpu_torch.training.run_image --dataset MNIST``
trains GNN_image on batched pixel-grid graphs, on the card: the first line
is ``[device] cuda:0 <card name>``, and without a CUDA device it raises
(``train_image(cfg, device="cpu")`` runs on the CPU). Without the raw
MNIST / CIFAR-10 files the loader falls back to the seeded blob images.
``train_image(cfg.replace(spmm_impl="pallas_blocked"))`` aggregates on the
blocked kernels (K15/K16) instead of K1/K2.
"""

from __future__ import annotations

import argparse
import time
from typing import Mapping, Optional

import numpy as np
import torch

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.data.image import load_image_dataset
from graph_neural_pde_tpu_torch.models.gnn_image import GNNImageModel
from graph_neural_pde_tpu_torch.training.train import (accuracy,
                                                       cross_entropy_loss,
                                                       make_optimizer)


def train_image(cfg: Config, data_dir: str = "./data", dataset: str = "MNIST",
                batch_size: int = 64, epochs: int = 3, diagonals: bool = False,
                max_batches: Optional[int] = None, verbose: bool = True,
                device="cuda", state_dict: Optional[Mapping] = None):
    """Train for ``epochs`` passes over the batches (at most
    ``max_batches`` each), from ``state_dict`` when given (e.g. weights
    converted from the JAX package's init). Returns (model, history) with
    one (mean loss, mean train accuracy) per epoch."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port trains on the card "
            "(train_image(cfg, device='cpu') runs it on the CPU)")
    data = load_image_dataset(data_dir, dataset, batch_size,
                              diagonals=diagonals)
    num_classes = int(data.y.max()) + 1
    model = GNNImageModel(cfg, data.graph, data.h, data.w, data.c,
                          num_classes, batch_size, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    optimizer = make_optimizer(cfg, model)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    history = []
    for epoch in range(epochs):
        t0 = time.time()
        losses, accs = [], []
        for bi, (x, y) in enumerate(data.batches(seed=epoch)):
            if max_batches is not None and bi >= max_batches:
                break
            x = torch.from_numpy(x).to(device)
            y = torch.from_numpy(y).to(device)
            ones = torch.ones_like(y, dtype=torch.float32)
            model.zero_grad(set_to_none=True)
            logits, _ = model(x, training=True, generator=generator)
            loss = cross_entropy_loss(logits, y, ones)
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))
            accs.append(float(accuracy(logits.detach(), y, ones)))
        history.append((np.mean(losses), np.mean(accs)))
        if verbose:
            print(f"Epoch {epoch}: loss {np.mean(losses):.4f} "
                  f"train acc {np.mean(accs):.4f} ({time.time()-t0:.1f}s)",
                  flush=True)
    return model, history


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="MNIST")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--time", type=float, default=3.0)
    p.add_argument("--diags", action="store_true")
    args = p.parse_args()
    cfg = Config(block="constant", function="laplacian", method="rk4",
                 step_size=1.0, time=args.time, input_dropout=0.0,
                 dropout=0.0, lr=0.01, decay=0.0, self_loop_weight=1.0)
    if torch.cuda.is_available():
        print(f"[device] cuda:0 {torch.cuda.get_device_name(0)}", flush=True)
    train_image(cfg, args.data_dir, args.dataset, args.batch_size,
                args.epochs, args.diags)
