"""Training harness: optimizers, loss, metrics and the Trainer (PyTorch port
of ``training/train.py``).

The optimizers are written out as the JAX package computes them (optax with
coupled weight decay), not taken from ``torch.optim``: ``optax.adamax``
puts ``eps`` inside the max (``nu = max(|g| + eps, b2·nu)``), where
``torch.optim.Adamax`` adds it elsewhere, and the losses of the two packages
are compared epoch for epoch. rmsprop is the JAX package's torch-semantics
``_torch_rmsprop`` (``g / (sqrt(nu) + eps)``, eps outside the root).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.solvers.tableaus import TABLEAUS


OPTIMIZERS = ("adam", "adamax", "rmsprop")


def _decay_mask(cfg: Config, name: str) -> bool:
    """Coupled weight decay skips the hard-attention block's own attention
    parameters, which the reference trains under no_grad (the JAX package's
    ``_decay_mask_fn``)."""
    freeze_block_att = (cfg.block == "hard_attention"
                        and cfg.function not in ("GAT", "transformer"))
    return not (freeze_block_att and name.startswith("block.att."))


class Optimizer:
    """adam / adamax / rmsprop with torch-style coupled weight decay (L2
    added to the gradient before the moment updates), as ``optax.chain(
    add_decayed_weights(wd, mask), adam|adamax|rmsprop)``. A parameter
    without a gradient takes a zero gradient, as jax.grad gives one."""

    def __init__(self, cfg: Config, named_params):
        if cfg.optimizer not in OPTIMIZERS:
            raise NotImplementedError(
                f"optimizer {cfg.optimizer!r}: ROADMAP Queue 1 slice 1 "
                "item 8 (sgd, adagrad)")
        self.cfg = cfg
        self.params = list(named_params)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.rms_alpha = 0.99
        self.count = 0
        self.mu = [torch.zeros_like(p) for _, p in self.params]
        self.nu = [torch.zeros_like(p) for _, p in self.params]

    @torch.no_grad()
    def step(self):
        cfg, b1, b2, eps = self.cfg, self.b1, self.b2, self.eps
        self.count += 1
        for i, (name, p) in enumerate(self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if cfg.decay and cfg.decay > 0 and _decay_mask(cfg, name):
                g = g + cfg.decay * p
            if cfg.optimizer == "rmsprop":
                a = self.rms_alpha
                nu = a * self.nu[i] + (1.0 - a) * g * g
                self.nu[i] = nu
                p.copy_(p + -cfg.lr * g / (torch.sqrt(nu) + eps))
                continue
            count = torch.tensor(self.count, device=p.device)
            mu = (1 - b1) * g + b1 * self.mu[i]
            mu_hat = mu / (1 - torch.tensor(b1, device=p.device) ** count)
            if cfg.optimizer == "adamax":
                nu = torch.maximum(torch.abs(g) + eps, b2 * self.nu[i])
                upd = mu_hat / nu
            else:
                nu = (1 - b2) * g * g + b2 * self.nu[i]
                nu_hat = nu / (1 - torch.tensor(b2, device=p.device) ** count)
                upd = mu_hat / (torch.sqrt(nu_hat) + eps)
            self.mu[i], self.nu[i] = mu, nu
            p.copy_(p + upd * (-cfg.lr))


def make_optimizer(cfg: Config, model: torch.nn.Module) -> Optimizer:
    return Optimizer(cfg, model.named_parameters())


def cross_entropy_loss(logits, labels, mask):
    """Masked-mean cross entropy over the training nodes."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, 1, labels[:, None].long())[:, 0]
    m = mask.to(logits.dtype)
    return -torch.sum(ll * m) / torch.clamp_min(torch.sum(m), 1.0)


def accuracy(logits, labels, mask):
    pred = torch.argmax(logits, dim=-1)
    m = mask.to(torch.float32)
    return (torch.sum((pred == labels).to(torch.float32) * m)
            / torch.clamp_min(torch.sum(m), 1.0))


@dataclass
class EpochLog:
    epoch: int
    loss: float
    train_acc: float
    val_acc: float
    test_acc: float
    fwd_nfe: int
    bwd_nfe: int
    runtime: float


class Trainer:
    """Runs train and eval steps of one model. Dropout bits come from a
    ``torch.Generator`` on the model's device seeded from ``cfg.seed``."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.optimizer = make_optimizer(model.cfg, model)
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(model.cfg.seed)
        # backward NFE per accepted forward step: the discrete adjoint
        # replays each accepted step once (the JAX package's metering); the
        # continuous adjoint reports its backward solve's NFE itself
        self.bwd_evals_per_step = TABLEAUS[model.cfg.method].num_stages

    def train_step(self, x, y, train_mask):
        """One optimizer step. Returns (loss, solver stats)."""
        self.model.zero_grad(set_to_none=True)
        logits, stats = self.model(x, training=True, generator=self.generator)
        loss = cross_entropy_loss(logits, y, train_mask)
        loss.backward()
        self.optimizer.step()
        if "bwd_nfe" not in stats:
            stats = dict(stats, bwd_nfe=stats["accepted"]
                         * self.bwd_evals_per_step)
        return float(loss.detach()), stats

    @torch.no_grad()
    def eval_step(self, x, y, masks):
        """Returns ((train, val, test) accuracies, logits, solver stats)."""
        logits, stats = self.model(x, training=False)
        accs = tuple(float(accuracy(logits, y, m)) for m in masks)
        return accs, logits, stats

    def fit(self, data, *, epochs: Optional[int] = None, verbose: bool = True):
        """Train for epochs 1 .. epochs-1 (the reference's loop bounds).
        Returns (best, logs)."""
        dev = self.model.device
        x, y = data.x.to(dev), data.y.to(dev)
        masks = tuple(m.to(dev) for m in (data.train_mask, data.val_mask,
                                          data.test_mask))
        epochs = epochs if epochs is not None else self.cfg.epoch
        best = {"val_acc": 0.0, "test_acc": 0.0, "train_acc": 0.0,
                "epoch": 0}
        logs = []
        for epoch in range(1, epochs):
            t0 = time.time()
            loss, tstats = self.train_step(x, y, masks[0])
            (tr, va, te), _, _ = self.eval_step(x, y, masks)
            if va > best["val_acc"]:
                best = {"val_acc": va, "test_acc": te, "train_acc": tr,
                        "epoch": epoch}
            log = EpochLog(epoch, loss, tr, va, te, tstats["nfe"],
                           tstats["bwd_nfe"], time.time() - t0)
            logs.append(log)
            if verbose:
                print(f"Epoch: {epoch:03d}, Runtime {log.runtime:.4f}, "
                      f"Loss {log.loss:.4f}, forward nfe {log.fwd_nfe}, "
                      f"backward nfe {log.bwd_nfe}, "
                      f"Train: {tr:.4f}, Val: {va:.4f}, Test: {te:.4f}")
        return best, logs
