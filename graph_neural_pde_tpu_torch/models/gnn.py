"""The GRAND model: encoder → continuous-time ODE block → decoder (PyTorch
port of ``models/gnn.py``).

* encoder: dropout → m1 → optional batch norm (running statistics kept in
  buffers between steps)
* ODE block: see models.blocks — one solve
* decoder: relu → dropout → m2

The model lives on one explicit ``device``. Its prepared graph is built on
the host once and moved there; its aggregation runs through
``ops.spmm.make_spmm`` (laplacian) or ``kernels.fused_rhs`` (transformer),
the hand-written CUDA kernels on a CUDA device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.models.blocks import (ODEBlock, block_forward,
                                                      check_block,
                                                      prepare_graph)
from graph_neural_pde_tpu_torch.models.functions import check_function
from graph_neural_pde_tpu_torch.models.layers import BatchNorm, Linear, dropout
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
from graph_neural_pde_tpu_torch.solvers.api import check_method
from graph_neural_pde_tpu_torch.training.train import OPTIMIZERS

# Config switches outside the ported slices, with the ROADMAP item that
# ports each (ROADMAP.md, Queue 1)
_NOT_PORTED = (
    ("beltrami", "slice 4 item 15 (Beltrami / positional encodings)"),
    ("rewire_KNN", "slice 4 item 16 (GNNKNN rewiring)"),
    ("fa_layer", "slice 4 item 16 (GNNKNN fa layer)"),
    ("edge_sampling", "slice 4 item 16 (edge sampling)"),
    ("rewiring", "slice 4 item 15 (load-time rewiring)"),
    ("use_labels", "slice 2 item 13 (label diffusion)"),
    ("use_mlp", "slice 5 item 18 (encoder MLP)"),
    ("fc_out", "slice 5 item 18 (decoder fc)"),
    ("augment", "slice 5 item 18 (augmented state)"),
    ("jacobian_norm2", "slice 5 item 17 (regularisers)"),
    ("total_deriv", "slice 5 item 17 (regularisers)"),
    ("kinetic_energy", "slice 5 item 17 (regularisers)"),
    ("directional_penalty", "slice 5 item 17 (regularisers)"),
)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for every config
    outside the ported slices (the tuned GRAND-l rows but ogbn-arxiv, and
    GRAND-nl: the transformer function without mix_features)."""
    if cfg.dataset == "ogbn-arxiv":
        raise NotImplementedError(
            "dataset ogbn-arxiv: ROADMAP Queue 1 slice 2 item 13 (arxiv "
            "loader, label diffusion, not_lcc)")
    for field, item in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(f"{field}: ROADMAP Queue 1 {item}")
    if cfg.mesh_devices and cfg.mesh_devices > 1:
        raise NotImplementedError(
            "mesh_devices: ROADMAP Queue 1 slice 6 item 20 (multi-device)")
    if cfg.spmm_impl != "xla":
        raise NotImplementedError(
            f"spmm_impl {cfg.spmm_impl!r}: ROADMAP Queue 2 P17-P18")
    if cfg.dtype != "float32" or cfg.rhs_payload_dtype != "float32":
        raise NotImplementedError(
            "bfloat16 state or payload: the port's kernels are float32 "
            "(ROADMAP Queue 3)")
    check_function(cfg)
    if cfg.optimizer not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r}: ROADMAP Queue 1 slice 1 item 8 "
            "(sgd, adagrad)")
    check_block(cfg)
    check_method(cfg.method)
    if cfg.adjoint:
        check_method(cfg.adjoint_method)


class GNNModel(nn.Module):
    """Usage:
        model = GNNModel(cfg, num_features, num_classes, graph, device)
        logits, stats = model(x, training=True, generator=gen)
    """

    def __init__(self, cfg: Config, num_features: int, num_classes: int,
                 graph: Graph, device="cpu"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.num_features = num_features
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.graph = prepare_graph(cfg, graph).to(self.device)
        self.spmm_fn = make_spmm(self.graph)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.m1 = Linear(num_features, cfg.hidden_dim, generator=gen)
        self.m2 = Linear(cfg.hidden_dim, num_classes, generator=gen)
        self.block = ODEBlock(cfg, cfg.hidden_dim, generator=gen)
        if cfg.batch_norm:
            self.bn_in = BatchNorm(cfg.hidden_dim)
        self.to(self.device)

    def encode(self, x, training: bool,
               generator: Optional[torch.Generator] = None):
        """Everything before the ODE solve: dropout → m1 → batch norm (a
        training forward moves its running statistics)."""
        x = dropout(x, self.cfg.input_dropout, training, generator)
        x = self.m1(x)
        if self.cfg.batch_norm:
            x = self.bn_in(x, training)
        return x

    def decode(self, z, training: bool,
               generator: Optional[torch.Generator] = None):
        """relu → dropout → m2."""
        z = dropout(torch.relu(z), self.cfg.dropout, training, generator)
        return self.m2(z)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """Full forward. Returns (logits, solver stats)."""
        x0 = self.encode(x, training, generator)
        z, stats = block_forward(self.block, self.cfg, self.graph, x0,
                                 training, spmm_fn=self.spmm_fn)
        return self.decode(z, training, generator), stats
