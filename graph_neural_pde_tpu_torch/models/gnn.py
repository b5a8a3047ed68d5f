"""The GRAND model: encoder → continuous-time ODE block → decoder (PyTorch
port of ``models/gnn.py``).

* encoder: dropout → m1 (or, with ``beltrami``, BLEND's dual encoder: mx
  over the features and mp over the positional encoding, concatenated) →
  optional label block (``use_labels``: the last ``num_classes`` input
  columns, a one-hot label channel, bypass the encoder and are appended to
  its output) → optional batch norm (running statistics kept in buffers
  between steps)
* ODE block: see models.blocks — one solve
* decoder: relu → dropout → m2

The model lives on one explicit ``device``. Its prepared graph is built on
the host once and moved there; its aggregation runs through
``ops.spmm.make_spmm`` (laplacian; ``kernels.blocked`` with
``spmm_impl="pallas_blocked"``, whose plan pads the ODE state's node count
to a multiple of ``spmm_block_n``), ``kernels.fused_rhs`` (transformer,
plain row softmax) or ``kernels.dual_scatter`` (the other transformer
variants and GAT), the hand-written CUDA kernels on a CUDA device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.models.blocks import (SPMM_IMPLS, ODEBlock,
                                                      block_forward,
                                                      build_spmm_engine,
                                                      check_block,
                                                      prepare_graph)
from graph_neural_pde_tpu_torch.models.functions import check_function
from graph_neural_pde_tpu_torch.models.layers import BatchNorm, Linear, dropout
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.solvers.api import check_method
from graph_neural_pde_tpu_torch.training.train import OPTIMIZERS

# Config switches outside the ported slices, with the ROADMAP item that
# ports each (ROADMAP.md, Queue 1)
_NOT_PORTED = (
    ("rewire_KNN", "slice 4 item 16 (GNNKNN rewiring)"),
    ("fa_layer", "slice 4 item 16 (GNNKNN fa layer)"),
    ("edge_sampling", "slice 4 item 16 (edge sampling)"),
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
    outside the ported slices (ported: every tuned GRAND-l row, label
    diffusion, GRAND-nl with the transformer or GAT function over the
    constant, attention, mixed and hard_attention blocks, BLEND (``beltrami``:
    the dual encoder and the split-space attention), and the ``two_hop``,
    ``gdc`` and ``pos_enc_knn`` rewirings, whose directed graphs every one
    of these runs on). The bfloat16 payload and fixed-grid state run on
    every one of these routes, as the JAX package runs them (see
    ``models.functions``; the blocked engine ignores the payload and
    widens the state, as its kernels do)."""
    for field, item in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(f"{field}: ROADMAP Queue 1 {item}")
    if cfg.mesh_devices and cfg.mesh_devices > 1:
        raise NotImplementedError(
            "mesh_devices: ROADMAP Queue 1 item 25 (--mesh_devices on the "
            "CLI; the sharded aggregations are in "
            "graph_neural_pde_tpu_torch.parallel)")
    if cfg.spmm_impl not in SPMM_IMPLS:
        raise ValueError(f"unknown spmm_impl {cfg.spmm_impl!r} (expected "
                         f"one of {SPMM_IMPLS})")
    for field in ("dtype", "rhs_payload_dtype"):
        if getattr(cfg, field) not in ("float32", "bfloat16"):
            raise ValueError(f"{field} {getattr(cfg, field)!r} (float32 or "
                             "bfloat16)")
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

    With ``beltrami`` the model takes the positional encoding of width
    ``pos_enc_dim`` (``rewiring.positional.apply_beltrami``) beside x:
    ``model(x, training=True, generator=gen, pos_encoding=pe)``.
    """

    def __init__(self, cfg: Config, num_features: int, num_classes: int,
                 graph: Graph, device="cpu", pos_enc_dim: int = 0):
        super().__init__()
        check_supported(cfg)
        if cfg.beltrami and pos_enc_dim:
            cfg = cfg.replace(pos_enc_dim=pos_enc_dim)
        self.cfg = cfg
        self.num_features = num_features
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.graph = prepare_graph(cfg, graph).to(self.device)
        self.spmm_fn, self.padded_nodes = build_spmm_engine(cfg, self.graph)
        gen = torch.Generator().manual_seed(cfg.seed)
        # width of the ODE state: the encoder's output plus the label block
        enc_dim = (cfg.feat_hidden_dim + cfg.pos_enc_hidden_dim
                   if cfg.beltrami else cfg.hidden_dim)
        self.core_dim = enc_dim + (num_classes if cfg.use_labels else 0)
        if cfg.beltrami:
            self.mx = Linear(num_features, cfg.feat_hidden_dim, generator=gen)
            self.mp = Linear(cfg.pos_enc_dim, cfg.pos_enc_hidden_dim,
                             generator=gen)
        else:
            self.m1 = Linear(num_features, cfg.hidden_dim, generator=gen)
        self.m2 = Linear(self.core_dim, num_classes, generator=gen)
        self.block = ODEBlock(cfg, self.core_dim, generator=gen)
        if cfg.batch_norm:
            self.bn_in = BatchNorm(self.core_dim)
        self.to(self.device)

    def encode(self, x, training: bool,
               generator: Optional[torch.Generator] = None,
               pos_encoding: Optional[torch.Tensor] = None):
        """Everything before the ODE solve: dropout → m1 (``beltrami``:
        dropout → mx over x, dropout → mp over ``pos_encoding``,
        concatenated) → label block → batch norm (a training forward moves
        its running statistics). With ``use_labels`` ``x`` is
        [N, num_features + num_classes] (``training.train.with_labels``)."""
        cfg = self.cfg
        labels = None
        if cfg.use_labels:
            labels = x[:, -self.num_classes:]
            x = x[:, :-self.num_classes]
        x = dropout(x, cfg.input_dropout, training, generator)
        if cfg.beltrami:
            if pos_encoding is None:
                raise ValueError("beltrami: the model needs the positional "
                                 "encoding (rewiring.positional."
                                 "apply_beltrami)")
            p = dropout(pos_encoding, cfg.input_dropout, training, generator)
            x = torch.cat([self.mx(x), self.mp(p)], dim=1)
        else:
            x = self.m1(x)
        if labels is not None:
            x = torch.cat([x, labels], dim=-1)
        if self.cfg.batch_norm:
            x = self.bn_in(x, training)
        return x

    def decode(self, z, training: bool,
               generator: Optional[torch.Generator] = None):
        """relu → dropout → m2."""
        z = dropout(torch.relu(z), self.cfg.dropout, training, generator)
        return self.m2(z)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None,
                pos_encoding: Optional[torch.Tensor] = None):
        """Full forward. Returns (logits, solver stats)."""
        x0 = self.encode(x, training, generator, pos_encoding)
        n = x0.shape[0]
        z, stats = block_forward(self.block, self.cfg, self.graph,
                                 pad_nodes(x0, self.padded_nodes), training,
                                 spmm_fn=self.spmm_fn)
        return self.decode(z[:n], training, generator), stats


def pad_nodes(x, num_nodes: int):
    """``x`` [N, D] with zero rows appended up to ``num_nodes`` (the ODE
    state of the blocked engine, whose plan pads the node count to a
    multiple of ``spmm_block_n``)."""
    if num_nodes > x.shape[0]:
        x = torch.nn.functional.pad(x, (0, 0, 0, num_nodes - x.shape[0]))
    return x
