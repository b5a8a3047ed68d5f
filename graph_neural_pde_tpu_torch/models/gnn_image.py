"""GNN_image: diffusion on pixel-grid graphs with per-image decoding
(PyTorch port of ``models/gnn_image.py``).

Pixel intensities diffuse directly on the grid graph: there is no encoder,
so the ODE state's width is the channel count (``hidden_dim = im_chan``).
Every image's node states then flatten into one vector, decoded by a single
linear head ``m2``. ``forward_plot_T`` and ``forward_plot_path`` expose the
diffusion for visualisation.

Pixel grids are block-local, the case of the blocked engine
(``spmm_impl="pallas_blocked"``: K15/K16), whose plan pads the node count
to a multiple of ``spmm_block_n``; the default ``xla`` engine runs K1/K2.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.models.blocks import (ODEBlock, block_forward,
                                                      build_spmm_engine,
                                                      prepare_graph)
from graph_neural_pde_tpu_torch.models.gnn import check_supported, pad_nodes
from graph_neural_pde_tpu_torch.models.layers import Linear, dropout
from graph_neural_pde_tpu_torch.ops.graph import Graph


class GNNImageModel(nn.Module):
    """Usage:
        model = GNNImageModel(cfg, graph, h, w, c, num_classes, batch_size,
                              device)
        logits, stats = model(x)     # x: [batch·h·w, c] pixel features
    """

    def __init__(self, cfg: Config, graph: Graph, im_height: int,
                 im_width: int, im_chan: int, num_classes: int,
                 batch_size: int, device="cpu"):
        super().__init__()
        # the ODE state width is the channel count (pixels diffuse raw)
        self.cfg = cfg = cfg.replace(hidden_dim=im_chan)
        check_supported(cfg)
        self.device = torch.device(device)
        self.graph = prepare_graph(cfg, graph).to(self.device)
        self.spmm_fn, self.padded_nodes = build_spmm_engine(cfg, self.graph)
        self.h, self.w, self.c = im_height, im_width, im_chan
        self.num_classes = num_classes
        self.batch_size = batch_size
        gen = torch.Generator().manual_seed(cfg.seed)
        self.m2 = Linear(im_height * im_width * im_chan, num_classes,
                         generator=gen)
        self.block = ODEBlock(cfg, im_chan, generator=gen)
        self.to(self.device)

    def _solve(self, z, training: bool):
        n = z.shape[0]
        z, stats = block_forward(self.block, self.cfg, self.graph,
                                 pad_nodes(z, self.padded_nodes), training,
                                 spmm_fn=self.spmm_fn)
        return z[:n], stats

    def _diffuse(self, x, training: bool,
                 generator: Optional[torch.Generator] = None):
        x = dropout(x, self.cfg.input_dropout, training, generator)
        return self._solve(x, training)

    def _per_image(self, z):
        return z.reshape(self.batch_size, self.h * self.w * self.c)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: [batch·H·W, C] -> ([batch, num_classes] logits, stats)."""
        z, stats = self._diffuse(x, training, generator)
        z = dropout(torch.relu(z), self.cfg.dropout, training, generator)
        return self.m2(self._per_image(z)), stats

    @torch.no_grad()
    def forward_plot_T(self, x):
        """Diffused pixel states at t = T, flattened per image."""
        z, _ = self._diffuse(x, False)
        return self._per_image(torch.relu(z))

    @torch.no_grad()
    def forward_plot_path(self, x, frames: int):
        """Stitched diffusion trajectory: frames + 1 snapshots per image
        [batch, frames + 1, H·W·C], each frame a solve over [0, T] from the
        last (relu'd) one."""
        z = x
        paths = [z.reshape(self.batch_size, -1)]
        for _ in range(frames):
            z = torch.relu(self._solve(z, False)[0])
            paths.append(z.reshape(self.batch_size, -1))
        return torch.stack(paths, dim=1)
