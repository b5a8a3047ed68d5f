"""Positional encodings for BLEND (PyTorch port of ``rewiring/positional.py``).

* ``random_walks``: uniform random walks over the edge list, host numpy,
  the JAX package's numpy walk step for step (same generator, same draws).
* ``deepwalk_embeddings``: the walks' skip-gram pairs and skip-gram with
  negative sampling trained in torch on ``device`` (``sgns_train``), with
  the JAX package's pair order, batch of 65,536 pairs, numpy permutations
  and negatives from ``default_rng(seed + 1)`` and update
  ``emb - lr g num_nodes``.
* ``apply_beltrami``: read a cached encoding (the reference's
  ``{dataset}_{type}.pkl`` pickle, or the ``.npz`` this module and the JAX
  package write) or compute the GDC or DeepWalk encoding, and cache it.

Two deliberate differences from the JAX package: the walks are always the
numpy ones (the JAX package takes ``runtime.gc_random_walks``, seeded
``seed + 1``, when its C++ host library loads), and the first embedding is
``0.1 N(0, 1)`` from a ``torch.Generator`` seeded ``seed``, not
``jax.random``'s bits. So the default encodings of the two packages differ;
``sgns_train`` takes the first embedding from its caller, and the tests hold
it to the JAX package's training from one shared start.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.rewiring.gdc import gdc_position_encoding

SGNS_BATCH = 65536


def random_walks(row: np.ndarray, col: np.ndarray, num_nodes: int, *,
                 walk_length: int = 20, walks_per_node: int = 10,
                 seed: int = 0) -> np.ndarray:
    """Uniform random walks over a CSR adjacency (host, vectorised numpy):
    [num_nodes walks_per_node, walk_length + 1] node ids, each node's walks
    starting at it; an isolated node loops on itself. The JAX package's
    numpy walk, draw for draw, but for one repair: the JAX package reads
    one slot past the edge list when the last node is isolated (and
    raises); here that read is clamped, and the node loops."""
    order = np.argsort(row, kind="stable")
    col_sorted = np.concatenate([col[order], [0]]).astype(col.dtype)
    deg = np.bincount(row, minlength=num_nodes)
    ptr = np.concatenate([[0], np.cumsum(deg)])
    rng = np.random.default_rng(seed)

    starts = np.tile(np.arange(num_nodes), walks_per_node)
    walks = np.empty((starts.shape[0], walk_length + 1), np.int64)
    walks[:, 0] = starts
    cur = starts
    for step in range(walk_length):
        d = deg[cur]
        offs = (rng.random(cur.shape[0]) * np.maximum(d, 1)).astype(np.int64)
        # col_sorted ends in one spare slot, read only for isolated nodes
        nxt = col_sorted[ptr[cur] + np.minimum(offs, np.maximum(d - 1, 0))]
        nxt = np.where(d > 0, nxt, cur)
        walks[:, step + 1] = nxt
        cur = nxt
    return walks


def skipgram_pairs(walks: np.ndarray, context: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(centers, contexts): every pair of a walk at offsets 1..context, by
    offset, then by walk and position."""
    centers = [walks[:, :-off].reshape(-1) for off in range(1, context + 1)]
    contexts = [walks[:, off:].reshape(-1) for off in range(1, context + 1)]
    return np.concatenate(centers), np.concatenate(contexts)


def _sgns_loss(emb_in, emb_out, c, ctx, neg):
    vc = emb_in[c]
    pos = torch.sum(vc * emb_out[ctx], dim=1)
    negd = torch.einsum("bd,bkd->bk", vc, emb_out[neg])
    return (-torch.mean(torch.nn.functional.logsigmoid(pos))
            - torch.mean(torch.nn.functional.logsigmoid(-negd)))


def sgns_train(emb_in: torch.Tensor, centers: np.ndarray,
               contexts: np.ndarray, num_nodes: int, *, negatives: int = 1,
               epochs: int = 3, lr: float = 0.01, seed: int = 0
               ) -> np.ndarray:
    """Skip-gram with negative sampling from the first input embedding
    ``emb_in`` [N, dim] (its device runs the steps; the output embedding
    starts at 0): each epoch permutes the pairs, and each full batch of
    ``SGNS_BATCH`` draws ``negatives`` uniform nodes per pair and steps both
    embeddings by ``lr g num_nodes``, g the gradient of the mean logistic
    losses. Permutations and negatives come from numpy's
    ``default_rng(seed + 1)``. Returns the input embedding, float32."""
    dev = emb_in.device
    rng = np.random.default_rng(seed + 1)
    emb_in = emb_in.detach().to(torch.float32)
    emb_out = torch.zeros_like(emb_in)
    cen = torch.as_tensor(centers, device=dev)
    ctx = torch.as_tensor(contexts, device=dev)
    n_pairs = centers.shape[0]
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(n_pairs), device=dev)
        for s in range(0, n_pairs - SGNS_BATCH + 1, SGNS_BATCH):
            sel = perm[s:s + SGNS_BATCH]
            neg = torch.as_tensor(
                rng.integers(0, num_nodes, size=(SGNS_BATCH, negatives)),
                device=dev)
            ei = emb_in.requires_grad_(True)
            eo = emb_out.requires_grad_(True)
            g_in, g_out = torch.autograd.grad(
                _sgns_loss(ei, eo, cen[sel], ctx[sel], neg), (ei, eo))
            emb_in = (ei - lr * g_in * num_nodes).detach()
            emb_out = (eo - lr * g_out * num_nodes).detach()
    return emb_in.cpu().numpy().astype(np.float32)


def deepwalk_embeddings(row, col, num_nodes: int, *, dim: int = 64,
                        walk_length: int = 20, walks_per_node: int = 10,
                        context: int = 5, negatives: int = 1,
                        epochs: int = 3, lr: float = 0.01, seed: int = 0,
                        device="cuda") -> np.ndarray:
    """DeepWalk [N, dim]: numpy walks, their skip-gram pairs, and
    ``sgns_train`` on ``device`` from ``0.1 N(0, 1)`` drawn by a
    ``torch.Generator`` seeded ``seed``."""
    walks = random_walks(np.asarray(row), np.asarray(col), num_nodes,
                         walk_length=walk_length,
                         walks_per_node=walks_per_node, seed=seed)
    centers, contexts = skipgram_pairs(walks, context)
    gen = torch.Generator().manual_seed(seed)
    emb_in = 0.1 * torch.randn(num_nodes, dim, generator=gen)
    return sgns_train(emb_in.to(device), centers, contexts, num_nodes,
                      negatives=negatives, epochs=epochs, lr=lr, seed=seed)


def apply_beltrami(g: Graph, cfg: Config, data_dir: Optional[str] = None,
                   node_order: Optional[np.ndarray] = None,
                   device="cuda") -> np.ndarray:
    """The positional encoding [N, pos_enc_dim] float32 of ``cfg.
    pos_enc_type``: read from ``{data_dir}/pos_encodings/{dataset}_{type}``
    ``.pkl`` (the reference's pickle; DeepWalk pickles hold
    ``{'data': encodings}``) or ``.npz`` when present, else computed (GDC on
    ``device``; ``DW<dim>`` by DeepWalk on ``device``) and cached as
    ``.npz``.

    ``node_order`` (``ops.reorder``, order[new_id] = old_id): cached
    encodings are indexed by the ORIGINAL node ids, so a relabelled graph
    permutes them on load; a fresh encoding of the relabelled graph needs
    nothing and is not cached (it would poison later loads in the original
    order)."""
    if data_dir:
        pkl = os.path.join(data_dir, "pos_encodings",
                           f"{cfg.dataset}_{cfg.pos_enc_type}.pkl")
        pe = None
        if os.path.exists(pkl):
            with open(pkl, "rb") as f:
                pe = pickle.load(f)
            if cfg.pos_enc_type.startswith("DW") and isinstance(pe, dict):
                pe = pe["data"]
        elif os.path.exists(pkl[:-4] + ".npz"):
            pe = np.load(pkl[:-4] + ".npz")["pe"]
        if pe is not None:
            pe = np.asarray(pe, np.float32)
            return pe[np.asarray(node_order)] if node_order is not None else pe

    if cfg.pos_enc_type == "GDC":
        pe = gdc_position_encoding(g, cfg, device).cpu().numpy()
    elif cfg.pos_enc_type.startswith("DW"):
        dim = int(cfg.pos_enc_type[2:] or 64)
        m = g.mask.cpu().numpy()
        pe = deepwalk_embeddings(g.row.cpu().numpy()[m],
                                 g.col.cpu().numpy()[m], g.num_nodes,
                                 dim=dim, seed=cfg.seed, device=device)
    else:
        raise ValueError(
            f"The positional encoding type you specified "
            f"({cfg.pos_enc_type}) does not exist")
    pe = np.asarray(pe, np.float32)

    if data_dir and node_order is None:
        os.makedirs(os.path.join(data_dir, "pos_encodings"), exist_ok=True)
        np.savez(os.path.join(data_dir, "pos_encodings",
                              f"{cfg.dataset}_{cfg.pos_enc_type}.npz"), pe=pe)
    return pe
