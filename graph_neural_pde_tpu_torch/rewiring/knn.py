"""k-nearest-neighbour graphs and the ``pos_enc_knn`` rewiring (PyTorch port
of ``rewiring/knn.py``).

* ``knn_graph``: the k nearest nodes of every node (itself included) by
  euclidean distance, from tiled squared distances |a|^2 - 2 a.b + |b|^2
  (one float32 matmul per tile of rows) and ``torch.topk`` on ``device``:
  memory O(tile N), not O(N^2).
* ``pairwise_distances``: the dense distance matrix, on ``device``.
* ``apply_dist_knn``, ``apply_dist_threshold``, ``hyperbolize``: host
  numpy over a dense distance matrix, as in the JAX package.
* ``apply_pos_dist_rewire``: the ``pos_enc_knn`` rewiring, a new edge set
  from the distances of BLEND's positional encodings (DeepWalk, or Poincaré
  distances for ``HYP*`` encodings).
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.ops.graph import Graph, make_graph
from graph_neural_pde_tpu_torch.rewiring.positional import apply_beltrami


def _knn_indices(x: torch.Tensor, k: int, tile: int) -> torch.Tensor:
    """[N, k] indices of the k nearest rows of x (self included), nearest
    first."""
    sq = torch.sum(x * x, dim=1)
    out = []
    for i in range(0, x.shape[0], tile):
        xt = x[i:i + tile]
        d = sq[i:i + tile, None] - 2.0 * (xt @ x.T) + sq[None, :]
        out.append(torch.topk(-d, k, dim=1).indices)
    return torch.cat(out)


def knn_graph(x, k: int, *, symmetric: bool = False, tile: int = 1024,
              device="cuda") -> np.ndarray:
    """edge_index [2, N k] with row i repeated k times, its k nearest nodes
    (itself included); ``symmetric`` adds the reverse of every edge and
    keeps each (row, col) pair once."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    n = x.shape[0]
    idx = _knn_indices(x, k, min(tile, max(8, n))).cpu().numpy()
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.reshape(-1).astype(np.int64)
    ei = np.stack([rows, cols])
    if symmetric:
        r = np.concatenate([ei[0], ei[1]])
        c = np.concatenate([ei[1], ei[0]])
        _, uniq = np.unique(r * n + c, return_index=True)
        ei = np.stack([r[uniq], c[uniq]])
    return ei


def pairwise_distances(x, device="cuda") -> np.ndarray:
    """Dense euclidean distance matrix [N, N] (float32)."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    sq = torch.sum(x * x, dim=1)
    d2 = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    return torch.sqrt(torch.clamp_min(d2, 0.0)).cpu().numpy()


def apply_dist_knn(dist: np.ndarray, k: int) -> np.ndarray:
    """kNN edge_index from a precomputed distance matrix."""
    idx = np.argsort(dist, axis=1)[:, :k]
    n = dist.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    return np.stack([rows, idx.reshape(-1).astype(np.int64)])


def apply_dist_threshold(dist: np.ndarray, quantile: float = 0.001
                         ) -> np.ndarray:
    """Keep the closest ``quantile`` fraction of all pairs."""
    thresh = np.quantile(dist, quantile)
    r, c = np.nonzero(dist <= thresh)
    return np.stack([r.astype(np.int64), c.astype(np.int64)])


def hyperbolize(emb: np.ndarray) -> np.ndarray:
    """Poincaré-ball distance matrix of embeddings (scaled into the unit
    ball when they leave it): d = arccosh(1 + 2|u - v|^2 / ((1 - |u|^2)
    (1 - |v|^2))), in float64, returned as float32."""
    emb = np.asarray(emb, np.float64)
    norms = np.linalg.norm(emb, axis=1)
    if norms.max() >= 1.0:
        emb = emb / (norms.max() * (1.0 + 1e-6))
    sq = np.sum(emb * emb, axis=1)
    diff = sq[:, None] - 2.0 * emb @ emb.T + sq[None, :]
    denom = (1.0 - sq)[:, None] * (1.0 - sq)[None, :]
    arg = 1.0 + 2.0 * np.maximum(diff, 0.0) / np.maximum(denom, 1e-15)
    return np.arccosh(np.maximum(arg, 1.0)).astype(np.float32)


def _hyperbolic_distances(g: Graph, cfg: Config, data_dir, device):
    """The Poincaré distances of a ``HYP*`` encoding: read from
    ``{data_dir}/pos_encodings/{dataset}_{type}_dists`` ``.pkl`` or
    ``.npz``, else computed from the encoding and cached as ``.npz``. The
    reference needs the HYP pickles on disk; without them the JAX package
    hyperbolises a DeepWalk encoding (DW64) instead, and so does this."""
    cache = None
    if data_dir:
        base = os.path.join(data_dir, "pos_encodings",
                            f"{cfg.dataset}_{cfg.pos_enc_type}_dists")
        cache = base + ".npz"
        if os.path.exists(base + ".pkl"):
            with open(base + ".pkl", "rb") as f:
                return np.asarray(pickle.load(f), np.float32)
        if os.path.exists(cache):
            return np.load(cache)["dist"].astype(np.float32)
    try:
        pe = apply_beltrami(g, cfg, data_dir, device=device)
    except ValueError:
        print(f"[rewire] no {cfg.pos_enc_type} encodings on disk; "
              f"hyperbolising DeepWalk embeddings as a stand-in",
              file=sys.stderr)
        pe = apply_beltrami(g, cfg.replace(pos_enc_type="DW64"), data_dir,
                            device=device)
    dist = hyperbolize(pe)
    if cache:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, dist=dist)
    return dist


def apply_pos_dist_rewire(g: Graph, cfg: Config, data_dir=None,
                          device="cuda") -> Graph:
    """The ``pos_enc_knn`` rewiring: a new host Graph at the same node
    count whose edges join close positional encodings.

    * ``HYP*``: Poincaré distances (``_hyperbolic_distances``), then the
      ``gdc_k`` nearest (``gdc_sparsification="topk"``) or the
      ``pos_dist_quantile`` closest pairs;
    * ``DW*``: kNN over the DeepWalk encoding (``knn_graph``), or the
      closest 1/1000 of all pairs by euclidean distance (the reference
      keeps the quantile at its default on this branch).

    The graph is directed in general (a node's k nearest need not have it
    among theirs)."""
    if cfg.pos_enc_type.startswith("HYP"):
        pos_dist = _hyperbolic_distances(g, cfg, data_dir, device)
        if cfg.gdc_sparsification == "topk":
            ei = apply_dist_knn(pos_dist, cfg.gdc_k)
        else:
            ei = apply_dist_threshold(pos_dist, cfg.pos_dist_quantile)
    elif cfg.pos_enc_type.startswith("DW"):
        pe = apply_beltrami(g, cfg, data_dir, device=device)
        if cfg.gdc_sparsification == "topk":
            ei = knn_graph(pe, cfg.gdc_k, device=device)
        else:
            ei = apply_dist_threshold(pairwise_distances(pe, device))
    else:
        raise ValueError(
            f"pos_enc_knn rewiring needs a DW*/HYP* pos_enc_type, got "
            f"{cfg.pos_enc_type}")
    return make_graph(ei[0], ei[1], None, num_nodes=g.num_nodes,
                      pad_multiple=cfg.edge_pad_multiple)
