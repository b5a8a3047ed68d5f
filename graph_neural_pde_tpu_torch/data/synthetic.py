"""Synthetic node-classification datasets (PyTorch port of
``data/synthetic.py``).

A stochastic block model with class-correlated Gaussian features, sized and
split like the citation benchmarks. ``make_sbm_dataset`` draws exactly the
JAX package's numpy random stream, so for one seed both packages build the
bit-identical graph, features and masks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graph_neural_pde_tpu_torch.ops.graph import Graph, make_graph


@dataclass
class NodeDataset:
    """Host-side dataset container (CPU tensors; the model moves them)."""

    graph: Graph
    x: torch.Tensor
    y: torch.Tensor
    train_mask: torch.Tensor
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    num_classes: int
    num_features: int
    name: str = "synthetic"


def make_sbm_dataset(num_nodes=120, num_classes=3, num_features=16,
                     avg_degree=8, homophily=0.85, train_per_class=20,
                     num_val=30, seed=0, edge_pad_multiple=64,
                     feature_signal=2.0) -> NodeDataset:
    """``feature_signal`` scales the class-mean separation relative to the
    unit feature noise (see the JAX package for the calibration)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)

    means = rng.normal(scale=feature_signal,
                       size=(num_classes, num_features))
    x = means[y] + rng.normal(size=(num_nodes, num_features))

    # SBM edges: sample pairs, keep intra-class with prob homophily. The
    # draw order is the JAX package's, one pair and one coin at a time.
    target_edges = num_nodes * avg_degree // 2
    rows, cols = [], []
    trials = 0
    while len(rows) < target_edges and trials < 50 * target_edges:
        u, v = rng.integers(0, num_nodes, size=2)
        trials += 1
        if u == v:
            continue
        same = y[u] == y[v]
        p = homophily if same else (1.0 - homophily)
        if rng.random() < p:
            rows.append(u)
            cols.append(v)
    row = np.array(rows + cols, np.int32)   # undirected: both directions
    col = np.array(cols + rows, np.int32)

    train_per_class = min(train_per_class,
                          max(1, num_nodes // (2 * num_classes)))
    train_mask = np.zeros(num_nodes, bool)
    for c in range(num_classes):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        train_mask[idx[:train_per_class]] = True
    remaining = np.where(~train_mask)[0]
    rng.shuffle(remaining)
    num_val = min(num_val, max(1, len(remaining) // 2))
    val_mask = np.zeros(num_nodes, bool)
    val_mask[remaining[:num_val]] = True
    test_mask = ~(train_mask | val_mask)
    if not (test_mask.any() and val_mask.any() and train_mask.any()):
        raise ValueError("empty split; use more nodes")

    g = make_graph(row, col, num_nodes=num_nodes,
                   pad_multiple=edge_pad_multiple)
    return NodeDataset(
        graph=g,
        x=torch.as_tensor(x, dtype=torch.float32),
        y=torch.as_tensor(y, dtype=torch.int64),
        train_mask=torch.as_tensor(train_mask),
        val_mask=torch.as_tensor(val_mask),
        test_mask=torch.as_tensor(test_mask),
        num_classes=num_classes,
        num_features=num_features,
    )


def make_random_graph_dataset(num_nodes=169_343, num_edges=1_166_243,
                              num_features=128, num_classes=40, seed=0,
                              edge_pad_multiple=1024) -> NodeDataset:
    """A symmetric random graph at ogbn-arxiv's node and edge counts with
    Gaussian features: the graph of the JAX package's ``bench.py``
    (``build_benchmark``: ``num_edges`` uniform pairs, both directions,
    duplicates and self loops kept), with uniform random labels and a
    random 60/20/20 split so that it can also be trained on. It measures
    and exercises; nothing can be learnt from it."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    col = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    g = make_graph(np.concatenate([row, col]).astype(np.int32),
                   np.concatenate([col, row]).astype(np.int32),
                   num_nodes=num_nodes, pad_multiple=edge_pad_multiple)
    x = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_nodes)
    part = rng.random(num_nodes)
    return NodeDataset(
        graph=g, x=torch.as_tensor(x), y=torch.as_tensor(y, dtype=torch.int64),
        train_mask=torch.as_tensor(part < 0.6),
        val_mask=torch.as_tensor((part >= 0.6) & (part < 0.8)),
        test_mask=torch.as_tensor(part >= 0.8),
        num_classes=num_classes, num_features=num_features,
        name="ogbn-arxiv-synthetic")
