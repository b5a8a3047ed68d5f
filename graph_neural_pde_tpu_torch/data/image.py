"""Image → pixel-grid graph pipeline, MNIST / CIFAR style (PyTorch port of
``data/image.py``).

Images become grid graphs with 4- or 8-neighbour connectivity (the
reference's edge counts), batched as one block-diagonal graph with a fixed
batch size. Raw MNIST idx files and CIFAR-10 pickles are parsed when
present; otherwise a seeded class-blob image set stands in. Everything here
is numpy on the host, bit-identical to the JAX package for one seed; the
graph is the port's ``ops.graph.Graph``.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass

import numpy as np

from graph_neural_pde_tpu_torch.ops.graph import Graph, make_graph


def grid_edge_index(h: int, w: int, diagonals: bool = False) -> np.ndarray:
    """Directed edge_index [2, E] of a h×w pixel grid (both directions).

    4-neighbour count: 2·((w−1)·h + w·(h−1)); 8-neighbour adds
    4·(w−1)·(h−1) more (data_image.py edge-count asserts).
    """
    idx = np.arange(h * w).reshape(h, w)
    pairs = []
    pairs.append((idx[:, :-1].ravel(), idx[:, 1:].ravel()))     # horizontal
    pairs.append((idx[:-1, :].ravel(), idx[1:, :].ravel()))     # vertical
    if diagonals:
        pairs.append((idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()))
        pairs.append((idx[:-1, 1:].ravel(), idx[1:, :-1].ravel()))
    r = np.concatenate([p[0] for p in pairs])
    c = np.concatenate([p[1] for p in pairs])
    row = np.concatenate([r, c])
    col = np.concatenate([c, r])
    expected = 2 * ((w - 1) * h + w * (h - 1))
    if diagonals:
        expected += 4 * (w - 1) * (h - 1)
    assert row.shape[0] == expected, (row.shape[0], expected)
    return np.stack([row, col]).astype(np.int64)


def batched_grid_graph(batch_size: int, h: int, w: int,
                       diagonals: bool = False, pad_multiple: int = 1
                       ) -> Graph:
    """Block-diagonal graph of `batch_size` identical grids."""
    ei = grid_edge_index(h, w, diagonals)
    n = h * w
    rows = np.concatenate([ei[0] + b * n for b in range(batch_size)])
    cols = np.concatenate([ei[1] + b * n for b in range(batch_size)])
    return make_graph(rows.astype(np.int32), cols.astype(np.int32), None,
                      num_nodes=batch_size * n, pad_multiple=pad_multiple)


# ---------------------------------------------------------------------------
# MNIST idx parsing + synthetic fallback
# ---------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def load_mnist(data_dir: str, train: bool = True):
    """Raw MNIST idx(.gz) files under {data_dir}/MNIST/raw/."""
    part = "train" if train else "t10k"
    raw = os.path.join(data_dir, "MNIST", "raw")
    for ext in ("", ".gz"):
        xi = os.path.join(raw, f"{part}-images-idx3-ubyte{ext}")
        yi = os.path.join(raw, f"{part}-labels-idx1-ubyte{ext}")
        if os.path.exists(xi) and os.path.exists(yi):
            x = _read_idx(xi).astype(np.float32) / 255.0
            y = _read_idx(yi).astype(np.int64)
            return x[..., None], y      # [N, 28, 28, 1]
    raise FileNotFoundError(raw)


def load_cifar10(data_dir: str, train: bool = True):
    """CIFAR-10 python-pickle batches under {data_dir}/cifar-10-batches-py/."""
    import pickle as pkl
    base = os.path.join(data_dir, "cifar-10-batches-py")
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for name in names:
        path = os.path.join(base, name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "rb") as f:
            d = pkl.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.float32) / 255.0)
        ys.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.concatenate(ys)           # [N, 32, 32, 3]


def synthetic_images(n=512, h=12, w=12, num_classes=4, seed=0):
    """Class-dependent Gaussian blobs — a learnable MNIST stand-in."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n)
    yy, xx = np.mgrid[0:h, 0:w]
    imgs = np.empty((n, h, w, 1), np.float32)
    for i in range(n):
        cx = (y[i] + 1) * w / (num_classes + 1)
        cy = (y[i] % 2 + 1) * h / 3
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 6.0))
        imgs[i, :, :, 0] = blob + 0.15 * rng.normal(size=(h, w))
    return imgs, y


@dataclass
class ImageBatches:
    """Host-side batch iterator over images as flattened pixel features."""

    x: np.ndarray       # [N, H, W, C]
    y: np.ndarray       # [N]
    batch_size: int
    graph: Graph
    h: int
    w: int
    c: int

    def batches(self, seed=0, shuffle=True):
        n = (self.x.shape[0] // self.batch_size) * self.batch_size
        order = (np.random.default_rng(seed).permutation(n) if shuffle
                 else np.arange(n))
        for s in range(0, n, self.batch_size):
            sel = order[s:s + self.batch_size]
            feats = self.x[sel].reshape(self.batch_size * self.h * self.w,
                                        self.c)
            yield feats.astype(np.float32), self.y[sel].astype(np.int64)


def load_image_dataset(data_dir: str, dataset: str = "MNIST",
                       batch_size: int = 64, diagonals: bool = False,
                       train: bool = True, synthetic_fallback: bool = True
                       ) -> ImageBatches:
    try:
        if dataset.upper() == "MNIST":
            x, y = load_mnist(data_dir, train)
        elif dataset.upper() in ("CIFAR", "CIFAR10"):
            x, y = load_cifar10(data_dir, train)
        else:
            raise FileNotFoundError(dataset)
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        x, y = synthetic_images()
    h, w, c = x.shape[1], x.shape[2], x.shape[3]
    g = batched_grid_graph(batch_size, h, w, diagonals)
    return ImageBatches(x=x, y=y, batch_size=batch_size, graph=g, h=h, w=w,
                        c=c)
