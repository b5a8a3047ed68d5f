"""Dataset loading for the port (PyTorch port of ``data/datasets.py``).

Ported here: the Planetoid raw format (Cora / Citeseer / Pubmed, the
``ind.{name}.*`` pickles, with the Citeseer isolated-test-node fix), the
Shchur et al. ``.npz`` format (Amazon Computers / Photo, Coauthor CS), the
OGB raw ``csv.gz`` layout of ogbn-arxiv with its time split,
``to_undirected`` + dedupe, largest-connected-component extraction, the
seeded development/test split (5,000 development nodes for CoauthorCS,
1,500 otherwise), and the size-matched SBM stand-in used when the raw files
are absent, with its calibrated feature signal and homophily. The stand-in
and the splits are bit-identical to the JAX package's for one seed.

``ogbn-arxiv-synthetic`` is the seeded random graph at ogbn-arxiv's size
that the JAX package's ``bench.py`` measures on (nothing is read from disk).

``cfg.rewiring`` (``two_hop`` or ``gdc``, ``rewiring/gdc.py``, or
``pos_enc_knn``, ``rewiring/knn.py``) rewires the loaded graph where the JAX
package does: after the largest connected component, before training, and
on the stand-in too; GDC's dense diffusion, DeepWalk and the kNN search run
on ``device``. ``cfg.node_reorder`` (``rcm`` or ``degree``) then
relabels the loaded dataset (``ops.reorder``), the stand-in included, as the
JAX package does. The geom-gcn loaders are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import gzip
import os
import pickle
import sys

import numpy as np
import torch

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.data.synthetic import (
    NodeDataset, make_random_graph_dataset, make_sbm_dataset)
from graph_neural_pde_tpu_torch.ops.graph import make_graph


class DatasetUnavailable(FileNotFoundError):
    pass


# approximate real shapes, for the synthetic fallback
_SHAPES = {
    "Cora": (2708, 1433, 7), "Citeseer": (3327, 3703, 6),
    "Pubmed": (19717, 500, 3), "Computers": (13752, 767, 10),
    "Photo": (7650, 745, 8), "CoauthorCS": (18333, 6805, 15),
    "ogbn-arxiv": (169343, 128, 40),
}
_PLANETOID = ("Cora", "Citeseer", "Pubmed")
# Shchur et al. .npz file of each Amazon / Coauthor dataset
_SHCHUR = {"Computers": "amazon_electronics_computers.npz",
           "Photo": "amazon_electronics_photo.npz",
           "CoauthorCS": "ms_academic_cs.npz"}

_GEOM_GCN = ("cornell", "texas", "wisconsin", "chameleon", "squirrel", "film")


def _parse_index_file(path):
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], np.int64)


def load_planetoid(root: str, name: str):
    """Parse the ind.* pickle format (PyG Planetoid raw layout)."""
    import scipy.sparse as sp

    lname = name.lower()
    raw = os.path.join(root, name, "raw")
    if not os.path.isdir(raw):
        raw = os.path.join(root, name)
    objs = {}
    for suffix in ("x", "tx", "allx", "y", "ty", "ally", "graph"):
        p = os.path.join(raw, f"ind.{lname}.{suffix}")
        if not os.path.exists(p):
            raise DatasetUnavailable(p)
        with open(p, "rb") as f:
            objs[suffix] = pickle.load(f, encoding="latin1")
    test_idx = _parse_index_file(os.path.join(raw, f"ind.{lname}.test.index"))

    x, tx, allx = objs["x"], objs["tx"], objs["allx"]
    y, ty, ally = objs["y"], objs["ty"], objs["ally"]

    test_sorted = np.sort(test_idx)
    if lname == "citeseer":
        # isolated test nodes: pad tx/ty over the full test range
        full = np.arange(test_sorted[0], test_sorted[-1] + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]), dtype=np.float32)
        tx_ext[test_sorted - test_sorted[0]] = tx
        ty_ext = np.zeros((len(full), ty.shape[1]), ty.dtype)
        ty_ext[test_sorted - test_sorted[0]] = ty
        tx, ty = tx_ext, ty_ext

    features = sp.vstack([allx, tx]).tolil()
    features[test_idx, :] = features[test_sorted, :]
    labels_oh = np.vstack([ally, ty])
    labels_oh[test_idx, :] = labels_oh[test_sorted, :]
    labels = labels_oh.argmax(axis=1).astype(np.int64)

    rows, cols = [], []
    for src, nbrs in objs["graph"].items():
        rows.extend([src] * len(nbrs))
        cols.extend(nbrs)
    edge_index = np.stack([np.array(rows, np.int64), np.array(cols, np.int64)])
    edge_index = to_undirected(edge_index)

    n = labels.shape[0]
    train_mask = np.zeros(n, bool)
    train_mask[: y.shape[0]] = True
    val_mask = np.zeros(n, bool)
    val_mask[y.shape[0]: y.shape[0] + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_idx] = True
    return (np.asarray(features.todense(), np.float32), labels, edge_index,
            train_mask, val_mask, test_mask)


def load_shchur_npz(root: str, name: str, fname: str):
    """Parse the Shchur et al. .npz layout (CSR adjacency and attributes,
    labels), symmetrised and deduplicated."""
    import scipy.sparse as sp
    candidates = [os.path.join(root, name, "raw", fname),
                  os.path.join(root, name, fname),
                  os.path.join(root, fname)]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        raise DatasetUnavailable(candidates[0])
    with np.load(path, allow_pickle=True) as loader:
        d = dict(loader)
    adj = sp.csr_matrix((d["adj_data"], d["adj_indices"], d["adj_indptr"]),
                        shape=d["adj_shape"]).tocoo()
    attr = sp.csr_matrix((d["attr_data"], d["attr_indices"],
                          d["attr_indptr"]), shape=d["attr_shape"])
    x = np.asarray(attr.todense(), np.float32)
    y = d["labels"].astype(np.int64)
    edge_index = to_undirected(
        np.stack([adj.row.astype(np.int64), adj.col.astype(np.int64)]))
    return x, y, edge_index


def load_ogbn_arxiv(root: str):
    """Parse OGB's raw layout (``ogbn_arxiv/raw/{edge,node-feat,node-label}
    .csv.gz``) and its time split (``split/time/{train,valid,test}.csv.gz``);
    the citation edges are symmetrised and deduplicated."""
    base = os.path.join(root, "ogbn-arxiv", "ogbn_arxiv")
    if not os.path.isdir(base):
        base = os.path.join(root, "ogbn_arxiv")
    raw, split = os.path.join(base, "raw"), os.path.join(base, "split", "time")
    if not os.path.isdir(raw):
        raise DatasetUnavailable(raw)

    def csv_gz(path):
        with gzip.open(path, "rt") as f:
            return np.loadtxt(f, delimiter=",")

    edge = csv_gz(os.path.join(raw, "edge.csv.gz")).astype(np.int64).T
    x = csv_gz(os.path.join(raw, "node-feat.csv.gz")).astype(np.float32)
    y = csv_gz(os.path.join(raw, "node-label.csv.gz")).astype(np.int64).ravel()
    masks = []
    for part in ("train", "valid", "test"):
        idx = csv_gz(os.path.join(split, f"{part}.csv.gz")).astype(np.int64)
        m = np.zeros(x.shape[0], bool)
        m[idx] = True
        masks.append(m)
    return (x, y, to_undirected(edge), *masks)


def _num_development(ds: str) -> int:
    """Development-set size of the seeded split (reference data.py:97-101)."""
    return 5000 if ds == "CoauthorCS" else 1500


def to_undirected(edge_index: np.ndarray) -> np.ndarray:
    row = np.concatenate([edge_index[0], edge_index[1]])
    col = np.concatenate([edge_index[1], edge_index[0]])
    return dedupe(np.stack([row, col]))


def dedupe(edge_index: np.ndarray) -> np.ndarray:
    """Drop repeated (row, col) pairs, keeping first occurrences in order."""
    key = edge_index[0] * (edge_index.max() + 1) + edge_index[1]
    _, idx = np.unique(key, return_index=True)
    return edge_index[:, np.sort(idx)]


def largest_connected_component(edge_index: np.ndarray, n: int) -> np.ndarray:
    """Node ids of the largest connected component."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    a = sp.coo_matrix((np.ones(edge_index.shape[1]),
                       (edge_index[0], edge_index[1])), shape=(n, n))
    ncomp, labels = connected_components(a, directed=False)
    if ncomp == 1:
        return np.arange(n)
    sizes = np.bincount(labels)
    return np.where(labels == sizes.argmax())[0]


def restrict_to_nodes(edge_index, keep: np.ndarray):
    """Remap edges onto the kept-node index space."""
    n_old = int(max(edge_index.max(), keep.max())) + 1
    mapper = np.full(n_old, -1, np.int64)
    mapper[keep] = np.arange(len(keep))
    r, c = mapper[edge_index[0]], mapper[edge_index[1]]
    m = (r >= 0) & (c >= 0)
    return np.stack([r[m], c[m]])


def set_train_val_test_split(seed: int, y: np.ndarray, num_development=1500,
                             num_per_class=20):
    """Seeded development/test split (reference data.py:147-174, the same
    RandomState draws)."""
    rnd_state = np.random.RandomState(seed)
    num_nodes = y.shape[0]
    development_idx = rnd_state.choice(num_nodes, num_development,
                                       replace=False)
    dev_set = set(development_idx.tolist())
    test_idx = [i for i in range(num_nodes) if i not in dev_set]

    train_idx = []
    rnd_state = np.random.RandomState(seed)
    for c in range(int(y.max()) + 1):
        class_idx = development_idx[np.where(y[development_idx] == c)[0]]
        train_idx.extend(
            rnd_state.choice(class_idx, num_per_class,
                             replace=False).tolist())
    train_set = set(train_idx)
    val_idx = [i for i in development_idx if i not in train_set]

    def mask(idx):
        m = np.zeros(num_nodes, bool)
        m[np.asarray(idx, np.int64)] = True
        return m

    return mask(train_idx), mask(val_idx), mask(test_idx)


def _masks_to_torch(d: NodeDataset, masks):
    d.train_mask, d.val_mask, d.test_mask = (torch.as_tensor(m)
                                             for m in masks)


def _stand_in(cfg: Config, data_dir: str, pad: int) -> NodeDataset:
    """The size-matched SBM stand-in with the JAX package's calibration
    (datasets.py:378-433 there): feature signal 2/sqrt(F)·sqrt(log C/log 7)
    and an intra-class edge fraction held at 17/35 for every class count."""
    ds = cfg.dataset
    n, f, c = _SHAPES.get(ds, (3000, 128, 7))
    print(f"[data] raw files for {ds} not found under {data_dir}; "
          f"using a size-matched synthetic SBM stand-in", file=sys.stderr)
    nf_syn = min(f, 512)
    sig = (2.0 / float(np.sqrt(nf_syn))
           * float(np.sqrt(np.log(max(c, 2)) / np.log(7.0))))
    frac_star = 0.85 / 1.75
    cc = max(c, 2)
    homo = frac_star * (cc - 1) / (1.0 + frac_star * (cc - 2))
    d = make_sbm_dataset(num_nodes=min(n, 20000), num_classes=c,
                         num_features=nf_syn, edge_pad_multiple=pad,
                         seed=cfg.seed, feature_signal=sig, homophily=homo)
    n_nodes = int(d.y.shape[0])
    dev = _num_development(ds)
    if n_nodes > dev + 100:
        _masks_to_torch(d, set_train_val_test_split(12345, d.y.numpy(), dev))
    d.name = f"{ds}-synthetic"
    return d


def rewire(g, cfg: Config, data_dir=None, device="cuda"):
    """Load-time rewiring dispatch (the reference's data.py): ``two_hop``,
    ``gdc`` or ``pos_enc_knn`` (whose positional encodings are cached under
    ``data_dir``), each returning a rebuilt host Graph."""
    from graph_neural_pde_tpu_torch.rewiring import gdc, knn
    rw = cfg.rewiring
    if rw == "two_hop":
        return gdc.two_hop(g, pad_multiple=cfg.edge_pad_multiple)
    if rw == "gdc":
        return gdc.apply_gdc(g, cfg, pad_multiple=cfg.edge_pad_multiple,
                             device=device)
    if rw == "pos_enc_knn":
        return knn.apply_pos_dist_rewire(g, cfg, data_dir, device=device)
    raise ValueError(f"unknown rewiring '{rw}'")


def get_dataset(cfg: Config, data_dir: str, use_lcc: bool = False, *,
                synthetic_fallback: bool = True,
                device="cuda") -> NodeDataset:
    """Load and preprocess a dataset (reference get_dataset semantics).
    ``device`` is where the rewiring runs its dense diffusion, DeepWalk and
    kNN search: the card unless the caller asks for the CPU (``run.setup``
    passes the run's device); nothing else of the load touches it."""
    ds = cfg.dataset
    pad = cfg.edge_pad_multiple
    if ds == "ogbn-arxiv-synthetic":
        # the random graph of the JAX package's bench.py, made from cfg.seed
        return make_random_graph_dataset(seed=cfg.seed,
                                         edge_pad_multiple=max(pad, 1))
    if ds in _GEOM_GCN:
        raise NotImplementedError(
            f"dataset {ds}: geom-gcn loader, ROADMAP Queue 1 slice 5")
    if ds not in _PLANETOID and ds not in _SHCHUR and ds != "ogbn-arxiv":
        raise ValueError(f"Unknown dataset {ds}.")
    masks = None
    try:
        if ds in _PLANETOID:
            x, y, ei, *masks = load_planetoid(data_dir, ds)
        elif ds == "ogbn-arxiv":
            x, y, ei, *masks = load_ogbn_arxiv(data_dir)
            use_lcc = False    # the reference keeps the whole graph
        else:
            x, y, ei = load_shchur_npz(data_dir, ds, _SHCHUR[ds])
    except DatasetUnavailable:
        if not synthetic_fallback:
            raise
        d = _stand_in(cfg, data_dir, pad)
        if cfg.rewiring is not None:
            d.graph = rewire(d.graph, cfg, data_dir, device)
        return _maybe_reorder(d, cfg)

    if use_lcc:
        lcc = largest_connected_component(ei, x.shape[0])
        x, y = x[lcc], y[lcc]
        ei = restrict_to_nodes(ei, lcc)
        masks = None   # LCC invalidates fixed masks (data.py:70-73)
    if masks is None:
        masks = set_train_val_test_split(12345, y,
                                         num_development=_num_development(ds))

    g = make_graph(ei[0], ei[1], num_nodes=x.shape[0], pad_multiple=pad)
    if cfg.rewiring is not None:
        # after the LCC, before training (the reference's data.py)
        g = rewire(g, cfg, data_dir, device)
    d = NodeDataset(graph=g, x=torch.as_tensor(x),
                    y=torch.as_tensor(y, dtype=torch.int64),
                    train_mask=None, val_mask=None, test_mask=None,
                    num_classes=int(y.max()) + 1, num_features=x.shape[1],
                    name=ds)
    _masks_to_torch(d, masks)
    return _maybe_reorder(d, cfg)


def _maybe_reorder(d: NodeDataset, cfg: Config) -> NodeDataset:
    """cfg.node_reorder: the block-locality relabelling (ops/reorder.py)."""
    if cfg.node_reorder in (None, "none"):
        return d
    from graph_neural_pde_tpu_torch.ops.reorder import reorder_dataset
    return reorder_dataset(d, cfg.node_reorder)[0]
