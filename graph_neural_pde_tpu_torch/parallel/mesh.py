"""The multi-device mesh over ``torch.distributed`` (PyTorch port of
``parallel/mesh.py``).

The JAX package shards the padded edge list over a device mesh (axis
"edges") while node states and parameters stay replicated: per-edge work is
local to its shard and per-node sums become local partial sums plus one
all-reduce. In JAX the mesh is a ``jax.sharding.Mesh`` and ``shard_map``
derives the collectives; here it is a process group, one process a rank,
and the collectives are explicit (``parallel.collectives``).

A :class:`Mesh` is one of two kinds:

* a **group** (:func:`make_mesh`): this process is one rank of a
  ``torch.distributed`` process group, NCCL on CUDA devices and gloo on
  the CPU; it runs its own rank's shard;
* a **split** (:func:`split_mesh`): no group; this process runs every
  rank's shard in turn, rank by rank, and the collectives reduce the
  ranks' partials in rank order. It is the same decomposition on one device
  (one card holds one NCCL rank only: NCCL refuses two ranks on one GPU).

Every rank holds the whole graph, as every process loads the dataset; the
sharded functions (``parallel.shard_spmm``) take it whole and keep their
ranks' slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from graph_neural_pde_tpu_torch.ops.graph import Graph


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``size`` ranks over ``device``; ``ranks`` are those this process
    runs (its own in a group, all of them in a split); ``group`` is the
    process group, None for a split."""

    size: int
    ranks: Tuple[int, ...]
    device: torch.device
    group: Optional[object] = None

    @property
    def is_group(self) -> bool:
        return self.group is not None


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh device {dev}: cuda (NCCL) or cpu (gloo)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mesh on cuda: no CUDA device (pass "
                           "device='cpu' for a gloo mesh)")
    return dev


def make_mesh(n: Optional[int] = None, device=None, *,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The mesh of the first ``n`` ranks (all by default) of the process
    group, on ``device``: ``cuda`` (the default, NCCL) or ``cpu`` (gloo).
    Where no process group exists it initialises one from ``init_method``
    (``tcp://host:port`` or ``file://path``), ``rank`` and ``world_size``.
    Raises ``ValueError`` when the group has fewer than ``n`` ranks or this
    process's rank lies outside the mesh. Every rank of the group must
    call it (a mesh smaller than the group makes a new group)."""
    dev = _device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError("make_mesh: no process group exists; pass "
                             "init_method, rank and world_size")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    elif dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs "
                         f"{dist.get_backend()}, a {dev.type} mesh needs "
                         f"{backend}")
    world = dist.get_world_size()
    n = n or world
    if world < n:
        raise ValueError(f"mesh of {n} ranks: the process group has only "
                         f"{world} (start {n} processes)")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    r = dist.get_rank()
    if r >= n:
        raise ValueError(f"rank {r} lies outside the mesh of {n} ranks")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", r % torch.cuda.device_count())
    return Mesh(size=n, ranks=(r,), device=dev, group=group)


def split_mesh(n: int, device=None) -> Mesh:
    """A mesh of ``n`` ranks that this process runs one after the other on
    ``device`` (``cuda`` by default), without a process group."""
    if n < 1:
        raise ValueError(f"split_mesh: {n} ranks")
    return Mesh(size=n, ranks=tuple(range(n)), device=_device(device))


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` (nested dicts, lists and tuples) on the
    mesh's device, with rank 0's values on every rank of a group
    (broadcast): the state that the sharded functions take replicated."""
    def put(t):
        t = t.detach().to(mesh.device).contiguous()
        if mesh.is_group and mesh.size > 1:
            dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0),
                           group=mesh.group)
        return t
    return _map_tensors(tree, put)


def edge_ranges(mesh: Mesh, capacity: int):
    """The slot range [lo, hi) of each rank this process runs, in
    ``mesh.ranks`` order: capacity / size slots each, contiguous."""
    if capacity % mesh.size:
        raise ValueError(
            f"edge capacity {capacity} not divisible by mesh size "
            f"{mesh.size}; pad it first (ops.graph.pad_capacity)")
    s = capacity // mesh.size
    return [(r * s, (r + 1) * s) for r in mesh.ranks]


def shard_graph(mesh: Mesh, g: Graph) -> Tuple[Graph, ...]:
    """Each rank's slice of the padded edge arrays (``capacity / size``
    contiguous slots), for the ranks this process runs, on the mesh's
    device. Raises ``ValueError`` when the capacity does not divide the mesh
    size (``ops.graph.pad_capacity`` makes it so)."""
    return tuple(
        Graph(row=g.row[lo:hi].to(mesh.device),
              col=g.col[lo:hi].to(mesh.device),
              weight=g.weight[lo:hi].to(mesh.device),
              mask=g.mask[lo:hi].to(mesh.device), num_nodes=g.num_nodes)
        for lo, hi in edge_ranges(mesh, g.capacity))
