"""Lane groups of the kernels that walk rows of a node table: K1
``csr_spmm``, K2 ``edge_dot`` and K15 ``blocked_spmm``.

Each of them gives one unit of work to a group of lanes of one warp: an
output row (K1, K15) or an edge (K2). The group reads the table's rows as
vectors of V elements (16-byte loads where the row width and the table's
address allow, else 8, 4 or 2 bytes). :func:`lanes` picks the group's
lanes and V from the row width, the tables' addresses and their dtypes; the
kernels take both as arguments of their C entry points and refuse any pair
that they were not built for.

* K15 (``blocked_spmm``): the smallest power of two of lanes that covers
  the row's D / V vectors, at most a warp: a lane owns one vector.
* K1 (``csr_spmm``): one lane a row of at most ``CSR_LANE_ROW_BYTES``
  (the image paths' D = 1 and 3: the lane loads several edges' rows at
  once), else one lane a vector up to ``CSR_ONE_VECTOR`` vectors (D = 10,
  64, 80), two vectors a lane above (D = 128, 162), at most a warp.
  Measured on an H100 (``probes/lanes.py``, ``PERF.md``).
* K2 (``edge_dot``): the largest power of two of lanes, at most a warp,
  that leaves each lane at least ``EDGE_LANE_BYTES`` of the float32 row
  a[row] (one lane an edge at the image paths' D = 1 and D = 3, 4 at
  D = 80, 8 at D = 128 and D = 162; measured on an H100,
  ``probes/lanes.py``, ``PERF.md``).

K1 and K15 sum a row's vectors in registers, at most ``VECS_PER_LANE`` a
lane a pass, so a pass covers G * V * 4 features; wider rows take more
passes over the row's edges. K1 takes as many as its row needs (D / V /
G, rounded up), K2 as many as D / V / L.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

# the vectors a lane of K1 / K15 sums in registers in one pass
VECS_PER_LANE = 4
# the widest vector a lane loads at once
MAX_VECTOR_BYTES = 16
# K1: rows of at most these bytes take one lane; up to these vectors one
# lane a vector, and above them two vectors a lane
CSR_LANE_ROW_BYTES = 16
CSR_ONE_VECTOR = 24
# K2: the bytes of a[row] each lane of an edge's group reads, at least
EDGE_LANE_BYTES = 64
KERNELS = ("blocked_spmm", "csr_spmm", "edge_dot")

Table = Union[torch.Tensor, Tuple[int, torch.dtype]]


def _address(t: Table) -> Tuple[int, int]:
    """(address, element size) of a tensor or an (address, dtype) pair."""
    if torch.is_tensor(t):
        return t.data_ptr(), t.element_size()
    address, dtype = t
    return address, torch.empty((), dtype=dtype).element_size()


def vector_width(dim: int, *tables: Table) -> int:
    """The widest V, a power of two, such that V divides ``dim`` and V
    elements of each table are at most 16 bytes and lie on a V-element
    boundary: every row of a table then starts on one."""
    sized = [_address(t) for t in tables] or [(0, 4)]
    vec = MAX_VECTOR_BYTES // max(size for _, size in sized)
    while vec > 1 and (dim % vec or any(a % (vec * size)
                                        for a, size in sized)):
        vec //= 2
    return vec


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _pow2_at_most(n: int) -> int:
    return 1 << max(n, 1).bit_length() - 1


def lanes(kernel: str, dim: int, *tables: Table) -> Tuple[int, int]:
    """(lanes in a group, vector width V in elements) of ``kernel`` over
    rows of ``dim`` elements in ``tables`` (tensors or (address, dtype)
    pairs; float32 at address 0 when none is given). K1 and K15 pass the
    table they gather, K2 both tables it dots."""
    if kernel not in KERNELS:
        raise ValueError(f"lanes: no lane groups for {kernel!r}")
    vec = vector_width(dim, *tables)
    vecs = max(dim // vec, 1)
    if kernel == "edge_dot":
        return min(32, _pow2_at_most(4 * dim // EDGE_LANE_BYTES)), vec
    if kernel == "csr_spmm":
        size = max([_address(t)[1] for t in tables] or [4])
        if dim * size <= CSR_LANE_ROW_BYTES and vecs <= VECS_PER_LANE:
            return 1, vec
        if vecs > CSR_ONE_VECTOR:
            vecs = -(-vecs // 2)
    return min(32, _pow2_at_least(vecs)), vec
