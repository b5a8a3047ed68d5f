"""Lane groups of the kernels that walk rows of a node table: K1
``csr_spmm``, K2 ``edge_dot``, K10 ``dual_scatter``, K11 ``dual_gather``
and K15 ``blocked_spmm``.

Each of them gives one unit of work to a group of lanes of one warp: an
output row (K1, K15), a row piece (K10, K11) or an edge (K2). The group
reads the table's rows as vectors of V elements (16-byte loads where the
row width and the table's address allow, else 8, 4 or 2 bytes).
:func:`lanes` picks the group's lanes and V from the row width, the
tables' addresses and their dtypes; the kernels take both as arguments of
their C entry points and refuse any pair that they were not built for.

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
* K10 and K11 (``dual_scatter``, ``dual_gather``): built for 16-byte
  vectors of x (4 floats, 8 bfloat16s) at 4, 8, 16 or 32 lanes, and for
  single elements at 32 lanes, where D or an address rules the wide
  vector out (K11's du walk reads ct_num's rows as float vectors beside
  x's, on 16-byte boundaries too; its dx walk, which passes ct_num alone,
  reads float32 rows only). A group covers its row in one pass: one lane
  a vector up to ``DUAL_ONE_VECTOR`` vectors, two above, at least
  ``DUAL_MIN_LANES`` lanes. K10 wants more lanes than K11: at D = 128 one
  vector a lane (32 lanes), where K11's walks take two (16), and at D = 16
  at least 8 lanes; on a bfloat16 table with more than
  ``DUAL_WIDE_HEADS`` heads it reads 8-byte vectors at 32 lanes, whose
  heads' sums take half the registers of 16-byte ones (measured on an
  H100, ``probes/lanes.py``, ``PERF.md``).

* K18 and K8's per-head mode over the scaled-dot fold (``payload_walk``,
  ``csrc/payload_walk.cuh``): K10's groups over the payload x_g (one lane
  a 16-byte vector up to ``DUAL_ONE_VECTOR["dual_scatter"]`` vectors, two
  above, at least ``DUAL_MIN_LANES["dual_scatter"]`` lanes; a bfloat16
  payload of more than ``DUAL_WIDE_HEADS`` heads in 8-byte vectors at 32
  lanes, so that 8 heads take one pass), where the float32 tables read
  beside it in vectors of V floats (Kw^T, ct_num, the outputs) lie on
  16-byte boundaries too; else single elements at 32 lanes.

K1 and K15 sum a row's vectors in registers, at most ``VECS_PER_LANE`` a
lane a pass, so a pass covers G * V * 4 features; wider rows take more
passes over the row's edges. K1 takes as many as its row needs (D / V /
G, rounded up), K2 as many as D / V / L.

K1's staging depth follows the rows (:func:`csr_design`): from the mean
row length, the edges over the rows, which the caller knows (a graph's
``num_valid``) without reading ``rowptr`` back from the card, a round
stages ``CSR_LONG_STAGE`` (col, w) pairs a lane where the rows are longer
than the group's lanes, else one (or as many as its batch needs).
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
# K10, K11: up to these vectors one lane a vector, two vectors a lane
# above, and at least these lanes a group
DUAL_ONE_VECTOR = {"dual_scatter": 32, "dual_gather": 24}
DUAL_MIN_LANES = {"dual_scatter": 8, "dual_gather": 4}
# K10 on a bfloat16 table: above these heads, 8-byte vectors at 32 lanes
DUAL_WIDE_HEADS = 4
# K1: the (col, w) pairs a lane stages a round on rows longer than the
# group (csrc/csr_spmm.cu's S)
CSR_LONG_STAGE = 4
DUAL_KERNELS = ("dual_scatter", "dual_gather")
KERNELS = ("blocked_spmm", "csr_spmm", "edge_dot", "payload_walk") \
    + DUAL_KERNELS

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


def lanes(kernel: str, dim: int, *tables: Table,
          heads: int = 1) -> Tuple[int, int]:
    """(lanes in a group, vector width V in elements) of ``kernel`` over
    rows of ``dim`` elements in ``tables`` (tensors or (address, dtype)
    pairs; float32 at address 0 when none is given). K1 and K15 pass the
    table they gather, K2 both tables it dots, K10 x (with its ``heads``),
    K11's du walk x and ct_num, its dx walk ct_num, the payload walks x_g
    and the float32 tables they read or write in vectors (with ``heads``)."""
    if kernel not in KERNELS:
        raise ValueError(f"lanes: no lane groups for {kernel!r}")
    if kernel in DUAL_KERNELS:
        return _dual_lanes(kernel, dim, heads, *tables)
    if kernel == "payload_walk":
        return _payload_lanes(dim, heads, *tables)
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


def csr_design(dim: int, mean_row: float, *tables: Table
               ) -> Tuple[int, int, int]:
    """K1's (lanes G, vector width V, stage S): :func:`lanes`'s (G, V),
    and ``CSR_LONG_STAGE`` (col, w) pairs a lane a round where the rows
    hold more edges than the group has lanes on average (``mean_row``:
    the edges over the rows), else 1."""
    group, vec = lanes("csr_spmm", dim, *tables)
    return group, vec, CSR_LONG_STAGE if mean_row > group else 1


def _dual_lanes(kernel: str, dim: int, heads: int,
                x: Table = (0, torch.float32),
                *floats: Table) -> Tuple[int, int]:
    """K10 / K11's (G, V): 16-byte vectors of the table ``x`` where D and
    every address allow (the float32 ``floats`` read beside it on 16-byte
    boundaries), else single elements at 32 lanes; then a lane a vector up
    to ``DUAL_ONE_VECTOR`` vectors, two above, ``DUAL_MIN_LANES`` to 32
    lanes. K10 over a bfloat16 table and more than ``DUAL_WIDE_HEADS``
    heads: 8-byte vectors at 32 lanes, where D and x's address allow."""
    address, size = _address(x)
    wide = MAX_VECTOR_BYTES // size
    if kernel == "dual_scatter" and size == 2 and heads > DUAL_WIDE_HEADS:
        half = wide // 2
        return (32, half) if not (dim % half or address % 8) else (32, 1)
    if (dim % wide or address % MAX_VECTOR_BYTES
            or any(_address(t)[0] % MAX_VECTOR_BYTES for t in floats)):
        return 32, 1
    vecs = dim // wide
    if vecs > DUAL_ONE_VECTOR[kernel]:
        vecs = -(-vecs // 2)
    return min(32, max(DUAL_MIN_LANES[kernel], _pow2_at_least(vecs))), wide


def _payload_lanes(dim: int, heads: int, x: Table = (0, torch.float32),
                   *floats: Table) -> Tuple[int, int]:
    """The payload walks' (G, V): K10's over the payload ``x`` where every
    float32 table of ``floats`` lies on a 16-byte boundary (they are read
    in vectors of V floats, 16 bytes at least), else single elements at
    32 lanes."""
    if any(_address(t)[0] % MAX_VECTOR_BYTES for t in floats):
        return 32, 1
    return _dual_lanes("dual_scatter", dim, heads, x)
