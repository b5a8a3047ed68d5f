"""K21 ``smem_gather``: a row gather from a table held in shared memory.

``out[i] = table[idx[i]]`` for a small table [T, D] of float32 or bfloat16
rows, staged whole in each block's shared memory.

Replaces the TPU probe kernels ``examples/perf_probe13_vmem_gather.py``
``pallas_take_kernel`` (probe 13's B, a gather from a VMEM table) and
``pallas_onehot_kernel`` (its C, the same gather as a one-hot product with
a bf16 table); see the source note in ``csrc/smem_gather.cu``. A table
larger than a block's shared memory (227 KB) makes the wrapper raise, as
the TPU compiler refused B at T >= 64. On a CUDA tensor the wrapper
launches the hand-written kernel or raises; on a CPU tensor it runs
:func:`smem_gather_plain`.
"""

from __future__ import annotations

import torch

from graph_neural_pde_tpu_torch.kernels import build

SHARED_BYTES = 232_448      # the most shared memory a block can have
_THREADS = 512              # the kernel's block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_gather_plain(idx: torch.Tensor, table: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version: ``index_select`` of the table's rows."""
    return torch.index_select(table, 0, idx.long())


def table_bytes(table: torch.Tensor) -> int:
    return table.shape[0] * table.shape[1] * table.element_size()


def table_fits(table: torch.Tensor) -> bool:
    """Whether a block's shared memory holds ``table``."""
    return table_bytes(table) <= SHARED_BYTES


def width_fits(table: torch.Tensor) -> bool:
    """Whether the kernel copies ``table``'s rows: a whole number of
    16-byte words that divides its 512 threads (D = 128 in float32 or
    bfloat16 does; a width no caller gives, such as 130, does not)."""
    row_bytes = table.shape[1] * table.element_size()
    return (row_bytes > 0 and row_bytes % 16 == 0
            and _THREADS % (row_bytes // 16) == 0)


def _check(idx, table):
    if idx.device != table.device:
        raise ValueError(f"smem_gather: idx on {idx.device}, table on "
                         f"{table.device}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise TypeError("smem_gather: idx must be contiguous 1-D int32")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("smem_gather: table must be a contiguous [T, D] "
                         "tensor")
    if table.dtype not in _DTYPES:
        raise TypeError(f"smem_gather: table must be float32 or bfloat16, "
                        f"not {table.dtype}")


def smem_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` [M, D] in the table's dtype. Indices must lie in
    ``[0, T)``; the kernel does not check them. Raises ``ValueError`` on a
    CUDA table of more than 227 KB, which no block's shared memory holds,
    or whose rows the kernel does not copy (:func:`width_fits`)."""
    _check(idx, table)
    if table.device.type == "cpu":
        return smem_gather_plain(idx, table)
    if table.device.type != "cuda":
        raise NotImplementedError(f"smem_gather: no kernel for "
                                  f"{table.device}")
    if not width_fits(table):
        raise ValueError(
            f"smem_gather: rows of {table.shape[1]} {table.dtype} are not a "
            f"whole number of 16-byte words dividing {_THREADS}")
    if not table_fits(table):
        raise ValueError(
            f"smem_gather: a table of {table.shape[0]} x {table.shape[1]} "
            f"{table.dtype} ({table_bytes(table)} bytes) does not fit in "
            f"the {SHARED_BYTES} bytes of shared memory a block can have")
    t_rows, d = table.shape
    out = torch.empty((idx.shape[0], d), dtype=table.dtype,
                      device=table.device)
    build.launch("smem_gather", table.device, idx.data_ptr(),
                 table.data_ptr(), out.data_ptr(), idx.shape[0], t_rows, d,
                 _DTYPES[table.dtype])
    smem_gather.launches += 1
    return out


smem_gather.launches = 0
