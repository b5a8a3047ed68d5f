"""Parameter conversion between the JAX package and the port.

The JAX package keeps parameters as a nested dict pytree, and the batch
norm's running statistics in a second ``state`` pytree; the port's modules
mirror its names (``m1``, or BLEND's dual encoder ``mx`` and ``mp``,
``m2``, ``block.func``, ``block.att`` with ``Q``/``K``/``V``/``Wout`` and the
exp_kernel's ``output_var`` / ``lengthscale``, or BLEND's ``Qx``/``Kx``/
``Vx``/``Qp``/``Kp``/``Vp``/``Wout`` and ``output_var_x``/``lengthscale_x``/
``output_var_p``/``lengthscale_p``, the GAT function's ``block.func.att``
with ``W``/``Wout``/``a``, the mixed block's ``block.gamma``, ``bn_in`` with
``scale``/``bias``;
the image model's ``m2`` and ``block``;
a block without an attention layer of its own simply has no ``block.att``
in either package) and keep its
``[in, out]`` weight orientation, so a leaf's dotted path is its
``state_dict`` key and no array is transposed. The batch norm's running
``mean``, ``var`` and ``count`` are buffers of ``bn_in`` in the port. The
JAX-only ``adjoint_nfe_probe`` leaf (a gradient side channel of the
continuous adjoint) has no counterpart and is dropped.

Takes and returns numpy-compatible arrays; this module imports no jax.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

_JAX_ONLY = ("adjoint_nfe_probe",)
# the batch norm's running statistics: JAX state leaves, port buffers
_STATE_LEAVES = ("mean", "var", "count")


def _flatten(tree: Mapping, out: Dict[str, torch.Tensor], prefix: str = ""):
    for key, val in tree.items():
        if key in _JAX_ONLY:
            continue
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            _flatten(val, out, name + ".")
        else:
            out[name] = torch.from_numpy(
                np.array(val, dtype=np.float32, copy=True))


def _nest(items) -> dict:
    tree: dict = {}
    for name, val in items:
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().cpu().numpy()
    return tree


def _is_state(name: str) -> bool:
    parts = name.split(".")
    return parts[0] == "bn_in" and parts[-1] in _STATE_LEAVES


def params_from_jax(tree: Mapping, state: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flatten a JAX params pytree (nested dicts of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``), and its model ``state`` where it
    has one (batch norm), into a port ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(tree, out)
    if state:
        _flatten(state, out)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The JAX params pytree of a port ``state_dict`` (the JAX-only probe
    leaf is restored as 0.0 where the JAX package has one)."""
    tree = _nest((k, v) for k, v in state_dict.items() if not _is_state(k))
    func = tree.get("block", {}).get("func")
    if func is not None:
        func.setdefault("adjoint_nfe_probe", np.zeros((), np.float32))
    return tree


def state_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The JAX model state pytree (batch-norm running statistics) of a port
    ``state_dict``; empty without batch norm."""
    return _nest((k, v) for k, v in state_dict.items() if _is_state(k))
