"""Parameter conversion between the JAX package and the port.

The JAX package keeps parameters as a nested dict pytree; the port's
modules mirror its names (``m1``, ``m2``, ``block.func``, ``block.att`` with
``Q``/``K``/``V``/``Wout``) and keep its ``[in, out]`` weight orientation, so
a leaf's dotted path is its ``state_dict`` key and no array is transposed.
The JAX-only ``adjoint_nfe_probe`` leaf (a gradient side channel of the
continuous adjoint) has no counterpart and is dropped.

Takes and returns numpy-compatible arrays; this module imports no jax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_JAX_ONLY = ("adjoint_nfe_probe",)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a JAX params pytree (nested dicts of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) into a port ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if key in _JAX_ONLY:
                continue
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                out[name] = torch.from_numpy(
                    np.array(val, dtype=np.float32, copy=True))

    walk(tree, "")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: a nested dict of numpy arrays (the JAX-only probe leaf
    is restored as 0.0 where the JAX package has one)."""
    tree: dict = {}
    for name, val in state_dict.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().cpu().numpy()
    func = tree.get("block", {}).get("func")
    if func is not None:
        func.setdefault("adjoint_nfe_probe", np.zeros((), np.float32))
    return tree
