"""Weight converter: the JAX package's flax ``params`` tree -> the port's
``state_dict``.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the params), so this module needs numpy only. Layout changes:

* Dense ``kernel (in, out)`` -> ``weight (out, in)``;
* Conv ``kernel (H, W, I, O)`` -> ``weight (O, I, H, W)``;
* scalar leaves (``log_k``, ``log_equil``, ``log_g``, ``log_m``) keep
  their names.

Module names map as ``ShallowUNet_0`` -> ``unet``, ``TorchConv_<i>`` ->
``convs.<i>`` (flax's inner ``Conv_0`` is dropped) and ``TorchDense_<i>``
-> ``dense.<i>``; the top-level names (``encoder``, ``velocity_encoder``,
``var_net_*``) are the same in both packages.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_RENAMES = {"ShallowUNet_0": "unet"}
_INDEXED = (("TorchConv_", "convs."), ("TorchDense_", "dense."))


def _module_name(segment: str) -> str:
    if segment in _RENAMES:
        return _RENAMES[segment]
    for prefix, name in _INDEXED:
        if segment.startswith(prefix):
            return name + segment[len(prefix):]
    return segment


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    return name, value


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax ``params`` tree of numpy arrays to a state_dict
    (each tensor keeps its array's dtype)."""
    out = {}
    for path, value in _flatten(params):
        modules = [_module_name(s) for s in path[:-1] if s != "Conv_0"]
        name, array = _leaf(path[-1], np.asarray(value))
        out[".".join(modules + [name])] = torch.from_numpy(array.copy())
    return out
