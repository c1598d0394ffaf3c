"""Weight converter: the JAX package's flax ``params`` tree -> the port's
``state_dict``, and a JAX checkpoint tree -> the port's checkpoint.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the params), so this module needs numpy only. Layout changes:

* Dense ``kernel (in, out)`` -> ``weight (out, in)``;
* Conv ``kernel (H, W, I, O)`` -> ``weight (O, I, H, W)``;
* top-level leaves (``log_k``, ``log_equil``, ``log_g``, ``log_m``,
  ``frame_offset``) keep their names; each task's tree holds its own cell's
  (spring: ``log_k``, ``log_equil``; gravity: ``log_g``, ``log_m``;
  bouncing: none), as the port's model does.

Module names map as ``ShallowUNet_0`` (or the deep ``UNet_0`` of 40 px and
larger inputs) -> ``unet``, ``TorchConv_<i>`` ->
``convs.<i>`` (flax's inner ``Conv_0`` is dropped) and ``TorchDense_<i>``
-> ``dense.<i>``; the top-level names (``encoder``, ``velocity_encoder``,
``var_net_*``) are the same in both packages.

The port never reads an orbax checkpoint itself: a user (or a test)
restores the JAX ``model.ckpt`` with ``orbax.checkpoint``, converts the
tree with ``flax_checkpoint_to_port`` and writes the result with
``train.checkpoint.save_checkpoint``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_RENAMES = {"ShallowUNet_0": "unet", "UNet_0": "unet"}
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
    (each tensor keeps its array's dtype). ``None`` leaves, the masked-out
    leaves of an optax ``multi_transform`` branch, are left out."""
    out = {}
    for path, value in _flatten(params):
        if value is None:
            continue
        modules = [_module_name(s) for s in path[:-1] if s != "Conv_0"]
        name, array = _leaf(path[-1], np.asarray(value))
        out[".".join(modules + [name])] = torch.from_numpy(array.copy())
    return out


def _find_mappings(tree, key):
    """Every mapping that stores a mapping under ``key``, in a tree of
    mappings and sequences."""
    if isinstance(tree, Mapping):
        if isinstance(tree.get(key), Mapping):
            yield tree
            return
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return
    for child in children:
        yield from _find_mappings(child, key)


def flax_checkpoint_to_port(tree: Mapping) -> dict:
    """The port's checkpoint dict (``train/checkpoint.py``) from the numpy
    tree an orbax restore of a JAX ``model.ckpt`` gives: ``params``,
    ``step`` and, where present, ``opt_state``, ``epoch`` and
    ``total_epochs_done`` (the recipe state is not converted: a restore
    starts it afresh).

    optax RMSprop's ``nu`` becomes each parameter's ``nu``, the port's
    RMSprop state. Under ``multi_transform`` (``--physics_lr_mult``,
    ``--bg_lr_mult``) each branch holds ``nu`` for its own parameters; the
    branches are merged, each parameter from the branch that trains it.
    The state of the other optimizers (Adam's ``mu``/``nu`` with its
    bias-correction count, momentum's trace) is left out, so a restore
    keeps their initial state and logs it."""
    optimizer = {}
    for rms in _find_mappings(tree.get("opt_state"), "nu"):
        if "mu" in rms:
            optimizer = {}
            break
        optimizer.update({name: {"nu": t} for name, t in
                          flax_to_state_dict(rms["nu"]).items()})
    out = {"model": flax_to_state_dict(tree["params"]),
           "optimizer": {"state": optimizer}}
    for key in ("step", "epoch", "total_epochs_done"):
        out[key] = int(np.asarray(tree.get(key, 0)))
    return out
