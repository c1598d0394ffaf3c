"""Weight converter: the JAX package's flax ``params`` tree -> the port's
``state_dict``, and a JAX checkpoint tree -> the port's checkpoint.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the params), so this module needs numpy only. Layout changes:

* Dense ``kernel (in, out)`` -> ``weight (out, in)``;
* Conv ``kernel (H, W, I, O)`` -> ``weight (O, I, H, W)``;
* top-level leaves (``log_k``, ``log_equil``, ``log_g``, ``log_m``,
  ``frame_offset``) keep their names; each task's tree holds its own cell's
  (spring: ``log_k``, ``log_equil``; gravity: ``log_g``, ``log_m``;
  bouncing: none), as the port's model does;
* a flax ``OptimizedLSTMCell`` (``lstm_<i>``) keeps one kernel per gate:
  input kernels ``ii, if, ig, io`` ``[in, H]`` without bias and hidden
  kernels ``hi, hf, hg, ho`` ``[H, H]`` with one. torch's ``LSTMCell``
  stacks its gates in the same order, so ``weight_ih`` is
  ``cat([ii, if, ig, io], 1).T``, ``weight_hh`` ``cat([hi, hf, hg, ho],
  1).T`` and ``bias_hh`` the four biases; the port's ``bias_ih`` is a zero
  buffer, not in the state_dict.

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
_LSTM_GATES = ("i", "f", "g", "o")
_INDEXED = (("TorchConv_", "convs."), ("TorchDense_", "dense."))


def _module_name(segment: str) -> str:
    if segment in _RENAMES:
        return _RENAMES[segment]
    for prefix, name in _INDEXED:
        if segment.startswith(prefix):
            return name + segment[len(prefix):]
    return segment


def _fuse_lstm(cell: Mapping) -> dict:
    """A flax OptimizedLSTMCell's per-gate leaves as torch LSTMCell's fused
    ones (none where a multi_transform branch masks the cell out)."""
    if cell["ii"]["kernel"] is None:
        return {}

    def gates(side, leaf):
        return np.concatenate([np.asarray(cell[side + g][leaf])
                               for g in _LSTM_GATES], axis=-1)
    return {"weight_ih": gates("i", "kernel").T,
            "weight_hh": gates("h", "kernel").T,
            "bias_hh": gates("h", "bias")}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping) and "ii" in value:
            yield from _flatten(_fuse_lstm(value), prefix + (key,))
        elif isinstance(value, Mapping):
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
    RMSprop state; optax Adam's ``mu``, ``nu`` and ``count`` become
    ``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq`` and ``step`` (the
    same update rule). Under ``multi_transform`` (``--physics_lr_mult``,
    ``--bg_lr_mult``) each branch holds the state of its own parameters;
    the branches are merged, each parameter from the branch that trains it.
    Momentum's trace is left out, so a restore keeps its initial state and
    logs it."""
    optimizer = {}
    for st in _find_mappings(tree.get("opt_state"), "nu"):
        nus = flax_to_state_dict(st["nu"])
        if "mu" not in st:
            optimizer.update({name: {"nu": t} for name, t in nus.items()})
            continue
        mus = flax_to_state_dict(st["mu"])
        count = float(np.asarray(st["count"]))
        optimizer.update({name: {"step": torch.tensor(count),
                                 "exp_avg": mus[name], "exp_avg_sq": t}
                          for name, t in nus.items()})
    out = {"model": flax_to_state_dict(tree["params"]),
           "optimizer": {"state": optimizer}}
    for key in ("step", "epoch", "total_epochs_done"):
        out[key] = int(np.asarray(tree.get(key, 0)))
    return out
