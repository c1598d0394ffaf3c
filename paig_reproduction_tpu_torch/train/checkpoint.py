"""Checkpoint save and restore.

Counterpart of ``paig_reproduction_tpu/train/checkpoint.py``. The JAX
package writes an orbax directory; the port writes one ``torch.save`` file
at ``save_dir/model.ckpt``, a dict of

* ``model``: the model's ``state_dict``;
* ``optimizer``: ``{"state": {parameter name: {key: tensor}}, "count":
  int}``, the optimizer's per-parameter state keyed by name instead of by
  position, and its update count, the LR schedule's position (optax's
  ``count`` in the JAX package; a checkpoint written before the port kept
  it lacks it);
* ``step``, ``epoch`` and ``total_epochs_done``: ints;
* ``recipe``: the single-command recipes' state (``RECIPE_DEFAULTS``'
  keys), read by ``recipe_state``.

Restore matches tensors by name and shape as the JAX package matches leaves
by path: a tensor the checkpoint lacks keeps its initial value, one whose
shape differs is skipped, and one the model lacks is ignored, each case
logged in the JAX package's words. Parameters do not depend on the sequence
length, so a checkpoint restores into a model built for another one (the
seq-30 test phase relies on it).
"""
from __future__ import annotations

import logging
import os

import torch

CKPT_NAME = "model.ckpt"
SCALARS = ("step", "epoch", "total_epochs_done")
# The recipe state and its values in a checkpoint without it: the step the
# --aux_on_recons trigger fired at, the step, count and epoch of the last
# --auto_rescue surgery (-1: none) and the (epoch, valid recons) history of
# the rescue's stall guard; and the epochs of --epochs that the chain's
# discovery arms used (``total_epochs_done`` counts the loop's only, as the
# JAX package's does).
RECIPE_DEFAULTS = {"aux_trigger_step": -1, "rescue_step": -1,
                   "rescue_count": -1, "rescue_epoch": -(10 ** 9),
                   "recons_history": [], "arm_epochs": 0}

logger = logging.getLogger("paig")


def optimizer_state_by_name(model, optimizer):
    """The optimizer's per-parameter state keyed by parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {"state": {names[id(p)]: dict(st)
                      for p, st in optimizer.state.items()}}


def save_checkpoint(save_dir, state) -> str:
    """Write ``state`` to ``save_dir/model.ckpt`` (through a temporary file,
    so a reader never sees half a checkpoint). Returns the path."""
    path = os.path.abspath(os.path.join(save_dir, CKPT_NAME))
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def _fits(src, shape):
    return tuple(src.shape) == tuple(shape) or (
        src.numel() == 1 and torch.Size(shape).numel() == 1)


def load_checkpoint(restore_dir) -> dict:
    """The dict of ``restore_dir/model.ckpt``, its tensors on the CPU.
    Raises where there is no such file, or where it is a directory (an
    orbax checkpoint of the JAX package)."""
    path = os.path.abspath(os.path.join(restore_dir, CKPT_NAME))
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an orbax checkpoint of the JAX package. "
            "Restore it with orbax.checkpoint, convert the tree with "
            "paig_reproduction_tpu_torch.convert.flax_checkpoint_to_port and "
            "write the result with train.checkpoint.save_checkpoint")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(restore_dir, model, optimizer=None, piece=None):
    """Restore ``restore_dir/model.ckpt`` into ``model`` (and
    ``optimizer``'s state) in place, on their device. ``piece(name,
    tensor)``, where given, cuts a saved tensor of parameter ``name`` to the
    slice this process holds (tensor parallelism). A checkpoint without
    optimizer state (``tools/slot_rescue.py`` writes one) leaves the
    optimizer's state fresh. Returns the checkpoint's ``step``, ``epoch``
    and ``total_epochs_done`` (0 where it lacks one) and, with
    ``optimizer``, ``opt_count``: the saved update count where the restore
    took the state of a trained parameter, 0 where it took none (the
    state is fresh, as the JAX package's count is where no leaf of its
    optimizer state fits), None where it took some but the checkpoint has
    no count."""
    piece = piece or (lambda name, t: t)
    ckpt = load_checkpoint(restore_dir)
    missing, shape_skipped, extra = [], [], []

    saved = ckpt.get("model", {})
    target = model.state_dict()
    with torch.no_grad():
        for name, t in target.items():
            src = saved.get(name)
            if src is not None:
                src = piece(name, src)
            if src is None:
                missing.append("model/" + name)
            elif not _fits(src, t.shape):
                shape_skipped.append("model/" + name)
            else:
                t.copy_(src.reshape(t.shape))
    extra += ["model/" + n for n in saved if n not in target]

    scalars = {k: int(ckpt.get(k, 0)) for k in SCALARS}
    if optimizer is not None:
        names = {id(p): n for n, p in model.named_parameters()}
        params = [p for g in optimizer.param_groups for p in g["params"]]
        current = optimizer.state_dict()
        state = dict(current["state"])
        took = False
        saved_opt = ckpt.get("optimizer", {}).get("state", {})
        for i, p in enumerate(params):
            name = names[id(p)]
            cur = current["state"].get(i, {})
            src = saved_opt.get(name)
            if src is not None:
                src = {k: piece(name, v) if v.dim() else v
                       for k, v in src.items()}
            if src is None:
                missing += [f"optimizer/{name}/{k}" for k in cur]
            elif any(v.dim() > 0 and v.shape != p.shape
                     for v in src.values()):
                shape_skipped += [f"optimizer/{name}/{k}" for k in src]
            else:
                missing += [f"optimizer/{name}/{k}" for k in cur
                            if k not in src]
                state[i] = {**cur, **src}
                took = True
        trained = {names[id(p)] for p in params}
        extra += [f"optimizer/{n}/{k}" for n, st in saved_opt.items()
                  if n not in trained for k in st]
        # load_state_dict moves each tensor to its parameter's device.
        optimizer.load_state_dict({"state": state,
                                   "param_groups": current["param_groups"]})
        count = ckpt.get("optimizer", {}).get("count")
        scalars["opt_count"] = (0 if not took else
                                None if count is None else int(count))

    missing += [k for k in SCALARS if k not in ckpt]
    if missing:
        logger.info("checkpoint restore: %d target leaves not in checkpoint, "
                    "keeping initialized values: %s", len(missing),
                    missing[:5])
    if shape_skipped:
        logger.info("checkpoint restore: %d leaves shape-incompatible, "
                    "keeping initialized values: %s", len(shape_skipped),
                    shape_skipped[:5])
    extra += [k for k in ckpt
              if k not in ("model", "optimizer", "recipe") + SCALARS]
    if extra:
        logger.info("checkpoint restore: ignoring %d extra leaves: %s",
                    len(extra), sorted(extra)[:5])
    return scalars


def recipe_state(restore_dir) -> dict:
    """The recipe state of ``restore_dir/model.ckpt``, with
    ``RECIPE_DEFAULTS`` for what it lacks (all of it where there is no such
    file: ``restore_checkpoint`` is the one that refuses a missing
    checkpoint)."""
    path = os.path.abspath(os.path.join(restore_dir, CKPT_NAME))
    saved = (torch.load(path, map_location="cpu",
                        weights_only=True).get("recipe", {})
             if os.path.isfile(path) else {})
    return {k: saved.get(k, v) for k, v in RECIPE_DEFAULTS.items()}
