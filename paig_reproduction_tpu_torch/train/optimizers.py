"""Optimizers with the JAX package's optax semantics, and its LR anneal.

Counterpart of ``paig_reproduction_tpu/train/optimizers.py``:

* ``rmsprop`` is optax's ``rmsprop(lr, decay=0.99, eps=1e-8)``: the update
  is ``g * rsqrt(nu + eps)`` with eps inside the square root and nu
  starting at 0. ``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps``
  instead, so it is not used.
* ``adam``, ``momentum`` and ``sgd`` are torch's own optimizers, which
  follow the same update rules as optax's at these settings.
* ``lr_schedule`` divides the learning rate by 5 from step
  ``int(0.75 * epochs) * steps_per_epoch`` on.
* Parameters named in ``FROZEN_PARAM_NAMES`` are never trained.
* ``physics_lr_mult`` and ``bg_lr_mult`` give the physical parameters
  (``PHYSICS_PARAM_NAMES``) and the background net (``var_net_background``)
  parameter groups of their own whose update is scaled by the multiplier,
  as the JAX package's ``multi_transform`` branches ``chain(opt, scale)``
  do. Optimizer state is per parameter in both, so each branch keeps its
  own. ``bg_lr_mult=0`` freezes the background (its state still updates,
  as in optax).
* ``grad_clip`` clips the global norm of the ``train`` group's gradients
  only: optax chains ``clip_by_global_norm`` into the ``train`` branch, so
  the physics and background branches are not in its norm. With no other
  branch it covers every trained parameter.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

# Parameter names that are never trained (gravity's mass).
FROZEN_PARAM_NAMES = ("log_m",)
# The learnable physical parameters (scalar, log-space).
PHYSICS_PARAM_NAMES = ("log_k", "log_equil", "log_g")


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop: nu = decay*nu + (1-decay)*g^2; u = g*rsqrt(nu+eps);
    p += -lr*u, in optax's order of operations, then times a group's
    ``scale`` where it has one (optax.scale after the optimizer). Each group
    is updated with a few multi-tensor (``torch._foreach_*``) launches."""

    def __init__(self, params, lr: float, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      scale=1.0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_addcmul_(nus, grads, grads,
                                    value=1 - group["decay"])
            updates = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(updates)
            torch._foreach_mul_(updates, grads)
            torch._foreach_mul_(updates, -group["lr"])
            if group["scale"] != 1.0:
                torch._foreach_mul_(updates, group["scale"])
            torch._foreach_add_(params, updates)


OPTIMIZERS = {
    "rmsprop": lambda params, lr: RMSprop(params, lr, decay=0.99, eps=1e-8),
    "adam": lambda params, lr: torch.optim.Adam(params, lr, betas=(0.9, 0.999),
                                                eps=1e-8),
    "momentum": lambda params, lr: torch.optim.SGD(params, lr, momentum=0.9),
    "sgd": lambda params, lr: torch.optim.SGD(params, lr),
}


def lr_schedule(base_lr: float, epochs: int, steps_per_epoch: int,
                anneal_lr: bool) -> Callable[[int], float]:
    """Learning rate for the update with index ``step`` (0-based): /5 from
    ``int(0.75 * epochs)`` epochs on when annealing."""
    boundary = int(0.75 * epochs) * steps_per_epoch
    if not anneal_lr or epochs <= 0 or boundary <= 0:
        return lambda step: base_lr
    return lambda step: base_lr if step < boundary else base_lr / 5.0


def param_label(name: str, physics_lr_mult: float = 1.0,
                bg_lr_mult: float = 1.0) -> str:
    """The JAX package's label of a parameter: ``frozen``, ``physics``,
    ``background`` or ``train`` (a branch exists only where its multiplier
    is not 1)."""
    parts = name.split(".")
    if parts[-1] in FROZEN_PARAM_NAMES:
        return "frozen"
    if physics_lr_mult != 1.0 and parts[-1] in PHYSICS_PARAM_NAMES:
        return "physics"
    if bg_lr_mult != 1.0 and parts[0] == "var_net_background":
        return "background"
    return "train"


def clip_train_group_(optimizer, max_norm: float):
    """optax.clip_by_global_norm on the optimizer's ``train`` group (its
    first): scales those gradients in place."""
    grads = [p.grad for p in optimizer.param_groups[0]["params"]
             if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


def set_lr(optimizer, lr: float):
    """Sets every group's learning rate for the next step. RMSprop applies a
    group's ``scale`` after its update, in optax's order; the other
    optimizers, whose updates are linear in the rate, take ``lr * scale``."""
    for group in optimizer.param_groups:
        group["lr"] = (lr if isinstance(optimizer, RMSprop)
                       else lr * group.get("scale", 1.0))


def build_optimizer(name: str, named_params: Iterable, lr: float,
                    physics_lr_mult: float = 1.0, grad_clip: float = 0.0,
                    bg_lr_mult: float = 1.0):
    """The optimizer over every parameter not named in
    ``FROZEN_PARAM_NAMES``: a ``train`` group first, then a ``physics`` and a
    ``background`` group whose ``scale`` is their multiplier, where those
    are not 1. Each group has its ``label``; the optimizer's ``grad_clip``
    (0 = off) is for ``clip_train_group_``, which the trainer calls before
    each step, and ``set_lr`` sets the rates."""
    if name not in OPTIMIZERS:
        raise KeyError(f"Unknown optimizer {name!r}; "
                       f"available: {sorted(OPTIMIZERS)}")
    groups = {"train": [], "physics": [], "background": []}
    for n, p in named_params:
        label = param_label(n, physics_lr_mult, bg_lr_mult)
        if label != "frozen":
            groups[label].append(p)
    scales = {"train": 1.0, "physics": physics_lr_mult,
              "background": bg_lr_mult}
    opt = OPTIMIZERS[name](
        [{"params": ps, "label": label, "scale": scales[label]}
         for label, ps in groups.items() if ps or label == "train"], lr)
    opt.grad_clip = grad_clip
    return opt
