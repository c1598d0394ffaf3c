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
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

# Parameter names that are never trained (gravity's mass).
FROZEN_PARAM_NAMES = ("log_m",)


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop: nu = decay*nu + (1-decay)*g^2; u = g*rsqrt(nu+eps);
    p += -lr*u, in optax's order of operations. Each group is updated with
    a few multi-tensor (``torch._foreach_*``) launches."""

    def __init__(self, params, lr: float, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

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


def build_optimizer(name: str, named_params: Iterable, lr: float):
    """The optimizer over every parameter not named in
    ``FROZEN_PARAM_NAMES``."""
    if name not in OPTIMIZERS:
        raise KeyError(f"Unknown optimizer {name!r}; "
                       f"available: {sorted(OPTIMIZERS)}")
    params = [p for n, p in named_params
              if n.split(".")[-1] not in FROZEN_PARAM_NAMES]
    return OPTIMIZERS[name](params, lr)
