"""Optimizers with the JAX package's optax semantics, and its LR anneal.

Counterpart of ``paig_reproduction_tpu/train/optimizers.py``:

* ``rmsprop`` is optax's ``rmsprop(lr, decay=0.99, eps=1e-8)``: the update
  is ``g * rsqrt(nu + eps)`` with eps inside the square root and nu
  starting at 0. ``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps``
  instead, so it is not used.
* ``adam``, ``momentum`` and ``sgd`` are optax's ``adam(lr, b1=0.9,
  b2=0.999, eps=1e-8)``, ``sgd(lr, momentum=0.9)`` and ``sgd(lr)``, with
  their state under ``torch.optim.Adam``'s and ``torch.optim.SGD``'s names
  (``exp_avg``, ``exp_avg_sq``, ``step``; ``momentum_buffer``), so that a
  checkpoint of either reads the same.
* A group's learning rate is a Python float or a 0-dim tensor on the
  parameters' device. Every step reads it, and every other quantity of the
  update (Adam's step count included) lives on the device too, so the whole
  step can be captured in a CUDA graph and replayed with the rate and the
  step count that the device tensors hold at each replay.
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


class _Foreach(torch.optim.Optimizer):
    """An optax update per parameter group, in a few multi-tensor
    (``torch._foreach_*``) launches: ``update(group, params, grads)``
    returns the optimizer's updates, which are then scaled by ``-lr`` and by
    the group's ``scale`` where it has one (optax.scale after the
    optimizer), in optax's order, and added to the parameters."""

    def __init__(self, params, lr, **defaults):
        super().__init__(params, dict(lr=lr, scale=1.0, capturable=True,
                                      **defaults))

    def init_state(self, p) -> dict:
        raise NotImplementedError

    def update(self, group, params, grads) -> list:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(self.init_state(p))
            updates = self.update(group, params, [p.grad for p in params])
            lr = group["lr"]
            torch._foreach_mul_(updates, -lr)
            if group["scale"] != 1.0:
                torch._foreach_mul_(updates, group["scale"])
            torch._foreach_add_(params, updates)


class RMSprop(_Foreach):
    """optax.rmsprop: nu = decay*nu + (1-decay)*g^2; u = g*rsqrt(nu+eps)."""

    def __init__(self, params, lr, decay: float = 0.99, eps: float = 1e-8):
        super().__init__(params, lr, decay=decay, eps=eps)

    def init_state(self, p):
        return {"nu": torch.zeros_like(p)}

    def update(self, group, params, grads):
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(nus, group["decay"])
        torch._foreach_addcmul_(nus, grads, grads, value=1 - group["decay"])
        updates = torch._foreach_add(nus, group["eps"])
        torch._foreach_rsqrt_(updates)
        torch._foreach_mul_(updates, grads)
        return updates


class Adam(_Foreach):
    """optax.adam: mu = b1*mu + (1-b1)*g; nu = b2*nu + (1-b2)*g^2; count +=
    1; u = mu_hat / (sqrt(nu_hat) + eps) with the bias corrections
    1 - b^count. The count is a float32 tensor on the device."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps)

    def init_state(self, p):
        return {"step": torch.zeros((), dtype=torch.float32,
                                    device=p.device),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def update(self, group, params, grads):
        b1, b2 = group["b1"], group["b2"]
        mus = [self.state[p]["exp_avg"] for p in params]
        nus = [self.state[p]["exp_avg_sq"] for p in params]
        steps = [self.state[p]["step"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
        torch._foreach_add_(steps, 1.0)
        count = steps[0]
        bc1 = 1 - torch.pow(b1, count)
        bc2 = 1 - torch.pow(b2, count)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        updates = torch._foreach_div(mus, bc1)
        torch._foreach_div_(updates, denom)
        return updates


class SGD(_Foreach):
    """optax.sgd: u = g, or with ``momentum`` the trace t = g + momentum*t
    (optax's, which starts at 0; torch's first step copies g: the same
    value)."""

    def __init__(self, params, lr, momentum: float = 0.0):
        super().__init__(params, lr, momentum=momentum)

    def init_state(self, p):
        return ({"momentum_buffer": torch.zeros_like(p)}
                if self.defaults["momentum"] else {})

    def update(self, group, params, grads):
        if not group["momentum"]:
            return torch._foreach_mul(grads, 1.0)
        bufs = [self.state[p]["momentum_buffer"] for p in params]
        torch._foreach_mul_(bufs, group["momentum"])
        torch._foreach_add_(bufs, grads)
        return torch._foreach_mul(bufs, 1.0)


OPTIMIZERS = {
    "rmsprop": lambda params, lr: RMSprop(params, lr, decay=0.99, eps=1e-8),
    "adam": lambda params, lr: Adam(params, lr, b1=0.9, b2=0.999, eps=1e-8),
    "momentum": lambda params, lr: SGD(params, lr, momentum=0.9),
    "sgd": lambda params, lr: SGD(params, lr),
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


def clip_train_group_(optimizer, max_norm: float, split=(), group=None):
    """optax.clip_by_global_norm on the optimizer's ``train`` group (its
    first): scales those gradients in place. Under tensor parallelism
    ``split`` holds the parameters that are slices of a kernel split over
    the process ``group``: their squares are summed over it, so the norm is
    the whole model's."""
    params = [p for p in optimizer.param_groups[0]["params"]
              if p.grad is not None]
    grads = [p.grad for p in params]
    if not grads:
        return
    norms = torch.stack(torch._foreach_norm(grads))
    if split:
        # Python-int selections: no index tensor crosses from the host,
        # which a captured step forbids.
        split_ids = {id(p) for p in split}
        sq = norms * norms
        parts = [[sq[i] for i, p in enumerate(params)
                  if (id(p) in split_ids) == is_split]
                 for is_split in (False, True)]
        rest_sq, split_sq = (torch.stack(x).sum() if x
                             else torch.zeros_like(norms[0]) for x in parts)
        torch.distributed.all_reduce(split_sq, group=group)
        norm = torch.sqrt(rest_sq + split_sq)
    else:
        norm = torch.linalg.vector_norm(norms)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


def set_lr(optimizer, lr):
    """Sets every group's learning rate for the next steps: a float, or a
    0-dim device tensor whose value each step reads (a group's ``scale`` is
    applied after the update, in optax's order)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


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
