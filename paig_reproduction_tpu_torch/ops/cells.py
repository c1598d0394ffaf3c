"""Differentiable-physics ODE cells as plain PyTorch functions.

Counterpart of ``paig_reproduction_tpu/ops/cells.py``: Euler integrators
with ``SUBSTEPS`` = 5 substeps per frame at ``dt/5`` and physical
parameters stored in log-space. State layout: ``pos``/``vel`` are
``[batch, n_objs * 2]``, object-major ``[x1, y1, x2, y2, ...]``.

This slice ports the spring cell; the bouncing and gravity cells come with
their tasks.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

SUBSTEPS = 5  # Euler substeps per frame

# Per-sample norm ceiling for cotangents flowing backward through one
# rollout frame (see clip_cotangent); "inf" disables the clip.
COTANGENT_LIMIT = float(os.environ.get("PAIG_COTANGENT_LIMIT", "1e3"))
# Spring-force clamp bound and sqrt epsilon (see spring_step); "inf"
# disables the clamp. Both change forward numerics.
SPRING_FORCE_CLAMP = float(os.environ.get("PAIG_SPRING_FORCE_CLAMP",
                                          "1e3"))
SPRING_SQRT_EPS = float(os.environ.get("PAIG_SPRING_SQRT_EPS", "1e-8"))

# Default integration step per frame of the spring cell.
SPRING_DT = 0.3


class _ClipCotangent(torch.autograd.Function):
    """Identity forward; the backward scales each sample's cotangent down
    to norm ``limit`` where it is larger."""

    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        nrm = torch.sqrt(torch.sum(g * g, dim=tuple(range(1, g.ndim)),
                                   keepdim=True))
        scale = torch.clamp(ctx.limit / (nrm + 1e-30), max=1.0)
        return g * scale, None


def clip_cotangent(x: torch.Tensor, limit: float = None) -> torch.Tensor:
    """Identity in the forward pass; clips each SAMPLE's cotangent norm
    (rows of the leading/batch axis) in the backward pass.

    Backward through the rollout multiplies per-substep Jacobians whose norm
    is unbounded near object collisions (the spring direction term scales
    like 1/(|p0 - p1| + 1e-4)). Applied between rollout frames this is BPTT
    gradient clipping, per sample so one exploding sequence never rescales
    the rest of the batch. It changes no forward numerics.
    """
    if limit is None:
        limit = COTANGENT_LIMIT
    if not math.isfinite(limit):
        return x
    return _ClipCotangent.apply(x, limit)


class CellParams(NamedTuple):
    """Learnable physics parameters, all stored in log-space. Only the
    fields a given cell uses are meaningful."""

    log_k: torch.Tensor      # spring constant      (spring cell)
    log_equil: torch.Tensor  # equilibrium length   (spring cell)
    log_g: torch.Tensor      # gravitational const  (gravity cell)
    log_m: torch.Tensor      # mass (frozen)        (gravity cell)

    @classmethod
    def initial(cls, device=None) -> "CellParams":
        z = torch.zeros((), device=device)
        return cls(log_k=z, log_equil=z, log_g=z, log_m=z)


def spring_step(params: CellParams, pos: torch.Tensor, vel: torch.Tensor,
                dt: float = SPRING_DT, substeps: int = SUBSTEPS):
    """One frame of 2-object Hooke's-law dynamics:
    F = exp(k) * (|p0 - p1| - 2*exp(equil)) * (p0 - p1)/(|p0 - p1| + 1e-4),
    applied with opposite signs to the two objects, ``substeps`` Euler
    substeps of dt/substeps.
    """
    k = torch.exp(params.log_k)
    two_equil = 2.0 * torch.exp(params.log_equil)
    h = dt / substeps
    p = pos.reshape(pos.shape[0], 2, 2)
    v = vel.reshape(vel.shape[0], 2, 2)
    for _ in range(substeps):
        diff = p[:, 0] - p[:, 1]                                    # [B, 2]
        # +eps inside the sqrt: its gradient is infinite at 0, and the two
        # objects encode to near-identical positions at init.
        norm = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True)
                          + SPRING_SQRT_EPS)
        direction = diff / (norm + 1e-4)
        force = k * (norm - two_equil) * direction                  # [B, 2]
        # The clamp is inactive on physical trajectories (forces are
        # O(1e2) in the task family) and zeroes the Jacobian on explosive
        # ones, where backward through the substeps would overflow.
        if math.isfinite(SPRING_FORCE_CLAMP):
            force = torch.clamp(force, -SPRING_FORCE_CLAMP,
                                SPRING_FORCE_CLAMP)
        v = v + h * torch.stack([-force, force], dim=1)
        p = p + h * v
    return p.reshape(pos.shape[0], -1), v.reshape(vel.shape[0], -1)


# Cell registry: name -> (step function, default dt). "lstm" is a model-level
# cell; the bouncing and gravity cells are not ported yet.
CELLS = {
    "spring_ode_cell": (spring_step, SPRING_DT),
}
