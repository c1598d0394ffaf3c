"""Differentiable-physics ODE cells as plain PyTorch functions.

Counterpart of ``paig_reproduction_tpu/ops/cells.py``: Euler integrators
with ``SUBSTEPS`` = 5 substeps per frame at ``dt/5`` and physical
parameters stored in log-space. State layout: ``pos``/``vel`` are
``[batch, n_objs * 2]``, object-major ``[x1, y1, x2, y2, ...]``.

The three cells: spring (2 objects), bouncing (free flight with elastic wall
reflections) and gravity (3 bodies, inverse square). ``numpy_generator_*``
are the dataset generators' own integrators, in float64 numpy.
"""
from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import numpy as np
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

# Default integration step per frame of each cell.
SPRING_DT = 0.3
BOUNCING_DT = 0.3
GRAVITY_DT = 0.5

# Bouncing-cell wall geometry: walls at 0 and 32 px, object radius 2 px.
WALL_SIZE = 32.0
BALL_RADIUS = 2.0


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


def bouncing_step(params: CellParams, pos: torch.Tensor, vel: torch.Tensor,
                  dt: float = BOUNCING_DT, substeps: int = SUBSTEPS):
    """One frame of free flight with elastic wall bounces; no learnable
    parameters. Per coordinate and substep, a position past a wall
    (``BALL_RADIUS`` from 0 or ``WALL_SIZE``) is reflected about it and
    its velocity negated."""
    del params
    h = dt / substeps
    hi = WALL_SIZE - BALL_RADIUS
    lo = BALL_RADIUS
    p, v = pos, vel
    for _ in range(substeps):
        p = p + h * v
        hit_hi = p > hi
        hit_lo = p < lo
        v = torch.where(hit_hi | hit_lo, -v, v)
        p = torch.where(hit_hi, 2.0 * hi - p, p)
        p = torch.where(hit_lo, 2.0 * lo - p, p)
    return p, v


@functools.lru_cache(maxsize=64)
def _constant(value: float, dtype, device) -> torch.Tensor:
    """A 0-dim tensor of `value`, made once per dtype and device (making it
    per call would copy it from the host each time). ``torch.full`` fills
    it on the device, inside ``torch.func`` transforms too."""
    return torch.full((), value, dtype=dtype, device=device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: max then min, whose derivative at a bound is 1/2, as
    JAX's (``torch.clamp``'s is 1)."""
    return torch.minimum(torch.maximum(x, _constant(lo, x.dtype, x.device)),
                         _constant(hi, x.dtype, x.device))


def gravity_step(params: CellParams, pos: torch.Tensor, vel: torch.Tensor,
                 dt: float = GRAVITY_DT, substeps: int = SUBSTEPS):
    """One frame of 3-body inverse-square dynamics. A = exp(log_g) *
    exp(2 log_m) is recomputed from the live parameters on every call, so
    gradients reach log_g. Each pair's squared distance is clamped to
    [1e-1, 1e5] before the square root and the distance to [1, 170] before
    it is cubed."""
    a = torch.exp(params.log_g) * torch.exp(2.0 * params.log_m)
    h = dt / substeps
    p = pos.reshape(pos.shape[0], 3, 2)
    v = vel.reshape(vel.shape[0], 3, 2)
    for _ in range(substeps):
        # The three pairs at once: rows p0-p1, p1-p2, p2-p0, each pair's
        # force vec/|vec|^3 with the clamps; body i feels its own pair's
        # force less the pair before it's (f01 - f20, f12 - f01, f20 - f12).
        vec = p - torch.roll(p, -1, dims=1)                         # [B,3,2]
        sq = _clip(torch.sum(vec * vec, dim=-1, keepdim=True), 1e-1, 1e5)
        norm = _clip(torch.sqrt(sq), 1.0, 170.0)
        pair = vec / (norm ** 3)
        force = pair - torch.roll(pair, 1, dims=1)
        v = v - h * a * force
        p = p + h * v
    return p.reshape(pos.shape[0], -1), v.reshape(vel.shape[0], -1)


# Cell registry: name -> (step function, default dt). "lstm" is a
# model-level cell (models/physics_net.py::_lstm_rollout), not a step here.
CELLS = {
    "spring_ode_cell": (spring_step, SPRING_DT),
    "bouncing_ode_cell": (bouncing_step, BOUNCING_DT),
    "gravity_ode_cell": (gravity_step, GRAVITY_DT),
}


def numpy_generator_spring(poss, vels, k, equil, dt, ode_steps):
    """The spring dataset generator's integrator (float64 numpy)."""
    poss = np.array(poss, dtype=np.float64)
    vels = np.array(vels, dtype=np.float64)
    for _ in range(ode_steps):
        norm = np.linalg.norm(poss[0] - poss[1])
        direction = (poss[0] - poss[1]) / norm
        F = k * (norm - 2 * equil) * direction
        vels[0] = vels[0] - dt / ode_steps * F
        vels[1] = vels[1] + dt / ode_steps * F
        poss = poss + dt / ode_steps * vels
    return poss, vels


def numpy_generator_gravity(poss, vels, g, m, dt, ode_steps):
    """The 3-body dataset generator's integrator (float64 numpy)."""
    poss = np.array(poss, dtype=np.float64)
    vels = np.array(vels, dtype=np.float64)
    for _ in range(ode_steps):
        n01 = np.linalg.norm(poss[0] - poss[1])
        n12 = np.linalg.norm(poss[1] - poss[2])
        n20 = np.linalg.norm(poss[2] - poss[0])
        v01 = poss[0] - poss[1]
        v12 = poss[1] - poss[2]
        v20 = poss[2] - poss[0]
        F = np.array([v01 / n01 ** 3 - v20 / n20 ** 3,
                      v12 / n12 ** 3 - v01 / n01 ** 3,
                      v20 / n20 ** 3 - v12 / n12 ** 3])
        F = -g * m * m * F
        vels = vels + dt / ode_steps * F
        poss = poss + dt / ode_steps * vels
    return poss, vels
