"""Dynamics-consistent initial-state estimation (Gauss-Newton).

Counterpart of ``paig_reproduction_tpu/ops/state_fit.py::fit_initial_state``
(``--init_state_fit``). Instead of the last encoded position and the MLP
velocity, the rollout starts from a least-squares fit of the state to every
encoded position of the input window under the model's own cell: a
Levenberg-damped Gauss-Newton solve over ``[p0, v0]``, batched over the
samples.

The Jacobian of the window rollout comes from one forward-mode JVP: the
``2 * cu2`` basis tangents ride as an extra batch axis through the (batched,
functional) cell step, so one rollout of ``2 * cu2 * B`` states gives every
column.

The bouncing cell's reflections break that linearization, so its fit is
``fit_initial_state_bouncing``: free flight between elastic walls is a
straight line in unfolded coordinates, fitted in closed form under each
bounce hypothesis, after ``align_slot_identities`` has undone slot swaps.

Gradients are straight-through: the forward value is the fitted state, the
backward pass sees the naive initializer (last observed position and the MLP
velocity). The solve itself runs on detached inputs.
"""
from __future__ import annotations

import torch

from paig_reproduction_tpu_torch.ops.cells import (
    BALL_RADIUS,
    WALL_SIZE,
    CellParams,
)


def fit_initial_state(step_fn, cell_params: CellParams, obs: torch.Tensor,
                      vel_init: torch.Tensor, dt: float, substeps: int,
                      iters: int, damping: float = 1e-2,
                      accept_rms: float = 0.75):
    """Fit the state at the LAST observed frame by Gauss-Newton.

    step_fn: the cell step ``(params, pos [B, cu2], vel [B, cu2], dt,
    substeps)``; obs: [B, s, cu2] observed positions of frames 0..s-1 (in the
    physical frame, offsets applied); vel_init: [B, cu2] the MLP velocity;
    iters: Gauss-Newton iterations.

    Returns (pos, vel) at frame s-1, the rollout's starting state.
    """
    b, s, cu2 = obs.shape
    if s < 2 or iters < 1:
        return obs[:, -1], vel_init
    params = CellParams(*(t.detach() for t in cell_params))
    y = obs.detach()
    target = y.reshape(b, s * cu2)
    n = 2 * cu2

    def roll_positions(x):
        """x: [M, 2*cu2] states at frame 0 -> positions of frames 0..s-1,
        [M, s*cu2]."""
        p, v = x[:, :cu2], x[:, cu2:]
        ps = [p]
        for _ in range(s - 1):
            p, v = step_fn(params, p, v, dt, substeps=substeps)
            ps.append(p)
        return torch.cat(ps, dim=1)

    # f32 rails, as in the JAX package: near-coincident objects make the
    # spring Jacobian overflow f32. Clipping J and the residual bounds the
    # solve (the clip's derivative is zero outside its range, so saturated
    # entries drop out of J), and the step clamp keeps one bad iterate from
    # throwing the state away.
    jac_lim, res_lim, step_lim = 1e4, 1e4, 16.0

    def resid(x, tgt):
        return torch.clamp(roll_positions(x) - tgt, -res_lim, res_lim)

    basis = torch.eye(n, dtype=y.dtype, device=y.device)
    tangents = basis.repeat_interleave(b, dim=0)              # [n*B, n]
    eye = basis.expand(b, n, n)
    x = torch.cat([y[:, 0], vel_init.detach()], dim=1)        # [B, n]
    for _ in range(iters):
        r_all, jt = torch.func.jvp(
            lambda z: resid(z, target.repeat(n, 1)),
            (x.repeat(n, 1),), (tangents,))
        r = torch.nan_to_num(r_all[:b], posinf=res_lim, neginf=-res_lim)
        jac = jt.reshape(n, b, -1).permute(1, 2, 0)          # [B, s*cu2, n]
        jac = torch.nan_to_num(torch.clamp(jac, -jac_lim, jac_lim))
        jac_t = jac.transpose(1, 2)
        a = jac_t @ jac + damping * eye
        dx = torch.linalg.solve_ex(a, (jac_t @ r[..., None]))[0][..., 0]
        dx = torch.clamp(torch.nan_to_num(dx), -step_lim, step_lim)
        x = x - dx
    res = torch.sum(torch.nan_to_num(resid(x, target)) ** 2, dim=1)

    # Advance the fitted frame-0 state to frame s-1.
    pos_f, vel_f = x[:, :cu2], x[:, cu2:]
    for _ in range(s - 1):
        pos_f, vel_f = step_fn(params, pos_f, vel_f, dt, substeps=substeps)

    naive_p, naive_v = obs[:, -1], vel_init
    # Per-sample acceptance: the fit must explain the window (residual under
    # an accept_rms px noise floor per frame and coordinate) and be finite;
    # otherwise that sample keeps the naive initializer.
    ok = (torch.isfinite(pos_f).all(dim=-1) & torch.isfinite(vel_f).all(dim=-1)
          & (res < (accept_rms ** 2) * (s * cu2)))[:, None]
    pos_f = torch.where(ok, pos_f, naive_p.detach())
    vel_f = torch.where(ok, vel_f, naive_v.detach())
    # Straight-through: forward = fitted, backward = naive.
    return (naive_p + (pos_f - naive_p).detach(),
            naive_v + (vel_f - naive_v).detach())


def align_slot_identities(obs: torch.Tensor) -> torch.Tensor:
    """Permutation-consistent observation window for 2-object tasks.

    obs: [B, s, 4] encoded positions, object-major [x1, y1, x2, y2]. The
    encoder binds slots by appearance and can swap them for a frame where
    objects cross. Frames s-2..0 are aligned backward to frame s-1 (the
    rollout's identity frame, left as it is): each keeps or swaps its two
    objects, swapping only when that is closer to the aligned successor by
    a clear margin (under half the cost), since for near-coincident objects
    either assignment fits. Exact for 2 objects; other shapes pass through.
    """
    b, s, cu2 = obs.shape
    if cu2 != 4 or s < 2:
        return obs
    p = obs.reshape(b, s, 2, 2)
    ref = p[:, -1]
    aligned = [ref]
    for t in range(s - 2, -1, -1):
        pt = p[:, t]
        sw = pt.flip(1)
        cost_id = torch.sum((pt - ref) ** 2, dim=(1, 2))
        cost_sw = torch.sum((sw - ref) ** 2, dim=(1, 2))
        ref = torch.where((cost_sw < 0.5 * cost_id)[:, None, None], sw, pt)
        aligned.append(ref)
    return torch.stack(aligned[::-1], dim=1).reshape(b, s, cu2)


def fit_initial_state_bouncing(obs: torch.Tensor, vel_init: torch.Tensor,
                               dt: float, accept_rms: float = 0.75,
                               wall_lo: float = BALL_RADIUS,
                               wall_hi: float = WALL_SIZE - BALL_RADIUS):
    """Reflection-aware initial-state fit for the bouncing cell.

    Reflecting the observations before a bounce across its wall (u = 2w - p)
    makes free flight a straight line u_t = u_0 + v t dt per coordinate. At
    most one bounce per coordinate fits in an input window, so every
    hypothesis (none, or one at either wall before frame j, j = 1..s-1) is
    solved by closed-form least squares. A bounce hypothesis is admissible
    only if its line crosses the wall inside the (j-1, j) frame interval,
    and it is taken only when its residual is under half the no-bounce
    one. The fitted last-frame position is clamped to the walls.

    obs: [B, s, cu2] positions in the physical frame; vel_init: [B, cu2] the
    MLP velocity (the naive fallback). Returns (pos, vel) at frame s-1.
    Per-coordinate acceptance: a coordinate whose best hypothesis leaves an
    rms residual above ``accept_rms`` px, or is not finite, keeps the naive
    initializer. Gradients: straight-through to the naive path.
    """
    b, s, cu2 = obs.shape
    if s < 2:
        return obs[:, -1], vel_init
    dtype, dev = obs.dtype, obs.device
    y = align_slot_identities(obs.detach()).transpose(1, 2)      # [B, cu2, s]

    # Hypotheses [H = 1 + 2(s-1)]: frames t < j reflected across a wall.
    js = torch.arange(1, s, device=dev)
    t_idx = torch.arange(s, device=dev)
    refl = t_idx[None, :] < js[:, None]                           # [s-1, s]
    masks = torch.cat([torch.zeros((1, s), dtype=torch.bool, device=dev),
                       refl, refl])                                # [H, s]
    walls = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                       torch.full((s - 1,), wall_lo, dtype=dtype, device=dev),
                       torch.full((s - 1,), wall_hi, dtype=dtype,
                                  device=dev)])                    # [H]
    u = torch.where(masks[:, None, None, :],
                    2.0 * walls[:, None, None, None] - y[None],
                    y[None])                                       # [H,B,cu2,s]

    ts = t_idx.to(dtype) * dt                                      # [s]
    sx, sxx = torch.sum(ts), torch.sum(ts * ts)
    su = torch.sum(u, dim=-1)
    sxu = torch.sum(u * ts, dim=-1)
    denom = s * sxx - sx * sx
    slope = (s * sxu - sx * su) / denom                            # [H,B,cu2]
    icept = (su - slope * sx) / s
    res = torch.sum((icept[..., None] + slope[..., None] * ts - u) ** 2,
                    dim=-1)

    # A bounce before frame j must cross its wall inside (j-1, j).
    t_cross = (walls[:, None, None] - icept) / torch.where(
        slope == 0.0, torch.full_like(slope, 1e-9), slope)
    j_all = torch.cat([torch.ones(1, dtype=js.dtype, device=dev), js, js])
    t_lo = (j_all - 1).to(dtype)[:, None, None] * dt
    t_hi = j_all.to(dtype)[:, None, None] * dt
    consistent = (t_cross >= t_lo) & (t_cross <= t_hi)
    consistent[0] = True                                 # no bounce: always
    res = torch.where(consistent, res, torch.full_like(res, float("inf")))

    # Prefer free flight unless a bounce explains the window clearly better.
    res_none = res[0]
    res_bounce, h_bounce = torch.min(res[1:], dim=0)
    h_best = torch.where(res_bounce < 0.5 * res_none, 1 + h_bounce,
                         torch.zeros_like(h_bounce))              # [B, cu2]

    def take(a):
        return torch.gather(a, 0, h_best[None])[0]

    res_b, slope_b, icept_b = take(res), take(slope), take(icept)
    pos_f = torch.clamp(icept_b + slope_b * (s - 1) * dt, wall_lo, wall_hi)
    vel_f = slope_b

    naive_p, naive_v = obs[:, -1], vel_init
    ok = (torch.isfinite(pos_f) & torch.isfinite(vel_f)
          & (res_b < (accept_rms ** 2) * s))
    pos_f = torch.where(ok, pos_f, naive_p.detach())
    vel_f = torch.where(ok, vel_f, naive_v.detach())
    return (naive_p + (pos_f - naive_p).detach(),
            naive_v + (vel_f - naive_v).detach())
