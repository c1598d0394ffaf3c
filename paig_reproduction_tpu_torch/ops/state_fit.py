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

Gradients are straight-through: the forward value is the fitted state, the
backward pass sees the naive initializer (last observed position and the MLP
velocity). The solve itself runs on detached inputs.
"""
from __future__ import annotations

import torch

from paig_reproduction_tpu_torch.ops.cells import CellParams


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
