"""Closed-form physical-parameter identification from encoder positions.

The port's numpy copy of ``paig_reproduction_tpu/ops/identify.py``, which
the train-time physics self-identification (``--fit_physics_every``,
``train/recipes.py``) uses. Given an encoder, the physical parameters are
identifiable from its own position sequences: the spring constant and
equilibrium length (a_par = -k*norm + 2*k*equil), and gravity's
A = g*m^2 (a = -A * sum_j d/|d|^3). The trajectory-space fits
(coarse-to-fine grids, scoring rollouts from finite-difference initial
velocities against the encoder positions) integrate instead of
double-differentiating, which would bias the parameters toward zero under
encoder noise; ``fit_gravity`` is the pointwise fit.

Pure numpy on host arrays.
"""
from __future__ import annotations

import numpy as np

# Outer coarse-to-fine grid bounds. A fit that lands on (or refines against)
# an outer edge found no interior optimum and must not be installed. The
# equilibrium bound sits above every task's truth (mnist's is 12); the
# search grids derive from these constants, so the rejection rule and the
# grid agree.
SPRING_K_BOUNDS = (0.25, 16.0)
SPRING_E_BOUNDS = (1.0, 20.0)
GRAVITY_A_BOUNDS = (2.0, 400.0)


def on_bounds(value, bounds, rel=0.02) -> bool:
    """True when ``value`` sits within ``rel`` (log-space) of either
    outer grid edge."""
    lo, hi = bounds
    return (value <= lo * (1 + rel)) or (value >= hi * (1 - rel))


def align_slots(enc: np.ndarray, n_objs: int) -> np.ndarray:
    """Permutation-consistent slot identities across frames.

    enc: [N, T, n_objs*2] object-major (x1, y1, x2, y2, ...). The encoder
    binds slots by appearance and can flicker the assignment at object
    crossings (measured: 68/200 bouncing test sequences), which poisons
    any trajectory fit. Aligns each frame backward to its successor by
    exhaustive permutation (n_objs <= 3 in every task; identity for
    larger counts)."""
    if n_objs > 3 or n_objs < 2 or enc.shape[1] < 2:
        return enc
    from itertools import permutations
    p = enc.reshape(enc.shape[0], enc.shape[1], n_objs, 2).copy()
    perms = list(permutations(range(n_objs)))
    for t in range(p.shape[1] - 2, -1, -1):
        ref = p[:, t + 1]
        costs = np.stack([((p[:, t][:, list(pm)] - ref) ** 2).sum((1, 2))
                          for pm in perms], axis=1)
        best = costs.argmin(axis=1)
        for i in np.nonzero(best)[0]:
            p[i, t] = p[i, t][list(perms[best[i]])]
    return p.reshape(enc.shape)


def spring_trajectory_error(enc, dt, k, e, input_steps=4, horizon=6,
                            substeps=5):
    """Summed per-frame median squared trajectory error of spring params
    (k, e) rolled out from finite-difference initial states against the
    encoder positions — the objective fit_spring_trajectory minimizes,
    exposed so callers (the --fit_physics_every hook) can compare a
    candidate fit against the CURRENT model parameters and refuse
    regressions (a pre-discovery encoder yields meaningless fits)."""
    p = enc.reshape(enc.shape[0], enc.shape[1], 2, 2)
    i0 = input_steps - 1
    horizon = min(horizon, enc.shape[1] - input_steps)
    h = dt / substeps
    err = 0.0
    poss = p[:, i0].copy()
    vels = (p[:, i0] - p[:, i0 - 1]) / dt
    for t in range(horizon):
        for _ in range(substeps):
            diff = poss[:, 0] - poss[:, 1]
            norm = np.linalg.norm(diff, axis=-1, keepdims=True)
            force = k * (norm - 2 * e) * diff / (norm + 1e-9)
            vels = vels + h * np.stack([-force, force], axis=1)
            poss = poss + h * vels
        err += np.median(
            np.sum((poss - p[:, input_steps + t]) ** 2, axis=(1, 2)))
    return float(err)


def fit_spring_trajectory(enc, dt, input_steps=4, horizon=6, substeps=5):
    """Trajectory-space fit: coarse-to-fine grid over (k, equil), scoring
    rollouts from finite-difference initial velocities against the
    encoder positions. Integration (vs the pointwise fit's double
    differentiation) suppresses the errors-in-variables attenuation that
    biases k toward zero under encoder noise."""
    def score(k, e):
        return spring_trajectory_error(enc, dt, k, e,
                                       input_steps=input_steps,
                                       horizon=horizon, substeps=substeps)

    ks = np.exp(np.linspace(*map(np.log, SPRING_K_BOUNDS), 9))
    es = np.exp(np.linspace(*map(np.log, SPRING_E_BOUNDS), 9))
    best = None
    for _ in range(3):   # coarse-to-fine
        scores = np.array([[score(k, e) for e in es] for k in ks])
        ik, ie = np.unravel_index(scores.argmin(), scores.shape)
        best = (ks[ik], es[ie], scores[ik, ie])
        ks = np.exp(np.linspace(np.log(ks[max(0, ik - 1)]),
                                np.log(ks[min(len(ks) - 1, ik + 1)]), 7))
        es = np.exp(np.linspace(np.log(es[max(0, ie - 1)]),
                                np.log(es[min(len(es) - 1, ie + 1)]), 7))
    return best


def fit_gravity(enc, dt):
    """enc: [N, T, 6]. Returns (A = g*m^2, residual): the pointwise fit of
    the generator law a_i = -g m^2 sum_j (p_i - p_j)/|p_i - p_j|^3 to
    central-difference accelerations."""
    p = enc.reshape(enc.shape[0], enc.shape[1], 3, 2)
    acc = (p[:, 2:] - 2 * p[:, 1:-1] + p[:, :-2]) / dt ** 2
    mid = p[:, 1:-1]
    xs, ys = [], []
    for i in range(3):
        f = np.zeros_like(mid[:, :, i])
        for j in range(3):
            if i == j:
                continue
            d = mid[:, :, i] - mid[:, :, j]
            n = np.linalg.norm(d, axis=-1, keepdims=True)
            f = f + d / (n ** 3 + 1e-9)
        # acc_i = -A * f, regressed componentwise
        xs.append(-f.reshape(-1, 2).ravel())
        ys.append(acc[:, :, i].reshape(-1, 2).ravel())
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    A = float(np.dot(x, y) / (np.dot(x, x) + 1e-12))
    rms = float(np.sqrt(np.mean((A * x - y) ** 2)))
    return A, rms


def gravity_trajectory_error(enc, dt, A, input_steps=4, horizon=12,
                             substeps=5):
    """fit_gravity_trajectory's objective for one candidate A, for the same
    candidate-against-current comparison as spring_trajectory_error. The
    distance is floored as the cell clamps it, and the initial velocity is
    the second-order one-sided difference (the first-order one equals
    v - a*dt/2, a bias correlated with A)."""
    p = enc.reshape(enc.shape[0], enc.shape[1], 3, 2)
    i0 = input_steps - 1
    horizon = min(horizon, enc.shape[1] - input_steps)
    h = dt / substeps
    err = 0.0
    poss = p[:, i0].copy()
    vels = (3 * p[:, i0] - 4 * p[:, i0 - 1] + p[:, i0 - 2]) / (2 * dt)
    for t in range(horizon):
        for _ in range(substeps):
            acc = np.zeros_like(poss)
            for i in range(3):
                for j in range(3):
                    if i == j:
                        continue
                    d = poss[:, j] - poss[:, i]
                    n = np.linalg.norm(d, axis=-1, keepdims=True)
                    n = np.clip(n, 1.0, 170.0)
                    acc[:, i] += A * d / n ** 3
            vels = vels + h * acc
            poss = poss + h * vels
        err += np.median(
            np.sum((poss - p[:, input_steps + t]) ** 2, axis=(1, 2)))
    return float(err)


def fit_gravity_trajectory(enc, dt, input_steps=4, horizon=12,
                           substeps=5):
    """Trajectory-space 1-D fit of A = g*m^2 over a coarse-to-fine log
    grid inside GRAVITY_A_BOUNDS. Returns (A, error)."""
    def score(A):
        return gravity_trajectory_error(enc, dt, A,
                                        input_steps=input_steps,
                                        horizon=horizon,
                                        substeps=substeps)

    grid = np.exp(np.linspace(*map(np.log, GRAVITY_A_BOUNDS), 13))
    best = None
    for _ in range(3):   # coarse-to-fine
        scores = np.array([score(a) for a in grid])
        ia = int(scores.argmin())
        best = (float(grid[ia]), float(scores[ia]))
        grid = np.exp(np.linspace(
            np.log(grid[max(0, ia - 1)]),
            np.log(grid[min(len(grid) - 1, ia + 1)]), 9))
    return best
