"""Parity of the port's ``ops/state_fit.py`` with the JAX package's, on the
same numpy windows. ``fit_initial_state`` (the ``--init_state_fit``
Gauss-Newton fit): a well-posed batch, a near-coincident batch where the f32
rails (Jacobian and residual clips, the step clamp, nan_to_num) act, the
straight-through gradient, and a window of the gravity cell.
``align_slot_identities`` and ``fit_initial_state_bouncing``: exact, noisy,
slot-swapped and unexplainable bouncing windows, built as the JAX package's
own tests build them.

Tolerances: the well-posed fit at rtol 1e-4 / atol 1e-4 px in f32 (sums in
another order through 3 iterations of a 4x4 solve) and 1e-9 in float64; the
near-coincident batch in float64 at 1e-9 (in f32 there the solves amplify
rounding; each package's own f32 result moves by more than its difference
from the other). Gradients are exact: both are the naive initializer's. The
bouncing fit is closed form: f32 at 1e-4 px, float64 at 1e-9, and the
hypothesis each coordinate takes is the same in both (its outputs would
differ by far more otherwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.ops import cells as jax_cells
from paig_reproduction_tpu.ops.state_fit import (
    align_slot_identities as jax_align,
)
from paig_reproduction_tpu.ops.state_fit import (
    fit_initial_state as jax_fit,
)
from paig_reproduction_tpu.ops.state_fit import (
    fit_initial_state_bouncing as jax_fit_bouncing,
)
from paig_reproduction_tpu_torch.ops import cells
from paig_reproduction_tpu_torch.ops.state_fit import (
    align_slot_identities,
    fit_initial_state,
    fit_initial_state_bouncing,
)

DT = 0.3


def _windows(b=8, s=4, seed=0, separation=10.0, noise=0.2):
    """Observed positions [B, s, 4] of spring trajectories (k=4, equil=6,
    the dataset's) with Gaussian noise, and an initial velocity guess."""
    rs = np.random.RandomState(seed)
    centre = rs.uniform(12, 20, (b, 2))
    angle = rs.uniform(0, 2 * np.pi, b)
    off = 0.5 * separation * np.stack([np.cos(angle), np.sin(angle)], 1)
    p = np.concatenate([centre + off, centre - off], 1)
    v = rs.randn(b, 4) * 2.0
    params = cells.CellParams.initial()._replace(
        log_k=torch.tensor(np.log(4.0), dtype=torch.float64),
        log_equil=torch.tensor(np.log(3.0), dtype=torch.float64))
    pt, vt = torch.from_numpy(p), torch.from_numpy(v)
    obs = [p]
    for _ in range(s - 1):
        pt, vt = cells.spring_step(params, pt, vt, DT)
        obs.append(pt.numpy())
    obs = np.stack(obs, 1) + rs.randn(b, s, 4) * noise
    return obs, v + rs.randn(b, 4) * 0.5


def _both(obs, vel, dtype, log_k=np.log(4.0), log_equil=np.log(3.0),
          iters=3):
    with jax.enable_x64(dtype == np.float64):
        jp = jax_cells.CellParams.initial()._replace(
            log_k=jnp.asarray(log_k, dtype),
            log_equil=jnp.asarray(log_equil, dtype))
        j_pos, j_vel = jax_fit(jax_cells.spring_step, jp,
                               jnp.asarray(obs, dtype),
                               jnp.asarray(vel, dtype), DT, 5, iters)
        j_pos, j_vel = np.asarray(j_pos), np.asarray(j_vel)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tp = cells.CellParams(*(torch.tensor(x, dtype=tdt) for x in (
        log_k, log_equil, 0.0, 0.0)))
    pos, vel_out = fit_initial_state(
        cells.spring_step, tp, torch.from_numpy(obs.astype(dtype)),
        torch.from_numpy(vel.astype(dtype)), DT, 5, iters)
    return (pos.numpy(), vel_out.numpy()), (j_pos, j_vel)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-9)])
def test_fit_matches_jax(dtype, tol):
    obs, vel = _windows()
    (pos, v), (j_pos, j_vel) = _both(obs, vel, dtype)
    np.testing.assert_allclose(pos, j_pos, rtol=tol, atol=tol)
    np.testing.assert_allclose(v, j_vel, rtol=tol, atol=tol)
    # The fit moved the state off the naive initializer.
    assert np.abs(pos - obs[:, -1]).max() > 1e-2


def test_near_coincident_batch_matches_jax():
    """Objects 1e-3 px apart: the spring direction's Jacobian overflows, so
    the clips and the step clamp decide the result. Samples whose fit fails
    fall back to the naive initializer in both packages."""
    obs, vel = _windows(b=6, separation=1e-3, noise=0.0, seed=1)
    obs[:3] += np.random.RandomState(2).randn(3, 4, 4) * 5.0
    (pos, v), (j_pos, j_vel) = _both(obs, vel * 50.0, np.float64,
                                     log_k=np.log(400.0))
    assert np.isfinite(pos).all() and np.isfinite(v).all()
    np.testing.assert_allclose(pos, j_pos, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(v, j_vel, rtol=1e-9, atol=1e-9)
    # Some samples kept the naive initializer (the acceptance test).
    naive = np.all(pos == obs[:, -1], axis=1)
    assert naive.any()


def test_rails_bound_the_jacobian():
    """With the clips off the near-coincident windows give non-finite
    Jacobian entries; the rails keep every output finite."""
    obs, vel = _windows(b=4, separation=0.0, noise=0.0, seed=3)
    tp = cells.CellParams(*(torch.tensor(x, dtype=torch.float32) for x in (
        np.log(1e4), np.log(3.0), 0.0, 0.0)))
    pos, v = fit_initial_state(cells.spring_step, tp,
                               torch.from_numpy(obs.astype(np.float32)),
                               torch.from_numpy(vel.astype(np.float32)) * 1e3,
                               DT, 5, 3)
    assert torch.isfinite(pos).all() and torch.isfinite(v).all()


def test_straight_through_gradient_matches_jax():
    """The backward pass sees the naive initializer: d/d obs of a weighted
    sum of the outputs lands on the last frame only, d/d vel_init is the
    velocity weight; the same as jax.grad of the JAX fit."""
    obs, vel = _windows(seed=4)
    rs = np.random.RandomState(5)
    wp, wv = rs.randn(8, 4), rs.randn(8, 4)

    def j_loss(o, v):
        p, vv = jax_fit(jax_cells.spring_step,
                        jax_cells.CellParams.initial()._replace(
                            log_k=jnp.log(4.0), log_equil=jnp.log(3.0)),
                        o, v, DT, 5, 3)
        return jnp.sum(p * wp) + jnp.sum(vv * wv)

    j_go, j_gv = jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(obs, np.float32), jnp.asarray(vel, np.float32))
    o = torch.from_numpy(obs.astype(np.float32)).requires_grad_()
    v = torch.from_numpy(vel.astype(np.float32)).requires_grad_()
    tp = cells.CellParams(*(torch.tensor(x, dtype=torch.float32) for x in (
        np.log(4.0), np.log(3.0), 0.0, 0.0)))
    p, vv = fit_initial_state(cells.spring_step, tp, o, v, DT, 5, 3)
    (torch.sum(p * torch.from_numpy(wp).float())
     + torch.sum(vv * torch.from_numpy(wv).float())).backward()
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(j_go), rtol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(j_gv), rtol=1e-6)
    assert np.abs(o.grad.numpy()[:, :-1]).max() == 0.0


def test_short_window_is_the_naive_initializer():
    obs, vel = _windows(s=1)
    tp = cells.CellParams.initial()
    pos, v = fit_initial_state(cells.spring_step, tp, torch.from_numpy(obs),
                               torch.from_numpy(vel), DT, 5, 3)
    assert np.array_equal(pos.numpy(), obs[:, -1])
    assert np.array_equal(v.numpy(), vel)


def test_gravity_window_fit_matches_jax():
    """The Gauss-Newton fit through the gravity cell (3bp_color's
    --init_state_fit=3), on noisy 3-body windows, in float64."""
    rs = np.random.RandomState(6)
    b, s = 6, 4
    angle = rs.uniform(0, 2 * np.pi, (b, 1)) + np.array([0, 2.1, 4.2])
    p = np.stack([18 + 7 * np.cos(angle), 18 + 7 * np.sin(angle)],
                 -1).reshape(b, 6)
    v = rs.uniform(-1, 1, (b, 6))
    params = cells.CellParams(*(torch.tensor(x, dtype=torch.float64)
                                for x in (0.0, 0.0, np.log(60.0), 0.0)))
    pt, vt = torch.from_numpy(p), torch.from_numpy(v)
    obs = [p]
    for _ in range(s - 1):
        pt, vt = cells.gravity_step(params, pt, vt)
        obs.append(pt.numpy())
    obs = np.stack(obs, 1) + rs.randn(b, s, 6) * 0.1
    vel0 = vt.numpy() + rs.randn(b, 6) * 0.5
    pos, vel = fit_initial_state(cells.gravity_step, params,
                                 torch.from_numpy(obs), torch.from_numpy(vel0),
                                 cells.GRAVITY_DT, 5, 3)
    with jax.enable_x64(True):
        jp = jax_cells.CellParams.initial()._replace(
            log_g=jnp.asarray(np.log(60.0)))
        j_pos, j_vel = jax_fit(jax_cells.gravity_step, jp, jnp.asarray(obs),
                               jnp.asarray(vel0), cells.GRAVITY_DT, 5, 3)
        j_pos, j_vel = np.asarray(j_pos), np.asarray(j_vel)
    np.testing.assert_allclose(pos.numpy(), j_pos, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(vel.numpy(), j_vel, rtol=1e-9, atol=1e-9)
    assert np.abs(pos.numpy() - obs[:, -1]).max() > 1e-2


def _bouncing_states(rs, b, s, vmax=8.0):
    """s frames of bouncing states [B, s, 4], half of them starting near the
    low wall so that windows hold bounces (the JAX tests' windows)."""
    pos = torch.from_numpy(np.concatenate(
        [rs.uniform(2.5, 6.0, (b // 2, 4)),
         rs.uniform(4.0, 28.0, (b - b // 2, 4))], axis=0))
    vel = torch.from_numpy(rs.uniform(-vmax, vmax, (b, 4)))
    ps, vs = [pos], [vel]
    for _ in range(s - 1):
        pos, vel = cells.bouncing_step(None, pos, vel)
        ps.append(pos)
        vs.append(vel)
    return torch.stack(ps, 1).numpy(), torch.stack(vs, 1).numpy()


def _bouncing_windows(case):
    """(obs [B, 4, 4], vel_init [B, 4]) of one of the JAX tests' cases."""
    if case == "exact":
        rs = np.random.RandomState(10)
        pos, vel = _bouncing_states(rs, 64, 4)
        p4 = pos.reshape(-1, 4, 2, 2)
        sep = np.linalg.norm(p4[:, :, 0] - p4[:, :, 1], axis=-1).min(axis=1)
        pos, vel = pos[sep > 3.0], vel[sep > 3.0]
        return pos, vel[:, -1] + 1.5
    if case == "noisy":
        rs = np.random.RandomState(11)
        pos, vel = _bouncing_states(rs, 256, 4)
        return (pos + 0.2 * rs.randn(*pos.shape),
                vel[:, -1] + 0.8 * rs.randn(256, 4))
    if case == "swapped":
        rs = np.random.RandomState(12)
        pos, vel = _bouncing_states(rs, 32, 4, vmax=5.0)
        sep = np.linalg.norm(pos[:, 0, :2] - pos[:, 0, 2:], axis=-1)
        pos, vel = pos[sep > 8.0], vel[sep > 8.0]
        pos[:, 1] = pos[:, 1][:, [2, 3, 0, 1]]          # flicker frame 1
        return pos, vel[:, -1] + 1.0
    obs = np.tile(np.array([16.0, 16, 16, 16])[None, :, None], (4, 1, 4))
    obs[:, :, 0] = [5.0, 25.0, 5.0, 25.0]               # 20 px/frame zig-zag
    return obs, np.full((4, 4), 3.0)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-9)])
@pytest.mark.parametrize("case", ["exact", "noisy", "swapped",
                                  "unexplainable"])
def test_bouncing_fit_matches_jax(case, dtype, tol):
    obs, vel = _bouncing_windows(case)
    obs, vel = obs.astype(dtype), vel.astype(dtype)
    pos, v = fit_initial_state_bouncing(torch.from_numpy(obs),
                                        torch.from_numpy(vel),
                                        cells.BOUNCING_DT)
    with jax.enable_x64(dtype == np.float64):
        j_pos, j_vel = jax_fit_bouncing(jnp.asarray(obs), jnp.asarray(vel),
                                        cells.BOUNCING_DT)
        j_pos, j_vel = np.asarray(j_pos), np.asarray(j_vel)
    np.testing.assert_allclose(pos.numpy(), j_pos, rtol=tol, atol=tol)
    np.testing.assert_allclose(v.numpy(), j_vel, rtol=tol, atol=tol)
    if case == "unexplainable":
        # The zig-zag coordinate keeps the naive initializer; the constant
        # tracks take the fit's zero velocity.
        np.testing.assert_allclose(v.numpy()[:, 0], vel[:, 0])
        np.testing.assert_allclose(v.numpy()[:, 1], 0.0, atol=1e-5)
    elif case != "noisy":
        # Noise-free windows, bounces and flickers included, are recovered.
        assert np.abs(v.numpy() - vel).max() > 0.5


def test_align_slot_identities_matches_jax():
    obs, _ = _bouncing_windows("swapped")
    rs = np.random.RandomState(13)
    obs = np.concatenate([obs, rs.uniform(0, 32, (8, 4, 4))])
    out = align_slot_identities(torch.from_numpy(obs)).numpy()
    with jax.enable_x64(True):
        ref = np.asarray(jax_align(jnp.asarray(obs)))
    assert np.array_equal(out, ref)
    # the flickered frame is swapped back; the last frame never moves
    assert not np.array_equal(out[:4], obs[:4])
    assert np.array_equal(out[:, -1], obs[:, -1])
    three = rs.uniform(0, 32, (2, 4, 6))
    assert np.array_equal(
        align_slot_identities(torch.from_numpy(three)).numpy(), three)


def test_bouncing_fit_straight_through_gradient():
    """The backward pass sees the naive initializer, as the JAX fit's."""
    obs, vel = _bouncing_windows("noisy")
    obs, vel = obs[:16].astype(np.float32), vel[:16].astype(np.float32)
    rs = np.random.RandomState(14)
    wp, wv = rs.randn(16, 4), rs.randn(16, 4)

    def j_loss(o, v):
        p, vv = jax_fit_bouncing(o, v, cells.BOUNCING_DT)
        return jnp.sum(p * wp) + jnp.sum(vv * wv)

    j_go, j_gv = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(obs),
                                                   jnp.asarray(vel))
    o = torch.from_numpy(obs).requires_grad_()
    v = torch.from_numpy(vel).requires_grad_()
    p, vv = fit_initial_state_bouncing(o, v, cells.BOUNCING_DT)
    (torch.sum(p * torch.from_numpy(wp).float())
     + torch.sum(vv * torch.from_numpy(wv).float())).backward()
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(j_go), rtol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(j_gv), rtol=1e-6)
