"""Parity of the port's bouncing and gravity cells (ops/cells.py) with the
JAX package's, on the same numpy states: values and gradients of a rollout
of several frames, with the gravity clamps binding (coincident bodies, a
distance under 1 px, a distance tied at 1 px, one beyond 170 px), and the
cells against the dataset generators' own integrators.

Tolerances: float64 values and gradients at rtol 1e-10 (the same operations
in the same order); f32 values at rtol 1e-5 / atol 1e-4 px. The gravity
clamps are ``jnp.clip``, whose derivative at a bound is 1/2; the port's
must be too (``torch.clamp``'s is 1), so the tied case is compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.ops import cells as jax_cells
from paig_reproduction_tpu_torch.ops import cells

FRAMES = 4


def _rollout(mod, step, params, pos, vel, frames=FRAMES, **kw):
    """Sum of a weighted rollout's positions and velocities (a scalar to
    differentiate) and the last state."""
    total = 0.0
    for t in range(frames):
        pos, vel = step(params, pos, vel, **kw)
        w = (t + 1) * 0.1
        total = total + w * (pos ** 2).sum() + 0.3 * w * (vel * pos).sum()
    return total, (pos, vel)


def _gravity_states():
    """[B, 6] positions: a spread triangle, two coincident bodies (squared
    distance under 0.1), a pair 0.5 px apart (distance clamped to 1), a pair
    exactly 1 px apart (tied at the clamp), and one body 200 px away."""
    rs = np.random.RandomState(0)
    pos = np.array([
        [10.0, 12.0, 20.0, 14.0, 15.0, 22.0],
        [10.0, 10.0, 10.0, 10.0, 20.0, 20.0],
        [10.0, 10.0, 10.5, 10.0, 18.0, 25.0],
        [10.0, 10.0, 11.0, 10.0, 18.0, 25.0],
        [10.0, 10.0, 20.0, 15.0, 210.0, 10.0],
    ])
    vel = rs.uniform(-1, 1, pos.shape)
    return pos, vel


def _bouncing_states():
    """[B, 4] states near both walls and in the middle, moving fast enough
    to bounce within a frame."""
    rs = np.random.RandomState(1)
    pos = np.concatenate([rs.uniform(2.5, 5.0, (3, 4)),
                          rs.uniform(27.0, 29.5, (3, 4)),
                          rs.uniform(8.0, 24.0, (2, 4))])
    vel = rs.uniform(-8.0, 8.0, pos.shape)
    return pos, vel


def _jax_value_grad(step, pos, vel, log_g, log_m):
    def f(p, v, lg, lm):
        params = jax_cells.CellParams.initial()._replace(log_g=lg, log_m=lm)
        return _rollout(jnp, step, params, p, v)
    with jax.enable_x64(True):
        (val, (p, v)), grads = jax.value_and_grad(
            f, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(log_g),
            jnp.asarray(log_m))
        return (float(val), np.asarray(p), np.asarray(v),
                [np.asarray(g) for g in grads])


def _torch_value_grad(step, pos, vel, log_g, log_m):
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (pos, vel, log_g, log_m)]
    params = cells.CellParams(torch.zeros((), dtype=torch.float64),
                              torch.zeros((), dtype=torch.float64),
                              leaves[2], leaves[3])
    val, (p, v) = _rollout(torch, step, params, leaves[0], leaves[1])
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    return (float(val.detach()), p.detach().numpy(), v.detach().numpy(),
            [np.zeros(()) if g is None else g.numpy() for g in grads])


@pytest.mark.parametrize("row", range(5), ids=[
    "spread", "coincident", "under_1px", "tied_at_1px", "beyond_170px"])
def test_gravity_values_and_grads_match_jax(row):
    pos, vel = _gravity_states()
    pos, vel = pos[row:row + 1], vel[row:row + 1]
    log_g, log_m = np.log(60.0), 0.1
    ref = _jax_value_grad(jax_cells.gravity_step, pos, vel, log_g, log_m)
    out = _torch_value_grad(cells.gravity_step, pos, vel, log_g, log_m)
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-10)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out[2], ref[2], rtol=1e-10, atol=1e-12)
    for name, g, r in zip(("pos", "vel", "log_g", "log_m"), out[3], ref[3]):
        np.testing.assert_allclose(g, r, rtol=1e-10,
                                   atol=1e-12 * max(1.0, np.abs(r).max()),
                                   err_msg=name)


def test_gravity_clamp_derivative_at_a_tie_is_half():
    """At a distance of exactly 1 px the norm clamp's derivative is 1/2 in
    both packages."""
    j = jax.grad(lambda x: jnp.clip(jnp.sqrt(x), 1.0, 170.0))(1.0)
    x = torch.tensor(1.0, requires_grad=True)
    cells._clip(torch.sqrt(x), 1.0, 170.0).backward()
    assert float(x.grad) == float(j) == 0.25


def test_bouncing_values_and_grads_match_jax():
    pos, vel = _bouncing_states()
    ref = _jax_value_grad(jax_cells.bouncing_step, pos, vel, 0.0, 0.0)
    out = _torch_value_grad(cells.bouncing_step, pos, vel, 0.0, 0.0)
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-10)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out[2], ref[2], rtol=1e-10, atol=1e-12)
    for g, r in zip(out[3][:2], ref[3][:2]):
        np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-12)
    # a bounce happened: some velocity changed sign
    assert np.any(np.sign(out[2]) != np.sign(vel))


@pytest.mark.parametrize("name", ["bouncing", "gravity"])
def test_f32_rollout_matches_jax(name):
    pos, vel = _bouncing_states() if name == "bouncing" else \
        _gravity_states()
    step_j = getattr(jax_cells, f"{name}_step")
    step_t = getattr(cells, f"{name}_step")
    jp = jax_cells.CellParams.initial()._replace(
        log_g=jnp.asarray(np.log(60.0), jnp.float32))
    tp = cells.CellParams.initial()._replace(
        log_g=torch.tensor(np.log(60.0), dtype=torch.float32))
    pj, vj = jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32)
    pt = torch.from_numpy(pos.astype(np.float32))
    vt = torch.from_numpy(vel.astype(np.float32))
    for _ in range(FRAMES):
        pj, vj = step_j(jp, pj, vj)
        pt, vt = step_t(tp, pt, vt)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-4)


def test_gravity_cell_follows_the_generator():
    """On a 3bp_color generator state (g=60, m=1, dt=0.5, 10 substeps) with
    no clamp binding, the cell is the generator's integrator."""
    pos, vel = _gravity_states()
    p0, v0 = pos[0].reshape(3, 2), vel[0].reshape(3, 2)
    gp, gv = cells.numpy_generator_gravity(p0, v0, 60.0, 1.0, 0.5, 10)
    jp, jv = jax_cells.numpy_generator_gravity(p0, v0, 60.0, 1.0, 0.5, 10)
    assert np.array_equal(gp, jp) and np.array_equal(gv, jv)
    params = cells.CellParams(*(torch.tensor(x, dtype=torch.float64)
                                for x in (0.0, 0.0, np.log(60.0), 0.0)))
    cp, cv = cells.gravity_step(params, torch.from_numpy(pos[:1]),
                                torch.from_numpy(vel[:1]), 0.5, 10)
    np.testing.assert_allclose(cp.numpy().reshape(3, 2), gp, rtol=1e-10)
    np.testing.assert_allclose(cv.numpy().reshape(3, 2), gv, rtol=1e-10)


def test_spring_generator_matches_jax():
    rs = np.random.RandomState(2)
    p0, v0 = rs.uniform(8, 24, (2, 2)), rs.uniform(-8, 8, (2, 2))
    for args in ((4.0, 6.0, 0.3, 10), (2.0, 12.0, 0.03, 1)):
        gp, gv = cells.numpy_generator_spring(p0, v0, *args)
        jp, jv = jax_cells.numpy_generator_spring(p0, v0, *args)
        assert np.array_equal(gp, jp) and np.array_equal(gv, jv)


def test_bouncing_and_gravity_constants_match_jax():
    for name in ("BOUNCING_DT", "GRAVITY_DT", "WALL_SIZE", "BALL_RADIUS"):
        assert getattr(cells, name) == getattr(jax_cells, name), name
    assert set(cells.CELLS) == set(jax_cells.CELLS)
    for name, (_, dt) in cells.CELLS.items():
        assert dt == jax_cells.CELLS[name][1], name
