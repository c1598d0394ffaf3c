"""Parity of the port's ops (ops/resize.py, ops/stn.py, ops/cells.py) with
the JAX package's.

Tolerances: resize and the interpolation helpers are a handful of f32
operations, held to 1e-6. The spring rollout runs 8 frames of 5 Euler
substeps in f32; values are held to rtol 1e-5 / atol 1e-4 (positions are
O(10) px) and the gradients, which pass 40 substeps of Jacobian products
summed in a different order, to rtol 1e-4 / atol 1e-3 against
magnitudes of O(1e3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.ops import cells as jcells
from paig_reproduction_tpu.ops import stn as jstn
from paig_reproduction_tpu.ops.resize import resize_bilinear as j_resize
from paig_reproduction_tpu_torch.ops import cells as tcells
from paig_reproduction_tpu_torch.ops import stn as tstn
from paig_reproduction_tpu_torch.ops.resize import resize_bilinear as t_resize


@pytest.mark.parametrize("hw_in,hw_out", [((8, 8), (16, 16)),
                                          ((16, 16), (32, 32)),
                                          ((9, 9), (18, 18)),
                                          ((18, 18), (36, 36)),
                                          ((32, 32), (64, 64))])
def test_resize_bilinear_matches_jax(hw_in, hw_out):
    """The ShallowUNet's upsampling sizes at 32 px and 36 px (3bp_color),
    and the deep UNet's at 64 px (8 -> 16 -> 32 -> 64)."""
    x = np.random.RandomState(0).randn(2, 5, *hw_in).astype(np.float32)
    ref = np.asarray(j_resize(jnp.asarray(x), hw_out))
    out = t_resize(torch.from_numpy(x), hw_out).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_out,n_in", [(32, 16), (36, 18), (64, 32)])
def test_interp_matrix_matches_jax(n_out, n_in):
    src = (np.random.RandomState(1).rand(3, n_out) * 1.5 * n_in
           - 0.25 * n_in).astype(np.float32)
    np.testing.assert_allclose(
        tstn._interp_matrix(torch.from_numpy(src), n_in).numpy(),
        np.asarray(jstn._interp_matrix(jnp.asarray(src), n_in)), atol=1e-6)
    np.testing.assert_allclose(
        tstn._base_coords(n_out).numpy(),
        np.asarray(jstn._base_coords(n_out, jnp.float32)), atol=1e-7)


def _spring_inputs(seed, coincident=False):
    rs = np.random.RandomState(seed)
    pos = (rs.rand(3, 4) * 32).astype(np.float32)
    if coincident:
        pos[:, 2:] = pos[:, :2]      # both objects at one point
    vel = rs.randn(3, 4).astype(np.float32)
    weights = rs.randn(8, 3, 4).astype(np.float32)
    return pos, vel, weights


def _jax_rollout(log_k, log_equil, pos, vel, weights, limit):
    params = jcells.CellParams.initial()._replace(log_k=log_k,
                                                  log_equil=log_equil)
    poss = []
    for _ in range(weights.shape[0]):
        pos, vel = jcells.spring_step(params, pos, vel)
        pos = jcells.clip_cotangent(pos, limit)
        vel = jcells.clip_cotangent(vel, limit)
        poss.append(pos)
    return jnp.stack(poss), jnp.sum(jnp.stack(poss) * weights) * 1e2


def _torch_rollout(log_k, log_equil, pos, vel, weights, limit):
    params = tcells.CellParams.initial()._replace(log_k=log_k,
                                                  log_equil=log_equil)
    poss = []
    for _ in range(weights.shape[0]):
        pos, vel = tcells.spring_step(params, pos, vel)
        pos = tcells.clip_cotangent(pos, limit)
        vel = tcells.clip_cotangent(vel, limit)
        poss.append(pos)
    return (torch.stack(poss),
            torch.sum(torch.stack(poss) * torch.from_numpy(weights)) * 1e2)


@pytest.mark.parametrize("coincident", [False, True])
@pytest.mark.parametrize("limit", [1e3, 1.0, float("inf")])
def test_spring_rollout_values_and_grads_match_jax(coincident, limit):
    """limit 1.0 makes the cotangent clip bind; inf turns it off."""
    pos, vel, weights = _spring_inputs(seed=int(coincident),
                                       coincident=coincident)
    j_fn = jax.jit(jax.value_and_grad(
        lambda lk, le, p, v: _jax_rollout(lk, le, p, v, weights, limit)[1],
        argnums=(0, 1, 2, 3)))
    j_val, j_grads = j_fn(jnp.float32(0.1), jnp.float32(0.2),
                          jnp.asarray(pos), jnp.asarray(vel))
    j_pos = np.asarray(jax.jit(lambda p, v: _jax_rollout(
        jnp.float32(0.1), jnp.float32(0.2), p, v, weights, limit)[0])(
            pos, vel))

    leaves = [torch.tensor(0.1, requires_grad=True),
              torch.tensor(0.2, requires_grad=True),
              torch.tensor(pos, requires_grad=True),
              torch.tensor(vel, requires_grad=True)]
    t_pos, t_val = _torch_rollout(*leaves, weights, limit)
    t_grads = torch.autograd.grad(t_val, leaves)

    np.testing.assert_allclose(t_pos.detach().numpy(), j_pos, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5)
    for name, tg, jg in zip(("log_k", "log_equil", "pos", "vel"), t_grads,
                            j_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-3, err_msg=name)


def test_clip_cotangent_is_identity_forward_and_clips_per_sample():
    x = torch.randn(4, 3, requires_grad=True)
    y = tcells.clip_cotangent(x, limit=1.0)
    assert torch.equal(y, x)
    g = torch.tensor([[3.0, 4.0, 0.0], [0.3, 0.4, 0.0], [0.0, 0.0, 0.0],
                      [6.0, 8.0, 0.0]])
    (gx,) = torch.autograd.grad(y, x, g)
    # Row norms 5, 0.5, 0, 10 -> clipped to 1, kept, kept, clipped to 1.
    np.testing.assert_allclose(gx.norm(dim=1).numpy(), [1.0, 0.5, 0.0, 1.0],
                               rtol=1e-6)
    j_gx = jax.grad(lambda a: jnp.sum(jcells.clip_cotangent(a, 1.0)
                                      * jnp.asarray(g.numpy())))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), rtol=1e-6)


def test_cell_constants_match_jax():
    assert tcells.SUBSTEPS == jcells.SUBSTEPS
    assert tcells.SPRING_DT == jcells.SPRING_DT
    assert tcells.COTANGENT_LIMIT == jcells.COTANGENT_LIMIT
    assert tcells.SPRING_FORCE_CLAMP == jcells.SPRING_FORCE_CLAMP
    assert tcells.SPRING_SQRT_EPS == jcells.SPRING_SQRT_EPS
    assert tcells.CELLS["spring_ode_cell"][1] == \
        jcells.CELLS["spring_ode_cell"][1]
