"""The port's spatial-transformer ops (ops/stn.py) against the JAX
package's: ``affine_grid``, ``grid_sample``, ``stn``, ``batch_transformer``
and ``separable_warp`` on the same seeded inputs, in f32, within 1e-6
(values of O(1); the two sides sum the same few terms in other orders).
The thetas are those of tests/test_stn.py: general ones, and the
decoder's axis-aligned ones, some of them sampling outside the input.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.ops import stn as jstn
from paig_reproduction_tpu_torch.ops import stn as tstn

ATOL = 1e-6


def _theta(rs, n, axis_aligned):
    if axis_aligned:
        theta = np.zeros((n, 2, 3), np.float32)
        theta[:, 0, 0] = rs.rand(n) * 2 + 0.2
        theta[:, 1, 1] = rs.rand(n) * 2 + 0.2
        theta[:, :, 2] = rs.randn(n, 2)
    else:
        theta = (rs.randn(n, 2, 3) * 0.7).astype(np.float32)
        theta[:, 0, 0] += 1.0
        theta[:, 1, 1] += 1.0
    return theta


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("size", [(3, 2, 32, 32), (2, 1, 13, 11)])
def test_affine_grid_matches_jax(size):
    theta = _theta(np.random.RandomState(0), size[0], False)
    _close(tstn.affine_grid(torch.from_numpy(theta), size),
           jstn.affine_grid(jnp.asarray(theta), size))


@pytest.mark.parametrize("axis_aligned", [False, True])
def test_grid_sample_and_stn_match_jax(axis_aligned):
    rs = np.random.RandomState(1)
    u = rs.rand(4, 3, 16, 16).astype(np.float32)
    theta = _theta(rs, 4, axis_aligned)
    grid = jstn.affine_grid(jnp.asarray(theta), (4, 3, 32, 32))
    _close(tstn.grid_sample(torch.from_numpy(u),
                            torch.from_numpy(np.array(grid))),
           jstn.grid_sample(jnp.asarray(u), grid))
    flat = theta.reshape(4, 6)
    _close(tstn.stn(torch.from_numpy(u), torch.from_numpy(flat), (32, 32)),
           jstn.stn(jnp.asarray(u), jnp.asarray(flat), (32, 32)))


def test_batch_transformer_matches_jax():
    rs = np.random.RandomState(2)
    u = rs.rand(2, 3, 16, 16).astype(np.float32)
    thetas = _theta(rs, 6, False).reshape(2, 3, 6)
    ours = tstn.batch_transformer(torch.from_numpy(u),
                                  torch.from_numpy(thetas), (24, 20))
    assert ours.shape == (6, 3, 24, 20)
    _close(ours, jstn.batch_transformer(jnp.asarray(u), jnp.asarray(thetas),
                                        (24, 20)))


def test_separable_warp_matches_jax():
    rs = np.random.RandomState(3)
    u = rs.rand(6, 4, 16, 16).astype(np.float32)
    sx, sy = (rs.rand(2, 6) + 0.3).astype(np.float32)
    tx, ty = rs.randn(2, 6).astype(np.float32)
    ours = tstn.separable_warp(torch.from_numpy(u), *map(
        torch.from_numpy, (sx, tx, sy, ty)), (32, 32))
    _close(ours, jstn.separable_warp(jnp.asarray(u), *map(
        jnp.asarray, (sx, tx, sy, ty)), (32, 32)))
    # And it is torch's own grid_sample at an axis-aligned theta.
    theta = np.stack([sx, 0 * sx, tx, 0 * sx, sy, ty], axis=1)
    grid = torch.nn.functional.affine_grid(
        torch.from_numpy(theta).reshape(6, 2, 3), [6, 4, 32, 32],
        align_corners=False)
    np.testing.assert_allclose(
        ours.numpy(), torch.nn.functional.grid_sample(
            torch.from_numpy(u), grid, align_corners=False).numpy(),
        atol=1e-5)
