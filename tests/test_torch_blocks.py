"""Parity of the port's building blocks (models/blocks.py) with the JAX
package's flax modules, on the same inputs and the same weights carried
across by convert.py.

Tolerance: atol 1e-5 relative to outputs of O(1) (positions: O(10) px,
held to 1e-4). Both sides compute in f32; convolutions and matmuls sum in
different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import blocks as jblocks
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.models import blocks as tblocks


def _init(module, *args):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *args)["params"]
    return params, flax_to_state_dict(jax.device_get(params))


def _frames(n, hw, ch, seed):
    return np.random.RandomState(seed).rand(n, hw, hw, ch).astype(
        np.float32)                                           # NHWC


@pytest.mark.parametrize("ch", [1, 3])
def test_shallow_unet_matches_jax(ch):
    x = _frames(3, 32, ch, seed=ch)
    j_mod = jblocks.ShallowUNet(8, 2)
    params, state = _init(j_mod, jnp.asarray(x))
    ref = np.asarray(jax.jit(j_mod.apply)({"params": params}, x))
    t_mod = tblocks.ShallowUNet(ch, 8, 2)
    t_mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = t_mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5)


def test_shallow_unet_at_36px_matches_jax():
    """3bp_color's 36 px frames: pools to 18 and 9, resizes back."""
    x = _frames(2, 36, 3, seed=7)
    j_mod = jblocks.ShallowUNet(8, 3)
    params, state = _init(j_mod, jnp.asarray(x))
    ref = np.asarray(jax.jit(j_mod.apply)({"params": params}, x))
    t_mod = tblocks.ShallowUNet(3, 8, 3)
    t_mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = t_mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5)


@pytest.mark.parametrize("ch", [1, 3])
def test_unet_matches_jax(ch):
    """The deep UNet of 40 px and larger inputs, at mnist_spring_color's
    64 px: three pools (to 8 px) and resizes to 16, 32 and 64."""
    x = _frames(2, 64, ch, seed=20 + ch)
    j_mod = jblocks.UNet(16, 2)
    params, state = _init(j_mod, jnp.asarray(x))
    ref = np.asarray(jax.jit(j_mod.apply)({"params": params}, x))
    t_mod = tblocks.UNet(ch, 16, 2)
    t_mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = t_mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5)
    # no ReLU on the final 1x1 conv
    assert ref.min() < 0


@pytest.mark.parametrize("ch", [1, 3])
def test_convolutional_encoder_matches_jax(ch):
    _check_encoder(32, ch, 2, seed=10 + ch)


@pytest.mark.parametrize("hw,ch,n_objs", [(36, 3, 3), (64, 3, 2)])
def test_convolutional_encoder_of_other_tasks_matches_jax(hw, ch, n_objs):
    """3bp_color's 36 px frames with 3 objects, and mnist_spring_color's
    64 px frames through the deep UNet and the 2x2-pooled head."""
    _check_encoder(hw, ch, n_objs, seed=10 + ch + hw)


def _check_encoder(hw, ch, n_objs, seed):
    x = _frames(4, hw, ch, seed=seed)
    j_mod = jblocks.ConvolutionalEncoder(input_hw=(hw, hw), n_objs=n_objs)
    params, state = _init(j_mod, jnp.asarray(x))
    j_pos, j_masks, j_masked = jax.jit(j_mod.apply)({"params": params}, x)
    t_mod = tblocks.ConvolutionalEncoder((hw, hw), ch, n_objs=n_objs)
    t_mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        pos, masks, masked = t_mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4)
    np.testing.assert_allclose(masks.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_masks), atol=1e-5)
    np.testing.assert_allclose(masked.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_masked), atol=1e-5)


@pytest.mark.parametrize("alt_vel", [False, True])
def test_velocity_encoder_matches_jax(alt_vel):
    pos = (np.random.RandomState(5).rand(3, 4, 4) * 32).astype(np.float32)
    j_mod = jblocks.VelocityEncoder(alt_vel=alt_vel, input_steps=4,
                                    n_objs=2)
    params, state = _init(j_mod, jnp.asarray(pos))
    ref = np.asarray(j_mod.apply({"params": params}, jnp.asarray(pos)))
    t_mod = tblocks.VelocityEncoder(alt_vel, 4, 2)
    t_mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = t_mod(torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_variable_from_network_matches_jax():
    j_mod = jblocks.VariableFromNetwork((2, 16, 16, 3))
    params, state = _init(j_mod)
    ref = np.asarray(j_mod.apply({"params": params}))
    t_mod = tblocks.VariableFromNetwork((2, 16, 16, 3))
    t_mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = t_mod()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_layers_draw_from_the_generator():
    """The layers keep torch's initialization: the same seed of torch's
    generator gives the same weights, and Linear's default
    U(+-1/sqrt(fan_in)) bound holds for kernel and bias."""
    torch.manual_seed(3)
    a = tblocks.TorchDense(50, 7)
    torch.manual_seed(3)
    b = tblocks.TorchDense(50, 7)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    bound = 1 / np.sqrt(50)
    assert float(a.weight.detach().abs().max()) <= bound
    assert float(a.bias.detach().abs().max()) <= bound
    conv = tblocks.TorchConv(4, 6)
    assert float(conv.weight.detach().abs().max()) <= 1 / np.sqrt(4 * 9)
