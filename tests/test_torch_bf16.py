"""The port's ``compute_dtype="bfloat16"`` against the JAX model's, on the
CPU, with the same weights carried across by convert.py.

Both packages run the encoder's UNet and its two hidden MLP layers in bf16
with float32 master weights and keep everything else in float32. Their bf16
products sum in float32 and round once, in orders that differ, so a value
now and then lands one bf16 step away and the difference travels on.
Measured on these inputs: 0.978 (ShallowUNet) and 0.962 (UNet) of the
UNet outputs are bit-equal to the JAX model's, where the float32 UNet's are
0.77 and 0.00; positions differ by 1.7e-3 px at 32 px and 2.6e-3 px at
64 px, reconstructions by 8.8e-5 and 3.4e-4 (over four seeds at most
2.5e-3 / 3.9e-3 px and 1.9e-4 / 5.8e-4). The tolerances are about 3x the
worst of those: 0.9 of the outputs bit-equal, positions within 1e-2 px,
reconstructions within 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.models import blocks as jblocks
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.models import PhysicsNet, compute_losses
from paig_reproduction_tpu_torch.models import blocks as tblocks
from paig_reproduction_tpu_torch.train.optimizers import build_optimizer

BIT_EQUAL = 0.9
POS_ATOL = 1e-2
RECONS_ATOL = 2e-3


def _kw(task, img):
    return dict(task=task, cell_type="spring_ode_cell", seq_len=8,
                input_steps=3, pred_steps=4, autoencoder_loss=3.0, color=True,
                input_size=img * img, compute_dtype="bfloat16")


@pytest.mark.parametrize("unet,hw,hidden", [("ShallowUNet", 32, 8),
                                            ("UNet", 64, 16)])
def test_unet_rounds_as_jax(unet, hw, hidden):
    x = np.random.RandomState(0).rand(2, hw, hw, 3).astype(np.float32)
    j_mod = getattr(jblocks, unet)(hidden, 2, dtype=jnp.bfloat16)
    params = jax.jit(j_mod.init)(jax.random.PRNGKey(0), x)["params"]
    ref = jax.jit(j_mod.apply)({"params": params}, x)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    t_mod = getattr(tblocks, unet)(3, hidden, 2, dtype=torch.bfloat16)
    t_mod.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                          strict=True)
    with torch.no_grad():
        out = t_mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in t_mod.parameters())
    out = out.float().permute(0, 2, 3, 1).numpy()
    assert (out == ref).mean() >= BIT_EQUAL


@pytest.fixture(scope="module", params=[("spring_color", 32),
                                        ("mnist_spring_color", 64)],
                ids=["32px", "64px"])
def jax_bf16(request):
    """The JAX bf16 model (ShallowUNet at 32 px, the deep UNet at 64 px):
    its init and outputs on two seeded sequences."""
    task, img = request.param
    model = JaxPhysicsNet(**_kw(task, img))
    inp = np.random.RandomState(1).rand(2, 8, 3, img, img).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), inp)["params"]
    out, aux = jax.jit(model.apply)({"params": params}, inp)
    return dict(task=task, img=img, inp=inp, params=jax.device_get(params),
                out=np.asarray(out), enc_pos=np.asarray(aux["enc_pos"]),
                recons=np.asarray(aux["recons_out"]))


def _port(ref):
    model = PhysicsNet(decoder_backend="xla", **_kw(ref["task"], ref["img"]))
    model.load_state_dict(flax_to_state_dict(ref["params"]), strict=True)
    return model


def test_forward_matches_jax_bf16(jax_bf16):
    """The encoder runs in bf16 (the UNet's output dtype, seen by a forward
    hook), its positions and the reconstructions agree with the JAX bf16
    model's, and what follows the encoder is float32."""
    model = _port(jax_bf16)
    seen = []
    model.encoder.unet.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    with torch.no_grad():
        out, aux = model(torch.from_numpy(jax_bf16["inp"]))
    assert seen == [torch.bfloat16]
    assert out.dtype == aux["enc_pos"].dtype == aux["recons_out"].dtype \
        == torch.float32
    np.testing.assert_allclose(aux["enc_pos"].numpy(), jax_bf16["enc_pos"],
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(aux["recons_out"].numpy(), jax_bf16["recons"],
                               rtol=0, atol=RECONS_ATOL)
    assert np.isfinite(out.numpy()).all()


def test_float32_master_weights_and_state(jax_bf16):
    """Parameters, gradients and the optimizer's state stay float32 after a
    bf16 step, and the state_dict is the float32 model's (a bf16 run's
    checkpoint restores into a float32 model and back)."""
    model = _port(jax_bf16)
    x = torch.from_numpy(jax_bf16["inp"])
    opt = build_optimizer("rmsprop", model.named_parameters(), 6e-4)
    out, aux = model(x)
    compute_losses(model, x, out, aux["recons_out"], aux)[0].backward()
    opt.step()
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(st["nu"].dtype == torch.float32 for st in opt.state.values())
    f32 = PhysicsNet(**dict(_kw(jax_bf16["task"], jax_bf16["img"]),
                            compute_dtype="float32"))
    f32.load_state_dict(model.state_dict(), strict=True)
    assert all(t.dtype == torch.float32
               for t in model.state_dict().values())
