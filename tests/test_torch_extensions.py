"""Parity of the port's model extension fields with the JAX package's: each
field of PhysicsNet on its own (one case of a parametrised test), every
penalty it returns and every term of compute_losses, with the JAX model's
initial weights carried across by convert.py; the slot gate and init_bias of
the blocks; and the shared-parameter copy ``--enhancers_eval_only`` trains.

Tolerances: outputs, positions and penalties at rtol 1e-4 / atol 1e-4 (f32,
sums in another order), losses at rtol 1e-4. The JAX losses are taken
eagerly, never from a jitted compute_losses (XLA's CPU backend sums the
three reduced axes with about 4e-4 relative error). The enhancers' cases run
in float64 at rtol 1e-7 / atol 1e-7: at initial weights both slots encode
near the frame centre, where the Gauss-Newton solves are so ill-conditioned
that the JAX package's own f32 result is 1e-2 px from its float64 one (the
two packages agree to 3e-11 in float64). Trained weights are held in f32 by
tests/test_torch_checkpoint.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.models import blocks as jax_blocks
from paig_reproduction_tpu.models.physics_net import (
    compute_losses as jax_losses,
)
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.models import PhysicsNet, blocks
from paig_reproduction_tpu_torch.models.physics_net import (
    ENHANCERS,
    EXTENSION_DEFAULTS,
    PENALTY_WEIGHTS,
    compute_losses,
)

KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
          input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
          input_size=32 * 32)
PENALTIES = tuple(PENALTY_WEIGHTS)

# One case per extension field (the enhancers' own parity tests are
# tests/test_torch_state_fit.py and tests/test_torch_pos_refine.py; here
# they run inside the model).
FIELDS = [
    dict(template_center_loss=0.1),
    dict(coarse_loss=1.0),
    dict(vel_anchor=0.1),
    dict(recons_warmup=True),
    dict(learn_frame_offset=True),
    dict(pos_consistency=0.3),
    dict(attn_overlap_loss=0.2),
    dict(active_slots=1),
    dict(active_slots=1, slot_gate_soft=2.0),
    dict(template_init=3.0),
    dict(init_state_fit=3),
    dict(refine_enc_pos=2),
    dict(refine_recons_pos=2),
    dict(reference_quirks=True),
]


def _input(seed=0, b=2):
    return np.random.RandomState(seed).rand(b, 12, 3, 32, 32).astype(
        np.float32)


def _pair(fields, inp, offset=None):
    """The JAX model, its params (PRNGKey 0) and the port model with the
    same weights. ``offset`` sets a learned frame_offset."""
    j_model = JaxPhysicsNet(**KW, **fields)
    params = jax.device_get(
        jax.jit(j_model.init)(jax.random.PRNGKey(0), inp)["params"])
    if offset is not None:
        params = dict(params, frame_offset=np.asarray(offset, np.float32))
    model = PhysicsNet(**KW, **fields)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return j_model, params, model


def test_every_field_is_ported():
    """Every extension field builds at a value other than its default,
    bf16 included (its parity: tests/test_torch_bf16.py)."""
    for name, default in EXTENSION_DEFAULTS.items():
        value = {bool: True, float: 0.5, int: 1, str: "bfloat16"}[
            type(default)]
        PhysicsNet(**KW, **{name: value})


@pytest.mark.parametrize("fields", FIELDS, ids=lambda f: ",".join(f))
def test_field_matches_jax(fields):
    """Outputs, positions, the rollout state, every penalty and the train
    loss at aux_scale 1 and 0.5 (the warm-up gate)."""
    wide = bool(set(fields) & set(ENHANCERS))
    dtype = np.float64 if wide else np.float32
    tol = dict(rtol=1e-7, atol=1e-7) if wide else dict(rtol=1e-4, atol=1e-4)
    inp = _input()
    offset = ([0.5, -0.25, -0.75, 1.0] if fields.get("learn_frame_offset")
              else None)
    j_model, params, model = _pair(fields, inp, offset)
    with jax.enable_x64(wide):
        params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)),
                              params)
        j_out, j_aux = jax.jit(j_model.apply)({"params": params},
                                              jnp.asarray(inp, dtype))
        j_out = np.asarray(j_out)
        j_aux = jax.device_get(j_aux)
        x = torch.from_numpy(inp.astype(dtype))
        model = model.to(torch.float64 if wide else torch.float32)
        with torch.no_grad():
            out, aux = model(x)
        for name, ref in (("output", j_out),
                          ("recons_out", j_aux["recons_out"]),
                          ("enc_pos", j_aux["enc_pos"]),
                          ("pos_vel_seq", j_aux["pos_vel_seq"])):
            got = out if name == "output" else aux[name]
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       err_msg=name, **tol)
        for key in PENALTIES:
            np.testing.assert_allclose(float(aux[key]), float(j_aux[key]),
                                       rtol=tol["rtol"], atol=1e-5,
                                       err_msg=key)
        j_args = [jnp.asarray(aux["recons_out"].numpy())] + [
            jnp.asarray(j_aux[k]) for k in PENALTIES]
        for scale in (1.0, 0.5):
            j_train, j_eval = jax_losses(j_model, jnp.asarray(inp, dtype),
                                         jnp.asarray(j_out), *j_args,
                                         aux_scale=scale)
            train, evals = compute_losses(model, x, out, aux["recons_out"],
                                          aux, aux_scale=scale)
            np.testing.assert_allclose(float(train), float(j_train),
                                       rtol=tol["rtol"])
            for k, v in j_eval.items():
                np.testing.assert_allclose(float(evals[k]), float(v),
                                           rtol=tol["rtol"], err_msg=k)


@pytest.mark.parametrize("key", PENALTIES)
def test_each_loss_term_is_weighted_as_jax(key):
    """compute_losses adds one penalty with its weight (scaled by aux_scale,
    except the slot overlap) exactly as the JAX function does, given the
    same penalty values."""
    field = PENALTY_WEIGHTS[key]
    model = PhysicsNet(**KW, **{field: 0.7})
    j_model = JaxPhysicsNet(**KW, **{field: 0.7})
    rs = np.random.RandomState(1)
    inp = rs.rand(2, 12, 3, 32, 32).astype(np.float32)
    out = rs.rand(2, 8, 3, 32, 32).astype(np.float32)
    recons = rs.rand(2, 10, 3, 32, 32).astype(np.float32)
    pens = {k: np.float32(rs.rand() * 10) for k in PENALTIES}
    base, _ = jax_losses(j_model, inp, out, recons, aux_scale=0.25)
    j_train, _ = jax_losses(j_model, inp, out, recons,
                            *[pens[k] for k in PENALTIES], aux_scale=0.25)
    train, _ = compute_losses(
        model, torch.from_numpy(inp), torch.from_numpy(out),
        torch.from_numpy(recons),
        {k: torch.tensor(v) for k, v in pens.items()}, aux_scale=0.25)
    np.testing.assert_allclose(float(train), float(j_train), rtol=1e-6)
    assert float(j_train) != pytest.approx(float(base))


def test_penalty_gradients_match_jax():
    """Gradients of the full extension loss (every penalty on, frame offset
    learned) in float64: max |torch - jax| <= 1e-6 * max |jax| per tensor.
    (In f32 the rollout's backward amplifies rounding; see
    tests/test_torch_physics_net.py.)"""
    fields = dict(template_center_loss=0.1, coarse_loss=1.0, vel_anchor=0.1,
                  pos_consistency=0.3, attn_overlap_loss=0.2,
                  learn_frame_offset=True)
    inp = _input(2)
    j_model, params, model = _pair(fields, inp, [0.5, -0.25, -0.75, 1.0])

    def loss(p, x):
        out, aux = j_model.apply({"params": p}, x)
        return jax_losses(j_model, x, out, aux["recons_out"],
                          *[aux[k] for k in PENALTIES], aux_scale=0.5)[0]

    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           params)
        j_grads = flax_to_state_dict(jax.device_get(
            jax.grad(loss)(p64, jnp.asarray(inp, jnp.float64))))
    model = model.double()
    x = torch.from_numpy(inp.astype(np.float64))
    out, aux = model(x)
    train, _ = compute_losses(model, x, out, aux["recons_out"], aux,
                              aux_scale=0.5)
    train.backward()
    for name, p in model.named_parameters():
        ref = j_grads[name].numpy()
        assert np.abs(p.grad.numpy() - ref).max() <= 1e-6 * max(
            np.abs(ref).max(), 1e-12), name


@pytest.mark.parametrize("active,soft", [(1, 0.0), (1, 2.5), (2, 0.0)])
def test_encoder_slot_gate_matches_jax(active, soft):
    """ConvolutionalEncoder's active_slots / slot_gate_soft gate."""
    rs = np.random.RandomState(3)
    x = rs.rand(3, 32, 32, 3).astype(np.float32)
    enc = jax_blocks.ConvolutionalEncoder(
        input_hw=(32, 32), n_objs=2, active_slots=active,
        slot_gate_soft=soft)
    params = jax.device_get(enc.init(jax.random.PRNGKey(1), x)["params"])
    j_pos, j_masks, _ = enc.apply({"params": params}, x)
    port = blocks.ConvolutionalEncoder((32, 32), 3, n_objs=2,
                                       active_slots=active,
                                       slot_gate_soft=soft)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        pos, masks, _ = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(masks.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_masks), rtol=1e-5, atol=1e-6)


def test_variable_init_bias_matches_jax():
    bias = np.random.RandomState(4).randn(2, 4, 4).astype(np.float32)
    var = jax_blocks.VariableFromNetwork((2, 4, 4), init_bias=bias)
    params = jax.device_get(var.init(jax.random.PRNGKey(2))["params"])
    port = blocks.VariableFromNetwork((2, 4, 4), init_bias=bias)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    assert "init_bias" not in port.state_dict()
    with torch.no_grad():
        np.testing.assert_allclose(port().numpy(),
                                   np.asarray(var.apply({"params": params})),
                                   rtol=1e-6, atol=1e-6)


def test_without_enhancers_shares_parameters():
    model = PhysicsNet(**KW, init_state_fit=3, refine_enc_pos=2,
                       refine_recons_pos=4, pos_consistency=1.0)
    clone = model.without_enhancers()
    assert (clone.init_state_fit, clone.refine_enc_pos,
            clone.refine_recons_pos) == (0, 0, 0)
    assert (model.init_state_fit, model.refine_enc_pos,
            model.refine_recons_pos) == (3, 2, 4)
    assert clone.pos_consistency == 1.0
    for (n, p), (n2, p2) in zip(model.named_parameters(),
                                clone.named_parameters()):
        assert n == n2 and p is p2
