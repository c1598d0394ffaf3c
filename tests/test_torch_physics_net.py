"""Parity of the port's PhysicsNet and compute_losses with the JAX
package's, with the JAX model's initial weights carried across by
convert.py.

Tolerances: losses in f32 at rtol 1e-4, as tests/test_golden.py holds the
JAX model to its stored values. Gradients of train_loss are compared in
float64, per parameter tensor, at max |torch - jax| <= 1e-6 * max |jax|.
In f32 they cannot be compared usefully: at init both object slots encode
near the frame center, and backward through 8 frames of 5 Euler substeps
of the spring cell amplifies rounding so much that the JAX package's own
f32 gradients differ from its float64 gradients by up to half of their
largest entry (measured on these dataset frames; the losses agree to 1e-6).
In float64 the two packages agree to about 1e-8.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.models.physics_net import (
    compute_losses as jax_losses,
)
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.models import (PhysicsNet, compute_losses,
                                                jax_init)
from paig_reproduction_tpu_torch.models.physics_net import EXTENSION_DEFAULTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "spring_color_fwd.npz")
DATASET = os.path.join(REPO, "data", "datasets", "spring_color",
                       "color_spring_vx8_vy8_sl12_r2_k4_e6.npz")
KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
          input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
          input_size=32 * 32)


def _dataset_batch(n, seed):
    with np.load(DATASET) as d:
        idx = np.random.RandomState(seed).choice(d["train_x"].shape[0], n,
                                                 replace=False)
        frames = d["train_x"][np.sort(idx)]
    return np.ascontiguousarray(
        np.transpose(frames, (0, 1, 4, 2, 3))).astype(np.float32) / 255.0


def _port_model(params):
    model = PhysicsNet(**KW)
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                          strict=True)
    return model


def _jax_value_and_grad(model, params, x):
    def loss(p):
        out, aux = model.apply({"params": p}, x)
        return jax_losses(model, x, out, aux["recons_out"])
    return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)


@pytest.fixture(scope="module")
def jax_reference():
    """JAX init (PRNGKey 0) on two dataset sequences: f32 losses and
    float64 grads of train_loss."""
    model = JaxPhysicsNet(**KW)
    inp = _dataset_batch(2, seed=0)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), inp)["params"]
    (train_loss, eval_losses), _ = _jax_value_and_grad(model, params, inp)
    with jax.enable_x64(True):
        params64 = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        _, grads64 = _jax_value_and_grad(
            model, params64, jnp.asarray(inp.astype(np.float64)))
        grads64 = jax.device_get(grads64)
    return dict(inp=inp, params=params, train_loss=float(train_loss),
                eval_losses={k: float(v) for k, v in eval_losses.items()},
                grads64=flax_to_state_dict(grads64))


def test_golden_forward():
    """The JAX golden configuration (PRNGKey 42, RandomState(123) input)
    through the port matches tests/golden/spring_color_fwd.npz at the
    tolerances of tests/test_golden.py."""
    inp = np.random.RandomState(123).rand(2, 12, 3, 32, 32).astype(
        np.float32)
    params = jax.jit(JaxPhysicsNet(**KW).init)(jax.random.PRNGKey(42),
                                               inp)["params"]
    model = _port_model(params)
    x = torch.from_numpy(inp)
    with torch.no_grad():
        out, aux = model(x)
        tl, ev = compute_losses(model, x, out, aux["recons_out"])
    with np.load(GOLDEN) as g:
        np.testing.assert_allclose(float(tl), g["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(float(ev["eval_pred_loss"]),
                                   g["pred_loss"], rtol=1e-4)
        np.testing.assert_allclose(float(ev["eval_extrap_loss"]),
                                   g["extrap_loss"], rtol=1e-4)
        np.testing.assert_allclose(float(ev["eval_recons_loss"]),
                                   g["recons_loss"], rtol=1e-4)
        np.testing.assert_allclose(aux["pos_vel_seq"].numpy(),
                                   g["pos_vel_seq"], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(out[:, :, :, ::8, ::8].numpy(),
                                   g["out_slice"], rtol=1e-3, atol=1e-4)


def test_losses_match_jax(jax_reference):
    model = _port_model(jax_reference["params"])
    x = torch.from_numpy(jax_reference["inp"])
    with torch.no_grad():
        out, aux = model(x)
        train_loss, eval_losses = compute_losses(model, x, out,
                                                 aux["recons_out"])
    np.testing.assert_allclose(float(train_loss),
                               jax_reference["train_loss"], rtol=1e-4)
    for k, v in jax_reference["eval_losses"].items():
        np.testing.assert_allclose(float(eval_losses[k]), v, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("group", ["var_net", "encoder.unet", "encoder.dense",
                                   "velocity_encoder", "log_"])
def test_train_loss_grads_match_jax(jax_reference, group):
    model = _port_model(jax_reference["params"]).double()
    x = torch.from_numpy(jax_reference["inp"]).double()
    out, aux = model(x)
    train_loss, _ = compute_losses(model, x, out, aux["recons_out"])
    train_loss.backward()
    checked = 0
    for name, param in model.named_parameters():
        if not name.startswith(group):
            continue
        ref = jax_reference["grads64"][name].numpy()
        assert ref.dtype == np.float64
        err = np.abs(param.grad.numpy() - ref).max()
        assert err <= 1e-6 * np.abs(ref).max(), (name, err,
                                                  np.abs(ref).max())
        checked += 1
    assert checked > 0


def test_decoder_backends_agree_on_cpu(jax_reference):
    """On CPU tensors "auto"/"pallas" run the kernel wrapper's plain
    version, which is the "xla" path."""
    x = torch.from_numpy(jax_reference["inp"])
    outs = []
    for backend in ("xla", "auto", "pallas"):
        model = jax_init.load_initial_state(
            PhysicsNet(decoder_backend=backend, **KW), jax_init.prng_key(0))
        with torch.no_grad():
            outs.append(model(x)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("field,value", [("compute_dtype", "bfloat16")])
def test_unported_extension_fields_raise(field, value):
    """bf16 is ported now (its parity: tests/test_torch_bf16.py): the value
    builds, and a dtype the JAX model does not accept raises."""
    PhysicsNet(**KW, **{field: EXTENSION_DEFAULTS[field]})
    PhysicsNet(**KW, **{field: value})
    with pytest.raises(ValueError):
        PhysicsNet(**KW, **{field: "float16"})


def test_extension_defaults_match_jax_fields():
    fields = JaxPhysicsNet.__dataclass_fields__
    for name, default in EXTENSION_DEFAULTS.items():
        assert fields[name].default == default, name


@pytest.mark.parametrize("cell", ["lstm"])
def test_unported_cells_raise(cell):
    """The LSTM is ported now (its parity: tests/test_torch_lstm.py): it
    builds, and a cell the JAX package does not have raises."""
    PhysicsNet(**dict(KW, cell_type=cell))
    with pytest.raises(ValueError):
        PhysicsNet(**dict(KW, cell_type=cell + "_ode_cell"))


# The other tasks' models (the JAX CLI's task table), each with the model
# fields of its chip_smoke.py run: (model kwargs, fields, dataset file or
# None for a seeded smooth random input).
TASKS = {
    "bouncing_balls": (
        dict(task="bouncing_balls", cell_type="bouncing_ode_cell",
             seq_len=12, input_steps=4, pred_steps=6, input_size=32 * 32),
        dict(init_state_fit=1, refine_enc_pos=2, learn_frame_offset=True),
        "bouncing/color_bounce_vx8_vy8_sl12_r2.npz"),
    "3bp_color": (
        dict(task="3bp_color", cell_type="gravity_ode_cell", seq_len=20,
             input_steps=4, pred_steps=12, input_size=36 * 36),
        dict(autoencoder_loss=5.0, init_state_fit=3,
             learn_frame_offset=True),
        "3bp_color/color_3bp_vx2_vy2_sl20_r2_g60_m1_dt05.npz"),
    "mnist_spring_color": (
        dict(task="mnist_spring_color", cell_type="spring_ode_cell",
             seq_len=12, input_steps=3, pred_steps=7, input_size=64 * 64),
        dict(), None),
}


def _task_batch(task, n=2):
    kw, _, rel = TASKS[task]
    if rel is None:
        hw = int(np.sqrt(kw["input_size"]))
        rs = np.random.RandomState(3)
        coarse = rs.rand(n, kw["seq_len"], 3, hw // 8, hw // 8)
        return np.repeat(np.repeat(coarse, 8, axis=3), 8, axis=4).astype(
            np.float32)
    with np.load(os.path.join(REPO, "data", "datasets", rel)) as d:
        frames = d["train_x"][:n]
    return np.ascontiguousarray(
        np.transpose(frames, (0, 1, 4, 2, 3))).astype(np.float32) / 255.0


@pytest.fixture(scope="module", params=sorted(TASKS))
def task_reference(request):
    """A task's JAX init (PRNGKey 0) on two sequences: f32 losses of the
    plain model, float64 losses and grads of train_loss with the run's
    fields (autoencoder_loss 3 unless the fields set it)."""
    task = request.param
    kw, fields, _ = TASKS[task]
    kw = dict(kw, color=True, autoencoder_loss=3.0)
    kw.update(fields)
    inp = _task_batch(task)
    plain = JaxPhysicsNet(**{k: v for k, v in kw.items()
                             if k not in ("init_state_fit", "refine_enc_pos")})
    model = JaxPhysicsNet(**kw)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), inp)["params"]
    (_, eval32), _ = _jax_value_and_grad(plain, params, inp)
    with jax.enable_x64(True):
        params64 = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        (train64, eval64), grads64 = _jax_value_and_grad(
            model, params64, jnp.asarray(inp.astype(np.float64)))
        grads64 = jax.device_get(grads64)
    return dict(task=task, kw=kw, inp=inp, params=params,
                eval32={k: float(v) for k, v in eval32.items()},
                train64=float(train64),
                eval64={k: float(v) for k, v in eval64.items()},
                grads64=flax_to_state_dict(grads64))


def test_task_state_dict_is_the_jax_tree(task_reference):
    """Each task's port model has exactly the JAX tree's parameters (the
    cell's own physical parameters, the deep UNet at 64 px), so a
    converted tree loads strictly."""
    model = PhysicsNet(**task_reference["kw"])
    names = set(flax_to_state_dict(jax.device_get(
        task_reference["params"])))
    assert set(model.state_dict()) == names
    model.load_state_dict(flax_to_state_dict(jax.device_get(
        task_reference["params"])), strict=True)


def test_task_losses_match_jax(task_reference):
    """f32 losses of the plain model (rtol 1e-4), float64 losses with the
    run's fields (rtol 1e-9)."""
    ref = task_reference
    state = flax_to_state_dict(jax.device_get(ref["params"]))
    x = torch.from_numpy(ref["inp"])
    plain_kw = {k: v for k, v in ref["kw"].items()
                if k not in ("init_state_fit", "refine_enc_pos")}
    model = PhysicsNet(**plain_kw)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        out, aux = model(x)
        _, ev = compute_losses(model, x, out, aux["recons_out"])
    for k, v in ref["eval32"].items():
        np.testing.assert_allclose(float(ev[k]), v, rtol=1e-4, err_msg=k)
    model = PhysicsNet(**ref["kw"]).double()
    model.load_state_dict(state, strict=True)
    x = x.double()
    with torch.no_grad():
        out, aux = model(x)
        tl, ev = compute_losses(model, x, out, aux["recons_out"], aux)
    np.testing.assert_allclose(float(tl), ref["train64"], rtol=1e-9)
    for k, v in ref["eval64"].items():
        np.testing.assert_allclose(float(ev[k]), v, rtol=1e-9, err_msg=k)


def test_task_train_loss_grads_match_jax(task_reference):
    """float64 gradients of train_loss with the run's fields, per parameter
    tensor, at max |torch - jax| <= 1e-6 * max(max |jax|, 1e-8). The floor
    is for gradients that vanish analytically: bouncing_balls' frame_offset
    (the free-flight rollout away from the walls is translation invariant)
    is 4e-16 in JAX and 9e-16 here."""
    ref = task_reference
    model = PhysicsNet(**ref["kw"]).double()
    model.load_state_dict(flax_to_state_dict(jax.device_get(ref["params"])),
                          strict=True)
    x = torch.from_numpy(ref["inp"]).double()
    out, aux = model(x)
    train_loss, _ = compute_losses(model, x, out, aux["recons_out"], aux)
    train_loss.backward()
    for name, param in model.named_parameters():
        r = ref["grads64"][name].numpy()
        if param.grad is None:
            assert not np.any(r), name
            continue
        err = np.abs(param.grad.numpy() - r).max()
        assert err <= 1e-6 * max(np.abs(r).max(), 1e-8), (name, err)
