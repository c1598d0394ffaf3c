"""The port's LSTM baseline (``PhysicsNet(cell_type="lstm")``) against the
JAX model's, with the JAX model's initial weights carried across by
convert.py, at one and two layers of 16 units on 16x16 frames.

Tolerances: outputs (frames, reconstructions, positions, the rollout state)
within 1e-5 abs; the losses, each package's outputs reduced in float64,
within 1e-5 relative (a jitted JAX ``compute_losses`` is not the reference:
XLA's CPU backend sums the three reduced axes with about 4e-4 relative
error); gradients of the train loss (f32 in both packages) within 1e-4 of
their tensor's largest magnitude, every gate of every LSTM kernel on its
own, so that a swapped gate names itself.
"""
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
from paig_reproduction_tpu_torch.models import PhysicsNet, compute_losses
from paig_reproduction_tpu_torch.models.physics_net import CELL_PARAMS

UNITS = 16
KW = dict(task="spring_color", cell_type="lstm", recurrent_units=UNITS,
          seq_len=8, input_steps=3, pred_steps=4, autoencoder_loss=3.0,
          color=True, input_size=16 * 16)
GATES = ("i", "f", "g", "o")


def _input(seed=0):
    return np.random.RandomState(seed).rand(3, 8, 3, 16, 16).astype(
        np.float32)


def _float64_losses(model, inp, out, recons):
    """compute_losses' three eval losses in float64 from one package's
    outputs."""
    inp = inp.astype(np.float64)
    t_in = model.input_steps + model.pred_steps
    recons = np.mean(np.sum((inp[:, :t_in] - recons) ** 2, axis=(2, 3, 4)))
    err = np.sum((inp[:, model.input_steps:] - out) ** 2, axis=(2, 3, 4))
    return np.array([np.mean(err[:, :model.pred_steps]),
                     np.mean(err[:, model.pred_steps:]), recons])


@pytest.fixture(scope="module", params=[1, 2], ids=["1layer", "2layers"])
def jax_lstm(request):
    """The JAX model at ``lstm_layers`` = 1 or 2: its init, outputs and the
    f32 gradients of its train loss on one seeded input."""
    model = JaxPhysicsNet(lstm_layers=request.param, **KW)
    inp = _input()
    params = jax.jit(model.init)(jax.random.PRNGKey(0), inp)["params"]

    def loss(p):
        out, aux = model.apply({"params": p}, inp)
        return jax_losses(model, jnp.asarray(inp), out, aux["recons_out"])[0]

    out, aux = jax.jit(model.apply)({"params": params}, inp)
    grads = jax.jit(jax.grad(loss))(params)
    return dict(layers=request.param, model=model, inp=inp,
                params=jax.device_get(params), out=np.asarray(out),
                aux={k: np.asarray(aux[k]) for k in
                     ("recons_out", "enc_pos", "pos_vel_seq")},
                grads=jax.device_get(grads))


def _port(ref):
    model = PhysicsNet(lstm_layers=ref["layers"], decoder_backend="xla", **KW)
    model.load_state_dict(flax_to_state_dict(ref["params"]), strict=True)
    return model


def test_parameters_are_the_jax_models(jax_lstm):
    """The converted tree loads strictly: the same cells, projection and
    encoder, no physical parameter and no frame offset."""
    model = _port(jax_lstm)
    names = {n for n, _ in model.named_parameters()}
    assert not names & {"log_k", "log_equil", "log_g", "log_m",
                        "frame_offset"}
    assert CELL_PARAMS["lstm"] == ()
    lstm = sorted(n for n in names if n.startswith("lstm"))
    want = [f"lstm_{i}.{w}" for i in range(jax_lstm["layers"])
            for w in ("bias_hh", "weight_hh", "weight_ih")]
    assert lstm == sorted(want + ["lstm_proj.bias", "lstm_proj.weight"])
    for i in range(jax_lstm["layers"]):
        assert not model.get_buffer(f"lstm_{i}.bias_ih").any()


def test_outputs_and_losses_match_jax(jax_lstm):
    model = _port(jax_lstm)
    x = torch.from_numpy(jax_lstm["inp"])
    with torch.no_grad():
        out, aux = model(x)
        _, port_losses = compute_losses(model, x, out, aux["recons_out"])
    np.testing.assert_allclose(out.numpy(), jax_lstm["out"], rtol=0,
                               atol=1e-5)
    for k, v in jax_lstm["aux"].items():
        np.testing.assert_allclose(aux[k].numpy(), v, rtol=0, atol=1e-5,
                                   err_msg=k)
    ref = _float64_losses(jax_lstm["model"], jax_lstm["inp"],
                          jax_lstm["out"], jax_lstm["aux"]["recons_out"])
    ours = _float64_losses(model, jax_lstm["inp"], out.numpy(),
                           aux["recons_out"].numpy())
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    np.testing.assert_allclose(
        [float(port_losses[k]) for k in ("eval_pred_loss", "eval_extrap_loss",
                                         "eval_recons_loss")], ref, rtol=1e-5)
    # The rollout starts at the encoder's last window position.
    np.testing.assert_array_equal(aux["pos_vel_seq"][:, 0, :4].numpy(),
                                  aux["enc_pos"][:, 2].numpy())


def _close(ours, ref, name):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    err = np.abs(ours - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_gradients_match_jax_gate_by_gate(jax_lstm):
    model = _port(jax_lstm)
    x = torch.from_numpy(jax_lstm["inp"])
    out, aux = model(x)
    compute_losses(model, x, out, aux["recons_out"])[0].backward()
    for i in range(jax_lstm["layers"]):
        ref = jax_lstm["grads"][f"lstm_{i}"]
        cell = model.get_submodule(f"lstm_{i}")
        for j, gate in enumerate(GATES):
            rows = slice(j * UNITS, (j + 1) * UNITS)
            _close(cell.weight_ih.grad[rows].T, ref["i" + gate]["kernel"],
                   f"lstm_{i} input kernel of gate {gate}")
            _close(cell.weight_hh.grad[rows].T, ref["h" + gate]["kernel"],
                   f"lstm_{i} hidden kernel of gate {gate}")
            _close(cell.bias_hh.grad[rows], ref["h" + gate]["bias"],
                   f"lstm_{i} bias of gate {gate}")
    proj = jax_lstm["grads"]["lstm_proj"]
    _close(model.lstm_proj.weight.grad.T, proj["kernel"], "lstm_proj kernel")
    _close(model.lstm_proj.bias.grad, proj["bias"], "lstm_proj bias")


def test_init_follows_flax(jax_lstm):
    """The port's own initialisation has flax's distributions: input
    kernels LeCun-normal (a normal truncated at two deviations, variance
    1/fan_in), recurrent kernels orthogonal per gate, biases zero."""
    model = PhysicsNet(lstm_layers=jax_lstm["layers"],
                       generator=torch.Generator().manual_seed(0), **KW)
    for i in range(jax_lstm["layers"]):
        cell = model.get_submodule(f"lstm_{i}")
        fan_in = cell.input_size
        w = cell.weight_ih.detach().numpy()
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= 2 * std
        assert abs(w.var() * fan_in - 1.0) < 0.25
        for block in cell.weight_hh.detach().view(4, UNITS, UNITS):
            np.testing.assert_allclose(block @ block.T, np.eye(UNITS),
                                       atol=1e-5)
        assert not cell.bias_hh.any()
        ref = jax_lstm["params"][f"lstm_{i}"]
        assert not any(np.asarray(ref["h" + g]["bias"]).any() for g in GATES)


def test_no_physics_penalty_or_fit(jax_lstm):
    """The LSTM branch has no cell dt, so the velocity anchor is zero (the
    JAX model computes it only for the cells of ``cells.CELLS``), and the
    state fit and frame offset fields are inert: the rollout equals the
    JAX model's without them."""
    kw = dict(KW, vel_anchor=1.0, learn_frame_offset=True, init_state_fit=2)
    model = PhysicsNet(lstm_layers=jax_lstm["layers"], decoder_backend="xla",
                       **kw)
    model.load_state_dict(flax_to_state_dict(jax_lstm["params"]), strict=True)
    with torch.no_grad():
        _, aux = model(torch.from_numpy(jax_lstm["inp"]))
    assert float(aux["vel_anchor_penalty"]) == 0.0
    np.testing.assert_allclose(aux["pos_vel_seq"].numpy(),
                               jax_lstm["aux"]["pos_vel_seq"], atol=1e-5)
