"""The port's initial weights (``paig_reproduction_tpu_torch/models/jax_init.py``)
against the JAX package's ``model.init(PRNGKey(seed), x)``: the uniform
draws of every conv and dense layer bit for bit, the LSTM cell's
truncated-normal and orthogonal kernels within 3e-6 (numpy's erf_inv and
QR round otherwise than XLA's), for the main path's model, the LSTM
baseline's and the 64-px mnist model's; and the CLI's model and a discovery
arm start from them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.models import jax_init

LSTM_ATOL = 3e-6
FIELDS = {f.name for f in dataclasses.fields(JaxPhysicsNet)}


def _both(argv, key, jax_key):
    args = cli.build_parser().parse_args(argv + ["--device=cpu"])
    seq = cli.TASK_TABLE[args.task][3]
    port = cli.build_model(args, seq)
    jax_model = JaxPhysicsNet(**{k: v for k, v in port.config.items()
                                 if k in FIELDS})
    x = jnp.zeros((1, seq, port.conv_ch, port.img_size, port.img_size))
    want = flax_to_state_dict(jax.device_get(
        jax.jit(jax_model.init)(jax_key, x)["params"]))
    return port, jax_init.initial_state(port, key), want


@pytest.mark.parametrize("argv,seed,arm", [
    (["--task=spring_color", "--color"], 0, 0),
    (["--task=spring_color", "--color"], 0, 6),
    (["--task=spring_color", "--color", "--cell_type=lstm"], 0, 0),
    (["--task=mnist_spring_color", "--color", "--learn_frame_offset"], 1, 0)],
    ids=["spring", "spring_arm6", "lstm", "mnist"])
def test_initial_weights_are_the_jax_packages(argv, seed, arm):
    jax_key = jax.random.PRNGKey(seed)
    if arm:
        jax_key = jax.random.fold_in(jax_key, arm)
    port, got, want = _both(argv + [f"--seed={seed}"],
                            jax_init.arm_key(seed, arm), jax_key)
    assert set(got) == set(want) == set(dict(port.named_parameters()))
    for name, value in want.items():
        value = value.reshape(got[name].shape)
        if name.split(".")[-1] in ("weight_ih", "weight_hh"):
            torch.testing.assert_close(got[name], value, rtol=0,
                                       atol=LSTM_ATOL)
        else:
            assert torch.equal(got[name], value), name
    if arm == 0:
        for name, param in port.named_parameters():
            assert torch.equal(param.detach(), got[name]), name


def test_threefry_matches_jax():
    """The generator's pieces: PRNGKey, fold_in, the partitionable bits."""
    key = jax.random.PRNGKey(2 ** 31 + 7)
    assert np.array_equal(jax_init.prng_key(2 ** 31 + 7),
                          np.asarray(jax.random.key_data(key)))
    folded = jax.random.fold_in(key, 123456789)
    assert np.array_equal(jax_init.fold_in(jax_init.prng_key(2 ** 31 + 7),
                                           123456789),
                          np.asarray(jax.random.key_data(folded)))
    assert np.array_equal(
        jax_init.random_bits(jax_init.prng_key(5), (3, 5, 7)),
        np.asarray(jax.random.bits(jax.random.PRNGKey(5), (3, 5, 7))))
