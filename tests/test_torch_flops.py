"""``utils/flops.py``'s count of one train step's matrix-product and
convolution FLOPs against the JAX package's ``matmul_flops`` of the same
step's jaxpr (``jax.value_and_grad`` of the loss through the XLA decode, as
``bench.py`` builds it), for the spring, 3bp, mnist and LSTM configurations
at B=2 and short sequences.

Tolerance: none; the counts are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.models.physics_net import (
    compute_losses as jax_losses,
)
from paig_reproduction_tpu.utils.flops import matmul_flops
from paig_reproduction_tpu_torch.models import PhysicsNet
from paig_reproduction_tpu_torch.utils.flops import step_flops

CONFIGS = {
    "spring": dict(task="spring_color", cell_type="spring_ode_cell",
                   seq_len=12, input_steps=4, pred_steps=6,
                   autoencoder_loss=3.0, input_size=32 * 32),
    "3bp": dict(task="3bp_color", cell_type="gravity_ode_cell", seq_len=20,
                input_steps=4, pred_steps=12, autoencoder_loss=5.0,
                input_size=36 * 36, learn_frame_offset=True,
                init_state_fit=3),
    "mnist": dict(task="mnist_spring_color", cell_type="spring_ode_cell",
                  seq_len=12, input_steps=3, pred_steps=7,
                  autoencoder_loss=3.0, input_size=64 * 64,
                  pos_consistency=1.0, vel_anchor=1.0,
                  learn_frame_offset=True),
    "lstm": dict(task="spring_color", cell_type="lstm", seq_len=12,
                 input_steps=4, pred_steps=6, autoencoder_loss=3.0,
                 input_size=32 * 32),
}


def _jax_flops(kw, batch_size):
    model = JaxPhysicsNet(**kw, color=True, decoder_backend="xla")
    img = int(np.sqrt(kw["input_size"]))
    x = jax.ShapeDtypeStruct((batch_size, kw["seq_len"], 3, img, img),
                             jnp.float32)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]

    def loss_fn(p, batch):
        out, aux = model.apply({"params": p}, batch)
        return jax_losses(model, batch, out, aux["recons_out"],
                          aux.get("center_penalty"),
                          aux.get("vel_anchor_penalty"),
                          aux.get("coarse_pred_loss"),
                          aux.get("pos_consistency_loss"),
                          aux.get("attn_overlap_penalty"))[0]

    return matmul_flops(jax.make_jaxpr(jax.value_and_grad(loss_fn))(params,
                                                                     x))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_flops_equal_jax(name):
    kw = CONFIGS[name]
    ours = step_flops(PhysicsNet(**kw, color=True), 2)
    assert ours == int(_jax_flops(kw, 2))
    assert ours > 0


def test_step_flops_scale_with_the_batch():
    model = PhysicsNet(**CONFIGS["spring"], color=True)
    # Every product is per sequence or per frame but the VariableFromNetwork
    # MLPs', which run once a step.
    one, two, four = (step_flops(model, b) for b in (1, 2, 4))
    assert four - two == 2 * (two - one) > 0
