"""A 3bp_color checkpoint of the JAX package for the tool parity tests:
the JAX model of 3bp_color's chain (``--color --autoencoder_loss=5.0
--learn_frame_offset``) initialized at seed 0 and written with the JAX
package's own ``save_checkpoint``, and the same checkpoint converted to the
port's."""
import os

import jax
import jax.numpy as jnp

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.train.checkpoint import save_checkpoint
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_checkpoint_to_port
from paig_reproduction_tpu_torch.train import checkpoint

ARGV = ["--task=3bp_color", "--color", "--autoencoder_loss=5.0",
        "--learn_frame_offset", "--device=cpu"]


def jax_model(argv=ARGV):
    """The JAX PhysicsNet of the port's CLI flags ``argv``, and the port's
    model of them (the JAX package's initial weights at ``--seed``)."""
    import dataclasses
    fields = {f.name for f in dataclasses.fields(JaxPhysicsNet)}
    args = cli.build_parser().parse_args(argv)
    port = cli.build_model(args, cli.TASK_TABLE[args.task][3])
    return JaxPhysicsNet(**{k: v for k, v in port.config.items()
                            if k in fields}), port


def jax_init_params(model, seed=0):
    """``model.init(PRNGKey(seed), x)["params"]``, jitted, as numpy."""
    x = jnp.zeros((1, model.seq_len, 3 if model.color else 1,
                   int(model.input_size ** 0.5),
                   int(model.input_size ** 0.5)))
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                              x)["params"])


def write(dst):
    """Writes the JAX checkpoint to ``dst/jax`` and its conversion to
    ``dst/port``; returns both directories."""
    import orbax.checkpoint as ocp
    jax_dir, port_dir = os.path.join(dst, "jax"), os.path.join(dst, "port")
    os.makedirs(port_dir)
    model, _ = jax_model()
    save_checkpoint(jax_dir, {"params": jax_init_params(model), "step": 0})
    tree = jax.device_get(ocp.PyTreeCheckpointer().restore(
        os.path.join(jax_dir, "model.ckpt")))
    checkpoint.save_checkpoint(port_dir, flax_checkpoint_to_port(tree))
    return jax_dir, port_dir
