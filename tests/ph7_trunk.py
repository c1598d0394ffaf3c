"""The spring trunk of 3bp_color's chain: ``runs/ph7`` (the JAX package's
spring_color checkpoint, an orbax directory) as the port's checkpoint.

The port reads no orbax checkpoint, and ``runs/`` is not committed, so
the chain's warm start reads this converted file:

    python tests/ph7_trunk.py

restores ``runs/ph7/model.ckpt`` with orbax, converts it with
``convert.flax_checkpoint_to_port`` and writes its ``model`` dict and its
``step`` with ``train.checkpoint.save_checkpoint`` to ``TRUNK``: what the
JAX package's restore of ``runs/ph7`` into a 3bp_color run takes (the
parameters whose name and shape fit, and the step, 37500, which sets the
LR schedule's position), and no more: none of its optimizer leaves, whose
paths differ from a 3bp_color run's (its ``log_m`` is frozen, so its
optimizer is a ``multi_transform``). ``tests/test_torch_chain.py`` holds
the committed file to this conversion bit for bit, and both restores to
each other.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PH7 = os.path.join(REPO, "runs", "ph7", "model.ckpt")
TRUNK = os.path.join(REPO, "data", "checkpoints", "ph7_spring")


def converted():
    """runs/ph7's checkpoint tree, converted to the port's (all of it)."""
    import jax
    import orbax.checkpoint as ocp

    from paig_reproduction_tpu_torch.convert import flax_checkpoint_to_port
    return flax_checkpoint_to_port(jax.device_get(
        ocp.PyTreeCheckpointer().restore(PH7)))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from paig_reproduction_tpu_torch.train.checkpoint import save_checkpoint
    os.makedirs(TRUNK, exist_ok=True)
    tree = converted()
    path = save_checkpoint(TRUNK, {"model": tree["model"],
                                   "step": tree["step"]})
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
