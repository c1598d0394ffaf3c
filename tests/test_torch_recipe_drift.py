"""The spring recipe's train step, 50 steps at B=8, against the JAX
package's from the same initial weights (the CLI's ``--seed=0``: the JAX
package's) on the same batches: how far the two trajectories part, beside
how far the JAX step parts from itself when its initial weights move by one
part in 10^7.

This is the mechanism behind a full-length run that does not repeat its
log (PERF.md, "Task quality on the card"): RMSprop's first updates are
about ``lr / sqrt(1 - decay)`` in the direction of each gradient's sign, so
a parameter whose gradient is at rounding level takes a full step in a
direction set by rounding. The port's float32 sums run in another order
than XLA's; from step 1 its parameters differ from JAX's by about 1e-4 of
the largest, and JAX's own differ from a 1e-7 perturbation of themselves
by more. The two trajectories stay as close as the JAX step stays to
itself, and the losses part no further than the JAX step's from itself
(and under 1e-2): no fault of the port, and no way for a port to repeat
the log's arms epoch by epoch.
"""
import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.models.physics_net import (
    compute_losses as jax_losses,
)
from paig_reproduction_tpu.train import optimizers as jax_opt
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.tools.reference_runs import RUNS
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SL12 = os.path.join(REPO, "data", "datasets", "spring_color",
                    "color_spring_vx8_vy8_sl12_r2_k4_e6.npz")
STEPS, BATCH, POOL = 50, 8, 64
LOSS_RTOL = 1e-2
PERTURBATION = 1e-7


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _largest_gap(a, b):
    return max(float(np.abs(np.asarray(a[k]).reshape(-1)
                            - np.asarray(b[k]).reshape(-1)).max())
               for k in a)


def test_recipe_steps_part_no_further_than_jax_from_itself(tmp_path,
                                                           one_thread):
    # spring_one5's flags as the arms train them: its model, the
    # enhancers kept for the evals, the alignment losses off (before the
    # --aux_on_recons trigger), its optimizer and schedule.
    argv = [a for a in RUNS["spring_one5"]["argv"]
            if a.split("=")[0] in ("--task", "--base_lr",
                                   "--autoencoder_loss", "--color", "--seed",
                                   "--epochs", "--pos_consistency",
                                   "--vel_anchor", "--learn_frame_offset",
                                   "--init_state_fit", "--refine_recons_pos",
                                   "--enhancers_eval_only")]
    args = cli.build_parser().parse_args(argv + ["--device=cpu"])
    model = cli.build_model(args, 12)
    with np.load(SL12) as d:
        path = tmp_path / "spring.npz"
        np.savez(path, train_x=d["train_x"][:POOL], valid_x=d["valid_x"][:8],
                 test_x=d["test_x"][:8])
    trainer = Trainer(model, device="cpu", enhancers_eval_only=True)
    trainer.get_data(iterators.get_iterators(str(path), conv=True))
    trainer.build_optimizer(args.base_lr, "rmsprop", True,
                            epochs=args.epochs, steps_per_epoch=25)
    trainer.aux_warmup_steps = 1 << 30
    x = trainer.train_iterator.raw_uint8.astype(np.float32) / 255

    fields = {f.name for f in dataclasses.fields(JaxPhysicsNet)}
    jax_model = JaxPhysicsNet(**{
        k: v for k, v in model.config.items() if k in fields
        and k not in ("init_state_fit", "refine_recons_pos")})
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), x[:1])["params"]
    start = flax_to_state_dict(jax.device_get(params))
    assert all(torch.equal(v.reshape(-1), start[k].reshape(-1))
               for k, v in model.state_dict().items() if k in start)
    tx = jax_opt.build_optimizer(
        "rmsprop", jax_opt.lr_schedule(args.base_lr, args.epochs, 25, True),
        params)

    @jax.jit
    def jax_step(params, opt_state, batch):
        def loss_fn(p):
            out, aux = jax_model.apply({"params": p}, batch)
            return jax_losses(jax_model, batch, out, aux["recons_out"],
                              aux_scale=0.0)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    nudged = jax.tree.map(lambda v: v * (1 + PERTURBATION), params)
    runs = [[params, tx.init(params)], [nudged, tx.init(nudged)]]
    rs = np.random.RandomState(0)
    loss_gaps = []                      # (port's, the nudged JAX run's)
    for _ in range(STEPS):
        idx = rs.choice(POOL, BATCH, replace=False)
        losses = []
        for run in runs:
            run[0], run[1], loss = jax_step(run[0], run[1], x[idx])
            losses.append(float(loss))
        port_loss = float(trainer.train_step(idx)["train_loss"])
        loss_gaps.append((abs(port_loss - losses[0]) / abs(losses[0]),
                          abs(losses[1] - losses[0]) / abs(losses[0])))
    ref, other = (flax_to_state_dict(jax.device_get(r[0])) for r in runs)
    port = {k: v.detach() for k, v in trainer.model.state_dict().items()
            if k in ref}
    largest = max(float(v.abs().max()) for v in ref.values())
    port_gap = _largest_gap({k: v.numpy() for k, v in port.items()},
                            {k: v.numpy() for k, v in ref.items()})
    jax_gap = _largest_gap({k: v.numpy() for k, v in other.items()},
                           {k: v.numpy() for k, v in ref.items()})
    port_loss_gap, jax_loss_gap = np.max(loss_gaps, axis=0)
    print(f"after {STEPS} steps: parameters, port against JAX "
          f"{port_gap / largest:.3e}, JAX against JAX from weights moved by "
          f"{PERTURBATION:g} {jax_gap / largest:.3e} of the largest; losses "
          f"at most {port_loss_gap:.3e} and {jax_loss_gap:.3e} relative")
    assert 0 < port_gap <= jax_gap
    assert port_loss_gap <= min(jax_loss_gap, LOSS_RTOL)
