"""The spring recipe's train step, 10 steps at B=8, against the JAX
package's from the same weights (the CLI's ``--seed=0``: the JAX
package's initial ones; or a JAX checkpoint's) on the same batches: how
far the two trajectories part, beside how far the JAX step parts from
itself when its weights move by one part in 10^7.

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

Ten steps are enough to show it: the comparison holds from step 3 on,
and at step 10 (parameters 5.6e-2 against 1.1e-1 of the largest, losses
2.3e-3 against 4.2e-3) its margins are those of step 50 (9.7e-2 against
2.0e-1, the same losses), where the gaps have stopped growing (CPU).

The same holds from an undiscovered state, the JAX package's
runs/spring_s2_100 (seed 2 after 100 plain epochs, valid recons 11.23) as
the port's kept arms are: parameters 4.2e-2 against 4.4e-2 of the largest,
losses at most 2.1e-2 against 2.6e-2. A fresh RMSprop on trained weights
takes its first steps at about ten times the rate's size, so the losses
there part by more than 1e-2 in JAX from itself, and that case holds the
port only to JAX's own spread.
"""
import jax
import numpy as np
import pytest
import torch

from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from spring_pair import (
    SL12,
    SPRING_S2_100,
    jax_models,
    jax_step_fn,
    load_port,
    nudged,
    port_trainer,
    recipe_args,
    start_params,
)

STEPS, BATCH, POOL = 10, 8, 64
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


@pytest.mark.parametrize("start,loss_cap", [
    ("jax_init", LOSS_RTOL), (SPRING_S2_100, None)],
    ids=["jax_init", "spring_s2_100"])
def test_recipe_steps_part_no_further_than_jax_from_itself(
        tmp_path, one_thread, start, loss_cap):
    # spring_one5's flags as its loop trains them before the trigger: its
    # model, the enhancers kept for the evals, the alignment losses off,
    # its optimizer and schedule. From the JAX init (the arms' start) and
    # from runs/spring_s2_100 (an undiscovered state, as the kept arms).
    args = recipe_args()
    with np.load(SL12) as d:
        path = tmp_path / "spring.npz"
        np.savez(path, train_x=d["train_x"][:POOL], valid_x=d["valid_x"][:8],
                 test_x=d["test_x"][:8])
    trainer = port_trainer(args, path, 25)
    x = trainer.train_iterator.raw_uint8.astype(np.float32) / 255

    jax_model, _ = jax_models(trainer.model)
    params = start_params(start, jax_model, x)
    load_port(trainer, start, params)
    tx, jax_step = jax_step_fn(jax_model, args, 25, params)

    other = nudged(params, PERTURBATION)
    runs = [[params, tx.init(params)], [other, tx.init(other)]]
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
    assert port_loss_gap <= jax_loss_gap
    if loss_cap is not None:
        assert port_loss_gap <= loss_cap
