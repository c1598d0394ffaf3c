"""3bp_color's chain with the prediction off through its curriculum
(``reference_runs``' ``3bp_chain_recons_warmup``) and the reading of the
velocity head, held to the JAX package on the CPU:

* ``velocity_state`` on the JAX package's 3bp_color checkpoint at seed 0
  (``tests/jax_3bp.py``), under that chain's first stage's flags, against
  the same quantities through the JAX package's ``apply`` (its velocity
  head's hidden layers captured as intermediates) and its gradient, taken
  in float64: the port's float32 start velocities, their spread and speeds
  within ``VEL_ATOL`` px a time unit, the saturated shares equal, the
  losses and gradient norms within ``LOSS_RTOL`` (the positions of
  ``test_torch_chain.py`` hold to 1e-5 px);
* three train steps of that chain's ``curriculum_1`` from the spring trunk
  (20 steps an epoch, as on the tracked file, so ``--aux_warmup_epochs``
  holds the prediction off), in float64 in both packages from the same
  restored state (the port's Trainer restoring the trunk, the JAX
  package's restore of ``runs/ph7`` into its 3bp_color train state): the
  losses at each step within ``STEP_LOSS_RTOL``, the velocity head's
  gradient at each step zero in both, and every parameter after within
  ``STEP_RTOL`` of the largest, the head's unmoved (the chain's float32
  parity tests hold positions to 1e-5 px and fits to 1e-3). The JAX
  package's optimizer (its RMSprop, ``log_m`` frozen) takes the learning
  rate the port's step applies: 2e-4 as the port's float32 device scalar
  holds it, 2e-4 * (1 - 2.5e-8). At the JAX schedule's own float64 2e-4
  the parameters part by 6e-5 of a tensor's largest after two steps,
  RMSprop's first steps amplifying the rounding as
  ``test_torch_recipe_drift.py`` shows; at the same rate they agree to
  6e-9. Where the two packages' schedules part after this restore
  (ROADMAP Queue 3) is ``test_trunk_restore_learning_rates``;
* the probes' flags and their test of a live head
  (``tools/curriculum_probes.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jax_3bp
from paig_reproduction_tpu.train import optimizers as jax_opt
from paig_reproduction_tpu.train.checkpoint import (
    restore_checkpoint as jax_restore,
)
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.tools import curriculum_probes as cp
from paig_reproduction_tpu_torch.tools import reference_runs as rr
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "datasets")
VEL_ATOL = 1e-4
LOSS_RTOL = 1e-5
STEP_RTOL = 1e-8
STEP_LOSS_RTOL = 1e-12
STEPS, BATCH = 3, 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHAIN = "3bp_chain_recons_warmup"
# The tracked train file's steps an epoch (2000 sequences at B=100).
STEPS_PER_EPOCH = 20


def _stage_argv(batch_size=8):
    """The chain's curriculum_1 flags (B=8 for the tiny split)."""
    return rr.CHAINS[CHAIN]["stages"](batch_size=batch_size)[0]["argv"]


def _jax_losses(model, x, out, aux, aux_scale=1.0):
    """The JAX trainer's train loss (``train/trainer.py``'s
    ``make_loss_fn``)."""
    from paig_reproduction_tpu.models.physics_net import compute_losses
    return compute_losses(
        model, x, out, aux["recons_out"], aux.get("center_penalty"),
        aux.get("vel_anchor_penalty"), aux.get("coarse_pred_loss"),
        aux.get("pos_consistency_loss"), aux.get("attn_overlap_penalty"),
        aux_scale=aux_scale)


def _norm(tree):
    return float(np.sqrt(sum(np.sum(np.asarray(v, np.float64) ** 2)
                             for v in jax.tree_util.tree_leaves(tree))))


def test_velocity_state_matches_jax(tmp_path):
    import orbax.checkpoint as ocp

    jax_dir, port_dir = jax_3bp.write(str(tmp_path))
    x = rr.valid_batch(DATA, 8)
    assert x.shape == (8, 20, 3, 36, 36) and x.dtype == np.float32
    argv = _stage_argv()
    rng = torch.get_rng_state()
    port = rr.velocity_state(port_dir, x, "cpu", argv)
    assert torch.equal(torch.get_rng_state(), rng)

    model, _ = jax_3bp.jax_model(argv + ["--device=cpu"])
    assert (model.recons_warmup, model.active_slots) == (True, 1)
    params = jax.device_get(ocp.PyTreeCheckpointer().restore(
        os.path.join(jax_dir, "model.ckpt")))["params"]

    def loss(p):
        xj = jnp.asarray(x, jnp.float64)
        (out, aux), state = model.apply(
            {"params": p}, xj, capture_intermediates=True,
            mutable=["intermediates"])
        total, ev = _jax_losses(model, xj, out, aux)
        head = state["intermediates"]["velocity_encoder"]
        hidden = [jnp.tanh(head[f"TorchDense_{i}"]["__call__"][0])
                  for i in (0, 1)]
        return total, (ev, aux["pos_vel_seq"][:, 0, 6:], hidden)

    # The JAX side in float64: XLA's float32 sums over a frame's pixels
    # carry about 1e-5 of relative error (ROADMAP Queue 3), the reference
    # must not.
    with jax.enable_x64(True):
        (_, (ev, vel, hidden)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), params))
    vel = np.asarray(vel, np.float64).reshape(8, 3, 2)
    gaps = np.linalg.norm(vel[:, :, None] - vel[:, None], axis=-1)
    speeds = np.linalg.norm(vel, axis=-1)
    np.testing.assert_allclose(port["velocities"], vel[0], rtol=0,
                               atol=VEL_ATOL)
    np.testing.assert_allclose(
        [port["spread"], port["speed"], port["speed_p95"]],
        [np.median(gaps.max(axis=(1, 2))), np.median(speeds),
         np.percentile(speeds, 95)], rtol=0, atol=VEL_ATOL)
    assert port["saturated"] == [
        float(np.mean(np.abs(np.asarray(h)) > rr.SATURATED))
        for h in hidden]
    assert 0 < port["saturated"][0] < 1
    np.testing.assert_allclose(
        [port["pred"], port["recons"], port["grad_norm"],
         port["vel_grad_norm"]],
        [float(ev["eval_pred_loss"]), float(ev["eval_recons_loss"]),
         _norm(grads), _norm(grads["velocity_encoder"])], rtol=LOSS_RTOL)


def _tiny_train(path):
    with np.load(os.path.join(DATA, cli.TASK_TABLE["3bp_color"][0])) as d:
        np.savez(path, train_x=d["train_x"][:8], valid_x=d["valid_x"][:4],
                 test_x=d["test_x"][:4])


def _port_trainer(args, path, run_dir):
    """The port's trainer of the stage's flags, as cli.main builds it on
    the tracked file (STEPS_PER_EPOCH), on the split at ``path``, restored
    from the trunk."""
    trainer = Trainer(cli.build_model(args, 20), device="cpu", seed=0)
    trainer.get_data(iterators.get_iterators(str(path), conv=True))
    trainer.build_optimizer(args.base_lr, args.optimizer, args.anneal_lr,
                            epochs=args.epochs,
                            steps_per_epoch=STEPS_PER_EPOCH,
                            aux_warmup_epochs=args.aux_warmup_epochs)
    trainer.initialize_graph(str(run_dir), use_ckpt=True,
                             ckpt_dir=rr.TRUNK)
    return trainer


def _jax_start(args):
    """The JAX package's 3bp_color model of the stage's flags, its LR
    schedule and its train state with runs/ph7 restored into it."""
    model, _ = jax_3bp.jax_model(_stage_argv() + ["--device=cpu"])
    init = jax_3bp.jax_init_params(model)
    schedule = jax_opt.lr_schedule(args.base_lr, args.epochs,
                                   STEPS_PER_EPOCH, True)
    tx = jax_opt.build_optimizer(args.optimizer, schedule, init)
    zero = np.asarray(0, np.int32)
    restored = jax.device_get(jax_restore(
        os.path.join(REPO, "runs", "ph7"),
        {"params": init, "opt_state": jax.device_get(tx.init(init)),
         "step": zero, "epoch": zero, "total_epochs_done": zero}))
    return model, schedule, restored


def test_curriculum_steps_match_jax(tmp_path):
    path = tmp_path / "3bp.npz"
    _tiny_train(path)
    args = cli.build_parser().parse_args(_stage_argv() + ["--device=cpu"])
    trainer = _port_trainer(args, path, tmp_path / "run")
    model, _, restored = _jax_start(args)
    assert trainer.step == int(restored["step"]) == 37500
    lr = float(np.float32(trainer._lr_at(trainer.step
                                         - trainer._opt_step0)))
    assert lr == pytest.approx(args.base_lr / 5, rel=1e-7)
    # The JAX trainer's aux scale: 0 before --aux_warmup_epochs' steps.
    warmup = args.aux_warmup_epochs * STEPS_PER_EPOCH
    assert warmup == trainer.aux_warmup_steps == 37500 + 300 * 3 * 20
    trainer.model.double()
    x = trainer.train_iterator.X.astype(np.float64)

    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              restored["params"])
        port_start = {k: v.clone() for k, v in
                      trainer.model.state_dict().items()}
        for name, t in flax_to_state_dict(jax.device_get(params)).items():
            assert torch.equal(port_start[name].reshape(-1),
                               t.reshape(-1).double()), name
        tx = jax_opt.build_optimizer(args.optimizer,
                                     optax.constant_schedule(lr), params)
        opt_state = tx.init(params)

        @jax.jit
        def step(p, o, batch, scale):
            def loss(q):
                out, aux = model.apply({"params": q}, batch)
                return _jax_losses(model, batch, out, aux, scale)
            (total, ev), g = jax.value_and_grad(loss, has_aux=True)(p)
            updates, o = tx.update(g, o, p)
            return optax.apply_updates(p, updates), o, total, ev, g

        rs = np.random.RandomState(0)
        for _ in range(STEPS):
            idx = rs.choice(8, BATCH, replace=False)
            params, opt_state, total, ev, g = step(
                params, opt_state, jnp.asarray(x[idx]),
                float(trainer.step >= warmup))
            trainer._fill_scalars(trainer.step)
            losses = trainer._step(torch.from_numpy(x[idx]))
            trainer.step += 1
            ours = dict(zip(("eval_pred_loss", "eval_extrap_loss",
                             "eval_recons_loss", "train_loss"),
                            losses.tolist()))
            np.testing.assert_allclose(
                [ours[k] for k in ("train_loss", "eval_pred_loss",
                                   "eval_recons_loss")],
                [float(total), float(ev["eval_pred_loss"]),
                 float(ev["eval_recons_loss"])], rtol=STEP_LOSS_RTOL)
            # The prediction off: no gradient reaches the velocity head.
            want = flax_to_state_dict(jax.device_get(
                {"velocity_encoder": g["velocity_encoder"]}))
            got = dict(trainer.model.named_parameters())
            assert want and all(not t.any() for t in want.values())
            assert all(not got[name].grad.any() for name in want)
        want = flax_to_state_dict(jax.device_get(params))
        got = trainer.model.state_dict()
        largest = max(float(v.abs().max()) for v in want.values())
        moved = 0
        for name, t in want.items():
            np.testing.assert_allclose(
                got[name].reshape(-1).numpy(), t.reshape(-1).numpy(),
                rtol=0, atol=STEP_RTOL * largest, err_msg=name)
            moved += not torch.equal(got[name], port_start[name])
        assert moved > 10
        head = [n for n in got if n.startswith("velocity_encoder.")]
        assert head and all(torch.equal(got[n], port_start[n])
                            for n in head)


def test_trunk_restore_learning_rates(tmp_path):
    """Where the packages' schedules part after the trunk's restore: the
    JAX package's LR follows its optimizer's count, which the restore of
    runs/ph7 leaves at 0 (no optimizer leaf fits a 3bp_color state), so its
    first curriculum step takes base_lr; the port's follows the train step,
    37500, past the anneal: base_lr / 5 (ROADMAP Queue 3)."""
    path = tmp_path / "3bp.npz"
    _tiny_train(path)
    args = cli.build_parser().parse_args(_stage_argv() + ["--device=cpu"])
    trainer = _port_trainer(args, path, tmp_path / "run")
    _, schedule, restored = _jax_start(args)
    counts = [np.asarray(v) for p, v in
              jax.tree_util.tree_leaves_with_path(restored["opt_state"])
              if jax.tree_util.keystr(p).endswith(".count")]
    assert counts and all(c == 0 for c in counts)
    assert float(schedule(counts[0])) == pytest.approx(args.base_lr)
    assert trainer._lr_at(trainer.step - trainer._opt_step0) == (
        pytest.approx(args.base_lr / 5))


def test_probe_flags_and_tests():
    """The probes' flags parse with the CLI and differ from the chain's by
    their candidate only; --aux_warmup_epochs counts from step 0, so (b)'s
    covers the trunk's 1875 epochs and the curriculum's 900; (c)'s clip is
    the median of base's gradient norms after its start; a head passes
    with differing, in-range velocities and its last hidden layer under
    half saturated."""
    records = [dict(epoch=e, grad_norm=g) for e, g in
               ((0, 1e6), (50, 3.0), (100, 5.0), (150, 4.0))]
    assert cp.clip_norm(records) == 4.0
    with pytest.raises(ValueError):
        cp.clip_norm(records[:1])
    flags = {n: cp.probe_flags(n, records) for n in "abcd"}
    assert flags == {"a": ["--vel_anchor=1.0"],
                     "b": ["--recons_warmup", "--aux_warmup_epochs=2775"],
                     "c": ["--grad_clip=4"], "d": []}
    assert cp.probe_flags("base") == []
    assert rr.TRUNK_EPOCHS * 20 == rr._ckpt_scalar(rr.TRUNK, "step")
    parser = cli.build_parser()
    base = rr.chain_stages()[0]["argv"]
    b = parser.parse_args(base + flags["b"])
    assert (b.recons_warmup, b.aux_warmup_epochs * 20) == (
        True, 37500 + 900 * 20)
    assert cp._stage(flags["b"], 300, 100, 50, 10)[0]["argv"] == (
        _stage_argv(100))
    assert cp._stage(flags["a"], 300, 100, 50, 10)[0]["argv"] == (
        rr.chain_stages()[0]["argv"] + flags["a"])
    live = dict(spread=2.0, speed_p95=4.4, saturated=[0.68, 0.32])
    assert all(cp.alive(live).values())
    flung = dict(spread=0.001, speed_p95=96.0, saturated=[0.99, 0.98])
    assert cp.alive(flung) == dict(differ=False, in_range=False,
                                   unsaturated=False)
