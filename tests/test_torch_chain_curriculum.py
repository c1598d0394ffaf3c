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
  parity tests hold positions to 1e-5 px and fits to 1e-3). Each
  package steps at its own schedule: the JAX package's optimizer (its
  RMSprop, ``log_m`` frozen, its state as the restore left it) at its
  schedule of its own count, the port's at its own of its optimizer's
  count, both 1e-3 after this restore. The JAX schedule's rate is taken
  in float32, as the JAX package computes it and as the port's device
  scalar holds it: under x64 it would be float64, and RMSprop's first
  steps amplify a rounding of 5e-8 to parameters that part by 6e-5 of a
  tensor's largest after two steps (``test_torch_recipe_drift.py``);
* the first step after each restore of the chain, through both packages'
  restores (``test_trunk_restore_learning_rates``): the port's LR is the
  JAX schedule's at its optimizer's restored count;
* the probes' flags and their tests of a live head, the pinned probes'
  too, and the test probes' stages (``tools/curriculum_probes.py``);
* ``test_state`` on that checkpoint and the first test sequences of the
  seq-40 file, under the ``test`` phase's flags, against the JAX
  package's ``apply`` (its ``fit_initial_state``, the head's output
  captured) in float64: the same sequences accepted, the head's and the
  fitted speeds within ``VEL_ATOL``; and with the head's last bias shifted
  out of the frame, every sequence rejected by both.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jax_3bp
from chain_pinned import train_losses as _jax_losses
from paig_reproduction_tpu.train import optimizers as jax_opt
from paig_reproduction_tpu.train.checkpoint import (
    restore_checkpoint as jax_restore,
)
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.tools import curriculum_probes as cp
from paig_reproduction_tpu_torch.tools import reference_runs as rr
from paig_reproduction_tpu_torch.train import checkpoint
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
    model, schedule, restored = _jax_start(args)
    assert trainer.step == int(restored["step"]) == 37500
    assert trainer.opt_count == 0
    assert trainer._lr_at(trainer.opt_count) == args.base_lr
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
        tx = jax_opt.build_optimizer(
            args.optimizer, lambda count: schedule(count).astype(
                jnp.float32), params)
        opt_state = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.issubdtype(np.asarray(a).dtype, np.floating)
            else jnp.asarray(a), restored["opt_state"])

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
            trainer._fill_scalars(trainer.step)
            count = [int(v) for p, v in
                     jax.tree_util.tree_leaves_with_path(opt_state)
                     if jax.tree_util.keystr(p).endswith(".count")]
            assert set(count) == {trainer.opt_count}
            assert float(trainer._scalars[0]) == float(
                schedule(count[0]).astype(jnp.float32)) == np.float32(1e-3)
            params, opt_state, total, ev, g = step(
                params, opt_state, jnp.asarray(x[idx]),
                float(trainer.step >= warmup))
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


# The chain whose restores test_trunk_restore_learning_rates holds, at a
# tiny depth: 2 epochs a curriculum stage and 2 pinned, B=4 on 8 train
# sequences (2 steps an epoch, so each stage's schedule anneals inside
# it); curriculum_1 is cut after its first epoch's save and resumed.
LR_DEPTH = dict(curriculum=(2, 2, 2), pinned=2, batch_size=4)
# The restore points, each named by the checkpoint restored: the trunk
# into curriculum_1; curriculum_1 at its cut, resumed; curriculum_1 into
# curriculum_2; curriculum_2 into curriculum_3; the surgery into pinned;
# slot_rescue --keep_step's checkpoint into pinned; pinned's, its count
# removed, into pinned.
LR_CASES = ("trunk", "resume", "curriculum_2", "curriculum_3", "pinned",
            "keep_step", "before_count")


def _jax_trainer(argv, spe, save_dir, ckpt_dir):
    """The JAX package's Trainer of the port's CLI flags ``argv``, built as
    its CLI builds it at ``spe`` steps an epoch and restored from
    ``ckpt_dir`` by its initialize_graph (no step is compiled: the
    parameters are zeros of the init's shapes), and its LR schedule."""
    from paig_reproduction_tpu.train.trainer import Trainer as JaxTrainer
    model, _ = jax_3bp.jax_model(argv + ["--device=cpu"])
    args = cli.build_parser().parse_args(argv + ["--device=cpu"])
    x = jnp.zeros((1, model.seq_len, 3, 36, 36))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    trainer = JaxTrainer(model)
    trainer.params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes["params"])
    trainer.build_optimizer(args.base_lr, args.optimizer, args.anneal_lr,
                            epochs=args.epochs, steps_per_epoch=spe,
                            aux_warmup_epochs=args.aux_warmup_epochs,
                            bg_lr_mult=args.bg_lr_mult)
    trainer.initialize_graph(str(save_dir), True, str(ckpt_dir))
    return trainer, jax_opt.lr_schedule(args.base_lr, args.epochs, spe,
                                        args.anneal_lr)


def _jax_count(trainer):
    counts = {int(np.asarray(v)) for p, v in
              jax.tree_util.tree_leaves_with_path(trainer.opt_state)
              if jax.tree_util.keystr(p).endswith(".count")}
    assert len(counts) == 1, counts
    return counts.pop()


def _jax_save(trainer, steps, epochs, save_dir):
    """The JAX trainer's checkpoint after ``steps`` more updates (optax's
    count goes up by one an update) and ``epochs`` of its loop."""
    trainer.opt_state = jax.tree_util.tree_map_with_path(
        lambda p, v: v + steps if jax.tree_util.keystr(p).endswith(".count")
        else v, trainer.opt_state)
    trainer.step += steps
    trainer._cur_epoch = epochs
    trainer.save_dir = str(save_dir)
    trainer.save()


def _port_first_lr(argv, data, save_dir, ckpt_dir):
    """(first step's LR, optimizer count, step) of the port's Trainer of
    ``argv``, built as cli.main builds it and restored from ``ckpt_dir``."""
    args = cli.build_parser().parse_args(argv + ["--device=cpu"])
    its = iterators.get_iterators(
        os.path.join(data, cli.TASK_TABLE["3bp_color"][0]), conv=True)
    trainer = Trainer(cli.build_model(args, 20), device="cpu", seed=0)
    trainer.get_data(its)
    trainer.build_optimizer(
        args.base_lr, args.optimizer, args.anneal_lr, epochs=args.epochs,
        steps_per_epoch=its[0].num_examples // args.batch_size,
        aux_warmup_epochs=args.aux_warmup_epochs, bg_lr_mult=args.bg_lr_mult)
    trainer.initialize_graph(str(save_dir), True, str(ckpt_dir))
    return trainer._lr_at(trainer.opt_count), trainer.opt_count, trainer.step


@pytest.fixture(scope="module")
def lr_chain(tmp_path_factory):
    """The port's chain (CHAIN) at LR_DEPTH through its pinned stage, run
    by the reference runner on a cut of the tracked files, and the JAX
    package's checkpoints at the same points. Returns {case: (the port's
    first step's LR, count and step after that restore, the JAX trainer's
    schedule, count and step)}."""
    from test_torch_chain import _tiny_3bp
    from test_torch_tools_fit import _jax_tool

    from paig_reproduction_tpu_torch.tools import slot_rescue
    from paig_reproduction_tpu_torch.train import checkpoint

    root = tmp_path_factory.mktemp("lr_chain")
    data = root / "data"
    _tiny_3bp(data)
    stages = rr.CHAINS[CHAIN]["stages"](
        LR_DEPTH["curriculum"], LR_DEPTH["pinned"],
        LR_DEPTH["batch_size"], save_every=1, eval_every=1)[:5]
    argv = {s["name"]: s["argv"] for s in stages}
    spe = 8 // LR_DEPTH["batch_size"]
    port = root / "port"
    save = Trainer.save
    cut = {}

    def save_then_stop(self):
        save(self)
        if self.save_dir.endswith("curriculum_1") and not cut:
            cut["ckpt"] = checkpoint.load_checkpoint(self.save_dir)
            raise rr._Terminated()

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PAIG_VIZ_EXAMPLES", "1")
        mp.setattr(Trainer, "save", save_then_stop)
        with pytest.raises(SystemExit):
            rr.run_chain(CHAIN, str(port), "cpu", str(data), stages=stages)
        rr.run_chain(CHAIN, str(port), "cpu", str(data), stages=stages)
    logged = {name: rr.parse_log(str(port / name / "log.txt"))["first_lr"]
              for name in argv if name != "surgery"}
    assert [len(v) for v in logged.values()] == [2, 1, 1, 1]
    ours = {"trunk": logged["curriculum_1"][0],
            "resume": logged["curriculum_1"][1],
            "curriculum_2": logged["curriculum_2"][0],
            "curriculum_3": logged["curriculum_3"][0],
            "pinned": logged["pinned"][0]}
    keep_step = ["--task=3bp_color", "--rescue_slot=all",
                 "--disk_radius=3", "--keep_step"]
    slot_rescue.main([f"--ckpt_dir={port / 'curriculum_3'}",
                      f"--out_dir={root / 'port_keep'}", *keep_step])
    ours["keep_step"] = _port_first_lr(argv["pinned"], data, root / "p_k",
                                       root / "port_keep")
    old = checkpoint.load_checkpoint(str(port / "pinned"))
    assert old["optimizer"].pop("count") == old["step"]
    os.makedirs(root / "port_old")
    checkpoint.save_checkpoint(str(root / "port_old"), old)
    ours["before_count"] = _port_first_lr(argv["pinned"], data, root / "p_o",
                                          root / "port_old")

    jax_dir = root / "jax"
    theirs = {}

    def restore(case, stage, ckpt_dir):
        trainer, schedule = _jax_trainer(argv[stage], spe,
                                         jax_dir / f"run_{case}", ckpt_dir)
        theirs[case] = (schedule, _jax_count(trainer), trainer.step)
        return trainer

    cut_steps = cut["ckpt"]["step"] - 37500
    t = restore("trunk", "curriculum_1", os.path.join(REPO, "runs", "ph7"))
    _jax_save(t, cut_steps, 1, jax_dir / "c1_cut")
    t = restore("resume", "curriculum_1", jax_dir / "c1_cut")
    side = rr._read_sidecar(str(port))["steps"]
    _jax_save(t, side["curriculum_1"] - cut_steps, 1, jax_dir / "c1")
    for i in (2, 3):
        t = restore(f"curriculum_{i}", f"curriculum_{i}",
                    jax_dir / f"c{i - 1}")
        _jax_save(t, side[f"curriculum_{i}"], 2, jax_dir / f"c{i}")
    tool = _jax_tool("slot_rescue")
    tool.main([f"--ckpt_dir={jax_dir / 'c3'}",
               f"--out_dir={jax_dir / 'surgery'}", "--task=3bp_color"]
              + rr.SURGERY_FLAGS[:2] + ["--set_background=median",
                                        f"--data_dir={data}"])
    t = restore("pinned", "pinned", jax_dir / "surgery")
    _jax_save(t, side["pinned"], 2, jax_dir / "pinned")
    restore("before_count", "pinned", jax_dir / "pinned")
    tool.main([f"--ckpt_dir={jax_dir / 'c3'}",
               f"--out_dir={jax_dir / 'keep'}", *keep_step])
    restore("keep_step", "pinned", jax_dir / "keep")
    # A checkpoint of the chain's curriculum written before the port saved
    # its count keeps the rule of then: counted from step 0, the trunk's
    # step included.
    old = checkpoint.load_checkpoint(str(port / "curriculum_1"))
    old["optimizer"].pop("count")
    os.makedirs(root / "port_old_c1")
    checkpoint.save_checkpoint(str(root / "port_old_c1"), old)
    old_c1 = _port_first_lr(argv["curriculum_2"], data, root / "p_c",
                            root / "port_old_c1")
    return dict(cases={case: (ours[case], theirs[case])
                       for case in LR_CASES}, old_curriculum=old_c1)


@pytest.mark.parametrize("case", LR_CASES)
def test_trunk_restore_learning_rates(lr_chain, case):
    """The first step after each restore of the chain (LR_CASES) takes the
    LR of the JAX package's schedule at its optimizer's restored count,
    and both packages restore the same step. The JAX package's count is
    optax's: 0 where no leaf of the checkpoint's optimizer state fits (the
    spring trunk, whose optimizer is not a 3bp_color run's
    ``multi_transform``; a surgery's checkpoint, with or without its
    step), the saved one where they fit. The port saves its count with
    its optimizer state; a checkpoint written before it did
    (``before_count``) is counted from step 0, or from its last surgery:
    the same here, where the stage started at step 0."""
    (lr, count, step), (schedule, jax_count, jax_step) = lr_chain["cases"][
        case]
    assert (count, step) == (jax_count, jax_step)
    assert lr == pytest.approx(float(schedule(jax_count)), rel=1e-7)
    base = 1e-3
    if case == "trunk":
        # The trunk's step is past every stage's anneal; the count is not.
        assert (count, step) == (0, 37500) and lr == base
        assert float(schedule(step)) == pytest.approx(base / 5)
    elif case == "keep_step":
        assert count == 0 and step > 37500 and lr == base
    elif case in ("curriculum_2", "pinned"):
        assert lr == base
    elif case == "before_count":
        lr, count, step = lr_chain["old_curriculum"]
        assert count == step > 37500 and lr == base / 5


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


def test_pinned_probe_flags_and_tests():
    """The pinned probes' flags parse with the CLI and differ from
    CHAIN's pinned stage by their candidate only; their stages are
    CHAIN's through the pinned stage; (e)'s are the gated chain's pinned
    flags; a pinned probe passes with a live head and valid recons under
    the recons bar."""
    assert cp.PINNED_PROBES == {
        "control": [], "e": ["--recons_warmup", "--aux_on_recons=3.0"],
        "f": ["--vel_anchor=1.0"]}
    assert cp.PINNED_FROM == CHAIN
    parser = cli.build_parser()
    chain = rr.CHAINS[CHAIN]["stages"]()
    for name, flags in cp.PINNED_PROBES.items():
        stages = cp.pinned_stages(flags)
        assert [s["name"] for s in stages] == [
            "curriculum_1", "curriculum_2", "curriculum_3", "surgery",
            "pinned"]
        assert stages[:4] == chain[:4]
        assert stages[4]["argv"] == chain[4]["argv"] + flags
        args = parser.parse_args(stages[4]["argv"])
        assert (args.epochs, args.bg_lr_mult, args.recons_warmup,
                args.aux_on_recons, args.vel_anchor) == (
            1000, 0.0, name == "e", 3.0 if name == "e" else 0.0,
            1.0 if name == "f" else 0.0)
    gated = rr.CHAINS["3bp_chain_pinned_gated"]["stages"]()
    assert gated[:5] == cp.pinned_stages(cp.PINNED_PROBES["e"])
    assert gated[5:] == chain[5:]
    assert cp.pinned_stages([], (1, 1, 1), 2, 8, 1, 1) == rr.CHAINS[CHAIN][
        "stages"]((1, 1, 1), 2, 8, 1, 1)[:5]
    live = dict(spread=2.0, speed_p95=4.4, saturated=[0.68, 0.32])
    assert cp.pinned_passed(live, {"recons": 1.2}) == dict(
        differ=True, in_range=True, unsaturated=True, recons=True)
    assert cp.pinned_passed(live, {"recons": 1.5})["recons"] is False
    assert cp.pinned_passed(live, None)["recons"] is False
    flung = dict(spread=0.001, speed_p95=96.0, saturated=[0.99, 0.98])
    assert not any(cp.pinned_passed(flung, {"recons": 13.0}).values())


# The head's last bias shifted by this (px a time unit): three steps of
# the state fit, each clamped to 16, cannot bring it back.
FLUNG_BIAS = 200.0


@pytest.fixture(scope="module")
def jax_test_state(tmp_path_factory):
    """The JAX checkpoint of ``tests/jax_3bp.py`` in both packages, the
    first test sequences of the seq-40 file, the ``test`` phase's flags
    and the JAX package's float64 (start velocities, head's velocities)
    of a params tree."""
    import dataclasses

    import orbax.checkpoint as ocp
    from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
    jax_dir, port_dir = jax_3bp.write(str(tmp_path_factory.mktemp("ts")))
    x = rr.valid_batch(DATA, 8, test=True)
    argv = rr.test_flags(rr.TEST_LOGS["test"])
    port = cli.build_model(cli.build_parser().parse_args(
        argv + ["--device=cpu"]), x.shape[1])
    fields = {f.name for f in dataclasses.fields(JaxPhysicsNet)}
    model = JaxPhysicsNet(**{k: v for k, v in port.config.items()
                             if k in fields})
    assert (model.init_state_fit, model.seq_len) == (3, 40)
    params = jax.device_get(ocp.PyTreeCheckpointer().restore(
        os.path.join(jax_dir, "model.ckpt")))["params"]

    @jax.jit
    def start(p):
        (_, aux), state = model.apply(
            {"params": p}, jnp.asarray(x, jnp.float64),
            capture_intermediates=True, mutable=["intermediates"])
        head = state["intermediates"]["velocity_encoder"]["__call__"][0]
        return aux["pos_vel_seq"][:, 0, 6:], head

    def run(p):
        with jax.enable_x64(True):
            fit, head = start(jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), p))
        return (np.asarray(fit, np.float64).reshape(len(x), 3, 2),
                np.asarray(head, np.float64).reshape(len(x), 3, 2))
    return dict(port_dir=port_dir, params=params, x=x, argv=argv, run=run)


@pytest.mark.parametrize("case", ["trunk_head", "flung_head"])
def test_test_state_matches_jax(jax_test_state, tmp_path, case):
    s = jax_test_state
    params, port_dir = s["params"], s["port_dir"]
    if case == "flung_head":
        params = jax.tree.map(lambda a: a, params)
        dense = params["velocity_encoder"]["TorchDense_2"]
        dense["bias"] = np.asarray(dense["bias"]) + FLUNG_BIAS
        ckpt = checkpoint.load_checkpoint(port_dir)
        ckpt["model"]["velocity_encoder.dense.2.bias"] += FLUNG_BIAS
        port_dir = str(tmp_path)
        checkpoint.save_checkpoint(port_dir, ckpt)
    rng = torch.get_rng_state()
    port = rr.test_state(port_dir, s["x"], "cpu", s["argv"])
    assert torch.equal(torch.get_rng_state(), rng)
    fit, head = s["run"](params)
    accepted = np.any(fit != head, axis=(1, 2))
    assert port["accepted"] == accepted.tolist()
    assert port["accepted_share"] == np.mean(accepted)
    head_speeds = np.linalg.norm(head, axis=-1)
    fit_speeds = np.linalg.norm(fit[accepted], axis=-1)
    np.testing.assert_allclose(
        [port["head_speed"], port["head_speed_p95"]],
        [np.median(head_speeds), np.percentile(head_speeds, 95)], rtol=0,
        atol=VEL_ATOL)
    if case == "trunk_head":
        assert accepted.any()
        np.testing.assert_allclose(
            [port["fit_speed"], port["fit_speed_p95"]],
            [np.median(fit_speeds), np.percentile(fit_speeds, 95)], rtol=0,
            atol=VEL_ATOL)
        assert port["pred_accepted"] is not None
    else:
        assert not accepted.any() and port["head_speed"] > FLUNG_BIAS / 2
        assert (port["fit_speed"], port["fit_speed_p95"],
                port["pred_accepted"]) == (None, None, None)
    assert port["A"] == pytest.approx(1.0)
    assert np.isfinite([port["pred"], port["recons"]]).all()


def test_test_probe_flags_and_tests(tmp_path):
    """The test probes' stages: the control's are 3bp_chain's from its
    pinned stage on; g's add the anchor stage (the pinned stage's model
    flags with ANCHOR_FLAGS in place of theirs, 300 epochs on the chain's
    1000) before the fit; h's and i's are the test phases alone, h's at
    --init_state_fit=8 on the control's fit, i's on a checkpoint of the
    generator's A. No CHAINS entry runs h's or i's: every chain's test
    phases keep their logs' flags and start from the chain's own fit.
    A probe passes where both test lines are under the bars."""
    assert (cp.TEST_FROM, cp.TEST_PROBES) == ("3bp_chain",
                                              ("control", "g", "h", "i"))
    assert rr.ANCHOR_FLAGS == ["--vel_anchor=1.0", "--bg_lr_mult=0",
                               "--base_lr=3e-4"]
    chain = rr.CHAINS[cp.TEST_FROM]["stages"]()
    names = [s["name"] for s in chain]
    control = str(tmp_path / "control")
    assert cp.test_probe_stages("control", control) == chain[4:]
    g = cp.test_probe_stages("g", control)
    assert [s["name"] for s in g] == ["pinned", "anchor", "fit", "test",
                                      "test_refine"]
    assert g[0] == chain[4] and g[3:] == chain[6:]
    assert g[1]["start"] == "pinned" and g[2]["start"] == "anchor"
    parser = cli.build_parser()
    anchor, pinned = (parser.parse_args(g[i]["argv"]) for i in (1, 0))
    assert (anchor.epochs, anchor.vel_anchor, anchor.bg_lr_mult,
            anchor.base_lr) == (1300, 1.0, 0.0, 3e-4)
    assert (pinned.epochs, pinned.vel_anchor, pinned.base_lr) == (
        1000, 0.0, 1e-3)
    assert {k: v for k, v in vars(anchor).items() if k not in (
        "epochs", "vel_anchor", "base_lr")} == {
        k: v for k, v in vars(pinned).items() if k not in (
            "epochs", "vel_anchor", "base_lr")}
    h = cp.test_probe_stages("h", control)
    i = cp.test_probe_stages("i", control)
    tests = [s for s in chain if s["kind"] == "test"]
    assert [s["name"] for s in h] == [s["name"] for s in i] == [
        "test", "test_refine"]
    assert i == tests
    for hs, ts in zip(h, tests):
        assert hs["start"] == os.path.join(control, "fit")
        assert hs["argv"] == [a for a in ts["argv"]
                              if a != "--init_state_fit=3"] + [
            "--init_state_fit=8"]
    with pytest.raises(ValueError):
        cp.test_probe_stages("e", control)
    for spec in rr.CHAINS.values():
        stages = spec["stages"]()
        for s in stages:
            assert not os.path.isabs(s["start"]) or s["start"] == rr.TRUNK
            if s["kind"] == "test":
                assert s["argv"] == rr.test_flags(s["log"])
                assert s["start"] == "fit"
    assert names == ["curriculum_1", "curriculum_2", "curriculum_3",
                     "surgery", "pinned", "fit", "test", "test_refine"]

    # set_gravity: exp(log_g) exp(2 log_m) becomes A, nothing else moves.
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    model = {"log_g": torch.tensor(0.5), "log_m": torch.tensor(0.0),
             "w": torch.arange(3.0)}
    checkpoint.save_checkpoint(str(src), {"model": model, "step": 7})
    cp.set_gravity(str(src), str(dst), 60.0)
    out = checkpoint.load_checkpoint(str(dst))
    assert out["step"] == 7 and torch.equal(out["model"]["w"], model["w"])
    assert float(torch.exp(out["model"]["log_g"])) == pytest.approx(60.0)
    assert out["model"]["log_g"].dtype == torch.float32

    line = dict(pred=2.9, recons=1.4, extrap=9.0)
    rows = {"test": dict(test=line, port_pass=True),
            "test_refine": dict(test=line, port_pass=False)}
    record = cp._test_record({"stages": rows}, tests)
    assert (record["passed"], record["tests"]["test"]) == (False, line)
    rows["test_refine"]["port_pass"] = True
    assert cp._test_record({"stages": rows}, tests)["passed"]


def test_test_probes_run_on_the_cpu(tmp_path, monkeypatch):
    """The test probes on a tiny 3bp_chain (B=8, 1 epoch a stage, 2
    pinned): the pinned stage is copied, not run again; g's anchor stage
    trains 1 epoch at the schedule of the pinned stage's count, its head
    read at its start and end with a gradient; h's tests run at 8
    iterations on the control's fit, i's on the generator's A; each test
    stage has its reading; a second call runs nothing again."""
    import functools
    import logging

    from test_torch_chain import _tiny_3bp
    from paig_reproduction_tpu_torch.tools import fit_physics
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setattr(fit_physics, "encoder_positions", functools.partial(
        fit_physics.encoder_positions, n_batches=1, batch_size=8))
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    data, chain_dir, save_dir = (str(tmp_path / n) for n in ("d", "c", "p"))
    _tiny_3bp(tmp_path / "d")
    kw = dict(batch_size=8, save_every=1, eval_every=1)
    try:
        rr.run_chain(cp.TEST_FROM, chain_dir, "cpu", data, stages=rr.CHAINS[
            cp.TEST_FROM]["stages"]((1, 1, 1), 2, **kw)[:5])
        pinned_log = open(os.path.join(chain_dir, "pinned",
                                       "log.txt")).read()
        out = cp.run_test_probes(save_dir, chain_dir, ["g", "h", "i"], "cpu",
                                 data, pinned=2, anchor=1, **kw)
        assert open(os.path.join(chain_dir, "pinned",
                                 "log.txt")).read() == pinned_log
        probes = out["probes"]
        assert list(probes) == ["control", "g", "h", "i"]
        with open(os.path.join(save_dir, "test_probes.json")) as f:
            assert json.load(f) == json.loads(json.dumps(out))
        for name, record in probes.items():
            assert record["passed"] is False
            for t in ("test", "test_refine"):
                state = record["test_state"][t]
                assert 0 <= state["accepted_share"] <= 1
                assert len(state["accepted"]) == 4
        side = rr._read_sidecar(os.path.join(save_dir, "g"))
        assert list(side["stages"]["pinned"]) == list(
            rr._read_sidecar(chain_dir)["stages"]["pinned"])
        assert set(side["stages"]) == {"pinned", "anchor", "fit", "test",
                                       "test_refine"}
        anchor = probes["g"]["anchor"]
        assert anchor["steps"] == 1
        assert tuple(anchor["first_lr"]) == (pytest.approx(3e-4 / 5), 2, 2)
        records = rr._velocity_records(os.path.join(save_dir, "g", "anchor"))
        assert [r["epoch"] for r in records] == [0, 1]
        assert all(r["vel_grad_norm"] > 0 for r in records)
        assert records[0]["step"] == 2
        assert probes["g"]["fit"]["A_traj_err"] >= 0
        control_a = probes["control"]["fit"]["A"]
        for t in ("test", "test_refine"):
            assert probes["h"]["test_state"][t]["A"] == pytest.approx(
                control_a, rel=1e-6)
            assert probes["i"]["test_state"][t]["A"] == pytest.approx(60.0)
            header = rr.parse_log(os.path.join(save_dir, "h", t,
                                               "log.txt"))["header"]
            assert "--init_state_fit=8" in header
            assert f"--ckpt_dir={save_dir}/control/fit" in header
        again = cp.run_test_probes(save_dir, chain_dir, ["g", "h", "i"],
                                   "cpu", data, pinned=2, anchor=1, **kw)
        assert json.loads(json.dumps(again)) == json.loads(json.dumps(out))
        assert rr._read_sidecar(os.path.join(save_dir, "g")) == side
        with pytest.raises(SystemExit, match="no finished pinned stage"):
            cp.run_test_probes(save_dir, str(tmp_path / "none"), ["control"],
                               "cpu", data)
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
