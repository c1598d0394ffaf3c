"""The port's checkpoints against the JAX package's: save and restore, the
partial-restore rules and their log lines, the save_dir wipe or restore
decision, the test phase's restore source, and the trained
``runs/spring500``, ``runs/ph5`` and ``runs/spring500c`` checkpoints
converted and scored on the seq-30 test split; spring500 with the inference
enhancers on; and spring500c's converted optimizer state stepped against
optax.

Tolerances: a restored run's next step equals the unbroken run's exactly
(the same float32 operations on the same values). The spring500 losses
agree within 1e-4 relative with the JAX model's outputs, the loss taken in
float64 (a jitted JAX ``compute_losses`` is not the reference: XLA's CPU
backend sums the three reduced axes with about 4e-4 relative error).
"""
import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

from paig_reproduction_tpu import cli as jax_cli
from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.train import checkpoint as jax_ckpt
from paig_reproduction_tpu.train import trainer as jax_trainer_mod
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import (
    flax_checkpoint_to_port,
    flax_to_state_dict,
)
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.models import (PhysicsNet, compute_losses,
                                                jax_init)
from paig_reproduction_tpu_torch.train import checkpoint
from paig_reproduction_tpu_torch.train import trainer as trainer_mod
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "datasets", "spring_color")
SL12 = os.path.join(DATA, "color_spring_vx8_vy8_sl12_r2_k4_e6.npz")
SL30 = os.path.join(DATA, "color_spring_vx8_vy8_sl30_r2_k4_e6.npz")
SPRING500 = os.path.join(REPO, "runs", "spring500", "model.ckpt")
KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
          input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
          input_size=32 * 32)


@pytest.fixture
def paig_log(caplog):
    """The "paig" logger's records, with the handlers a CLI run adds
    removed afterwards."""
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    caplog.set_level(logging.INFO, logger="paig")
    yield caplog
    for h in set(logger.handlers) - set(handlers):
        logger.removeHandler(h)
        h.close()


def _tiny_file(dst_dir, src, n_train=8, n_eval=4):
    with np.load(src) as d:
        path = os.path.join(dst_dir, "spring_color", os.path.basename(src))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, train_x=d["train_x"][:n_train],
                 valid_x=d["valid_x"][:n_eval], test_x=d["test_x"][:n_eval])
    return path


def _trainer(path, optimizer, seed=0):
    model = jax_init.load_initial_state(PhysicsNet(**KW),
                                        jax_init.prng_key(seed))
    trainer = Trainer(model, device="cpu")
    trainer.get_data(iterators.get_iterators(path, conv=True))
    trainer.build_optimizer(6e-4, optimizer, True, epochs=2,
                            steps_per_epoch=2)
    return trainer


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam"])
def test_restored_step_equals_unbroken_step(tmp_path, optimizer):
    """Save after 2 steps, restore into a fresh model and optimizer (other
    initial weights), and take step 3: it equals the unbroken run's step 3,
    which crosses the LR anneal (boundary int(0.75 * 2) * 2 = 2)."""
    path = _tiny_file(str(tmp_path), SL12)
    idx = [np.random.RandomState(s).choice(8, 2, replace=False)
           for s in range(3)]
    unbroken = _trainer(path, optimizer)
    for i in idx[:2]:
        unbroken.train_step(i)
    unbroken.initialize_graph(str(tmp_path / "run"))
    unbroken.save()
    last = unbroken.train_step(idx[2])

    restored = _trainer(path, optimizer, seed=1)
    restored.initialize_graph(str(tmp_path / "run"), use_ckpt=True)
    assert restored.step == 2
    again = restored.train_step(idx[2])
    for k in last:
        torch.testing.assert_close(again[k], last[k], rtol=0, atol=0)
    for name, t in unbroken.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[name], t,
                                   rtol=0, atol=0, msg=name)


class _Tiny(torch.nn.Module):
    def __init__(self, b_shape):
        super().__init__()
        self.a = torch.nn.Parameter(torch.ones(3))
        self.b = torch.nn.Parameter(torch.ones(b_shape))
        self.c = torch.nn.Parameter(torch.ones(2))


def _messages(records):
    """The restore's log lines without their name lists."""
    return [re.sub(r": \[.*\]$", "", r.getMessage()) for r in records
            if r.getMessage().startswith("checkpoint restore:")]


def test_partial_restore_follows_the_jax_rules(tmp_path, paig_log):
    """The checkpoint holds a (fits), b (another shape) and d (extra); the
    model has a, b and c (missing). a is restored, b and c keep their
    values, d is ignored, and the three log lines read as the JAX
    package's for the same leaves."""
    saved = {"a": torch.full((3,), 2.0), "b": torch.full((4,), 2.0),
             "d": torch.full((5,), 2.0)}
    checkpoint.save_checkpoint(str(tmp_path), {
        "model": saved, "optimizer": {"state": {}}, "step": 5, "epoch": 1,
        "total_epochs_done": 1})
    model = _Tiny(b_shape=(2, 2))
    scalars = checkpoint.restore_checkpoint(str(tmp_path), model)
    assert scalars == {"step": 5, "epoch": 1, "total_epochs_done": 1}
    assert torch.equal(model.a, torch.full((3,), 2.0))
    assert torch.equal(model.b, torch.ones(2, 2))
    assert torch.equal(model.c, torch.ones(2))
    port_lines = _messages(paig_log.records)
    paig_log.clear()

    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_ckpt.save_checkpoint(str(jax_dir), {
        "a": np.full((3,), 2.0, np.float32), "b": np.full((4,), 2.0,
                                                          np.float32),
        "d": np.full((5,), 2.0, np.float32)})
    jax_ckpt.restore_checkpoint(str(jax_dir), {
        "a": np.ones(3, np.float32), "b": np.ones((2, 2), np.float32),
        "c": np.ones(2, np.float32)})
    assert port_lines == _messages(paig_log.records)
    assert port_lines == [
        "checkpoint restore: 1 target leaves not in checkpoint, keeping "
        "initialized values",
        "checkpoint restore: 1 leaves shape-incompatible, keeping "
        "initialized values",
        "checkpoint restore: ignoring 1 extra leaves"]


def test_optimizer_state_restores_by_name(tmp_path):
    """Optimizer state follows its parameter's name, not its position, and
    a state whose shape no longer fits is skipped."""
    src = _Tiny(b_shape=(4,))
    opt = torch.optim.Adam([src.c, src.a, src.b], 1e-3)
    for p in src.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    checkpoint.save_checkpoint(str(tmp_path), {
        "model": src.state_dict(),
        "optimizer": checkpoint.optimizer_state_by_name(src, opt),
        "step": 1, "epoch": 0, "total_epochs_done": 0})
    dst = _Tiny(b_shape=(2, 2))
    dst_opt = torch.optim.Adam([dst.a, dst.b, dst.c], 1e-3)
    checkpoint.restore_checkpoint(str(tmp_path), dst, dst_opt)
    for name in ("a", "c"):
        got = dst_opt.state[getattr(dst, name)]
        want = opt.state[getattr(src, name)]
        for key in want:
            assert torch.equal(got[key], want[key]), (name, key)
    assert not dst_opt.state[dst.b]


def test_directory_checkpoint_raises(tmp_path):
    (tmp_path / "model.ckpt").mkdir()
    with pytest.raises(ValueError, match="flax_checkpoint_to_port"):
        checkpoint.restore_checkpoint(str(tmp_path), _Tiny((4,)))


def _jax_decision(monkeypatch, save_dir, use_ckpt, ckpt_dir):
    seen = []

    def restore(restore_dir, target):
        seen.append(restore_dir)
        return target
    monkeypatch.setattr(jax_trainer_mod, "restore_checkpoint", restore)
    monkeypatch.setattr(jax_trainer_mod, "peek_checkpoint_leaf",
                        lambda *a: None)
    trainer = jax_trainer_mod.Trainer(JaxPhysicsNet(**KW))
    trainer.initialize_graph(save_dir, use_ckpt, ckpt_dir)
    return seen


def _port_decision(monkeypatch, save_dir, use_ckpt, ckpt_dir):
    seen = []

    def restore(restore_dir, model, optimizer):
        seen.append(restore_dir)
        return {"step": 0, "epoch": 0, "total_epochs_done": 0}
    monkeypatch.setattr(trainer_mod, "restore_checkpoint", restore)
    trainer = Trainer(PhysicsNet(**KW), device="cpu")
    trainer.build_optimizer(6e-4)
    trainer.initialize_graph(save_dir, use_ckpt, ckpt_dir)
    return seen


@pytest.mark.parametrize("exists", [False, True])
@pytest.mark.parametrize("use_ckpt", [False, True])
@pytest.mark.parametrize("ckpt_dir", ["", "other"])
def test_initialize_graph_decides_as_jax(tmp_path, monkeypatch, exists,
                                         use_ckpt, ckpt_dir):
    """Wipe or keep save_dir, and where to restore from, for each
    combination: the same as the JAX Trainer's."""
    outcome = []
    for name, decide in (("jax", _jax_decision), ("port", _port_decision)):
        save_dir = tmp_path / name
        if exists:
            save_dir.mkdir()
            (save_dir / "old.txt").write_text("old")
        seen = decide(monkeypatch, str(save_dir), use_ckpt,
                      str(tmp_path / ckpt_dir) if ckpt_dir else "")
        outcome.append((save_dir.is_dir(), (save_dir / "old.txt").exists(),
                        ["save_dir" if d == str(save_dir) else d
                         for d in seen]))
    assert outcome[0] == outcome[1]


class _SpyTrainer:
    """Stands in for either package's Trainer and records the test phase's
    restore arguments."""
    calls = []

    def __init__(self, *args, **kwargs):
        self._epoch_base = 0

    def initialize_graph(self, save_dir, use_ckpt, ckpt_dir=""):
        _SpyTrainer.calls.append((use_ckpt, ckpt_dir))

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


@pytest.mark.parametrize("test_mode", [False, True])
def test_test_phase_restores_as_jax(tmp_path, monkeypatch, test_mode):
    """Both CLIs' initialize_graph calls: the test phase restores from
    --ckpt_dir only under --test_mode, from save_dir otherwise."""
    for src in (SL12, SL30):
        _tiny_file(str(tmp_path), src)
    monkeypatch.setenv("PAIG_COMPILE_CACHE", "0")
    argv = ["--task=spring_color", "--color", f"--data_dir={tmp_path}",
            f"--save_dir={tmp_path / 'run'}", "--use_ckpt",
            f"--ckpt_dir={tmp_path / 'warm'}"]
    argv += ["--test_mode"] if test_mode else []
    calls = []
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        for main, module in ((jax_cli.main, jax_trainer_mod),
                             (cli.main, trainer_mod)):
            _SpyTrainer.calls = []
            monkeypatch.setattr(module, "Trainer", _SpyTrainer)
            main(argv + (["--device=cpu"] if main is cli.main else []))
            calls.append(list(_SpyTrainer.calls))
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
    assert calls[0] == calls[1]
    assert calls[1][-1] == (True, str(tmp_path / "warm") if test_mode
                            else "")


def _float64_losses(model, inp, out, recons):
    """The JAX compute_losses in float64 on one batch's outputs."""
    inp = inp.astype(np.float64)
    t_in = model.input_steps + model.pred_steps
    recons = np.mean(np.sum((inp[:, :t_in] - recons) ** 2, axis=(2, 3, 4)))
    err = np.sum((inp[:, model.input_steps:] - out) ** 2, axis=(2, 3, 4))
    return np.array([np.mean(err[:, :model.pred_steps]),
                     np.mean(err[:, model.pred_steps:]), recons])


def test_spring500_scores_as_jax(tmp_path, paig_log, monkeypatch):
    """runs/spring500's trained weights, restored with orbax, converted and
    scored by the port's --test_mode on the tracked seq-30 split (200
    sequences, two batches of 100, no ragged tail), against the JAX
    model's outputs on the same sequences."""
    import orbax.checkpoint as ocp

    tree = jax.device_get(ocp.PyTreeCheckpointer().restore(SPRING500))
    converted = flax_checkpoint_to_port(tree)
    assert set(converted["optimizer"]["state"]) == set(converted["model"])
    ckpt_dir = tmp_path / "converted"
    ckpt_dir.mkdir()
    checkpoint.save_checkpoint(str(ckpt_dir), converted)

    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    save_dir = tmp_path / "test"
    _, test_trainer = cli.main([
        "--task=spring_color", "--base_lr=6e-4", "--autoencoder_loss=3.0",
        "--color", "--test_mode", f"--ckpt_dir={ckpt_dir}",
        f"--save_dir={save_dir}", "--device=cpu"])
    assert test_trainer.step == int(tree["step"])
    line = next(r.getMessage() for r in paig_log.records
                if r.getMessage().startswith("test - epoch=0 "))
    port = {k: float(v) for k, v in re.findall(r"(\w+)=(\S+)", line)
            if k.startswith("eval_")}

    model = JaxPhysicsNet(**dict(KW, seq_len=30))
    apply = jax.jit(model.apply)
    with np.load(SL30) as d:
        test_x = d["test_x"]
    per_batch = []
    for i in range(0, 200, 100):
        inp = (np.transpose(test_x[i:i + 100], (0, 1, 4, 2, 3))
               .astype(np.float32) / 255.0)
        out, aux = apply({"params": tree["params"]}, inp)
        per_batch.append(_float64_losses(
            model, inp, np.asarray(out, np.float64),
            np.asarray(aux["recons_out"], np.float64)))
    ref = np.mean(per_batch, axis=0)
    np.testing.assert_allclose(
        [port["eval_pred_loss"], port["eval_extrap_loss"],
         port["eval_recons_loss"]], ref, rtol=1e-4)


# Trained runs whose flags use the model extension fields: (run, CLI flags,
# the JAX model's fields).
TRAINED_RUNS = {
    "ph5": (["--pos_consistency=0.3", "--learn_frame_offset",
             "--cell_substeps=10"],
            dict(pos_consistency=0.3, learn_frame_offset=True,
                 cell_substeps=10)),
    "spring500c": (["--template_center_loss=0.1", "--coarse_loss=1.0",
                    "--vel_anchor=0.1", "--physics_lr_mult=3.0"],
                   dict(template_center_loss=0.1, coarse_loss=1.0,
                        vel_anchor=0.1)),
}


def _restore_run(run):
    import orbax.checkpoint as ocp
    return jax.device_get(ocp.PyTreeCheckpointer().restore(
        os.path.join(REPO, "runs", run, "model.ckpt")))


@pytest.mark.parametrize("run", sorted(TRAINED_RUNS))
def test_trained_run_scores_as_jax(tmp_path, paig_log, monkeypatch, run):
    """runs/ph5 (a learned frame offset, 10 substeps) and runs/spring500c
    (the template-centre, coarse and velocity-anchor losses; the
    physics_lr_mult optimizer), restored with orbax, converted and scored by
    the port's --test_mode with the run's flags on the seq-30 test split,
    against the JAX model's outputs with the same fields (float64 losses).
    The converted optimizer state covers every parameter, from each
    multi_transform branch."""
    flags, fields = TRAINED_RUNS[run]
    tree = _restore_run(run)
    converted = flax_checkpoint_to_port(tree)
    assert set(converted["optimizer"]["state"]) == set(converted["model"])
    ckpt_dir = tmp_path / "converted"
    ckpt_dir.mkdir()
    checkpoint.save_checkpoint(str(ckpt_dir), converted)

    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    _, test_trainer = cli.main([
        "--task=spring_color", "--base_lr=6e-4", "--autoencoder_loss=3.0",
        "--color", "--test_mode", f"--ckpt_dir={ckpt_dir}",
        f"--save_dir={tmp_path / 'test'}", "--device=cpu", *flags])
    assert test_trainer.step == int(tree["step"])
    line = next(r.getMessage() for r in paig_log.records
                if r.getMessage().startswith("test - epoch=0 "))
    port = {k: float(v) for k, v in re.findall(r"(\w+)=(\S+)", line)
            if k.startswith("eval_")}

    model = JaxPhysicsNet(**dict(KW, seq_len=30), **fields)
    apply = jax.jit(model.apply)
    with np.load(SL30) as d:
        test_x = d["test_x"]
    per_batch = []
    for i in range(0, 200, 100):
        inp = (np.transpose(test_x[i:i + 100], (0, 1, 4, 2, 3))
               .astype(np.float32) / 255.0)
        out, aux = apply({"params": tree["params"]}, inp)
        per_batch.append(_float64_losses(
            model, inp, np.asarray(out, np.float64),
            np.asarray(aux["recons_out"], np.float64)))
    ref = np.mean(per_batch, axis=0)
    np.testing.assert_allclose(
        [port["eval_pred_loss"], port["eval_extrap_loss"],
         port["eval_recons_loss"]], ref, rtol=1e-4)


def test_spring500_enhancers_match_jax_apply():
    """runs/spring500's weights with init_state_fit=3 and
    refine_recons_pos=4 on 20 valid sequences: the refined enc_pos, the
    fitted rollout start and the losses equal the JAX model's apply with
    the same fields. Tolerances: positions within 1e-3 px and losses at
    rtol 1e-4 (f32 Gauss-Newton solves on well-separated trained
    encodings; sums in another order)."""
    tree = _restore_run("spring500")
    fields = dict(init_state_fit=3, refine_recons_pos=4)
    with np.load(SL12) as d:
        inp = (np.transpose(d["valid_x"][:20], (0, 1, 4, 2, 3))
               .astype(np.float32) / 255.0)
    j_model = JaxPhysicsNet(**KW, **fields)
    j_out, j_aux = jax.jit(j_model.apply)({"params": tree["params"]}, inp)
    model = PhysicsNet(**KW, **fields)
    model.load_state_dict(flax_checkpoint_to_port(tree)["model"])
    x = torch.from_numpy(inp)
    with torch.no_grad():
        out, aux = model(x)
        _, losses = compute_losses(model, x, out, aux["recons_out"], aux)
    np.testing.assert_allclose(aux["enc_pos"].numpy(),
                               np.asarray(j_aux["enc_pos"]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(aux["pos_vel_seq"].numpy(),
                               np.asarray(j_aux["pos_vel_seq"]), rtol=0,
                               atol=1e-3)
    ref = _float64_losses(j_model, inp, np.asarray(j_out, np.float64),
                          np.asarray(j_aux["recons_out"], np.float64))
    np.testing.assert_allclose(
        [float(losses[k]) for k in ("eval_pred_loss", "eval_extrap_loss",
                                    "eval_recons_loss")], ref, rtol=1e-4)
    # The refinement moved the positions.
    plain = JaxPhysicsNet(**KW).apply({"params": tree["params"]}, inp)[1]
    assert np.abs(aux["enc_pos"].numpy()
                  - np.asarray(plain["enc_pos"])).max() > 1e-2


def test_spring500c_optimizer_step_matches_optax(tmp_path):
    """runs/spring500c's RMSprop state (a multi_transform with a physics
    branch at physics_lr_mult=3), converted: one step on the same
    gradients equals optax's from the restored state, at its step count
    (12500, past the anneal). Tolerance rtol 1e-6 / atol 1e-7."""
    import optax

    from paig_reproduction_tpu.train import optimizers as jax_opt
    from paig_reproduction_tpu_torch.train import optimizers

    tree = _restore_run("spring500c")
    params = tree["params"]
    tx = jax_opt.build_optimizer(
        "rmsprop", jax_opt.lr_schedule(6e-4, 500, 25, True), params,
        physics_lr_mult=3.0)
    restored = jax_ckpt.restore_checkpoint(
        os.path.join(REPO, "runs", "spring500c"),
        {"params": params, "opt_state": tx.init(params),
         "step": np.asarray(0)})
    rs = np.random.RandomState(0)
    grads = jax.tree.map(
        lambda a: np.asarray(rs.randn(*np.shape(a)), np.float32), params)
    updates, _ = tx.update(grads, restored["opt_state"], params)
    ref = flax_to_state_dict(jax.device_get(
        optax.apply_updates(params, updates)))

    converted = flax_checkpoint_to_port(tree)
    checkpoint.save_checkpoint(str(tmp_path), converted)
    model = PhysicsNet(**KW)
    opt = optimizers.build_optimizer("rmsprop", model.named_parameters(),
                                     6e-4, physics_lr_mult=3.0)
    step = checkpoint.restore_checkpoint(str(tmp_path), model, opt)["step"]
    assert step == 12500
    optimizers.set_lr(opt, optimizers.lr_schedule(6e-4, 500, 25, True)(step))
    for name, g in flax_to_state_dict(grads).items():
        model.get_parameter(name).grad = g
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


BOUNCE = os.path.join(REPO, "data", "datasets", "bouncing",
                      "color_bounce_vx8_vy8_sl30_r2.npz")
# runs/bounce_one1's model flags (benchmarks/bounce_one1_test_log.txt), the
# enhancers included, and the JAX model's fields for them.
BOUNCE_FLAGS = ["--task=bouncing_balls", "--autoencoder_loss=2.0",
                "--color", "--pos_consistency=1.0", "--vel_anchor=1.0",
                "--learn_frame_offset", "--init_state_fit=1",
                "--refine_enc_pos=4", "--refine_recons_pos=4"]
BOUNCE_KW = dict(task="bouncing_balls", cell_type="bouncing_ode_cell",
                 seq_len=30, input_steps=4, pred_steps=6,
                 autoencoder_loss=2.0, color=True, input_size=32 * 32,
                 pos_consistency=1.0, vel_anchor=1.0,
                 learn_frame_offset=True, init_state_fit=1,
                 refine_enc_pos=4, refine_recons_pos=4)


def test_bounce_one1_scores_as_jax(tmp_path, paig_log, monkeypatch):
    """runs/bounce_one1 (bouncing_balls: no physical parameters, a learned
    frame offset), restored with orbax, converted and scored by the port's
    --test_mode with its enhancer flags (the reflection-aware state fit and
    4 refinement iterations) on the tracked seq-30 test split (200
    sequences, two batches of 100), against the JAX model's outputs with
    the same fields (float64 losses), within 1e-4 relative."""
    tree = _restore_run("bounce_one1")
    converted = flax_checkpoint_to_port(tree)
    assert not {"log_k", "log_equil", "log_g", "log_m"} & set(
        converted["model"])
    assert set(converted["optimizer"]["state"]) == set(converted["model"])
    ckpt_dir = tmp_path / "converted"
    ckpt_dir.mkdir()
    checkpoint.save_checkpoint(str(ckpt_dir), converted)

    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    _, test_trainer = cli.main(BOUNCE_FLAGS + [
        "--test_mode", f"--ckpt_dir={ckpt_dir}",
        f"--save_dir={tmp_path / 'test'}", "--device=cpu"])
    assert test_trainer.step == int(tree["step"])
    line = next(r.getMessage() for r in paig_log.records
                if r.getMessage().startswith("test - epoch=0 "))
    port = {k: float(v) for k, v in re.findall(r"(\w+)=(\S+)", line)
            if k.startswith("eval_")}

    model = JaxPhysicsNet(**BOUNCE_KW)
    apply = jax.jit(model.apply)
    with np.load(BOUNCE) as d:
        test_x = d["test_x"]
    assert test_x.shape[0] == 200
    per_batch = []
    for i in range(0, 200, 100):
        inp = (np.transpose(test_x[i:i + 100], (0, 1, 4, 2, 3))
               .astype(np.float32) / 255.0)
        out, aux = apply({"params": tree["params"]}, inp)
        per_batch.append(_float64_losses(
            model, inp, np.asarray(out, np.float64),
            np.asarray(aux["recons_out"], np.float64)))
    ref = np.mean(per_batch, axis=0)
    np.testing.assert_allclose(
        [port["eval_pred_loss"], port["eval_extrap_loss"],
         port["eval_recons_loss"]], ref, rtol=1e-4)


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam"])
def test_lstm_checkpoint_round_trip(tmp_path, optimizer):
    """A JAX LSTM model's checkpoint (two layers; params and the RMSprop or
    Adam state after one update) written and restored with orbax, converted
    and restored by the port: the weights equal the JAX model's gate by
    gate, and one more step on the same gradients equals optax's (rtol 1e-6
    / atol 1e-7), which needs the converted state."""
    import optax
    import orbax.checkpoint as ocp

    from paig_reproduction_tpu.train import optimizers as jax_opt
    from paig_reproduction_tpu_torch.train import optimizers

    kw = dict(task="spring_color", cell_type="lstm", recurrent_units=8,
              lstm_layers=2, seq_len=6, input_steps=2, pred_steps=2,
              input_size=16 * 16)
    j_model = JaxPhysicsNet(**kw)
    x = np.random.RandomState(0).rand(1, 6, 3, 16, 16).astype(np.float32)
    params = jax.jit(j_model.init)(jax.random.PRNGKey(0), x)["params"]
    schedule = jax_opt.lr_schedule(6e-4, 2, 2, True)
    tx = jax_opt.build_optimizer(optimizer, schedule, params)
    rs = np.random.RandomState(1)

    def grads():
        return jax.tree.map(
            lambda a: np.asarray(rs.randn(*np.shape(a)), np.float32), params)

    @jax.jit
    def step(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = step(grads(), tx.init(params), params)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), {
        "params": params, "opt_state": opt_state, "step": np.asarray(1)})
    tree = jax.device_get(ocp.PyTreeCheckpointer().restore(
        str(tmp_path / "jax" / "model.ckpt")))
    checkpoint.save_checkpoint(str(tmp_path), flax_checkpoint_to_port(tree))

    model = PhysicsNet(**kw)
    opt = optimizers.build_optimizer(optimizer, model.named_parameters(),
                                     6e-4)
    assert checkpoint.restore_checkpoint(str(tmp_path), model,
                                         opt)["step"] == 1
    host = jax.device_get(params)
    for i in range(2):
        cell = model.get_submodule(f"lstm_{i}")
        for j, gate in enumerate("ifgo"):
            rows = slice(8 * j, 8 * (j + 1))
            ref = host[f"lstm_{i}"]
            np.testing.assert_array_equal(
                cell.weight_ih.detach()[rows].T, ref["i" + gate]["kernel"])
            np.testing.assert_array_equal(
                cell.weight_hh.detach()[rows].T, ref["h" + gate]["kernel"])
            np.testing.assert_array_equal(cell.bias_hh.detach()[rows],
                                          ref["h" + gate]["bias"])

    g2 = grads()
    ref = flax_to_state_dict(jax.device_get(step(g2, opt_state, params)[0]))
    optimizers.set_lr(opt, optimizers.lr_schedule(6e-4, 2, 2, True)(1))
    for name, g in flax_to_state_dict(g2).items():
        model.get_parameter(name).grad = g
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
