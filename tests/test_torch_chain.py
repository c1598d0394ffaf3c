"""3bp_color's chain (``paig_reproduction_tpu_torch/tools/reference_runs.py``,
``3bp_chain``) on the CPU, its new stages held to the JAX package:

* the spring trunk: ``data/checkpoints/ph7_spring/model.ckpt`` is
  ``convert.flax_checkpoint_to_port`` of ``runs/ph7`` (its model and its
  step), bit for bit;
* the cross-task restore: ``runs/ph7`` restored into the JAX package's
  3bp_color train state at seed 0 (the curriculum's first stage: its
  parameters, RMSprop state and step) by its ``restore_checkpoint``, and
  the trunk into the port's trainer by its own: the same tensors taken
  (under ``convert``'s names), the same kept at their initial values,
  every value bit for bit; no optimizer state taken by either (the paths
  differ: a 3bp_color run's optimizer is a ``multi_transform``, its
  ``log_m`` frozen); the step, 37500, taken by both, and the LR both
  schedules give at the optimizer count the restore leaves, 0. A trunk
  of the model alone, without the step, fails this;
* ``fit_physics`` on a gravity cell: on the JAX package's 3bp_color
  checkpoint at seed 0 (``tests/jax_3bp.py``), the encoder positions and
  the rendered-appearance offsets within 1e-5 px of the JAX tool's on 16
  train sequences, the pointwise A within 1e-3 relative (1e-5 absolute:
  at initial weights it is near 0) and the trajectory A within 1e-3
  relative; with ``--write`` the same printed fits as the JAX tool's, and
  exactly ``log_g`` and ``frame_offset`` changed, as the JAX tool writes
  them;
* the chain's stages: the curriculum's flags, the surgery's and the test
  phases' (their logs' headers less the directories);
* the runner's chain at 1 epoch a stage (2 pinned), B=8, on a cut of the
  tracked 3bp files: cut after the surgery and again after the pinned
  stage's first epoch, it resumes where it stopped and runs no finished
  stage again; each stage's files, argv and steps; the fit's trajectory
  error and each test phase's state-fit reading (``test_state``), whose
  absence alone reruns that test phase.
"""
import functools
import json
import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

import jax_3bp
import ph7_trunk
from test_torch_tools_fit import _jax_tool, jitted_jax_model  # noqa: F401
from paig_reproduction_tpu.train.checkpoint import (
    restore_checkpoint as jax_restore,
)
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.tools import fit_physics
from paig_reproduction_tpu_torch.tools import reference_runs as rr
from paig_reproduction_tpu_torch.train import checkpoint
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "datasets")
POS_ATOL = 1e-5
FIT_RTOL = 1e-3
FIT_ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for a test's small models: more threads run
    them no faster, and beside the suite's other workers they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_new_handlers():
    """Removes the log handlers a run adds to the "paig" logger."""
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    yield
    for h in set(logger.handlers) - set(handlers):
        logger.removeHandler(h)
        h.close()


def test_trunk_is_ph7_converted():
    trunk = checkpoint.load_checkpoint(rr.TRUNK)
    assert set(trunk) == {"model", "step"}
    want = ph7_trunk.converted()
    assert trunk["step"] == want["step"] == 37500
    assert want["optimizer"]["state"]
    assert set(trunk["model"]) == set(want["model"])
    for name, t in want["model"].items():
        assert trunk["model"][name].dtype == t.dtype, name
        assert torch.equal(trunk["model"][name], t), name
    assert os.path.samefile(rr.TRUNK, ph7_trunk.TRUNK)


def test_spring_trunk_restores_into_3bp_as_in_jax(tmp_path,
                                                  no_new_handlers):
    """The warm start of the chain's first stage in both packages."""
    from paig_reproduction_tpu.train import optimizers as jax_opt
    from paig_reproduction_tpu_torch.train.trainer import Trainer

    stage = rr.chain_stages()[0]
    args = cli.build_parser().parse_args(stage["argv"] + ["--device=cpu"])
    jax_model, _ = jax_3bp.jax_model(jax_3bp.ARGV + ["--seed=0"])
    init = jax_3bp.jax_init_params(jax_model)
    schedule = jax_opt.lr_schedule(args.base_lr, args.epochs, 20, True)
    tx = jax_opt.build_optimizer(args.optimizer, schedule, init)
    opt_init = jax.device_get(tx.init(init))
    zero = np.asarray(0, np.int32)
    target = {"params": init, "opt_state": opt_init, "step": zero,
              "epoch": zero, "total_epochs_done": zero}
    restored = jax.device_get(jax_restore(
        os.path.join(REPO, "runs", "ph7"), target))
    jax_init_sd, jax_sd = flax_to_state_dict(init), flax_to_state_dict(
        restored["params"])
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(restored["opt_state"]),
        jax.tree_util.tree_leaves(opt_init)))

    port = cli.build_model(args, 20)
    port_init = {n: t.clone() for n, t in port.state_dict().items()}
    trainer = Trainer(port, device="cpu", seed=0)
    trainer.build_optimizer(args.base_lr, args.optimizer, args.anneal_lr,
                            epochs=args.epochs, steps_per_epoch=20)
    trainer.initialize_graph(str(tmp_path / "run"), use_ckpt=True,
                             ckpt_dir=rr.TRUNK)
    port_sd = port.state_dict()
    assert set(port_sd) == set(jax_sd) == set(jax_init_sd)
    assert not trainer.optimizer.state
    assert trainer.step == int(restored["step"]) == 37500
    counts = {int(v) for p, v in jax.tree_util.tree_leaves_with_path(
        restored["opt_state"]) if jax.tree_util.keystr(p).endswith(".count")}
    assert counts == {trainer.opt_count} == {0}
    assert trainer._lr_at(trainer.opt_count) == pytest.approx(
        float(schedule(0))) == args.base_lr

    def taken(got, start):
        return {n for n in got if not torch.equal(
            got[n].reshape(start[n].shape), start[n])}

    for name, t in port_init.items():
        assert torch.equal(t, jax_init_sd[name].reshape(t.shape)), name
    assert taken(port_sd, port_init) == taken(jax_sd, jax_init_sd)
    for name, t in port_sd.items():
        assert torch.equal(t, jax_sd[name].reshape(t.shape)), name

    trunk = checkpoint.load_checkpoint(rr.TRUNK)["model"]
    fits = {n for n, t in trunk.items()
            if n in port_init and t.shape == port_init[n].shape}
    assert taken(port_sd, port_init) == fits
    # Taken: the UNet's convs but its last (one channel an object: 3
    # against 2), the coordinate and velocity heads but the first layer's
    # input (36 px against 32), the first layers of the template, content
    # and background networks. Kept: their output layers (36-px images),
    # the gravity cell's parameters and the frame offset (3 objects).
    unet = {n for n in port_sd if n.startswith("encoder.unet.")}
    kept = set(port_sd) - fits
    assert unet - fits == {"encoder.unet.convs.12.weight",
                           "encoder.unet.convs.12.bias"}
    assert kept == {"encoder.unet.convs.12.weight",
                    "encoder.unet.convs.12.bias", "encoder.dense.0.weight",
                    "log_g", "log_m", "frame_offset"} | {
        f"var_net_{v}.dense.1.{leaf}" for v in (
            "template", "content", "background") for leaf in ("weight",
                                                              "bias")}
    assert not {"log_k", "log_equil"} & set(port_sd)


@pytest.fixture(scope="module")
def jax_3bp_dirs(tmp_path_factory):
    return jax_3bp.write(str(tmp_path_factory.mktemp("jax_3bp")))


def test_gravity_fit_matches_jax(jax_3bp_dirs, tmp_path, monkeypatch,
                                 capsys, jitted_jax_model):
    jax_dir, port_dir = jax_3bp_dirs
    jax_fp = _jax_tool("fit_physics")
    cut = dict(n_batches=1, batch_size=16)
    np.random.seed(0)
    enc_j, model_j, _, off_j = jax_fp.encoder_positions(
        "3bp_color", jax_dir, DATA, **cut)
    np.random.seed(0)
    enc_p, model_p, _, off_p = fit_physics.encoder_positions(
        "3bp_color", port_dir, DATA, device="cpu", **cut)
    assert model_p.cell_type == model_j.cell_type == "gravity_ode_cell"
    assert enc_p.shape == enc_j.shape == (16, 16, 6)
    np.testing.assert_allclose(off_p, off_j, rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(enc_p - off_p, enc_j - off_j, rtol=0,
                               atol=POS_ATOL)
    a_p, rms_p = fit_physics.fit_gravity(enc_p, 0.5)
    a_j, rms_j = jax_fp.fit_gravity(enc_j, 0.5)
    np.testing.assert_allclose([a_p, rms_p], [a_j, rms_j], rtol=FIT_RTOL,
                               atol=FIT_ATOL)
    kw = dict(input_steps=4, substeps=5)
    np.testing.assert_allclose(
        fit_physics.fit_gravity_trajectory(enc_p, 0.5, **kw)[0],
        jax_fp.fit_gravity_trajectory(enc_j, 0.5, **kw)[0], rtol=FIT_RTOL)

    # --write through both tools' command lines, each on its own copy.
    import shutil
    shutil.copytree(jax_dir, tmp_path / "jax")
    port_copy = tmp_path / "port"
    port_copy.mkdir()
    before = checkpoint.load_checkpoint(port_dir)
    checkpoint.save_checkpoint(str(port_copy), before)
    monkeypatch.setattr(jax_fp, "encoder_positions", functools.partial(
        jax_fp.encoder_positions, **cut))
    monkeypatch.setattr(fit_physics, "encoder_positions", functools.partial(
        fit_physics.encoder_positions, **cut))
    np.random.seed(0)
    jax_fp.main(["--task", "3bp_color", "--ckpt_dir", str(tmp_path / "jax"),
                 "--data_dir", DATA, "--write"])
    jax_out = capsys.readouterr().out
    np.random.seed(0)
    fitted = fit_physics.main([
        "--task", "3bp_color", "--ckpt_dir", str(port_copy), "--data_dir",
        DATA, "--write", "--device=cpu"])
    out = capsys.readouterr().out

    def fits(text):
        return [tuple(map(float, m)) for m in re.findall(
            r"(?:pointwise|trajectory) gravity fit: A=(?:g\*m\^2=)?(\S+) "
            r"\((?:residual rms|median traj err) (\S+)\)", text)]
    assert len(fits(out)) == 2
    np.testing.assert_allclose(fits(out), fits(jax_out), rtol=FIT_RTOL,
                               atol=FIT_ATOL)
    assert "wrote ['log_g'] + frame_offset into " in out
    assert set(fitted) == {"log_g", "frame_offset"}

    after = checkpoint.load_checkpoint(str(port_copy))
    changed = {n for n, t in after["model"].items()
               if not torch.equal(t, before["model"][n])}
    assert changed == {"log_g", "frame_offset"}
    assert {k: v for k, v in after.items() if k != "model"} == {
        k: v for k, v in before.items() if k != "model"}
    import orbax.checkpoint as ocp
    theirs = jax.device_get(ocp.PyTreeCheckpointer().restore(
        str(tmp_path / "jax" / "model.ckpt")))["params"]
    for name in changed:
        np.testing.assert_allclose(after["model"][name].numpy(),
                                   np.asarray(theirs[name]), rtol=FIT_RTOL,
                                   atol=POS_ATOL, err_msg=name)


@pytest.mark.parametrize("chain", sorted(rr.CHAINS))
def test_chain_stages_are_the_records(chain):
    """The curriculum: 1, 2, 3 active slots, each later stage from the one
    before, the first from the trunk, each stage's --epochs counting the
    chain's epochs through it; the surgery's flags; the pinned resume's
    1000 epochs with the background frozen; the test phases' flags their
    logs' headers less the directories. 3bp_chain_recons_warmup's
    curriculum stages add --recons_warmup and an --aux_warmup_epochs
    that counts the trunk's 1875 epochs (its step, 37500, at 20 steps an
    epoch) and the curriculum's 900, so the prediction term stays off to
    the curriculum's last step; nothing else differs, and its pinned stage
    (whose step the surgery restarts at 0) trains the prediction from its
    first step. 3bp_chain_pinned_gated's curriculum is
    3bp_chain_recons_warmup's, and its pinned stage adds --recons_warmup
    --aux_on_recons=3.0: the prediction off until a valid eval's recons
    fall under 3.0."""
    stages = rr.CHAINS[chain]["stages"]()
    warm = chain != "3bp_chain"
    gated = chain == "3bp_chain_pinned_gated"
    extra = ["--recons_warmup", "--aux_warmup_epochs=2775"] if warm else []
    pinned_extra = (["--recons_warmup", "--aux_on_recons=3.0"] if gated
                    else [])
    assert rr.PINNED_GATE_FLAGS == ["--recons_warmup", "--aux_on_recons=3.0"]
    assert [s["name"] for s in stages] == [
        "curriculum_1", "curriculum_2", "curriculum_3", "surgery", "pinned",
        "fit", "test", "test_refine"]
    assert [s["start"] for s in stages] == [
        rr.TRUNK, "curriculum_1", "curriculum_2", "curriculum_3", "surgery",
        "pinned", "fit", "fit"]
    parser = cli.build_parser()
    total = 0
    for slots, (stage, epochs) in enumerate(
            zip(stages[:3], rr.CURRICULUM_EPOCHS), 1):
        total += epochs
        args = parser.parse_args(stage["argv"])
        assert (args.task, args.base_lr, args.autoencoder_loss, args.color,
                args.learn_frame_offset, args.batch_size, args.active_slots,
                args.epochs, args.seed, args.bg_lr_mult, args.vel_anchor,
                args.recons_warmup, args.aux_on_recons) == (
            "3bp_color", 1e-3, 5.0, True, True, 100, slots, total, 0, 1.0,
            0.0, warm, 0.0)
        assert args.aux_warmup_epochs * 20 == (
            37500 + sum(rr.CURRICULUM_EPOCHS) * 20 if warm else 0)
        assert args.epochs % args.eval_every_n_epochs == 0
        assert stage["argv"] == rr.chain_stages()[slots - 1]["argv"] + extra
    pinned = parser.parse_args(stages[4]["argv"])
    assert (pinned.epochs, pinned.bg_lr_mult, pinned.active_slots,
            pinned.eval_every_n_epochs, pinned.recons_warmup,
            pinned.aux_warmup_epochs, pinned.aux_on_recons) == (
        1000, 0.0, 0, 10, gated, 0, 3.0 if gated else 0.0)
    assert stages[4]["argv"] == rr.chain_stages()[4]["argv"] + pinned_extra
    assert [s["argv"] for s in stages[3:] if s["name"] != "pinned"] == [
        s["argv"] for s in rr.chain_stages()[3:] if s["name"] != "pinned"]
    assert stages[3]["argv"] == ["--task=3bp_color", "--rescue_slot=all",
                                 "--disk_radius=3", "--set_background=median"]
    for stage in stages[6:]:
        header = rr.parse_log(os.path.join(REPO, stage["log"]))["header"]
        assert header[3:5] == ["--ckpt_dir=runs/3bp_fit_ckpt",
                               f"--save_dir={header[4][11:]}"]
        assert stage["argv"] == header[:3] + header[5:]
    assert stages[6]["argv"] == [
        "--task=3bp_color", "--test_mode", "--use_ckpt", "--batch_size=100",
        "--color", "--autoencoder_loss=5.0", "--learn_frame_offset",
        "--init_state_fit=3"]
    assert stages[7]["argv"] == stages[6]["argv"] + ["--refine_recons_pos=3"]
    assert rr.parse_log(os.path.join(REPO, stages[6]["log"]))["test"][
        "pred"] == pytest.approx(1.0559180974960327)


def _tiny_3bp(dst, n_train=8, n_eval=4):
    (dst / "3bp_color").mkdir(parents=True)
    for rel, n in zip(cli.TASK_TABLE["3bp_color"][:2], (n_train, n_eval)):
        with np.load(os.path.join(DATA, rel)) as d:
            np.savez(dst / rel, train_x=d["train_x"][:n],
                     valid_x=d["valid_x"][:n_eval],
                     test_x=d["test_x"][:n_eval])


class _Cut(Exception):
    pass


@pytest.mark.parametrize("chain", sorted(rr.CHAINS))
def test_chain_runs_cut_and_resumed_on_the_cpu(tmp_path, monkeypatch,
                                               no_new_handlers, chain):
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    data = tmp_path / "data"
    _tiny_3bp(data)
    monkeypatch.setattr(fit_physics, "encoder_positions", functools.partial(
        fit_physics.encoder_positions, n_batches=1, batch_size=8))
    stages = rr.CHAINS[chain]["stages"]((1, 1, 1), 2, batch_size=8,
                                        save_every=1, eval_every=1)
    save_dir = tmp_path / "chain"
    ran = []
    cli_call, echoed = rr._cli, rr._echoed

    def spy_cli(argv):
        ran.append(argv)
        if cut["at"] == "pinned" and f"--save_dir={save_dir}/pinned" in argv:
            raise rr._Terminated()
        return cli_call(argv)

    def spy_echoed(fn, argv, path):
        ran.append([fn.__module__] + argv)
        return echoed(fn, argv, path)

    save = Trainer.save

    def save_then_stop(self):
        save(self)
        if cut["at"] == "pinned_epoch" and self.save_dir.endswith("pinned"):
            raise rr._Terminated()

    monkeypatch.setattr(rr, "_cli", spy_cli)
    monkeypatch.setattr(rr, "_echoed", spy_echoed)
    monkeypatch.setattr(Trainer, "save", save_then_stop)

    def run():
        return rr.run_chain(chain, str(save_dir), "cpu", str(data),
                            stages=stages)

    cut = {"at": "pinned"}
    with pytest.raises(SystemExit):
        run()
    assert [stage_of(a) for a in ran] == [
        "curriculum_1", "curriculum_2", "curriculum_3", "surgery", "pinned"]
    assert not (save_dir / "pinned").exists()
    cut["at"], ran[:] = "pinned_epoch", []
    with pytest.raises(SystemExit):
        run()
    assert [stage_of(a) for a in ran] == ["pinned"]
    assert rr.resume_decision(str(save_dir / "pinned")) == "resume"
    assert rr._ckpt_scalar(str(save_dir / "pinned"), "total_epochs_done") == 1
    cut["at"], ran[:] = None, []
    out = run()
    assert [stage_of(a) for a in ran] == [
        "pinned", "fit", "test", "test_refine"]

    # The argv each stage ran.
    where = [f"--data_dir={data}", "--device=cpu"]
    pinned = str(save_dir / "pinned")
    assert ran[0] == stages[4]["argv"] + [
        "--use_ckpt", "--resume_remaining_epochs", f"--save_dir={pinned}",
        f"--ckpt_dir={pinned}"] + where
    assert ran[1][1:] == stages[5]["argv"] + [
        f"--ckpt_dir={save_dir / 'fit'}", f"--data_dir={data}",
        "--device=cpu"]
    for argv, stage in zip(ran[2:], stages[6:]):
        assert argv == stage["argv"] + [
            f"--ckpt_dir={save_dir / 'fit'}",
            f"--save_dir={save_dir / stage['name']}"] + where

    side = rr._read_sidecar(str(save_dir))
    assert side["run"] == chain and out["run"] == chain
    assert {n: [s["kind"] for s in segs]
            for n, segs in side["stages"].items()} == {
        "curriculum_1": ["fresh"], "curriculum_2": ["fresh"],
        "curriculum_3": ["fresh"], "surgery": ["fresh"],
        "pinned": ["fresh", "fresh", "resume"], "fit": ["fresh"],
        "test": ["fresh"], "test_refine": ["fresh"]}
    assert side["steps"] == {"curriculum_1": 1, "curriculum_2": 1,
                             "curriculum_3": 1, "pinned": 2}

    # Each stage's files; the curriculum's step, optimizer and gate.
    for name in ("curriculum_1", "curriculum_2", "curriculum_3", "pinned"):
        for f in ("log.txt", "model.ckpt", "outputs.npz"):
            assert (save_dir / name / f).exists(), (name, f)
    # The velocity head read at each training stage's start and after each
    # save (the pinned stage's first save was cut before its reading, and
    # the resumed stage did not read its start again), and its last reading
    # in the compare line.
    for name, epochs in (("curriculum_1", [0, 1]), ("curriculum_2", [0, 1]),
                         ("curriculum_3", [0, 1]), ("pinned", [0, 2])):
        records = rr._velocity_records(str(save_dir / name))
        assert [r["epoch"] for r in records] == epochs, name
        assert out["stages"][name]["velocity"] == records[-1]
        assert len(records[-1]["velocities"]) == 3
        assert all(np.isfinite(records[-1][k]) for k in (
            "spread", "speed_p95", "grad_norm", "vel_grad_norm", "pred",
            "recons"))
    assert rr._velocity_records(str(save_dir / "curriculum_1"))[0][
        "step"] == 37500
    for i in (1, 2, 3):
        ckpt = checkpoint.load_checkpoint(str(save_dir / f"curriculum_{i}"))
        # The trunk's step carried on (the LR schedule's position).
        assert (ckpt["step"], ckpt["total_epochs_done"]) == (37500 + i, i)
        assert ckpt["optimizer"]["state"]
        header = rr.parse_log(str(save_dir / f"curriculum_{i}" / "log.txt"))[
            "header"]
        assert f"--active_slots={i}" in header
    assert (save_dir / "surgery" / "slot_rescue.txt").read_text().count(
        "rescuing slot ") == 3
    assert set(checkpoint.load_checkpoint(str(save_dir / "surgery"))) == {
        "model", "step"}
    pinned_log = rr.parse_log(str(save_dir / "pinned" / "log.txt"))
    assert sorted(pinned_log["valid"]) == [0, 1, 2]
    assert pinned_log["segments"] == 2 and pinned_log["test_epoch"] == 0
    with open(save_dir / "fit" / rr.FIT_JSON) as f:
        fit = json.load(f)
    written = checkpoint.load_checkpoint(str(save_dir / "fit"))["model"]
    assert np.exp(float(written["log_g"])) == pytest.approx(fit["A"],
                                                            rel=1e-6)
    # The trajectory fit's median error, as fit_physics printed it.
    printed = (save_dir / "fit" / "fit_physics.txt").read_text()
    assert f"(median traj err {fit['A_traj_err']:.3f})" in printed
    assert out["stages"]["fit"]["A_traj_err"] == fit["A_traj_err"]
    for name in ("test", "test_refine"):
        assert rr.resume_decision(str(save_dir / name)) == "done"
        assert out["stages"][name]["test"] is not None
        # The state fit's reading of the test phase's start, on its first
        # batch of test sequences, with the fit's A.
        with open(save_dir / name / rr.TEST_STATE_JSON) as f:
            state = json.load(f)
        assert out["stages"][name]["test_state"] == state
        assert len(state["accepted"]) == 4
        assert state["accepted_share"] == np.mean(state["accepted"])
        assert 0 <= state["accepted_share"] <= 1
        assert state["A"] == pytest.approx(fit["A"], rel=1e-6)
        assert all(np.isfinite(state[k]) for k in (
            "head_speed", "head_speed_p95", "pred", "recons"))

    # A finished chain runs nothing again, and goes on at no other seed;
    # a test phase without its state reading is run again.
    ran[:] = []
    again = run()
    assert ran == [] and again["stages"] == out["stages"]
    os.remove(save_dir / "test_refine" / rr.TEST_STATE_JSON)
    again = run()
    assert [stage_of(a) for a in ran] == ["test_refine"]
    assert again["stages"]["test_refine"]["test_state"] == out["stages"][
        "test_refine"]["test_state"]
    ran[:] = []
    with pytest.raises(SystemExit, match="ran at seed 0; refusing to go on "
                                         "at seed 1"):
        rr.run_chain(chain, str(save_dir), "cpu", str(data), seed=1,
                     stages=stages)
    assert ran == []


def test_chain_raises_without_a_card(monkeypatch, tmp_path):
    """No CUDA device: the chain refuses unless --device=cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        rr.main(["--run", "3bp_chain", "--save_dir", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


def stage_of(argv):
    """The stage a recorded call ran: its --save_dir's or --out_dir's or
    --ckpt_dir's last part (the fit runs in its own directory)."""
    for prefix in ("--save_dir=", "--out_dir="):
        for a in argv:
            if a.startswith(prefix):
                return os.path.basename(a[len(prefix):])
    return next(os.path.basename(a[len("--ckpt_dir="):]) for a in argv
                if a.startswith("--ckpt_dir="))
