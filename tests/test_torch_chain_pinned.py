"""3bp_color's tracked ``curriculum_3`` checkpoint
(``reference_runs.CURRICULUM_3``) and the pinned stage from it, in both
packages on the CPU:

* the checkpoint holds the model and step of ``3bp_chain``'s
  ``curriculum_3`` and nothing more, loads in both packages and restores
  into a 3bp_color model of each: every parameter of the port's model,
  every leaf of the JAX package's at its shape, and the same losses in
  float64 on 4 valid sequences;
* the chain's all-slot surgery on it (``SURGERY_FLAGS``), by the port's
  ``slot_rescue`` and the JAX package's ``tools/slot_rescue.py``: the same
  printed template masses and salience, the same slots picked by
  ``--rescue_slot=auto`` (all three: every salience lies under
  ``select_dead_slots``' 0.1, so ``auto`` is ``all`` on this state), and
  every written parameter within 1e-6;
* the pinned stage's train step from the surgery's output, 10 steps at
  B=8 on the same batches: after every step the port's parameters lie
  nearer JAX's (L2 distance) than JAX's own do when its start moves by
  +-1e-7 (0.0002 against 0.0180 after step 1, 0.0046 against 1.2310
  after step 4, 4.0033 against 5.0928 after step 10, CPU), and its train
  loss (float64, one evaluator) as long as those JAX runs agree within
  1e-2 and one step beyond (steps 1-5: 6.9e-08 against 6.4e-06 after
  step 1, 2.2e-03 against 1.8e-01 after step 5). From step 5 on the
  post-surgery descent amplifies a 1e-7 nudge into a different loss
  (JAX's runs part by 0.18), and one run's loss is a draw from a spread:
  ``tests/chain_pinned_study.py --ensemble`` steps 17 starts of each
  package and finds their losses' distributions alike (PERF.md §6);
* ``curriculum_probes --stage pinned --curriculum_dir``: 3bp_chain's
  surgery and pinned stage alone, from the given checkpoint, run tiny.
"""
import contextlib
import importlib.util
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

import chain_pinned as cpn
from chain_state_study import _frames, losses_both, port_to_flax
from paig_reproduction_tpu.train import surgery as jax_surgery
from paig_reproduction_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import (
    flax_checkpoint_to_port,
    flax_to_state_dict,
)
from paig_reproduction_tpu_torch.tools import curriculum_probes as cp
from paig_reproduction_tpu_torch.tools import reference_runs as rr
from paig_reproduction_tpu_torch.tools import slot_rescue
from paig_reproduction_tpu_torch.train import checkpoint, surgery

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The chain's step at curriculum_3's end: the trunk's 37500 and 900
# epochs of 20 steps.
CURRICULUM_3_STEP = 37500 + sum(rr.CURRICULUM_EPOCHS) * 20
# The file's bytes over its parameters' float32 bytes: torch.save's
# container and the names (an optimizer's state would double it).
CONTAINER_OVERHEAD = 1.05
LOSS_RTOL = 1e-9
PARAM_ATOL = 1e-6
STEPS, BATCH, POOL = 10, 8, 64
PERTURBATION = 1e-7
# The train losses are compared while JAX's runs moved by +-1e-7 stay
# within this of JAX's own (the losses' tolerance of the recipe drift
# test); from there on a run's loss is one draw from a spread, and at
# least MIN_WINDOW steps must have been compared.
LOSS_WINDOW = 1e-2
MIN_WINDOW = 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    return checkpoint.load_checkpoint(rr.CURRICULUM_3)


@pytest.fixture(scope="module")
def surgeries(tmp_path_factory, state):
    """Both tools with SURGERY_FLAGS on the tracked state (the JAX tool on
    its conversion, written by the JAX package's ``save_checkpoint``):
    the directory holding ``port/`` and ``jax/``, and each tool's printed
    lines but the last."""
    d = tmp_path_factory.mktemp("surgery")
    src = d / "jax_src"
    jax_save_checkpoint(str(src), {"params": port_to_flax(state["model"]),
                                   "step": np.asarray(state["step"])})
    spec = importlib.util.spec_from_file_location(
        "jax_slot_rescue", os.path.join(REPO, "tools", "slot_rescue.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    lines = {}
    for side, main, ckpt in (("jax", jax_tool.main, src),
                             ("port", slot_rescue.main, rr.CURRICULUM_3)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([f"--ckpt_dir={ckpt}", f"--out_dir={d / side}",
                  "--task=3bp_color", f"--data_dir={rr.TRACKED_DATA}",
                  *rr.SURGERY_FLAGS])
        lines[side] = buf.getvalue().splitlines()[:-1]
    return d, lines


def test_curriculum_3_restores_in_both_packages(state):
    path = os.path.join(rr.CURRICULUM_3, checkpoint.CKPT_NAME)
    floats = sum(4 * v.numel() for v in state["model"].values())
    assert floats < os.path.getsize(path) <= CONTAINER_OVERHEAD * floats
    assert set(state) == {"model", "step"}
    assert state["step"] == CURRICULUM_3_STEP
    args = cli.build_parser().parse_args(cpn.pinned_argv()
                                         + ["--device=cpu"])
    model = cli.build_model(args, 20)
    model.load_state_dict(state["model"], strict=True)
    # The JAX model's every leaf, at its shape and type.
    jax_params = cpn.jax_params(rr.CURRICULUM_3, cpn.jax_model())
    assert {k: v.shape for k, v in flax_to_state_dict(jax_params).items()} \
        == {k: v.shape for k, v in state["model"].items()}
    x = _frames(cli.TASK_TABLE["3bp_color"][0], "valid_x", 4)
    ours, theirs = losses_both(state["model"], cpn.pinned_argv(), x)
    print(f"curriculum_3 on 4 valid sequences (float64): train_loss port "
          f"{ours[0]:.9f}, JAX {theirs[0]:.9f}; valid recons "
          f"{ours[1]['eval_recons_loss']:.9f}")
    np.testing.assert_allclose(ours[0], theirs[0], rtol=LOSS_RTOL)
    for k, v in theirs[1].items():
        np.testing.assert_allclose(ours[1][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    assert np.isfinite(ours[0])


def test_surgery_on_curriculum_3_matches_jax(surgeries, state):
    d, lines = surgeries
    assert lines["port"] == lines["jax"]
    assert lines["port"][0].startswith("slot template mask mass (px): ")
    assert lines["port"][1].startswith("slot content salience ")
    assert [line for line in lines["port"] if line.startswith("rescuing")] \
        == [f"rescuing slot {i}: disk r=3.0, content [0.5, 0.5, 0.5]"
            for i in range(3)]

    # --rescue_slot=auto's choice on this state, each package's own.
    with np.load(cpn.SL20) as f:
        frames = f["train_x"]
    port_params = {k: v.numpy() for k, v in state["model"].items()}
    flax_params = port_to_flax(state["model"])
    picked = {}
    for name, lib, params in (("port", surgery, port_params),
                              ("jax", jax_surgery, flax_params)):
        bg = lib.median_background(frames)
        health = lib.slot_health(params, 3, 18)
        salience = lib.slot_salience(params, 3, 18, 3, bg)
        picked[name] = [int(s) for s in lib.select_dead_slots(
            health, tmpl_px=18 * 18, salience=salience)]
        assert max(salience) < 0.1
        print(f"{name}: masses {np.round(health, 1).tolist()}, salience "
              f"{np.round(salience, 3).tolist()}, auto picks "
              f"{picked[name]}")
    assert picked["port"] == picked["jax"] == [0, 1, 2]

    ours = checkpoint.load_checkpoint(str(d / "port"))
    import orbax.checkpoint as ocp
    theirs = flax_checkpoint_to_port(jax.device_get(
        ocp.PyTreeCheckpointer().restore(str(d / "jax" / "model.ckpt"))))
    assert set(ours) == {"model", "step"} and ours["step"] == 0
    assert theirs["step"] == 0 and not theirs["optimizer"]["state"]
    assert set(ours["model"]) == set(theirs["model"])
    moved = 0
    for name, t in ours["model"].items():
        assert t.dtype == torch.float32, name
        np.testing.assert_allclose(t.numpy(), theirs["model"][name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        moved += not torch.equal(t, state["model"][name])
    assert moved > 0


def _largest_gap(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _l2_gap(a, b):
    return float(np.sqrt(sum(np.sum((a[k].astype(np.float64) - b[k]) ** 2)
                             for k in a)))


def test_pinned_steps_part_no_further_than_jax_from_itself(surgeries,
                                                           tmp_path):
    path = tmp_path / "3bp.npz"
    with np.load(cpn.SL20) as f:
        np.savez(path, train_x=f["train_x"][:POOL], valid_x=f["valid_x"][:8],
                 test_x=f["test_x"][:8])
    args = cli.build_parser().parse_args(cpn.pinned_argv()
                                         + ["--device=cpu"])
    net = cli.build_model(args, 20)
    nudges = (0.0, PERTURBATION, -PERTURBATION)
    window = 0
    for step, (ports, (ref, *others), x) in enumerate(cpn.nudged_steps(
            str(surgeries[0] / "port"), path, (0.0,), nudges, STEPS,
            BATCH), 1):
        port_l2 = _l2_gap(ports[0], ref)
        jax_l2 = max(_l2_gap(o, ref) for o in others)
        line = (f"step {step}: parameters' L2 distance from JAX, port "
                f"{port_l2:.4f}, JAX moved by +-{PERTURBATION:g} "
                f"{jax_l2:.4f}")
        if window == step - 1:
            losses = cpn.loss64(net, [ref, ports[0], *others], x[:8])
            port_loss = abs(losses[1] - losses[0]) / losses[0]
            jax_loss = max(abs(v - losses[0]) for v in losses[2:]) / losses[0]
            line += (f"; train loss (float64, one evaluator) from JAX's, "
                     f"port {port_loss:.3e}, JAX moved {jax_loss:.3e}")
            assert port_loss <= jax_loss, line
            if jax_loss <= LOSS_WINDOW:
                window = step
        print(line)
        assert 0 < port_l2 <= jax_l2, line
    largest = max(float(np.abs(v).max()) for v in ref.values())
    print(f"after {STEPS} steps: the largest difference from JAX, port "
          f"{_largest_gap(ports[0], ref) / largest:.3e}, JAX moved "
          f"{max(_largest_gap(o, ref) for o in others) / largest:.3e} of "
          f"the largest parameter; losses compared through step {window}")
    assert window >= MIN_WINDOW


def test_pinned_probe_runs_from_a_curriculum_dir(tmp_path, monkeypatch):
    """``--curriculum_dir``: 3bp_chain's surgery (reading the given
    directory) and pinned stage alone, their flags the chain's; run
    tiny (B=8, 2 pinned epochs) on the CPU from the tracked state, it
    runs no curriculum, prints its valid recons every RECONS_EVERY
    epochs, and a second call runs nothing again."""
    import logging

    from test_torch_chain import _tiny_3bp
    chain = rr.CHAINS[cp.PINNED_FROM_STATE]["stages"]()
    stages = cp.pinned_stages([], start=rr.CURRICULUM_3)
    assert [s["name"] for s in stages] == ["surgery", "pinned"]
    assert stages[0] == dict(chain[3], start=rr.CURRICULUM_3)
    assert stages[1] == chain[4]
    assert cp.pinned_stages(["--vel_anchor=1.0"], start="x")[1]["argv"] \
        == chain[4]["argv"] + ["--vel_anchor=1.0"]

    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setattr(cp, "RECONS_EVERY", 1)
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    data, save_dir = str(tmp_path / "d"), str(tmp_path / "p")
    _tiny_3bp(tmp_path / "d")
    kw = dict(pinned=2, batch_size=8, save_every=1, eval_every=1)
    try:
        out = cp.run_pinned_probes(save_dir, "", ["control"], "cpu", data,
                                   seed=1, curriculum_dir=rr.CURRICULUM_3,
                                   **kw)
        assert sorted(os.listdir(os.path.join(save_dir, "control"))) == [
            "pinned", rr.SIDECAR, "surgery"]
        probe = out["probes"]["control"]
        assert list(probe["recons_every"]) == [0, 1, 2]
        assert probe["launches"] == 0 and probe["wall_s"] > 0
        assert tuple(probe["first_lr"]) == (1e-3, 0, 0)
        side = rr._read_sidecar(os.path.join(save_dir, "control"))
        assert side["seed"] == 1 and side["run"] == cp.PINNED_FROM_STATE
        header = rr.parse_log(os.path.join(save_dir, "control", "pinned",
                                           "log.txt"))["header"]
        assert "--seed=1" in header and "--bg_lr_mult=0" in header
        with open(os.path.join(save_dir, "pinned_probes.json")) as f:
            assert json.load(f) == json.loads(json.dumps(out))
        again = cp.run_pinned_probes(save_dir, "", ["control"], "cpu", data,
                                     seed=1, curriculum_dir=rr.CURRICULUM_3,
                                     **kw)
        assert json.loads(json.dumps(again)) == json.loads(json.dumps(out))
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)


def test_smoke_pinned_check_runs_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.pinned_card_vs_cpu`` on the CPU (B=4 on a tiny split):
    the surgery, then the fused chunk (the step body called directly)
    against the eager steps, bitwise equal, no decoder launch; a planted
    fault on the first trainer's side, a negated or a skipped gradient,
    fails it on the updates alone (the losses' check off), and a launch
    count other than the expected one fails it too."""
    import chip_smoke
    from test_torch_chain import _tiny_3bp
    _tiny_3bp(tmp_path / "d")
    out = chip_smoke.pinned_card_vs_cpu(4, str(tmp_path / "d"), "cpu")
    assert out["rel"] == out["loss_rel"] == 0.0 and out["launches"] == 0

    make, tolerance = chip_smoke.make_trainer, chip_smoke.PINNED_UPDATE_RTOL
    monkeypatch.setattr(chip_smoke, "PINNED_LOSS_RTOL", float("inf"))
    for fault in (torch.neg, torch.zeros_like):
        made = []

        def faulty(*a, **kw):
            trainer = make(*a, **kw)
            if len(made) % 2 == 0:   # each call's first: the card's
                for p in trainer.model.parameters():
                    p.register_hook(fault)
            made.append(trainer)
            return trainer

        monkeypatch.setattr(chip_smoke, "make_trainer", faulty)
        with pytest.raises(AssertionError, match="disagree"):
            chip_smoke.pinned_card_vs_cpu(4, str(tmp_path / "d"), "cpu")
        monkeypatch.setattr(chip_smoke, "PINNED_UPDATE_RTOL", float("inf"))
        # A skipped gradient leaves the parameters at the start: 1; a
        # negated one moves them the other way: about 2.
        got = chip_smoke.pinned_card_vs_cpu(4, str(tmp_path / "d"), "cpu")
        print(f"{fault.__name__}: the updates' difference {got['rel']:.4f}")
        assert got["rel"] >= 1.0 > tolerance, fault
        monkeypatch.setattr(chip_smoke, "PINNED_UPDATE_RTOL", tolerance)

    monkeypatch.setattr(chip_smoke, "make_trainer", make)
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder
    monkeypatch.setattr(st_decoder, "LAUNCHES", 0)
    fused_env = chip_smoke.fused_env

    @contextlib.contextmanager
    def one_launch(value):
        with fused_env(value):
            yield
        st_decoder.LAUNCHES += 1

    monkeypatch.setattr(chip_smoke, "fused_env", one_launch)
    with pytest.raises(AssertionError, match="1 decoder launches"):
        chip_smoke.pinned_card_vs_cpu(4, str(tmp_path / "d"), "cpu")


def test_pinned_steps_match_jax_in_float64(surgeries, tmp_path):
    """The pinned stage's step in float64 from the surgery's output, 3
    steps at B=4 in both packages: the same losses (1e-12) and parameters
    (5.9e-14 of the largest, CPU): the two packages run one function,
    which float32 rounding alone parts and the descent then amplifies."""
    import jax.numpy as jnp
    start = str(surgeries[0] / "port")
    path = tmp_path / "3bp.npz"
    with np.load(cpn.SL20) as f:
        np.savez(path, train_x=f["train_x"][:8], valid_x=f["valid_x"][:4],
                 test_x=f["test_x"][:4])
    trainer = cpn.port_trainer(start, tmp_path / "run", path)
    trainer.model.double()
    x = trainer.train_iterator.X.astype(np.float64)
    model = cpn.jax_model()
    params = cpn.jax_params(start, model)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        start_state = {k: v.clone() for k, v in
                       trainer.model.state_dict().items()}
        tx, step = cpn.jax_step_fn(model, params, jnp.float32)
        opt_state = tx.init(params)

        rs = np.random.RandomState(0)
        for _ in range(3):
            idx = rs.choice(8, 4, replace=False)
            params, opt_state, total, ev = step(params, opt_state,
                                                jnp.asarray(x[idx]))
            trainer._fill_scalars(trainer.step)
            losses = trainer._step(torch.from_numpy(x[idx]))
            trainer.step += 1
            np.testing.assert_allclose(
                [float(losses[3]), float(losses[0]), float(losses[2])],
                [float(total), float(ev["eval_pred_loss"]),
                 float(ev["eval_recons_loss"])], rtol=1e-12)
        want = flax_to_state_dict(jax.device_get(params))
    got = trainer.model.state_dict()
    largest = max(float(v.abs().max()) for v in want.values())
    worst = max(float((got[k].reshape(-1) - v.reshape(-1).double())
                      .abs().max()) for k, v in want.items()) / largest
    print(f"3 pinned steps in float64: parameters' largest difference "
          f"{worst:.3e} of the largest")
    assert worst <= 1e-8
    # The background is frozen; on this state the velocity head and
    # gravity get no gradient in either package either: the head, flung
    # since curriculum_1, starts every rollout out of the frame.
    still = [n for n in want if n.startswith(("var_net_background.",
                                              "velocity_encoder.", "log_g"))]
    assert len(still) == 11 and all(
        torch.equal(got[n], start_state[n]) for n in still)
    assert sum(not torch.equal(got[n], start_state[n]) for n in want) > 10
