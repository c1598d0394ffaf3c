"""The port's single-command recipes (``train/recipes.py`` and the trainer's
hooks): a tiny CPU drive of the recipe CLI with every hook firing and a
resume; the discovery arms' weights and selection; and the stall guard,
the rendered offsets and the physics self-identification against the JAX
package's ``RecipeMixin`` methods on the same weights and batches.

Tolerances: the rendered offsets within 1e-3 px and the installed physics
within 1e-4 relative (f32 forwards in another summation order, then the
same numpy fit); the stall guard's decisions exactly.
"""
import inspect
import logging
import os
import re
import types

import jax
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.train import recipes as jax_recipes
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.models import PhysicsNet
from paig_reproduction_tpu_torch.tools import reference_runs
from paig_reproduction_tpu_torch.train import recipes
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "datasets", "spring_color")
SL12 = "color_spring_vx8_vy8_sl12_r2_k4_e6.npz"
SL30 = "color_spring_vx8_vy8_sl30_r2_k4_e6.npz"
SPRING500 = os.path.join(REPO, "runs", "spring500", "model.ckpt")
KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
          input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
          input_size=32 * 32)
RECIPE = ["--task=spring_color", "--base_lr=6e-4", "--autoencoder_loss=3.0",
          "--color", "--batch_size=4", "--print_interval=1",
          "--discovery_restarts=2", "--discovery_epochs=1",
          "--discovery_recons_ok=4.0", "--aux_on_recons=1e9",
          "--fit_physics_every=1", "--auto_rescue=2", "--rescue_recons=0",
          "--max_rescues=1", "--eval_every_n_epochs=1",
          "--pos_consistency=1.0", "--vel_anchor=1.0", "--learn_frame_offset",
          "--init_state_fit=3", "--refine_recons_pos=2",
          "--enhancers_eval_only", "--save_every_n_epochs=1",
          "--device=cpu"]


@pytest.fixture
def paig_log(caplog):
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    caplog.set_level(logging.INFO, logger="paig")
    yield caplog
    for h in set(logger.handlers) - set(handlers):
        logger.removeHandler(h)
        h.close()


def _tiny_data(dst, n_train=16, n_eval=4):
    (dst / "spring_color").mkdir(parents=True, exist_ok=True)
    for name in (SL12, SL30):
        with np.load(os.path.join(DATA, name)) as d:
            np.savez(dst / "spring_color" / name,
                     train_x=d["train_x"][:n_train],
                     valid_x=d["valid_x"][:n_eval],
                     test_x=d["test_x"][:n_eval])


def test_recipe_cli_runs_every_hook_and_resumes(tmp_path, paig_log,
                                                monkeypatch):
    """The spring recipe's flags at a tiny size: both arms run and one is
    kept, the aux trigger fires, the physics fit runs and is accepted, one
    rescue fires, every loss is finite, the seq-30 phase keeps the
    enhancers; a resume brings the rescue and trigger state back and skips
    the arms."""
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    _tiny_data(tmp_path)
    save_dir = tmp_path / "run"
    argv = RECIPE + [f"--data_dir={tmp_path}", f"--save_dir={save_dir}"]
    trainer, test_trainer = cli.main(argv + ["--epochs=4"])
    log = (save_dir / "log.txt").read_text()
    for needle in ("discovery restart arm 1/2: valid recons",
                   "discovery restart arm 2/2: valid recons",
                   "discovery restarts: continuing from arm",
                   "aux_on_recons trigger: valid recons",
                   "fit_physics: k=",
                   "fit_physics: first accepted fit",
                   "auto_rescue: epoch"):
        assert needle in log, needle
    losses = [float(v) for line in log.splitlines()
              for v in re.findall(r"_loss=(\S+)", line)]
    assert losses and np.isfinite(losses).all()
    assert "test - epoch=0 " in log
    # The kept arm's 4 steps, then the loop's 3 epochs of 4.
    assert trainer.step == 4 * 4
    assert trainer._rescue_count == 1 and trainer._aux_triggered
    assert trainer.train_net.init_state_fit == 0
    assert test_trainer.model.init_state_fit == 3
    assert test_trainer.model.refine_recons_pos == 2

    paig_log.clear()
    resumed, _ = cli.main(argv + ["--epochs=1", "--use_ckpt"])
    messages = [r.getMessage() for r in paig_log.records]
    assert "discovery_restarts ignored: resuming from a checkpoint" in \
        messages
    assert not any("discovery restart arm" in m for m in messages)
    assert any(m.startswith("aux_on_recons trigger restored") for m in
               messages)
    assert resumed._rescue_count == 1
    assert resumed._rescue_step == trainer._rescue_step
    assert resumed._aux_triggered
    assert resumed.aux_warmup_steps == trainer.aux_warmup_steps
    assert resumed.step == trainer.step + 4


# A recipe run whose every valid eval is stalled (an LR of 1e-9 keeps the
# recons flat), so that a rescue fires at each segment's first loop epoch.
RESCUE_RUN = ["--task=spring_color", "--batch_size=8", "--base_lr=1e-9",
              "--autoencoder_loss=3.0", "--color", "--discovery_restarts=1",
              "--discovery_epochs=1", "--auto_rescue=1", "--rescue_recons=0",
              "--max_rescues=2", "--eval_every_n_epochs=1",
              "--save_every_n_epochs=1"]


# The logged recipe events: an arm scored after its epochs, the arm kept,
# a rescue's loop epoch, a resume's epochs done and epochs to train.
_EVENTS = {
    "arm": re.compile(r"discovery restart arm (\d+)/\d+: valid recons \S+ "
                      r"after (\d+) epochs"),
    "kept": re.compile(r"discovery restarts: continuing from arm (\d+)"),
    "rescue": re.compile(r"auto_rescue: epoch (\d+) "),
    "resume": re.compile(r"checkpoint chain has (\d+) epochs done, "
                         r"training (\d+) more")}


def _events(messages):
    return [(kind, tuple(int(v) for v in hit.groups()))
            for m in messages for kind, pattern in _EVENTS.items()
            for hit in [pattern.search(m)] if hit]


def test_resumed_rescue_schedule_matches_jax(tmp_path, paig_log,
                                             monkeypatch):
    """RESCUE_RUN at --epochs=2 (the arm's epoch, then one loop epoch), then
    resumed with --epochs=4 --use_ckpt --resume_remaining_epochs, through
    both packages' CLIs on the same files. Every LR schedule that either
    builds (build_optimizer's, the arm's, each rescue's) is recorded with
    the schedule position each optimizer step reads (the port's
    ``_lr_at`` argument; the JAX optimizer's count, seen by a
    ``jax.debug.callback`` in the compiled step): at every step of both
    CLI runs the two packages use a schedule of the same horizon, steps an
    epoch and anneal at the same position, and the same LR within float32
    rounding. The JAX package reuses build_optimizer's schedule for its
    arms where the port builds one of the same arguments. Each rescue
    rebuilds the same schedule in both, the resumed one over 4 less the
    loop epoch it fires at, as the JAX trainer sizes it; the arms, the
    arm kept, the rescues and the resume fall at the same epochs. The
    resumed run's length is the one deliberate departure
    (``cli.epochs_to_train``): the port counts the arm's epoch among the
    chain's, the JAX CLI does not, and trains one epoch more."""
    from paig_reproduction_tpu import cli as jax_cli
    from paig_reproduction_tpu.train import optimizers as jax_opt
    from paig_reproduction_tpu_torch.train import optimizers as opt

    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setenv("PAIG_COMPILE_CACHE", "0")
    _tiny_data(tmp_path, n_eval=8)
    made, used, events = {}, {}, {}
    for name, main, lib, extra in (("port", cli.main, opt, ["--device=cpu"]),
                                   ("jax", jax_cli.main, jax_opt, [])):
        built = made[name] = []     # (args, schedule, built by a rescue)
        steps = used[name] = []     # per CLI run: (schedule, position)

        def record(*args, make=lib.lr_schedule, built=built, steps=steps,
                   name=name):
            fn, i = make(*args), len(built)
            built.append((args, fn, any(f.function == "_do_auto_rescue"
                                        for f in inspect.stack(0))))
            if name == "port":
                return lambda step: steps[-1].append((i, step)) or fn(step)

            def traced(count):
                jax.debug.callback(
                    lambda c: steps[-1].append((i, int(c))), count)
                return fn(count)
            return traced

        monkeypatch.setattr(lib, "lr_schedule", record)
        argv = RESCUE_RUN + extra + [f"--data_dir={tmp_path}",
                                     f"--save_dir={tmp_path / name}"]
        for more in (["--epochs=2"], ["--epochs=4", "--use_ckpt",
                                      "--resume_remaining_epochs"]):
            steps.append([])
            main(argv + more)
        events[name] = _events(r.getMessage() for r in paig_log.records)
        paig_log.clear()

    def per_step(name):
        """Each CLI run's optimizer steps: (schedule arguments, position,
        LR). The JAX optimizer reads its schedule once per branch of the
        update (the frozen background's too): consecutive repeats are one
        step."""
        runs = []
        for run in used[name]:
            run = [p for k, p in enumerate(run) if k == 0 or p != run[k - 1]]
            runs.append([(made[name][i][0], pos, float(made[name][i][1](pos)))
                         for i, pos in run])
        return runs

    port, ref = per_step("port"), per_step("jax")
    assert [a for a, _, rescue in made["port"] if rescue] == [
        a for a, _, rescue in made["jax"] if rescue] == [
        (1e-9, 1, 2, True), (1e-9, 3, 2, True)]
    # Call by call (the port's repeats for its arms dropped): the same
    # arguments in the same order, and the same LR at every position of
    # each schedule's horizon and past it. Each CLI's seq-30 phase builds
    # one over 0 epochs.
    distinct = {}
    for name in made:
        distinct[name] = []
        for args, fn, _ in made[name]:
            if not distinct[name] or distinct[name][-1][0] != args:
                distinct[name].append((args, fn))
    assert [a for a, _ in distinct["port"]] == [
        a for a, _ in distinct["jax"]] == [
        (1e-9, 2, 2, True), (1e-9, 1, 2, True), (1e-9, 0, 1, True),
        (1e-9, 4, 2, True), (1e-9, 3, 2, True), (1e-9, 0, 1, True)]
    for (args, lr), (_, ref_lr) in zip(distinct["port"], distinct["jax"]):
        steps = range(args[1] * args[2] + 2)
        assert [lr(s) for s in steps] == pytest.approx(
            [float(ref_lr(s)) for s in steps], rel=1e-7)
    # Step by step. The first run: the arm's 2 steps, then the loop
    # epoch's 2 on the kept arm's optimizer, annealed from position 2
    # (int(0.75 * 2) epochs of 2 steps). The resumed run: 2 steps on
    # build_optimizer's schedule from the rescue's position 0, then the
    # rescue's schedule over the epochs left; the port trains 2 epochs in
    # all, the JAX CLI 3.
    assert [len(r) for r in port] == [4, 4]
    assert [len(r) for r in ref] == [4, 6]
    for got, want in zip(port, ref):
        assert [(a, p) for a, p, _ in got] == [
            (a, p) for a, p, _ in want[:len(got)]]
        assert [lr for _, _, lr in got] == pytest.approx(
            [lr for _, _, lr in want[:len(got)]], rel=1e-7)
    assert [(a[1], p, lr) for a, p, lr in port[0] + port[1]] == [
        (2, 0, 1e-9), (2, 1, 1e-9), (2, 2, 2e-10), (2, 3, 2e-10),
        (4, 0, 1e-9), (4, 1, 1e-9), (3, 0, 1e-9), (3, 1, 1e-9)]
    # The events at the same epochs; the port's resume counts the arm's
    # epoch among those done.
    common = [("arm", (1, 1)), ("kept", (0,)), ("rescue", (1,))]
    assert events["port"] == common + [("resume", (2, 2)), ("rescue", (1,))]
    assert events["jax"] == common + [("resume", (1, 3)), ("rescue", (1,))]


def _trainer(tmp_path, **fields):
    _tiny_data(tmp_path)
    model = PhysicsNet(**KW, **fields)
    trainer = Trainer(model, device="cpu", seed=3)
    trainer.get_data(iterators.get_iterators(
        str(tmp_path / "spring_color" / SL12), conv=True))
    trainer.build_optimizer(6e-4, "rmsprop", True, epochs=4,
                            steps_per_epoch=4)
    trainer.save_dir = str(tmp_path / "run")
    os.makedirs(trainer.save_dir, exist_ok=True)
    return trainer


def test_discovery_arms(tmp_path, paig_log, monkeypatch):
    """Each arm starts from the JAX package's weights of that arm (its
    ``model.init`` at ``PRNGKey(seed)`` for arm 0, at ``fold_in(PRNGKey(seed),
    arm)`` for the others), bit for bit; a NaN arm never wins; the iterator
    is rewound."""
    trainer = _trainer(tmp_path)
    x = np.zeros((1, 12, 3, 32, 32), np.float32)
    jax_model = JaxPhysicsNet(**KW)
    jax_starts = [flax_to_state_dict(jax.device_get(jax.jit(jax_model.init)(
        jax.random.PRNGKey(3) if arm == 0 else jax.random.fold_in(
            jax.random.PRNGKey(3), arm), x)["params"])) for arm in range(3)]
    plain = jax_starts[0]
    starts = []
    monkeypatch.setattr(trainer, "_train_epochs_raw", lambda *a: starts.append(
        {k: v.clone() for k, v in trainer.model.state_dict().items()}))
    scores = iter([float("nan"), 7.0, 9.0])
    monkeypatch.setattr(trainer, "_quick_valid_recons",
                        lambda *a: next(scores))
    assert trainer.run_discovery_restarts(4, 3, 1)[1:] == [7.0, 9.0]
    for arm, want in enumerate(jax_starts):
        for k, v in want.items():
            assert torch.equal(starts[arm][k], v.reshape(
                starts[arm][k].shape)), (arm, k)
    assert not torch.equal(starts[1]["encoder.dense.0.weight"],
                           starts[0]["encoder.dense.0.weight"])
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, starts[1][k]), k
    assert trainer.train_iterator.epochs_completed == 0
    assert "continuing from arm 1 (valid recons 7.000" in paig_log.text


def _log_rescue_case():
    """benchmarks/spring_one5_test_log.txt's valid curve up to its decisive
    rescue at loop epoch 250 (--auto_rescue=250), parsed: (the evals
    before it, 250, its recons there, 250). The log's run began before the
    JAX package had its stall guard."""
    valid = reference_runs.parse_log(
        reference_runs.log_path("spring_one5"))["valid"]
    history = [(e, v["recons"]) for e, v in sorted(valid.items()) if e < 250]
    return history, 250, valid[250]["recons"], 250


LOG_RESCUE = _log_rescue_case()


@pytest.mark.parametrize("history,ep,recons,auto_rescue", [
    ([(0, 30.0), (1, 20.0)], 2, 19.5, 2),
    ([(0, 30.0), (1, 20.0)], 2, 15.0, 2),
    ([(0, 30.0)], 1, 29.9, 4),
    ([], 3, 10.0, 2),
    ([(0, float("nan")), (2, 9.0)], 4, 8.0, 4),
    pytest.param(*LOG_RESCUE, id="spring_one5_log_at_250")])
def test_stall_guard_matches_jax(history, ep, recons, auto_rescue):
    state = dict(auto_rescue=auto_rescue, _recons_history=list(history))
    stalled = jax_recipes.RecipeMixin._discovery_stalled(
        types.SimpleNamespace(**state), ep, recons)
    assert recipes.RecipeMixin._discovery_stalled(
        types.SimpleNamespace(**state), ep, recons) == stalled
    if (history, ep, recons, auto_rescue) == LOG_RESCUE:
        # 5.330 at epoch 125 to 5.006 at 250 is 6.1%, over the guard's 5%:
        # both packages defer the rescue that the log's run made there.
        assert dict(history)[ep - auto_rescue // 2] == 5.33042049407959
        assert not stalled


@pytest.fixture(scope="module")
def spring500():
    import orbax.checkpoint as ocp
    return jax.device_get(ocp.PyTreeCheckpointer().restore(SPRING500))


def _jax_host(model, params, iterator):
    """A stand-in with the JAX RecipeMixin's attribute surface."""
    host = types.SimpleNamespace(
        model=model, params=dict(params), train_iterator=iterator,
        aux_on_recons=1e9, _aux_triggered=True, aux_warmup_steps=1 << 30,
        step=7, _put_batch_replicated=np.asarray,
        _forward=jax.jit(lambda p, b: model.apply({"params": p}, b)),
        _forward_extras=lambda p, b: model.apply({"params": p}, b,
                                                 with_extras=True))
    host._rendered_offsets = lambda: jax_recipes.RecipeMixin.\
        _rendered_offsets(host)
    return host


@pytest.mark.parametrize("weights", ["spring500", "seed1"])
def test_auto_rescue_matches_jax(tmp_path, spring500, paig_log, monkeypatch,
                                 weights):
    """The in-training rescue (--auto_rescue) of both packages on the same
    weights and train frames: the same log line (slot health, salience,
    the slots reset), the same parameters after the surgery (within 1e-6
    of the largest: numpy sums over the two packages' kernel layouts), and
    the optimizer rebuilt with the background frozen and the LR schedule
    over the same horizon. On runs/spring500's trained weights and on the
    JAX package's seed-1 initial weights (spring_one5 at seed 1, whose
    rescues on the card did not part the objects)."""
    from paig_reproduction_tpu.train import optimizers as jax_opt
    from paig_reproduction_tpu_torch.train import optimizers as opt

    if weights == "spring500":
        params = spring500["params"]
    else:
        params = jax.device_get(jax.jit(JaxPhysicsNet(**KW).init)(
            jax.random.PRNGKey(1), np.zeros((1, 12, 3, 32, 32),
                                            np.float32))["params"])
    trainer = _trainer(tmp_path)
    trainer.model.load_state_dict(
        {k: v.reshape(trainer.model.state_dict()[k].shape)
         for k, v in flax_to_state_dict(params).items()}, strict=False)
    trainer.step = 100
    host = types.SimpleNamespace(
        model=JaxPhysicsNet(**KW), params=dict(params),
        train_iterator=types.SimpleNamespace(
            raw_uint8=trainer.train_iterator.raw_uint8), step=100,
        rescue_disk_radius=0.0, rescue_seed_color=False, rescue_recons=3.0,
        max_rescues=1, _rescue_count=0, _epochs_consumed=0,
        _opt_args=dict(optimizer="rmsprop", epochs=4, steps_per_epoch=4,
                       physics_lr_mult=1.0, grad_clip=0.0),
        base_lr=6e-4, anneal_lr=True, _compile_steps=lambda **kw: None)
    rebuilt = {}
    for name, lib in (("port", opt), ("jax", jax_opt)):
        calls = rebuilt[name] = []

        def schedule(*args, make=lib.lr_schedule, calls=calls):
            calls.append(args)
            return make(*args)

        def build(*args, make=lib.build_optimizer, calls=calls, **kwargs):
            calls.append(kwargs["bg_lr_mult"])
            return make(*args, **kwargs)

        monkeypatch.setattr(lib, "lr_schedule", schedule)
        monkeypatch.setattr(lib, "build_optimizer", build)
    lines = []
    for rescue in (lambda: trainer._do_auto_rescue(2, 10.0),
                   lambda: jax_recipes.RecipeMixin._do_auto_rescue(
                       host, 2, 10.0)):
        paig_log.clear()
        rescue()
        lines.append([r.getMessage() for r in paig_log.records
                      if r.getMessage().startswith("auto_rescue: epoch")])
    assert len(lines[0]) == 1 and lines[0] == lines[1]
    assert rebuilt["port"] == rebuilt["jax"] == [(6e-4, 2, 4, True), 0.0]
    assert trainer._rescue_count == host._rescue_count == 1
    want = flax_to_state_dict(jax.device_get(host.params))
    state = trainer.model.state_dict()
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(state[k].reshape(v.shape).numpy(),
                                   v.numpy(), rtol=0, atol=1e-6 * scale,
                                   err_msg=k)


def test_physics_self_identification_matches_jax(tmp_path, spring500,
                                                 paig_log):
    """runs/spring500's weights, a frame offset learned: the rendered
    offsets, then the accepted fit's log_k, log_equil and frame_offset, as
    the JAX hook installs them (the same batches drawn from the seeded
    global RNG), and the alignment losses switched on."""
    fields = dict(learn_frame_offset=True)
    params = dict(spring500["params"],
                  frame_offset=np.zeros(4, np.float32))
    trainer = _trainer(tmp_path, **fields)
    trainer.model.load_state_dict(flax_to_state_dict(params))
    trainer.aux_on_recons, trainer._aux_triggered = 1e9, True
    trainer.aux_warmup_steps, trainer.step = recipes.NEVER, 7
    host = _jax_host(JaxPhysicsNet(**KW, **fields), params,
                     trainer.train_iterator)

    np.testing.assert_allclose(trainer._rendered_offsets(),
                               host._rendered_offsets(), rtol=0, atol=1e-3)
    np.random.seed(11)
    jax_recipes.RecipeMixin._identify_physics(host, 4)
    np.random.seed(11)
    trainer._identify_physics(4)
    assert "fit_physics: k=" in paig_log.text
    for name in ("log_k", "log_equil", "frame_offset"):
        np.testing.assert_allclose(
            getattr(trainer.model, name).detach().numpy(),
            np.asarray(host.params[name]), rtol=1e-4, atol=1e-3,
            err_msg=name)
    assert trainer.aux_warmup_steps == host.aux_warmup_steps == 7


BP_DATA = os.path.join(REPO, "data", "datasets", "3bp_color",
                       "color_3bp_vx2_vy2_sl20_r2_g60_m1_dt05.npz")
BP_KW = dict(task="3bp_color", cell_type="gravity_ode_cell", seq_len=20,
             input_steps=4, pred_steps=12, autoencoder_loss=5.0, color=True,
             input_size=36 * 36, learn_frame_offset=True)


@pytest.mark.parametrize("g_true,installs", [(60.0, True), (1.0, False)])
def test_gravity_self_identification_matches_jax(tmp_path, paig_log,
                                                 g_true, installs):
    """The gravity branch of the hook (3bp_color's --fit_physics_every):
    with the encodings of every forward stubbed by 3-body trajectories of
    g*m^2 = g_true and fixed rendered offsets in both packages, the fit
    installs log_g and the frame offset as the JAX hook does (g_true=60),
    or is refused as there (g_true=1, under the grid's lower bound of
    2)."""
    from test_torch_surgery import _gravity_encodings
    enc = _gravity_encodings(n=16, t=16, g=g_true).astype(np.float32)
    offsets = np.linspace(-0.5, 0.5, 6).astype(np.float32)
    dst = tmp_path / "3bp_color"
    dst.mkdir()
    with np.load(BP_DATA) as d:
        np.savez(dst / "sl20.npz", train_x=d["train_x"][:8],
                 valid_x=d["valid_x"][:4], test_x=d["test_x"][:4])
    model = PhysicsNet(**BP_KW)
    jmodel = JaxPhysicsNet(**BP_KW)
    trainer = Trainer(model, device="cpu", seed=3)
    trainer.get_data(iterators.get_iterators(str(dst / "sl20.npz"),
                                             conv=True))
    host_params = {"log_g": np.float32(0.0), "log_m": np.float32(0.0),
                   "frame_offset": np.zeros(6, np.float32)}
    chunks = iter(np.split(enc, 4) * 2)

    def stub(*_):
        return None, {"enc_pos": torch.from_numpy(next(chunks))}

    model.forward = stub
    host = types.SimpleNamespace(
        model=jmodel, params=host_params,
        train_iterator=trainer.train_iterator, aux_on_recons=0.0,
        _aux_triggered=False, aux_warmup_steps=0, step=7,
        _put_batch_replicated=np.asarray,
        _forward=lambda p, b: (None, {"enc_pos": next(chunks)}),
        _rendered_offsets=lambda: offsets)
    trainer._rendered_offsets = lambda: offsets
    trainer._identify_physics(4)
    port_log = paig_log.text
    jax_recipes.RecipeMixin._identify_physics(host, 4)
    jax_log = paig_log.text[len(port_log):]
    assert ("fit_physics: A=g*m^2=" in port_log) == installs
    assert port_log.split("fit_physics: ")[1].split("\n")[0] == \
        jax_log.split("fit_physics: ")[1].split("\n")[0]
    np.testing.assert_allclose(model.log_g.item(),
                               float(np.asarray(host.params["log_g"])),
                               rtol=1e-6)
    np.testing.assert_allclose(model.frame_offset.detach().numpy(),
                               np.asarray(host.params["frame_offset"]))
    assert model.log_m.item() == 0.0
    if installs:
        # 5 substeps and the offsets bias the fit a little off the truth.
        assert 0.8 < np.exp(model.log_g.item()) / 60.0 < 1.2
