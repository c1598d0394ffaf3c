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


def test_resumed_rescue_schedule_matches_jax(tmp_path, paig_log,
                                             monkeypatch):
    """RESCUE_RUN at --epochs=2 (the arm's epoch, then one loop epoch), then
    resumed with --epochs=4 --use_ckpt --resume_remaining_epochs, through
    both packages' CLIs on the same files: each rescue rebuilds the same
    LR schedule in both (its horizon, steps and anneal, and its LR at every
    step, within float32 rounding), the resumed one over 4 less the loop
    epoch it fires at, as the JAX trainer sizes it. The resumed run's
    length is the one deliberate departure (``cli.epochs_to_train``): the
    port counts the arm's epoch among the chain's, the JAX CLI does not."""
    from paig_reproduction_tpu import cli as jax_cli
    from paig_reproduction_tpu.train import optimizers as jax_opt
    from paig_reproduction_tpu_torch.train import optimizers as opt

    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setenv("PAIG_COMPILE_CACHE", "0")
    _tiny_data(tmp_path, n_eval=8)
    schedules, messages = {}, {}
    for name, main, lib, extra in (("port", cli.main, opt, ["--device=cpu"]),
                                   ("jax", jax_cli.main, jax_opt, [])):
        calls = schedules[name] = []

        def record(*args, make=lib.lr_schedule, calls=calls):
            if any(f.function == "_do_auto_rescue"
                   for f in inspect.stack(0)):
                calls.append((args, make(*args)))
            return make(*args)

        monkeypatch.setattr(lib, "lr_schedule", record)
        argv = RESCUE_RUN + extra + [f"--data_dir={tmp_path}",
                                     f"--save_dir={tmp_path / name}"]
        main(argv + ["--epochs=2"])
        main(argv + ["--epochs=4", "--use_ckpt", "--resume_remaining_epochs"])
        messages[name] = [r.getMessage() for r in paig_log.records]
        paig_log.clear()
    port, ref = schedules["port"], schedules["jax"]
    assert [a for a, _ in port] == [a for a, _ in ref] == [
        (1e-9, 1, 2, True), (1e-9, 3, 2, True)]
    for (args, lr), (_, ref_lr) in zip(port, ref):
        steps = range(args[1] * args[2] + 2)
        assert [lr(s) for s in steps] == pytest.approx(
            [float(ref_lr(s)) for s in steps], rel=1e-7)
    resumed = "resume_remaining_epochs: checkpoint chain has %d epochs " \
        "done, training %d more"
    assert resumed % (2, 2) in messages["port"]
    assert resumed % (1, 3) in messages["jax"]


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


@pytest.mark.parametrize("history,ep,recons,auto_rescue", [
    ([(0, 30.0), (1, 20.0)], 2, 19.5, 2),
    ([(0, 30.0), (1, 20.0)], 2, 15.0, 2),
    ([(0, 30.0)], 1, 29.9, 4),
    ([], 3, 10.0, 2),
    ([(0, float("nan")), (2, 9.0)], 4, 8.0, 4)])
def test_stall_guard_matches_jax(history, ep, recons, auto_rescue):
    state = dict(auto_rescue=auto_rescue, _recons_history=list(history))
    assert recipes.RecipeMixin._discovery_stalled(
        types.SimpleNamespace(**state), ep, recons) == \
        jax_recipes.RecipeMixin._discovery_stalled(
            types.SimpleNamespace(**state), ep, recons)


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
