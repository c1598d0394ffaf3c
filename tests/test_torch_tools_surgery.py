"""The port's slot_rescue tool against the JAX package's
``tools/slot_rescue.py``, the trainer's restore of the checkpoint it
writes, and the port's seed_sweep tool.

* ``slot_rescue`` on ``runs/bounce_one1`` (``--rescue_slot=auto
  --set_background=median``, the tracked bouncing file's median), on
  ``runs/spring500`` (``--rescue_slot=0``) and on a 3bp_color checkpoint
  of the JAX package's initial weights at seed 0, written by its own
  ``save_checkpoint`` (``tests/jax_3bp.py``), with 3bp_color's chain's
  surgery (``--rescue_slot=all --disk_radius=3 --set_background=median``
  at 18-px templates, three slots), each restored with orbax and
  converted as ``tests/test_torch_checkpoint.py`` does: every written
  parameter within 1e-6 of the JAX tool's output, converted (both are
  float32 numpy; the JAX tool's MLP products go through XLA's dot), the
  same printed lines, and ``model`` and ``step`` with no optimizer state.
* The trainer restores that checkpoint with the model's parameters as
  written, the optimizer's state fresh, and the partial restore's logged
  notice.
* ``seed_sweep``: 2 seeds, 1 epoch at B=8 on a cut copy of the spring
  file; each seed's metrics equal, exactly, a direct Trainer run from the
  JAX package's initial weights at that seed (``models/jax_init.py``, as
  the CLI's ``--seed``).
"""
import importlib.util
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

import jax_3bp

from paig_reproduction_tpu_torch.convert import flax_checkpoint_to_port
from paig_reproduction_tpu_torch.data.iterators import get_iterators
from paig_reproduction_tpu_torch.models import PhysicsNet, jax_init
from paig_reproduction_tpu_torch.tools import seed_sweep, slot_rescue
from paig_reproduction_tpu_torch.train import checkpoint
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SL12 = os.path.join(REPO, "data", "datasets", "spring_color",
                    "color_spring_vx8_vy8_sl12_r2_k4_e6.npz")
PARAM_ATOL = 1e-6
# (run, task, slot_rescue flags)
RESCUES = {
    "bounce_one1": ("bouncing_balls",
                    ["--rescue_slot=auto", "--set_background=median"]),
    "spring500": ("spring_color", ["--rescue_slot=0"]),
    "3bp_init": ("3bp_color", ["--rescue_slot=all", "--disk_radius=3",
                               "--set_background=median"]),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for a test's small models: more threads run
    them no faster, and beside the suite's other workers they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_3bp_dir(tmp_path_factory):
    """The JAX package's 3bp_color checkpoint at seed 0 (tests/jax_3bp.py)."""
    return jax_3bp.write(str(tmp_path_factory.mktemp("jax_3bp")))[0]


def _orbax_tree(path):
    import orbax.checkpoint as ocp
    return jax.device_get(ocp.PyTreeCheckpointer().restore(path))


@pytest.fixture
def no_new_handlers():
    """Removes the log handlers a run adds to the "paig" logger."""
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    yield
    for h in set(logger.handlers) - set(handlers):
        logger.removeHandler(h)
        h.close()


def _rescued(tmp_path, run, capsys, ckpt_dir=None):
    """Both tools on the JAX checkpoint in ``ckpt_dir`` (by default
    runs/<run>): (the port's output dict, the JAX tool's output converted,
    the lines each printed but the last)."""
    task, flags = RESCUES[run]
    ckpt_dir = ckpt_dir or os.path.join(REPO, "runs", run)
    spec = importlib.util.spec_from_file_location(
        "jax_slot_rescue", os.path.join(REPO, "tools", "slot_rescue.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    jax_tool.main([f"--ckpt_dir={ckpt_dir}",
                   f"--out_dir={tmp_path / 'jax'}", f"--task={task}",
                   *flags])
    jax_lines = capsys.readouterr().out.splitlines()

    src = tmp_path / "converted"
    src.mkdir()
    checkpoint.save_checkpoint(str(src), flax_checkpoint_to_port(
        _orbax_tree(os.path.join(ckpt_dir, "model.ckpt"))))
    slot_rescue.main([f"--ckpt_dir={src}", f"--out_dir={tmp_path / 'port'}",
                      f"--task={task}", *flags])
    lines = capsys.readouterr().out.splitlines()
    theirs = flax_checkpoint_to_port(_orbax_tree(
        str(tmp_path / "jax" / "model.ckpt")))
    return (checkpoint.load_checkpoint(str(tmp_path / "port")), theirs,
            lines[:-1], jax_lines[:-1])


@pytest.mark.parametrize("run", sorted(RESCUES))
def test_slot_rescue_matches_jax(tmp_path, capsys, request, run):
    ckpt_dir = (request.getfixturevalue("jax_3bp_dir") if run == "3bp_init"
                else None)
    ours, theirs, lines, jax_lines = _rescued(tmp_path, run, capsys,
                                              ckpt_dir)
    assert lines == jax_lines
    assert any(line.startswith("rescuing slot ") for line in lines)
    assert set(ours) == {"model", "step"} and ours["step"] == 0
    assert theirs["step"] == 0 and not theirs["optimizer"]["state"]
    assert set(ours["model"]) == set(theirs["model"])
    for name, t in ours["model"].items():
        assert t.dtype == torch.float32, name
        np.testing.assert_allclose(t.numpy(), theirs["model"][name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    if "--set_background=median" in RESCUES[run][1]:
        assert any(line.startswith("installing background")
                   for line in lines)
    if run == "3bp_init":
        assert [line for line in lines if line.startswith("rescuing")] == [
            f"rescuing slot {i}: disk r=3.0, content [0.5, 0.5, 0.5]"
            for i in range(3)]


def test_trainer_restores_a_rescued_checkpoint(tmp_path, capsys, caplog,
                                               no_new_handlers):
    """spring500's rescue restored by the trainer: the model as written,
    the optimizer's state fresh (made at the first step), the step 0, and
    the partial restore's notice of what the checkpoint lacks."""
    ours, _, _, _ = _rescued(tmp_path, "spring500", capsys)
    model = PhysicsNet(task="spring_color", cell_type="spring_ode_cell",
                       seq_len=12, input_steps=4, pred_steps=6,
                       autoencoder_loss=3.0, color=True,
                       input_size=32 * 32)
    jax_init.load_initial_state(model, jax_init.prng_key(1))
    trainer = Trainer(model, device="cpu")
    trainer.build_optimizer(6e-4, "rmsprop", True, epochs=1,
                            steps_per_epoch=1)
    caplog.set_level(logging.INFO, logger="paig")
    trainer.initialize_graph(str(tmp_path / "resume"), use_ckpt=True,
                             ckpt_dir=str(tmp_path / "port"))
    assert trainer.step == 0
    assert not trainer.optimizer.state
    for name, t in model.state_dict().items():
        assert torch.equal(t, ours["model"][name]), name
    assert any(r.getMessage().startswith(
        "checkpoint restore: 2 target leaves not in checkpoint")
        for r in caplog.records)


def _cut_spring(dst):
    (dst / "spring_color").mkdir(parents=True)
    with np.load(SL12) as d:
        np.savez(dst / "spring_color" / os.path.basename(SL12),
                 train_x=d["train_x"][:16], valid_x=d["valid_x"][:8],
                 test_x=d["test_x"][:8])


def test_seed_sweep_equals_direct_trainer_runs(tmp_path, monkeypatch,
                                               capsys, no_new_handlers):
    _cut_spring(tmp_path / "data")
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    out = tmp_path / "sweep.json"
    results = seed_sweep.main([
        "--task", "spring_color", "--seeds", "0", "1", "--epochs", "1",
        "--batch_size", "8", "--data_dir", str(tmp_path / "data"),
        "--save_root", str(tmp_path / "runs"), "--out", str(out),
        "--device", "cpu"])
    printed = capsys.readouterr().out
    assert set(results) == {0, 1}
    with open(out) as f:
        assert json.load(f) == {str(s): m for s, m in results.items()}
    best = min(results, key=lambda s: results[s]["eval_pred_loss"])
    assert f"best seed: {best} -> " in printed

    for seed in (0, 1):
        np.random.seed(seed)
        model = PhysicsNet(
            task="spring_color", cell_type="spring_ode_cell", seq_len=12,
            input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
            input_size=32 * 32)
        jax_init.load_initial_state(model, jax_init.prng_key(seed))
        its = get_iterators(str(tmp_path / "data" / "spring_color"
                                / os.path.basename(SL12)), conv=True)
        trainer = Trainer(model, device="cpu", seed=seed)
        trainer.get_data(its)
        trainer.build_optimizer(6e-4, "rmsprop", True, epochs=1,
                                steps_per_epoch=2)
        trainer.initialize_graph(str(tmp_path / f"direct{seed}"), False)
        metrics = trainer.train_model(1, 8, save_every_n_epochs=1,
                                      eval_every_n_epochs=1,
                                      print_interval=100, debug=True)
        assert results[seed] == {k: float(v) for k, v in metrics.items()}
        assert os.path.exists(tmp_path / "runs" / f"spring_color_seed{seed}"
                              / "model.ckpt")
