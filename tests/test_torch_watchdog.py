"""The port's runtime flags against the JAX package's: the hung-device
watchdog (``train/watchdog.py``, ``--watchdog_secs``,
``--watchdog_floor_secs``), ``--resume_remaining_epochs``,
``--profile_dir`` and ``--debug_nans``.

The watchdog's firing path ends the process with ``os._exit``, so it runs
in subprocesses; its timing logic runs on an injected clock, with no thread
and no patching of ``time``. The CLI runs are on a tiny spring_color pair
(8 train sequences, B=4, CPU).
"""
import copy
import glob
import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu.train import watchdog as jax_watchdog
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.data.iterators import gather_batch
from paig_reproduction_tpu_torch.train import checkpoint
from paig_reproduction_tpu_torch.train import watchdog as wd_mod
from paig_reproduction_tpu_torch.train.trainer import Trainer
from paig_reproduction_tpu_torch.train.watchdog import (
    EXIT_CODE,
    DeviceWatchdog,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "datasets", "spring_color")
FILES = ("color_spring_vx8_vy8_sl12_r2_k4_e6.npz",
         "color_spring_vx8_vy8_sl30_r2_k4_e6.npz")


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_constants_are_the_jax_modules():
    assert (EXIT_CODE, wd_mod.WARMUP_PETS, wd_mod.ADAPT_FACTOR) == (
        jax_watchdog.EXIT_CODE, jax_watchdog.WARMUP_PETS,
        jax_watchdog.ADAPT_FACTOR) == (75, 20, 100.0)


def test_fires_with_exit_75_in_a_subprocess():
    """No pet after start: the monitor's first wake (at least 1 s) sees a
    stale heartbeat and ends the process with 75."""
    code = ("import time\n"
            "from paig_reproduction_tpu_torch.train.watchdog import "
            "DeviceWatchdog\n"
            "DeviceWatchdog(0.5, note='test').start()\n"
            "time.sleep(30)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == EXIT_CODE, proc.stderr


def test_floor_never_exceeds_the_timeout():
    wd = DeviceWatchdog(30.0, adaptive_floor_secs=120.0, clock=Clock())
    assert wd.floor == 30.0
    clock = wd._clock
    for _ in range(wd_mod.WARMUP_PETS + 5):
        clock.t += 0.01
        wd.pet()
    assert wd.effective_timeout() == 30.0


def test_adaptive_timeout_on_an_injected_clock():
    """Before the warm-up the ceiling; then ADAPT_FACTOR x the EWMA of the
    intervals, clamped to [floor, timeout]; gaps at the ceiling's scale
    stay out of the estimate; and the staleness check fires past the
    effective timeout only."""
    clock = Clock()
    wd = DeviceWatchdog(2100.0, adaptive_floor_secs=60.0, clock=clock)
    for _ in range(wd_mod.WARMUP_PETS - 1):
        clock.t += 0.02
        wd.pet()
    assert wd.effective_timeout() == 2100.0
    clock.t += 0.02
    wd.pet()
    assert wd.effective_timeout() == 60.0         # 100 x 0.02 s, floored
    for _ in range(200):
        clock.t += 1.5
        wd.pet()
    assert wd.effective_timeout() == pytest.approx(100 * 1.5, rel=1e-6)
    clock.t += 5000.0                             # a compile-sized gap
    wd.pet()
    assert wd._ewma == pytest.approx(1.5, rel=1e-6)

    wd._armed = True                              # as start() sets it
    clock.t += 149.0
    assert wd.stale() is None
    clock.t += 2.0
    assert wd.stale() == pytest.approx(151.0)
    wd.stop()
    assert wd.stale() is None


def test_zero_timeout_never_starts():
    wd = DeviceWatchdog(0)
    wd.start()
    assert wd._thread is None


def test_trainer_pets_lazily():
    """No thread while watchdog_secs is 0; armed once when it is set."""
    t = Trainer.__new__(Trainer)
    t.watchdog_secs, t.watchdog_floor_secs, t._watchdog = 0.0, 0.0, None
    t._wd_pet()
    assert t._watchdog is None
    t.watchdog_secs = 3600.0
    t._wd_pet()
    first = t._watchdog
    assert first is not None and first._armed
    t._wd_pet()
    assert t._watchdog is first
    first.stop()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    (root / "spring_color").mkdir()
    for name in FILES:
        with np.load(os.path.join(DATA, name)) as d:
            np.savez(root / "spring_color" / name, train_x=d["train_x"][:8],
                     valid_x=d["valid_x"][:4], test_x=d["test_x"][:4])
    return root


def _argv(data_dir, save_dir, *extra):
    return ["--task=spring_color", "--base_lr=6e-4", "--autoencoder_loss=3.0",
            "--color", "--batch_size=4", "--print_interval=1",
            f"--data_dir={data_dir}", f"--save_dir={save_dir}",
            "--device=cpu", *extra]


def _main(argv):
    """cli.main with the log handlers it adds removed afterwards."""
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        return cli.main(argv)
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()


@pytest.fixture(scope="module")
def trained(data_dir, tmp_path_factory):
    """A 2-epoch run (2 steps an epoch) with the watchdog, the profiler and
    the NaN checks on; each visualization records whether the watchdog of
    its trainer was armed."""
    save_dir = tmp_path_factory.mktemp("runs") / "run"
    prof_dir = save_dir.parent / "profile"
    armed = []
    visualize = Trainer.visualize_sequence

    def recording(self):
        armed.append((self, self._watchdog is not None
                      and self._watchdog._armed))
        return visualize(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PAIG_VIZ_EXAMPLES", "1")
        mp.setattr(Trainer, "visualize_sequence", recording)
        trainer, test_trainer = _main(_argv(
            data_dir, save_dir, "--epochs=2", "--watchdog_secs=600",
            "--watchdog_floor_secs=60", f"--profile_dir={prof_dir}",
            "--debug_nans"))
    return dict(data_dir=data_dir, save_dir=save_dir, prof_dir=prof_dir,
                armed=armed, trainer=trainer, test_trainer=test_trainer)


def test_watchdog_stops_before_the_last_artifacts(trained):
    """Both phases' trainers arm a watchdog (the floor clamped to the
    timeout's side); every visualization but each trainer's last runs with
    it armed, the last (after the final test eval's batches) with it
    stopped, so an adaptive timeout cannot fire during them."""
    for t in (trained["trainer"], trained["test_trainer"]):
        assert (t._watchdog.timeout, t._watchdog.floor) == (600.0, 60.0)
        states = [a for who, a in trained["armed"] if who is t]
        assert states[-1] is False and all(states[:-1])
    assert len(trained["armed"]) == 5     # valid x3, test, seq-30 test


def test_profile_dir_writes_a_trace(trained):
    """A Chrome trace of the training phase (TensorBoard's plugin reads
    the same file), holding the train step's operators."""
    traces = glob.glob(str(trained["prof_dir"] / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::conv2d" in names


@pytest.mark.parametrize("epochs,done,flag,trains", [
    (3, 2, True, 1), (2, 2, True, 1), (5, 2, True, 3), (3, 0, True, 3),
    (3, 2, False, 3), (1, 7, True, 1)])
def test_epochs_to_train_counts_as_jax(epochs, done, flag, trains):
    """max(1, --epochs - the checkpoint chain's epochs) with the flag, as
    the JAX CLI counts (cli.py:442-449); --epochs without it."""
    assert cli.epochs_to_train(epochs, done, flag) == trains


def test_resume_remaining_epochs(trained, tmp_path, caplog, monkeypatch):
    """--use_ckpt --resume_remaining_epochs --epochs=3 on the 2-epoch run
    trains 1 epoch, logs the JAX CLI's line, and its checkpoint carries the
    chain on to 3 epochs."""
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    caplog.set_level(logging.INFO, logger="paig")
    save_dir = tmp_path / "resumed"
    trainer, _ = _main(_argv(trained["data_dir"], save_dir, "--use_ckpt",
                             f"--ckpt_dir={trained['save_dir']}",
                             "--epochs=3", "--resume_remaining_epochs"))
    assert trainer.step == 4 + 2
    saved = torch.load(save_dir / "model.ckpt", weights_only=True)
    assert saved["total_epochs_done"] == 3
    assert ("resume_remaining_epochs: checkpoint chain has 2 epochs done, "
            "training 1 more") in caplog.text


def test_debug_nans_raises_at_a_poisoned_weight(trained, tmp_path):
    """A NaN in a weight: with --debug_nans the resumed run raises
    FloatingPointError at its first forward (the pre-train valid eval);
    without the flag the same forward returns NaN losses."""
    ckpt = torch.load(trained["save_dir"] / "model.ckpt", weights_only=True)
    name = "var_net_background.dense.1.bias"
    ckpt["model"][name][0] = float("nan")
    poisoned = tmp_path / "poisoned"
    poisoned.mkdir()
    checkpoint.save_checkpoint(str(poisoned), ckpt)
    with pytest.raises(FloatingPointError, match="forward"):
        _main(_argv(trained["data_dir"], tmp_path / "run", "--use_ckpt",
                    f"--ckpt_dir={poisoned}", "--epochs=1", "--debug_nans"))

    t = trained["trainer"]
    net = copy.deepcopy(t.model)
    net.load_state_dict(ckpt["model"])
    batch = gather_batch(t._split_u8("valid"), np.arange(2))
    t.debug_nans = False
    try:
        with torch.no_grad():
            _, losses = t._losses(batch, net)
        assert all(torch.isnan(v) for v in losses.values())
    finally:
        t.debug_nans = True


def test_jax_debug_nans_raises_at_a_poisoned_weight():
    """What the flag mirrors: the JAX model under jax_debug_nans raises
    FloatingPointError on the same poisoning (a tiny model)."""
    model = JaxPhysicsNet(task="spring_color", seq_len=4, input_steps=1,
                          pred_steps=2, input_size=8 * 8)
    x = np.full((1, 4, 3, 8, 8), 0.5, np.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                x)["params"])
    bias = np.array(params["var_net_background"]["TorchDense_1"]["bias"])
    bias[0] = np.nan
    params["var_net_background"]["TorchDense_1"]["bias"] = jnp.asarray(bias)
    with jax.debug_nans(True), pytest.raises(FloatingPointError):
        jax.jit(model.apply)({"params": params}, x)


def test_debug_nans_guards_the_backward():
    """A NaN made by a backward function (0 x inf at sqrt(0)) raises as
    FloatingPointError under the flag, autograd's anomaly mode naming the
    function; a NaN gradient the guard lets through is caught after it.
    Without the flag neither check runs."""
    t = Trainer.__new__(Trainer)
    t.debug_nans = True
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="SqrtBackward"):
        with t._nan_guard():
            (torch.sqrt(x) * 0).sum().backward()
    with pytest.raises(FloatingPointError, match="gradient.*'w'"):
        t._raise_on_nan("gradient", {"v": torch.zeros(2),
                                     "w": torch.tensor([0.0, float("nan")])})
    t.debug_nans = False
    x.grad = None
    with t._nan_guard():
        (torch.sqrt(x) * 0).sum().backward()
    assert torch.isnan(x.grad).all()
