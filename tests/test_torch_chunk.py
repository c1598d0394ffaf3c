"""The fused train/eval chunk of the port's trainer on the CPU, where
``PAIG_FUSED=1`` runs the chunk code with the step body called directly (the
card captures the same body as a CUDA graph): chunked training against the
eager per-step loop from the same converted weights, across an epoch
boundary, the LR anneal and an ``--aux_on_recons`` trigger; the eval chunk
against the eager eval; a recapture after the auto-rescue surgery gives the
optimizer new storage; the predicate's named exclusions; and the decoder's
launch count over graph replays, with a stand-in graph whose replay calls
the body.

Tolerance: the parameter checksum within 1e-6 relative, although the same
operations run in the same order (bitwise is expected, and the log lines,
which print every loss in full, are compared exactly).
"""
import logging
import os
import sys

import jax
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import PhysicsNet as JaxPhysicsNet
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.convert import flax_to_state_dict
from paig_reproduction_tpu_torch.data import iterators
from paig_reproduction_tpu_torch.models import PhysicsNet
from paig_reproduction_tpu_torch.ops.cuda import st_decoder as tkernel
from paig_reproduction_tpu_torch.train import trainer as trainer_mod
from paig_reproduction_tpu_torch.train.graphs import CapturedStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

DATA = os.path.join(REPO, "data", "datasets", "spring_color")
SL12 = "color_spring_vx8_vy8_sl12_r2_k4_e6.npz"
SL30 = "color_spring_vx8_vy8_sl30_r2_k4_e6.npz"
KW = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
          input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
          input_size=32 * 32, pos_consistency=1.0, vel_anchor=1.0)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    (d / "spring_color").mkdir()
    for name, n in ((SL12, 8), (SL30, 4)):
        with np.load(os.path.join(DATA, name)) as src:
            np.savez(d / "spring_color" / name, train_x=src["train_x"][:n],
                     valid_x=src["valid_x"][:4], test_x=src["test_x"][:4])
    return d


@pytest.fixture(scope="module")
def weights(data_dir):
    """The JAX model's initial weights, converted."""
    raw = iterators.get_iterators(str(data_dir / "spring_color" / SL12),
                                  conv=True)[0].raw_uint8
    params = jax.jit(JaxPhysicsNet(**KW).init)(
        jax.random.PRNGKey(0), raw[:1].astype(np.float32) / 255)["params"]
    return flax_to_state_dict(jax.device_get(params))


@pytest.fixture
def paig_log(caplog):
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    caplog.set_level(logging.INFO, logger="paig")
    yield caplog
    for h in set(logger.handlers) - set(handlers):
        logger.removeHandler(h)
        h.close()


class FakeStep(CapturedStep):
    """A stand-in for the CUDA graph on the CPU: capture records the body
    without running it (as a capture does), a replay calls it with the
    wrapper's count left as it was and keeps the decoder launches it made
    (what a capture records, which ``replay`` then adds), and the warm-up
    calls it directly."""

    made = []

    def _record(self, fn):
        self.fn = fn
        FakeStep.made.append(self)

    def _replay(self):
        before = tkernel.LAUNCHES
        self.fn()
        self.launches = tkernel.LAUNCHES - before
        tkernel.LAUNCHES = before

    @staticmethod
    def warm_up(fn, device):
        fn()


def _trainer(data_dir, weights, save_dir, epochs=3, **kw):
    np.random.seed(0)
    model = PhysicsNet(**KW)
    model.load_state_dict(weights)
    trainer = trainer_mod.Trainer(model, device="cpu", **kw)
    trainer.get_data(iterators.get_iterators(
        str(data_dir / "spring_color" / SL12), conv=True))
    trainer.build_optimizer(6e-4, "rmsprop", True, epochs=epochs,
                            steps_per_epoch=4)
    trainer.initialize_graph(str(save_dir))
    return trainer


def _log_lines(path):
    """log.txt without timestamps, the fused-step line and the
    throughput."""
    with open(path) as f:
        lines = [line.split(" - paig - ", 1)[1] for line in f
                 if " - paig - " in line]
    return [line for line in lines
            if not line.startswith(("fused step:", "throughput:"))]


def _checksum(trainer):
    return sum(float(p.detach().double().abs().sum())
               for p in trainer.model.parameters())


def test_chunked_training_equals_per_step(data_dir, weights, tmp_path,
                                          paig_log, monkeypatch):
    """2 epochs of 4 steps in chunks of at most 3 (so chunks end both at
    the step limit and at the epoch's end), the /5 anneal from step 4 and
    the aux trigger at the first valid eval (step 4): the same parameters
    and the same log.txt as the eager loop."""
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setenv("PAIG_CHUNK_STEPS", "3")
    runs = {}
    logger = logging.getLogger("paig")
    for fused in ("0", "1"):
        monkeypatch.setenv("PAIG_FUSED", fused)
        t = _trainer(data_dir, weights, tmp_path / fused, epochs=2)
        t.set_aux_trigger(1e9)
        handlers = list(logger.handlers)
        t.train_model(2, 2, save_every_n_epochs=2, eval_every_n_epochs=1,
                      print_interval=1)
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
        runs[fused] = t
    eager, chunked = runs["0"], runs["1"]
    assert eager.step == chunked.step == 8
    assert eager._aux_triggered and chunked.aux_warmup_steps == 4
    assert eager._lr_at(4) == eager._lr_at(3) / 5
    a, b = _checksum(eager), _checksum(chunked)
    assert abs(a - b) <= 1e-6 * abs(a)
    lines = [_log_lines(tmp_path / f / "log.txt") for f in ("0", "1")]
    assert sum("train - iter=" in line for line in lines[0]) == 8
    assert lines[0] == lines[1]
    messages = [r.getMessage() for r in paig_log.records]
    assert "fused step: off (PAIG_FUSED=0)" in messages
    assert ("fused step: on (the step body called directly)" in messages)


def test_eval_chunk_equals_eager_eval(data_dir, weights, tmp_path,
                                      monkeypatch):
    t = _trainer(data_dir, weights, tmp_path / "run")
    out = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("PAIG_FUSED", fused)
        t.valid_iterator.indices = np.arange(4)
        np.random.seed(1)
        out[fused] = t._eval_losses("valid", 2)
    np.testing.assert_array_equal(out["0"][1], out["1"][1])
    np.testing.assert_array_equal(out["0"][0], out["1"][0])
    assert out["1"][0].shape == (1, 3)


def test_surgery_is_seen_by_the_next_chunk(data_dir, weights, tmp_path,
                                           paig_log, monkeypatch):
    """The auto-rescue surgery writes the weights in place and makes a new
    optimizer: the next chunk captures its step again, and training goes on
    as the eager twin's."""
    monkeypatch.setenv("PAIG_FUSED", "1")
    monkeypatch.setitem(trainer_mod.CAPTURE_CLASSES, "cpu", FakeStep)
    FakeStep.made.clear()
    idx = np.random.RandomState(0).choice(8, (6, 2))
    fused = _trainer(data_dir, weights, tmp_path / "fused")
    eager = _trainer(data_dir, weights, tmp_path / "eager")
    chunks = iter([idx[:3], idx[3:]])
    fused.train_iterator.next_index_batches = lambda b, k: next(chunks)
    for t in (fused, eager):
        t.auto_rescue = 2
    fused.train_chunk(2, 3)
    for i in idx[:3]:
        eager.train_step(i)
    assert len(FakeStep.made) == 1 and FakeStep.made[0].replays == 2
    for t in (fused, eager):
        t._do_auto_rescue(2, 10.0)
    opt = fused.optimizer
    fused.train_chunk(2, 3)
    for i in idx[3:]:
        eager.train_step(i)
    assert len(FakeStep.made) == 2 and FakeStep.made[1].replays == 2
    assert ("train", 2) in fused._graphs
    assert id(opt) in fused._graphs["train", 2].signature
    for p, q in zip(fused.model.parameters(), eager.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("env,field,reason", [
    (None, None, "the CPU; PAIG_FUSED=1 runs the chunk there, uncaptured"),
    ("0", None, "PAIG_FUSED=0"),
    ("1", "debug_nans", "--debug_nans syncs the host at every operation"),
    ("1", "native_loader",
     "--native_loader feeds host batches to the captured step"),
])
def test_fused_exclusions_are_logged(data_dir, weights, tmp_path, paig_log,
                                     monkeypatch, env, field, reason):
    if env is None:
        monkeypatch.delenv("PAIG_FUSED", raising=False)
    else:
        monkeypatch.setenv("PAIG_FUSED", env)
    t = _trainer(data_dir, weights, tmp_path / "run")
    if field:
        setattr(t, field, True)
    t.add_train_logger()
    assert not t._fused_train(2)
    t._fused_train(2)
    messages = [r.getMessage() for r in paig_log.records
                if r.getMessage().startswith("fused step:")]
    assert messages == [f"fused step: off ({reason})"]
    with open(tmp_path / "run" / "log.txt") as f:
        assert f"fused step: off ({reason})" in f.read()


def test_replayed_launches_match_a_hand_count(data_dir, tmp_path,
                                              monkeypatch):
    """The main path's CLI run, tiny (B=4, 2 epochs), with every train and
    eval step replayed through the stand-in graph: the wrapper's count,
    replays included, is chip_smoke.expected_launches's, as in the eager
    run (tests/test_torch_chip_smoke.py)."""
    monkeypatch.setenv("PAIG_FUSED", "1")
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setitem(trainer_mod.CAPTURE_CLASSES, "cpu", FakeStep)
    FakeStep.made.clear()
    fused = tkernel.st_decode_fused

    def counted(*a):
        tkernel.LAUNCHES += 1
        return fused(*a)

    monkeypatch.setattr(tkernel, "st_decode_fused", counted)
    monkeypatch.setattr(tkernel, "LAUNCHES", 0)
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        trainer, _ = cli.main([
            "--task=spring_color", "--color", "--autoencoder_loss=3.0",
            "--batch_size=4", "--epochs=2", f"--data_dir={data_dir}",
            f"--save_dir={tmp_path / 'run'}", "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    kinds = sorted({s.signature is not None for s in FakeStep.made})
    replays = sum(s.replays for s in FakeStep.made)
    # Graphs: the train step and the valid eval of the training phase; the
    # test evals of both phases have one batch each (their warm-up).
    assert len(FakeStep.made) == 2 and kinds == [True]
    # 4 train steps (1 warm-up, 3 replays); 3 valid evals of 1 batch (1
    # warm-up, 2 replays).
    assert replays == 3 + 2
    assert tkernel.LAUNCHES == chip_smoke.expected_launches(
        trainer.step, 4, 4, 4, batch_size=4, epochs=2) == 28
