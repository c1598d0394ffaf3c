"""The port's native loader (``data/native.py`` over its copy of the C++
source) against the JAX package's ``NativeBatcher``, built with
``native/build.sh`` into a temporary directory: the same batches and epoch
counts at the same seed; the refusal of a batch larger than the split; rows
copied into a tensor; and ``--native_loader`` through the CLI on the CPU:
with the fused path off (``PAIG_FUSED=0``) the steps consume the loader's
batches at the run's seed, and with it on (``PAIG_FUSED=1``) the flag
changes nothing, as in the JAX trainer, which builds its loader only where
its fused chunk is off.

Tolerance: none; the batches are compared exactly.
"""
import logging
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from paig_reproduction_tpu.data import native as jax_native
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.data import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_batcher(tmp_path_factory):
    """The JAX package's NativeBatcher over a library that native/build.sh
    built in a temporary copy of native/."""
    d = tmp_path_factory.mktemp("native")
    for name in ("build.sh", "paig_data.cpp"):
        shutil.copy(os.path.join(REPO, "native", name), d / name)
    subprocess.run(["sh", str(d / "build.sh")], check=True,
                   capture_output=True, timeout=120)
    saved = jax_native._SO_PATH, jax_native._lib
    jax_native._SO_PATH, jax_native._lib = str(d / "libpaig_data.so"), None
    yield jax_native.NativeBatcher
    jax_native._SO_PATH, jax_native._lib = saved


@pytest.mark.parametrize("n,batch,seed,normalize", [
    (13, 4, 1, True), (12, 4, 3, False), (7, 7, 0, True)])
def test_batches_and_epochs_match_jax(jax_batcher, n, batch, seed,
                                      normalize):
    data = np.random.RandomState(n).randint(0, 256, (n, 2, 3, 4, 4),
                                            dtype=np.uint8)
    ours = native.NativeBatcher(data, batch, seed=seed, normalize=normalize)
    theirs = jax_batcher(data, batch, seed=seed, normalize=normalize)
    for _ in range(4 * (n // batch) + 1):
        a, b = ours.next_batch_x().copy(), theirs.next_batch_x().copy()
        np.testing.assert_array_equal(a, b)
        assert ours.epochs_completed == theirs.epochs_completed
    assert ours.epochs_completed >= 4
    ours.close()


def test_batch_larger_than_the_split_raises():
    data = np.zeros((3, 2, 2), np.uint8)
    with pytest.raises(ValueError, match="batch of 4 from a split of 3"):
        native.NativeBatcher(data, 4)
    with pytest.raises(ValueError, match="uint8"):
        native.NativeBatcher(data.astype(np.float32), 2)


def test_next_batch_into_copies_rows():
    data = np.random.RandomState(0).randint(0, 256, (8, 3, 2), np.uint8)
    a = native.NativeBatcher(data, 4, seed=5)
    b = native.NativeBatcher(data, 4, seed=5)
    dst = torch.zeros((2, 3, 2))
    for _ in range(3):
        a.next_batch_into(dst, slice(2, 4))
        np.testing.assert_array_equal(dst.numpy(), b.next_batch_x()[2:4])


@pytest.fixture
def one_thread():
    """One intra-op thread for a test's small models: more threads run
    them no faster, and beside the suite's other workers they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_spring(tmp_path, n_train=8):
    src = os.path.join(REPO, "data", "datasets", "spring_color")
    (tmp_path / "spring_color").mkdir()
    for name, n in (("color_spring_vx8_vy8_sl12_r2_k4_e6.npz", n_train),
                    ("color_spring_vx8_vy8_sl30_r2_k4_e6.npz", 4)):
        with np.load(os.path.join(src, name)) as d:
            np.savez(tmp_path / "spring_color" / name,
                     train_x=d["train_x"][:n], valid_x=d["valid_x"][:4],
                     test_x=d["test_x"][:4])


def _run_cli(argv):
    """cli.main(argv), with the log handlers it adds removed after it."""
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        return cli.main(argv)
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()


def test_cli_trains_from_the_native_loader(tmp_path, monkeypatch,
                                           one_thread):
    """--native_loader with the fused path off (PAIG_FUSED=0), 2 epochs at
    B=4 on 8 sequences: finite losses that fall, and the steps' batches are
    the loader's at the run's seed."""
    _tiny_spring(tmp_path)
    seen = []
    into = native.NativeBatcher.next_batch_into

    def recorded(self, dst, rows=slice(None)):
        into(self, dst, rows)
        seen.append(dst.clone())

    monkeypatch.setattr(native.NativeBatcher, "next_batch_into", recorded)
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setenv("PAIG_FUSED", "0")
    save_dir = tmp_path / "run"
    trainer, _ = _run_cli([
        "--task=spring_color", "--color", "--autoencoder_loss=3.0",
        "--batch_size=4", "--epochs=2", "--print_interval=1",
        "--native_loader", "--seed=3", f"--data_dir={tmp_path}",
        f"--save_dir={save_dir}", "--device=cpu"])
    log = (save_dir / "log.txt").read_text()
    assert "fused step: off (PAIG_FUSED=0)" in log
    assert "using native C++ prefetching loader" in log
    losses = [float(line.split("train_loss=")[1])
              for line in log.splitlines() if "train - iter=" in line]
    assert trainer.step == 4 and len(losses) == 4
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    ref = native.NativeBatcher(trainer.train_iterator.raw_uint8, 4, seed=3)
    assert len(seen) == 4
    for batch in seen:
        np.testing.assert_array_equal(batch.numpy(), ref.next_batch_x())


def test_native_loader_leaves_the_fused_step_on(tmp_path, monkeypatch,
                                                one_thread):
    """With the fused path on (PAIG_FUSED=1, the chunk code on the CPU), a
    2-epoch run at B=8 with --native_loader logs the same ``train - iter=``
    lines as the same run without the flag, and builds no loader: the JAX
    trainer builds its loader only where its fused chunk is off."""
    _tiny_spring(tmp_path, n_train=16)
    built = []
    monkeypatch.setattr(native.NativeBatcher, "__init__",
                        lambda *a, **k: built.append(1))
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setenv("PAIG_FUSED", "1")
    lines = {}
    for flag in ("", "--native_loader"):
        save_dir = tmp_path / f"run{flag}"
        _run_cli([
            "--task=spring_color", "--color", "--autoencoder_loss=3.0",
            "--batch_size=8", "--epochs=2", "--print_interval=1",
            "--seed=3", f"--data_dir={tmp_path}", f"--save_dir={save_dir}",
            "--device=cpu"] + ([flag] if flag else []))
        log = (save_dir / "log.txt").read_text()
        assert "fused step: on (the step body called directly)" in log
        assert "using native C++ prefetching loader" not in log
        lines[flag] = [line.split(" - paig - ")[1] for line in
                       log.splitlines() if " - paig - train - iter=" in line]
    assert len(lines[""]) == 4
    assert lines["--native_loader"] == lines[""]
    assert not built
