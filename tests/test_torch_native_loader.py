"""The port's native loader (``data/native.py`` over its copy of the C++
source) against the JAX package's ``NativeBatcher``, built with
``native/build.sh`` into a temporary directory: the same batches and epoch
counts at the same seed; the refusal of a batch larger than the split; rows
copied into a tensor; and ``--native_loader`` through the CLI on the CPU,
whose steps consume the loader's batches at the run's seed.

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


def test_cli_trains_from_the_native_loader(tmp_path, monkeypatch):
    """--native_loader, 2 epochs at B=4 on 8 sequences: finite losses that
    fall, and the steps' batches are the loader's at the run's seed."""
    src = os.path.join(REPO, "data", "datasets", "spring_color")
    (tmp_path / "spring_color").mkdir()
    for name, n in (("color_spring_vx8_vy8_sl12_r2_k4_e6.npz", 8),
                    ("color_spring_vx8_vy8_sl30_r2_k4_e6.npz", 4)):
        with np.load(os.path.join(src, name)) as d:
            np.savez(tmp_path / "spring_color" / name,
                     train_x=d["train_x"][:n], valid_x=d["valid_x"][:4],
                     test_x=d["test_x"][:4])
    seen = []
    into = native.NativeBatcher.next_batch_into

    def recorded(self, dst, rows=slice(None)):
        into(self, dst, rows)
        seen.append(dst.clone())

    monkeypatch.setattr(native.NativeBatcher, "next_batch_into", recorded)
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    save_dir = tmp_path / "run"
    try:
        trainer, _ = cli.main([
            "--task=spring_color", "--color", "--autoencoder_loss=3.0",
            "--batch_size=4", "--epochs=2", "--print_interval=1",
            "--native_loader", "--seed=3", f"--data_dir={tmp_path}",
            f"--save_dir={save_dir}", "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    log = (save_dir / "log.txt").read_text()
    assert "using native C++ prefetching loader" in log
    losses = [float(line.split("train_loss=")[1])
              for line in log.splitlines() if "train - iter=" in line]
    assert trainer.step == 4 and len(losses) == 4
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    ref = native.NativeBatcher(trainer.train_iterator.raw_uint8, 4, seed=3)
    assert len(seen) == 4
    for batch in seen:
        np.testing.assert_array_equal(batch.numpy(), ref.next_batch_x())
