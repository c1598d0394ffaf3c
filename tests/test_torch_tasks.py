"""The other four tasks (bouncing_balls, 3bp_color, spring_color_half,
mnist_spring_color) through the port's CLI on the CPU with chip_smoke.py's
flags for each, at a tiny size: they train, evaluate, save, run the long
test phase from the run's checkpoint and write every artifact, and the
kernel's wrapper is called as often as chip_smoke.py's launch arithmetic
says the card's run launches it. (Apart from tests/test_torch_chip_smoke.py
so that the test runner's workers share the two files' minutes.)"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from paig_reproduction_tpu_torch.ops.cuda import st_decoder as tkernel  # noqa: E402,E501


def _tiny_task_data(task, dst):
    """A task's two files under dst at a tiny size: 8 train, 4 valid and 4
    test sequences of the train length, and 2 test sequences of the test
    length; cut from the tracked files, or written by the port's generator
    for the tasks without tracked files."""
    import numpy as np

    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.data import generate

    rels = cli.TASK_TABLE[task][:2]
    if chip_smoke.TASK_RUNS[task]["generate"] is not None:
        generate.generate(task, str(dst), (8, 4, 4), (0, 0, 2))
        return
    for rel, (n_train, n_valid, n_test) in zip(rels, ((8, 4, 4), (0, 0, 2))):
        with np.load(os.path.join(chip_smoke.DATA_DIR, rel)) as d:
            os.makedirs(os.path.dirname(dst / rel), exist_ok=True)
            np.savez(dst / rel, train_x=d["train_x"][:n_train],
                     valid_x=d["valid_x"][:n_valid],
                     test_x=d["test_x"][:n_test])


@pytest.mark.parametrize("task", sorted(chip_smoke.TASK_RUNS))
def test_task_runs_on_cpu_and_launches_count(task, tmp_path, monkeypatch):
    """Each new task through the CLI on the CPU with chip_smoke.py's flags
    for it, at B=4 for one epoch on tiny files: it trains, evaluates,
    saves, runs its long test phase from the run's checkpoint and writes
    every artifact, and the kernel's wrapper is called as often as
    recipe_counts and recipe_decodes say the card's run launches it."""
    import logging
    import math

    from paig_reproduction_tpu_torch import cli

    _tiny_task_data(task, tmp_path / "data")
    fused = tkernel.st_decode_fused
    calls = []
    monkeypatch.setattr(tkernel, "st_decode_fused",
                        lambda *a: calls.append(1) or fused(*a))
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    save_dir = tmp_path / "run"
    argv = chip_smoke.task_argv(task, str(tmp_path / "data"), str(save_dir),
                                batch_size=4)
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        trainer, test_trainer = cli.main(argv + ["--epochs=1",
                                                 "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    assert trainer.step == 2
    assert test_trainer.step == trainer.step
    assert test_trainer.model.seq_len == cli.TASK_TABLE[task][4]
    train, evals, test_long = chip_smoke.read_log(save_dir / "log.txt")
    assert len(train) == 2 and test_long is not None
    assert all(math.isfinite(v) for v in train + evals
               + list(test_long.values()))
    counts = chip_smoke.recipe_counts(
        save_dir / "log.txt", arms=0, arm_epochs=0, loop_epochs=1,
        steps_per_epoch=2, valid_batches=1, test_batches=1, test30_batches=1)
    launches, _ = chip_smoke.recipe_decodes(*counts,
                                            chip_smoke.refine_iters(argv))
    assert len(calls) == launches
    chip_smoke.check_artifacts(str(save_dir))
