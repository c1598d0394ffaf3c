"""chip_smoke.py checked on the CPU: the bound it reports, the shapes it
runs on the card, and the kernel launches it expects of a CLI run, counted
here as calls of the kernel's wrapper. The phases themselves need a
card."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from paig_reproduction_tpu_torch.models import decoder as tdec  # noqa: E402
from paig_reproduction_tpu_torch.ops.cuda import st_decoder as tkernel  # noqa: E402,E501


def test_st_decode_bound_of_the_main_path():
    # 12.29 MB of output and 36 KB of inputs at 3.35 TB/s; 98 MFLOP at
    # 67 TFLOP/s take less.
    ms, by = chip_smoke.st_decode_bound(1000, 32, 16, 2, 3)
    assert by == "bytes"
    bytes_moved = 4 * (1000 * 4 + 2 * 16 * 16 * 4 + 32 * 32 * 3
                       + 1000 * 32 * 32 * 3)
    assert ms == pytest.approx(bytes_moved / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(3.679e-3, abs=1e-6)


@pytest.mark.parametrize("n,img,tmpl,n_objs,ch", chip_smoke.ST_DECODE_SHAPES)
def test_every_smoke_shape_fits_the_kernel(n, img, tmpl, n_objs, ch):
    tkernel.check_limits(tdec.DecoderConfig((img, img), tmpl, n_objs, ch))


def test_expected_launches_count_a_cli_run(tmp_path, monkeypatch):
    """A tiny CLI run (8 train, 4 valid and 4 test sequences at seq 12, 4
    at seq 30; B=4, 2 epochs) calls the kernel's wrapper as often as
    chip_smoke.expected_launches says the card's run launches it."""
    import logging

    import numpy as np

    from paig_reproduction_tpu_torch import cli

    data = os.path.join(os.path.dirname(chip_smoke.__file__), "data",
                        "datasets", "spring_color")
    for name in ("color_spring_vx8_vy8_sl12_r2_k4_e6.npz",
                 "color_spring_vx8_vy8_sl30_r2_k4_e6.npz"):
        with np.load(os.path.join(data, name)) as d:
            (tmp_path / "spring_color").mkdir(exist_ok=True)
            np.savez(tmp_path / "spring_color" / name,
                     train_x=d["train_x"][:8], valid_x=d["valid_x"][:4],
                     test_x=d["test_x"][:4])
    fused = tkernel.st_decode_fused
    calls = []
    monkeypatch.setattr(tkernel, "st_decode_fused",
                        lambda *a: calls.append(1) or fused(*a))
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        trainer, _ = cli.main([
            "--task=spring_color", "--color", "--autoencoder_loss=3.0",
            "--batch_size=4", "--epochs=2", f"--data_dir={tmp_path}",
            f"--save_dir={tmp_path / 'run'}", "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    assert len(calls) == chip_smoke.expected_launches(
        trainer.step, 4, 4, 4, batch_size=4, epochs=2) == 28


def _tiny_data(tmp_path, n_train=8):
    import numpy as np

    data = os.path.join(os.path.dirname(chip_smoke.__file__), "data",
                        "datasets", "spring_color")
    (tmp_path / "spring_color").mkdir(exist_ok=True)
    for name in ("color_spring_vx8_vy8_sl12_r2_k4_e6.npz",
                 "color_spring_vx8_vy8_sl30_r2_k4_e6.npz"):
        with np.load(os.path.join(data, name)) as d:
            np.savez(tmp_path / "spring_color" / name,
                     train_x=d["train_x"][:n_train],
                     valid_x=d["valid_x"][:4], test_x=d["test_x"][:4])


def test_recipe_launches_count_a_recipe_run(tmp_path, monkeypatch):
    """chip_smoke.py's recipe flags, run tiny on the CPU (8 train, 4 valid
    and 4 test sequences, B=4): the kernel's wrapper is called as often as
    recipe_counts and recipe_decodes say the card's run launches it, the
    refinement's calls included, and every hook fires. Every train chunk
    and eval batch runs through a stand-in graph
    (tests/test_torch_chunk.py), and the counts that replays advance (the
    wrapper's, and chip_smoke.refinement_launches's, as chip_smoke.recipe
    counts on the card) are the same."""
    import logging

    from test_torch_chunk import FakeStep

    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.models import physics_net
    from paig_reproduction_tpu_torch.train import trainer as trainer_mod

    _tiny_data(tmp_path)
    monkeypatch.setenv("PAIG_FUSED", "1")
    monkeypatch.setitem(trainer_mod.CAPTURE_CLASSES, "cpu", FakeStep)
    FakeStep.made.clear()
    fused = tkernel.st_decode_fused
    calls = []

    def counted(*a):
        calls.append(1)
        tkernel.LAUNCHES += 1
        return fused(*a)

    monkeypatch.setattr(tkernel, "st_decode_fused", counted)
    monkeypatch.setattr(tkernel, "LAUNCHES", 0)
    refine = physics_net.refine_positions
    in_refine = []

    def counted_refine(*args, **kwargs):
        before = len(calls)
        out = refine(*args, **kwargs)
        in_refine.append(len(calls) - before)
        return out

    monkeypatch.setattr(physics_net, "refine_positions", counted_refine)
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    argv = [a for a in chip_smoke.RECIPE_ARGS if a != "--device=cuda"]
    save_dir = tmp_path / "run"
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        with chip_smoke.refinement_launches() as refine_count:
            trainer, test_trainer = cli.main(argv + [
                "--batch_size=4", f"--data_dir={tmp_path}",
                f"--save_dir={save_dir}", "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    counts = chip_smoke.recipe_counts(
        save_dir / "log.txt", arms=2, arm_epochs=1, loop_epochs=3,
        steps_per_epoch=2, valid_batches=1, test_batches=1, test30_batches=1)
    launches, refine_launches = chip_smoke.recipe_decodes(
        *counts, chip_smoke.REFINE_ITERS)
    assert len(calls) == launches
    assert sum(in_refine) == refine_launches
    assert set(in_refine) == {chip_smoke.REFINE_ITERS}
    assert sum(s.replays for s in FakeStep.made) > 0
    assert tkernel.LAUNCHES == launches
    assert refine_count() == refine_launches
    chip_smoke.check_fused_line(save_dir / "log.txt",
                                "fused step: on (captured CUDA graph)")
    log = (save_dir / "log.txt").read_text()
    for needle in ("discovery restart arm 2/2", "aux_on_recons trigger: ",
                   "- fit_physics: "):
        assert needle in log
    assert test_trainer.model.refine_recons_pos == chip_smoke.REFINE_ITERS
    assert trainer.train_net.refine_recons_pos == 0


def test_refinement_launches_count_replays(monkeypatch):
    """chip_smoke.refinement_launches and the captured step's own count
    on the card's terms: a capture runs the step's Python once and records
    its launches without changing either count, and a replay runs no
    Python and adds what its capture recorded."""
    from paig_reproduction_tpu_torch.models import physics_net
    from paig_reproduction_tpu_torch.train.graphs import CapturedStep

    def refine(*a, **k):
        tkernel.LAUNCHES += 4

    def step():
        tkernel.LAUNCHES += 2
        physics_net.refine_positions()

    class Recorded(CapturedStep):
        def _record(self, fn):
            fn()

        def _replay(self):
            pass

    monkeypatch.setattr(physics_net, "refine_positions", refine)
    monkeypatch.setattr(tkernel, "LAUNCHES", 0)
    with chip_smoke.refinement_launches() as refine_count:
        step()
        graph = Recorded(step)
        assert (tkernel.LAUNCHES, refine_count()) == (6, 4)
        assert graph.launches == 6
        for _ in range(3):
            graph.replay()
        assert (tkernel.LAUNCHES, refine_count()) == (6 + 3 * 6, 4 + 3 * 4)
    assert physics_net.refine_positions is refine


def test_recipe_flags_are_the_logged_recipes():
    """chip_smoke.py's recipe keeps benchmarks/spring_one5_test_log.txt's
    flags; only the depth flags differ."""
    log = os.path.join(os.path.dirname(chip_smoke.__file__), "benchmarks",
                       "spring_one5_test_log.txt")
    with open(log) as f:
        logged = {line.strip().split("=")[0]: line.strip()
                  for line in f if line.startswith("--")}
    smoke = {a.split("=")[0]: a for a in chip_smoke.RECIPE_ARGS}
    depth = {"--epochs", "--discovery_restarts", "--discovery_epochs",
             "--aux_on_recons", "--fit_physics_every", "--auto_rescue",
             "--max_rescues", "--save_every_n_epochs"}
    for flag, arg in logged.items():
        if flag in ("--save_dir", "--seed", "--batch_size"):
            continue
        assert flag in smoke, flag
        if flag not in depth:
            assert smoke[flag] == arg, flag


def test_task_flags_are_the_logged_recipes():
    """Every model flag of a task's smoke run is its logged recipe's; only
    the `extra` depth flags are not in the log."""
    for task, run in chip_smoke.TASK_RUNS.items():
        with open(os.path.join(os.path.dirname(chip_smoke.__file__),
                               run["log"])) as f:
            logged = {line.strip() for line in f if line.startswith("--")}
        assert f"--task={task}" in logged, task
        for flag in run["flags"]:
            assert flag in logged, (task, flag)
        for flag in run["extra"]:
            assert flag not in logged, (task, flag)


def test_task_timed_shapes_are_the_tasks_decodes():
    """The timed shapes hold every decode a task's B=100 run makes: the
    reconstructions and the rollout of its train length and the rollout of
    its test length."""
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.models.physics_net import COORD_UNITS

    for task in chip_smoke.TASK_RUNS:
        (_, _, _, seq, test_seq, inp, pred, size) = cli.TASK_TABLE[task]
        img = int(size ** 0.5)
        o = COORD_UNITS[task] // 4
        for frames in (inp + pred, seq - inp, test_seq - inp):
            assert (100 * frames, img, img // 2, o, 3) in \
                chip_smoke.TIMED_SHAPES, (task, frames)


@pytest.mark.parametrize("extra", [chip_smoke.LSTM_ARGS,
                                   chip_smoke.BF16_ARGS],
                         ids=["lstm", "bf16"])
def test_variant_launches_count_a_cli_run(tmp_path, monkeypatch, extra):
    """The lstm and bf16 phases' flags, run tiny on the CPU (8 train, 4
    valid and 4 test sequences, B=4, 1 epoch): the kernel's wrapper is
    called as chip_smoke.expected_launches says (the LSTM rollout in one
    decode), and the model is the phase's."""
    import logging

    from paig_reproduction_tpu_torch import cli

    _tiny_data(tmp_path)
    fused = tkernel.st_decode_fused
    calls = []
    monkeypatch.setattr(tkernel, "st_decode_fused",
                        lambda *a: calls.append(1) or fused(*a))
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    argv = [a for a in chip_smoke.TRAIN_ARGS if a != "--device=cuda"]
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        trainer, test_trainer = cli.main(argv + extra + [
            "--batch_size=4", "--epochs=1", f"--data_dir={tmp_path}",
            f"--save_dir={tmp_path / 'run'}", "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    assert len(calls) == chip_smoke.expected_launches(
        trainer.step, 4, 4, 4, batch_size=4, epochs=1) == 20
    flags = dict(a[2:].split("=") for a in extra)
    for model in (trainer.model, test_trainer.model):
        assert model.cell_type == flags.get("cell_type", "spring_ode_cell")
        assert model.compute_dtype == flags.get("compute_dtype", "float32")


def test_hang_under_watchdog_exits_75(tmp_path):
    """The runtime phase's hung run, tiny on the CPU: the subprocess's
    train step sleeps past the watchdog, which ends it with 75."""
    _tiny_data(tmp_path)
    argv = [a for a in chip_smoke.TRAIN_ARGS if a != "--device=cuda"]
    code, fired, seconds = chip_smoke.hang_under_watchdog(argv + [
        "--batch_size=4", f"--data_dir={tmp_path}",
        f"--save_dir={tmp_path / 'run'}", "--device=cpu"])
    assert code == 75 and len(fired) == 1
    assert seconds < 100


def test_check_fused_line(tmp_path):
    log = tmp_path / "log.txt"
    log.write_text("2026-01-01 00:00:00,000 - paig - fused step: off "
                   "(--debug_nans syncs the host at every operation)\n")
    chip_smoke.check_fused_line(log, "fused step: off (--debug_nans")
    with pytest.raises(AssertionError, match="does not say"):
        chip_smoke.check_fused_line(log)
    log.write_text("no such line\n")
    with pytest.raises(AssertionError, match="does not say"):
        chip_smoke.check_fused_line(log, "fused step: off")


def test_parallel_errors_parse_the_workers_results():
    import numpy as np

    rs = np.random.RandomState(0)
    ref = {"losses": np.array([1.0, 2.0, 4.0, 8.0]),
           "split": np.array(["a"]),
           "g/a": rs.randn(3, 2), "g/b": rs.randn(4) * 10}
    got = {k: v.copy() for k, v in ref.items()}
    got["losses"][2] *= 1 + 2e-6
    got["g/a"][0, 0] += 1e-3
    errors = chip_smoke.parallel_errors(ref, got)
    assert errors["loss_rel"] == pytest.approx(2e-6)
    largest = max(np.abs(ref["g/a"]).max(), np.abs(ref["g/b"]).max())
    assert errors["grad"] == pytest.approx(1e-3 / largest)
    assert errors["split_grad"] == pytest.approx(
        1e-3 / np.abs(ref["g/a"]).max())
    assert "param_rel" not in errors
    steps = {"losses": np.ones(4), "p/a": np.full(3, 2.0), "graphs":
             np.array(1), "split": np.array([], dtype=str)}
    moved = dict(steps, **{"p/a": np.array([2.0, 2.0, 2.0 + 1e-6])})
    errors = chip_smoke.parallel_errors(steps, moved)
    assert errors == {"loss_rel": 0.0, "param_rel": pytest.approx(5e-7)}
    with pytest.raises(AssertionError, match="different parameters"):
        chip_smoke.parallel_errors(ref, dict(got, **{"g/c": ref["g/a"]}))


def test_graph_and_parallel_configs_are_the_cli_flags():
    """The graph phase's configurations parse with the CLI's flags and
    carry the tasks' logged model flags; the parallel phase runs the main
    path's command."""
    from paig_reproduction_tpu_torch import cli

    parser = cli.build_parser()
    for name, argv in chip_smoke.GRAPH_CONFIGS.items():
        args = parser.parse_args(argv)
        assert args.device == "cuda"
        if name in chip_smoke.TASK_RUNS:
            assert set(chip_smoke.TASK_RUNS[name]["flags"]) <= set(argv)
    assert parser.parse_args(chip_smoke.GRAPH_CONFIGS["lstm"]).cell_type \
        == "lstm"
    assert chip_smoke.PARALLEL_ARGS == chip_smoke.TRAIN_ARGS
