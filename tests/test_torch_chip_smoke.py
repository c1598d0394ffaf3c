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


def _counted_recipe_run(tmp_path, monkeypatch, smoke_argv):
    """``smoke_argv`` run tiny on the CPU (8 train, 4 valid and 4 test
    sequences, B=4) with every train chunk and eval batch through a
    stand-in graph (tests/test_torch_chunk.py). Returns the trainers, the
    save_dir, the kernel wrapper's calls and the refinement's share of
    each call of it, after checking that the counts that replays advance
    (the wrapper's, and chip_smoke.refinement_launches's, as the card's
    phases count) agree with the calls."""
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
    argv = [a for a in smoke_argv if a != "--device=cuda"]
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
    assert sum(s.replays for s in FakeStep.made) > 0
    assert tkernel.LAUNCHES == len(calls)
    assert refine_count() == sum(in_refine)
    chip_smoke.check_fused_line(save_dir / "log.txt",
                                "fused step: on (captured CUDA graph)")
    return trainer, test_trainer, save_dir, calls, in_refine


def test_recipe_launches_count_a_recipe_run(tmp_path, monkeypatch):
    """chip_smoke.py's recipe flags, run tiny on the CPU: the kernel's
    wrapper is called as often as recipe_counts and recipe_decodes say the
    card's run launches it, the refinement's calls included, and every
    hook fires."""
    trainer, test_trainer, save_dir, calls, in_refine = _counted_recipe_run(
        tmp_path, monkeypatch, chip_smoke.RECIPE_ARGS)
    counts = chip_smoke.recipe_counts(
        save_dir / "log.txt", arms=2, arm_epochs=1, loop_epochs=3,
        steps_per_epoch=2, valid_batches=1, test_batches=1, test30_batches=1)
    launches, refine_launches = chip_smoke.recipe_decodes(
        *counts, chip_smoke.REFINE_ITERS)
    assert len(calls) == launches
    assert sum(in_refine) == refine_launches
    assert set(in_refine) == {chip_smoke.REFINE_ITERS}
    log = (save_dir / "log.txt").read_text()
    for needle in ("discovery restart arm 2/2", "aux_on_recons trigger: ",
                   "- fit_physics: "):
        assert needle in log
    assert test_trainer.model.refine_recons_pos == chip_smoke.REFINE_ITERS
    assert trainer.train_net.refine_recons_pos == 0


def test_bf16_recipe_launches_count_a_cli_run(tmp_path, monkeypatch):
    """chip_smoke.py's bf16 recipe (bf16 with the enhancers of
    spring_bf16_one1's logged argv; one arm of one epoch, one loop epoch),
    run tiny on the CPU: the wrapper is called as recipe_counts and
    recipe_decodes say, and every eval model runs in bf16 with the
    enhancers."""
    from paig_reproduction_tpu_torch.tools.reference_runs import RUNS

    logged = RUNS["spring_bf16_one1"]["argv"]
    for flag in ["--compute_dtype=bfloat16"] + chip_smoke.RECIPE_MODEL_FLAGS:
        assert flag in logged and flag in chip_smoke.BF16_RECIPE_ARGS, flag
    trainer, test_trainer, save_dir, calls, in_refine = _counted_recipe_run(
        tmp_path, monkeypatch, chip_smoke.BF16_RECIPE_ARGS)
    counts = chip_smoke.recipe_counts(
        save_dir / "log.txt", arms=1, arm_epochs=1, loop_epochs=1,
        steps_per_epoch=2, valid_batches=1, test_batches=1, test30_batches=1)
    assert counts == (4, 5, 4)
    launches, refine_launches = chip_smoke.recipe_decodes(
        *counts, chip_smoke.REFINE_ITERS)
    assert (len(calls), sum(in_refine)) == (launches, refine_launches)
    assert "discovery restart arm 1/1: valid recons" in \
        (save_dir / "log.txt").read_text()
    for model in (trainer.model, test_trainer.model):
        assert model.compute_dtype == "bfloat16"
        assert model.init_state_fit == 3
        assert model.refine_recons_pos == chip_smoke.REFINE_ITERS
    assert trainer.train_net.refine_recons_pos == 0


def test_recipe_swaps_hold_and_count_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    """recipe_swaps_vs_eager on tiny files (8 train, 4 valid sequences,
    B=4: two steps an epoch, one eval batch) on the CPU, where the fused
    trainer calls the step body directly: each trainer goes through the
    arms (the first kept), the steps, the rescue, the steps, the trigger
    and the steps in that order; the parameters are bitwise equal after
    each block; each block's line and the launches line are printed; and
    the wrapper is called as recipe_decodes says for 2 arms of 2 steps, 3
    blocks of 2 steps and 3 valid evals of one batch."""
    import numpy as np
    import torch

    from paig_reproduction_tpu_torch.train.trainer import Trainer

    data = os.path.join(os.path.dirname(chip_smoke.__file__), "data",
                        "datasets", "spring_color")
    name = "color_spring_vx8_vy8_sl12_r2_k4_e6.npz"
    (tmp_path / "spring_color").mkdir()
    with np.load(os.path.join(data, name)) as d:
        np.savez(tmp_path / "spring_color" / name, train_x=d["train_x"][:8],
                 valid_x=d["valid_x"][:4], test_x=d["test_x"][:4])
    fused = tkernel.st_decode_fused

    def counted(*a):
        tkernel.LAUNCHES += 1
        return fused(*a)

    monkeypatch.setattr(tkernel, "st_decode_fused", counted)
    monkeypatch.setattr(tkernel, "LAUNCHES", 0)
    events = {}

    def spy(method, label):
        real = getattr(Trainer, method)

        def wrapped(self, *a, **k):
            events.setdefault(id(self), []).append(label)
            return real(self, *a, **k)

        monkeypatch.setattr(Trainer, method, wrapped)

    for method, label in (("run_discovery_restarts", "arms"),
                          ("_do_auto_rescue", "rescue"),
                          ("_after_valid_eval", "trigger"),
                          ("train_chunk", "chunk"), ("train_step", "step")):
        spy(method, label)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.recipe_swaps_vs_eager(
            chip_smoke.SWAP_ARGS, str(tmp_path), steps=2, batch_size=4,
            device="cpu")
    finally:
        torch.set_num_threads(threads)
    fused_events, eager_events, again_events = events.values()
    # The fused trainer: one chunk an arm, then one of 2 steps a block.
    assert fused_events == ["arms", "chunk", "chunk", "chunk", "rescue",
                            "chunk", "trigger", "chunk"]
    assert eager_events == again_events == (
        ["arms"] + ["step"] * 4 + ["step"] * 2 + ["rescue"] + ["step"] * 2
        + ["trigger"] + ["step"] * 2)
    assert list(out["blocks"]) == list(chip_smoke.SWAP_BLOCKS)
    for block in out["blocks"].values():
        assert block["bitwise"] and block["eager_bitwise"]
        assert block["param_rel"] == block["eager_rel"] == 0.0
    assert (out["expected"], out["expected_refine"]) == \
        chip_smoke.recipe_decodes(2 * 2 + 3 * 2, 3, 0,
                                  chip_smoke.REFINE_ITERS) == (38, 12)
    assert out["launches"] == [38, 38] and out["refine_launches"] == [12, 12]
    assert [len(s) for s in out["scores"]] == [3, 3, 3]
    assert out["score_rel"] == 0.0
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("recipe swaps")]
    assert len(lines) == 4
    for line, block in zip(lines, chip_smoke.SWAP_BLOCKS):
        assert line.startswith(f"recipe swaps, after the {block} block and "
                               f"2 steps: ")
        assert ("graphed against eager 0.000e+00 (bitwise equal); eager "
                "against eager 0.000e+00 (bitwise equal) (tolerance "
                "1e-05)") in line
    assert lines[3].startswith("recipe swaps: st_decode launches, fused / "
                               "eager 38 / 38 (expected 38: ")


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
    assert parser.parse_args(
        chip_smoke.GRAPH_CONFIGS["bf16"]).compute_dtype == "bfloat16"
    assert {"bouncing_balls", "spring_color_half"} <= set(
        chip_smoke.GRAPH_CONFIGS)
    recipe = parser.parse_args(chip_smoke.GRAPH_CONFIGS["spring_recipe"])
    assert set(chip_smoke.RECIPE_MODEL_FLAGS) <= set(chip_smoke.RECIPE_ARGS)
    assert (recipe.task, recipe.pos_consistency, recipe.vel_anchor,
            recipe.init_state_fit, recipe.enhancers_eval_only) == (
        "spring_color", 1.0, 1.0, 3, True)
    assert len(chip_smoke.GRAPH_CONFIGS) == 8
    assert chip_smoke.PARALLEL_ARGS == chip_smoke.TRAIN_ARGS


@pytest.fixture
def one_thread():
    """One intra-op thread for a test's small models: more threads run
    them no faster, and beside the suite's other workers they contend."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_cli(argv):
    import logging

    from paig_reproduction_tpu_torch import cli

    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        return cli.main(argv)
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()


def test_pipeline_helpers_count_and_parse_the_tools(tmp_path, monkeypatch,
                                                    one_thread):
    """The pipeline phase's helpers on the tools' own output, tiny on the
    CPU (16 train, 4 valid and 4 test sequences, B=4): a discovery run's
    valid recons by epoch; fit_physics's printed numbers (the checkpoint
    holding them) and its launches (tool_launches); analyze_tail's report
    and launches (analyze_tail_launches); seed_sweep's launches
    (sweep_launches); each counted as calls of the kernel's wrapper inside
    chip_smoke.stage."""
    import json

    import numpy as np

    from paig_reproduction_tpu_torch.tools import (
        analyze_tail,
        fit_physics,
        seed_sweep,
    )
    from paig_reproduction_tpu_torch.train.checkpoint import load_checkpoint

    _tiny_data(tmp_path, n_train=16)
    calls = []
    fused = tkernel.st_decode_fused

    def counted(*a):
        tkernel.LAUNCHES += 1
        return fused(*a)

    monkeypatch.setattr(tkernel, "st_decode_fused", counted)
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    argv = [a for a in chip_smoke.TRAIN_ARGS if a != "--device=cuda"]
    disc = tmp_path / "disc"
    stages = {}
    with chip_smoke.stage("discovery", stages):
        trainer, _ = _run_cli(argv + [
            "--batch_size=4", "--epochs=4", "--print_interval=4",
            "--eval_every_n_epochs=2", f"--data_dir={tmp_path}",
            f"--save_dir={disc}", "--device=cpu"])
    recons = chip_smoke.valid_recons(disc / "log.txt")
    assert sorted(recons) == [0, 2, 4]
    assert all(np.isfinite(list(recons.values())))
    assert stages["discovery"]["launches"] == chip_smoke.expected_launches(
        trainer.step, 4, 4, 4, batch_size=4, epochs=4, eval_every=2) == 52

    with chip_smoke.stage("fit_physics", stages):
        fitted, printed = chip_smoke.echoed(fit_physics.main, [
            "--task=spring_color", f"--ckpt_dir={disc}",
            f"--data_dir={tmp_path}", "--write", "--device=cpu"])
    fits = chip_smoke.fit_lines(printed)
    assert stages["fit_physics"]["launches"] == chip_smoke.tool_launches(8)
    assert stages["fit_physics"]["seconds"] > 0
    np.testing.assert_allclose(fitted["frame_offset"], fits["offsets"],
                               rtol=0, atol=0.005 + 1e-6)
    assert abs(np.exp(fitted["log_k"]) - fits["trajectory"]["k"]) <= 5e-5
    written = load_checkpoint(str(disc))["model"]
    np.testing.assert_array_equal(written["log_equil"].numpy(),
                                  fitted["log_equil"])
    assert set(fits["pointwise"]) == {"k", "equil"}

    data = tmp_path / "spring_color" / "color_spring_vx8_vy8_sl30_r2_k4_e6.npz"
    with chip_smoke.stage("analyze_tail", stages):
        report, printed = chip_smoke.echoed(analyze_tail.main, [
            f"--ckpt_dir={disc}", f"--data={data}", "--batch=3",
            f"--out={tmp_path / 'tail.npz'}", "--device=cpu"])
    assert json.loads(printed.split("saved arrays ->")[0]) == report
    assert report["n_sequences"] == 4
    assert stages["analyze_tail"]["launches"] == \
        chip_smoke.analyze_tail_launches(4, 3) == 8

    with chip_smoke.stage("seed_sweep", stages):
        _, printed = chip_smoke.echoed(seed_sweep.main, [
            "--task=spring_color", "--seeds", "0", "1", "--epochs=1",
            "--batch_size=4", f"--data_dir={tmp_path}",
            f"--save_root={tmp_path / 'sweep'}",
            f"--out={tmp_path / 'sweep.json'}", "--device=cpu"])
    assert "best seed: " in printed
    assert stages["seed_sweep"]["launches"] == 2 * chip_smoke.sweep_launches(
        4, 4, 4, batch_size=4, epochs=1) == 2 * 16


def test_chain_phase_counts_every_stage_on_the_cpu(tmp_path, monkeypatch,
                                                  one_thread):
    """The chain phase tiny on the CPU (8 train, 4 valid and 4 test
    sequences of the tracked 3bp files, 4 of the seq-40 file; B=8, 1
    epoch a curriculum stage, 2 pinned; fit_physics on 1 batch): every
    stage's decodes, counted as calls of the kernel's wrapper, are what
    chain_launches says, and each training stage's steps what its epochs
    make; the chain_epochs it reads; a stage whose count is off fails the
    phase."""
    import functools

    import numpy as np

    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.tools import fit_physics

    data = os.path.join(os.path.dirname(chip_smoke.__file__), "data",
                        "datasets")
    (tmp_path / "3bp_color").mkdir()
    for rel, n in zip(cli.TASK_TABLE["3bp_color"][:2], (8, 4)):
        with np.load(os.path.join(data, rel)) as d:
            np.savez(tmp_path / rel, train_x=d["train_x"][:n],
                     valid_x=d["valid_x"][:4], test_x=d["test_x"][:4])
    fused = tkernel.st_decode_fused

    def counted(*a):
        tkernel.LAUNCHES += 1
        return fused(*a)

    monkeypatch.setattr(tkernel, "st_decode_fused", counted)
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    monkeypatch.setattr(fit_physics, "encoder_positions", functools.partial(
        fit_physics.encoder_positions, n_batches=1, batch_size=8))
    tool_launches = chip_smoke.tool_launches
    monkeypatch.setattr(chip_smoke, "tool_launches",
                        lambda n, f=1: tool_launches(1, f))
    assert chip_smoke.chain_epochs() == {
        "curriculum_1": 1, "curriculum_2": 1, "curriculum_3": 1,
        "pinned": 2}
    stages, out = chip_smoke.chain(batch_size=8, data_dir=str(tmp_path),
                                   device="cpu")
    assert {k: v["launches"] for k, v in stages.items()} == {
        "curriculum_1": 18, "curriculum_2": 18, "curriculum_3": 18,
        "surgery": 0, "pinned": 24, "fit": 4, "test": 4, "test_refine": 10}
    assert all(v["seconds"] > 0 for v in stages.values())
    assert {k: r["steps"] for k, r in out["stages"].items()
            if r["kind"] == "train"} == {
        "curriculum_1": 1, "curriculum_2": 1, "curriculum_3": 1, "pinned": 2}
    # The same counts at B=100 on the tracked files: what the card's run
    # must launch (20 steps an epoch, 200 valid and test sequences, 150
    # seq-40 ones, fit_physics's 8 batches).
    monkeypatch.setattr(chip_smoke, "tool_launches", tool_launches)
    from paig_reproduction_tpu_torch.tools import reference_runs as rr
    full = {s["name"]: chip_smoke.chain_launches(
        s, chip_smoke.chain_epochs().get(s["name"], 0), 2000, 200, 200, 150,
        100) for s in rr.chain_stages((1, 1, 1), 2, eval_every=1)}
    assert full == {"curriculum_1": 62, "curriculum_2": 62,
                    "curriculum_3": 62, "surgery": 0, "pinned": 108,
                    "fit": 18, "test": 4, "test_refine": 10}
    # A miscount fails the phase (the runner's result read again).
    monkeypatch.setattr(rr, "run_chain", lambda *a, **k: out)
    monkeypatch.setattr(chip_smoke, "tool_launches",
                        lambda n, f=1: tool_launches(1, f) + 1)
    with pytest.raises(AssertionError, match="fit did not decode"):
        chip_smoke.chain(batch_size=8, data_dir=str(tmp_path),
                         device="cpu")


def test_slot_separation():
    import numpy as np

    enc = np.zeros((2, 3, 4))
    enc[..., 2:] = [3.0, 4.0]
    assert chip_smoke.slot_separation(enc) == 5.0
    enc[1, :, 2:] = 0.0
    assert chip_smoke.slot_separation(enc) == 2.5
    assert chip_smoke.slot_separation(np.ones((5, 10, 4))) == 0.0


def test_kernels_line_has_every_phase(capsys):
    """The kernels line of made-up numbers: the contract's keys, and the
    launches of every phase, the native loader's fused run's and the
    pipeline's stages included."""
    import json

    timing = dict(ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes",
                  share_of_bound=0.5, store_floor_ms=0.7)
    timings = {shape: timing for shape in chip_smoke.TIMED_SHAPES}
    runs = dict(
        recipe=dict(launches=442, refine_launches=128, swaps=dict(
            launches=[3380, 3380], refine_launches=[400, 400], blocks={
                b: dict(param_rel=0.0) for b in chip_smoke.SWAP_BLOCKS})),
        tasks={"3bp_color": dict(launches=72)}, lstm=dict(
            launches=11430, test={"pred": 19.0}, log_test={"pred": 19.16},
            limits={"pred": 21.08}, valid10_pred=20.3, last_pred=19.2,
            wall_s=200.0, steps=3750, eval_s=90.0, step_ms=23.3),
        bf16=dict(launches=130, recipe=dict(launches=100)),
        runtime=dict(launches=30),
        native=dict(launches=130, fused_launches=130),
        graph=dict(param_rel=0.0, bitwise=True, eval_rel=0.0, steps={}),
        pipeline={"discovery": dict(seconds=1.0, launches=2818),
                  "slot_rescue": dict(seconds=1.0, launches=0)},
        chain={"curriculum_1": dict(seconds=21.5, launches=62),
               "surgery": dict(seconds=0.6, launches=0)})
    line = chip_smoke.kernels_line(130, 5e-6, timings, {"jvp_ms": 1.0}, runs)
    assert "\n" not in line
    (kernel,) = json.loads(line)["kernels"]
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in kernel
    assert kernel["route"] == "cuda" and kernel["launches"] == 130
    assert kernel["pipeline_launches"] == {"discovery": 2818,
                                           "slot_rescue": 0}
    assert kernel["chain_launches"] == {"curriculum_1": 62, "surgery": 0}
    assert kernel["native_loader_fused_launches"] == 130
    assert kernel["task_launches"] == {"3bp_color": 72}
    assert kernel["lstm_launches"] == 11430
    assert kernel["bf16_recipe_launches"] == 100
    assert kernel["recipe_swaps"] == {
        "launches": [3380, 3380], "refine_launches": [400, 400],
        "kept arm restored": 0.0, "rescue": 0.0, "trigger": 0.0}
    assert kernel["lstm_proof"]["test"] == {"pred": 19.0}
    assert kernel["lstm_proof"]["steps"] == 3750
    # Only numbers measured in the run: the log's and the limits derived
    # from it are printed by the lstm phase, not carried here.
    assert not {"log_test", "limits"} & set(kernel["lstm_proof"])


def test_pipeline_flags_are_the_cli_flags():
    """The aligned resume's flags parse with the CLI's and are
    docs/TRAINING.md's fine-tune extensions."""
    from paig_reproduction_tpu_torch import cli

    args = cli.build_parser().parse_args(chip_smoke.TRAIN_ARGS
                                         + chip_smoke.ALIGN_ARGS)
    assert (args.pos_consistency, args.vel_anchor,
            args.learn_frame_offset) == (1.0, 1.0, True)
    assert chip_smoke.PIPELINE_EPOCHS == 50


@pytest.mark.parametrize("seed", [chip_smoke.DISCOVERY_SEED, 1,
                                  chip_smoke.DEAD_SEED])
def test_discovery_seed_has_live_slots(seed):
    """Why the seed-sweep stage holds DEAD_SEED beside DISCOVERY_SEED: the
    ShallowUNet's final ReLU passes a slot's mask logit only where the
    final 1x1 conv's output is positive (at initialization, on 20 train
    sequences). With the JAX package's initial weights (the CLI's --seed)
    DISCOVERY_SEED (0, the JAX package's spring500 run's and the logged
    LSTM run's) has one live slot, seed 1 two and DEAD_SEED none, so no
    gradient reaches its UNet and its slots never part."""
    import numpy as np
    import torch

    from paig_reproduction_tpu_torch import cli

    args = cli.build_parser().parse_args(
        [a for a in chip_smoke.TRAIN_ARGS if a != "--device=cuda"]
        + ["--device=cpu", f"--seed={seed}"])
    unet = cli.build_model(args, 12).encoder.unet
    name = "color_spring_vx8_vy8_sl12_r2_k4_e6.npz"
    with np.load(os.path.join(chip_smoke.DATA_DIR, "spring_color",
                              name)) as d:
        x = torch.from_numpy(d["train_x"][:20, :10]).permute(0, 1, 4, 2, 3)
    seen = {}
    unet.convs[-1].register_forward_hook(
        lambda m, i, out: seen.setdefault("logits", out))
    with torch.no_grad():
        unet(x.reshape(200, 3, 32, 32).float() / 255)
    live = (seen["logits"] > 0).flatten(2).any(-1).any(0)   # per slot
    assert int(live.sum()) == {chip_smoke.DISCOVERY_SEED: 1, 1: 2,
                               chip_smoke.DEAD_SEED: 0}[seed]
