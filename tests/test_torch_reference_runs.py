"""The reference runner (``paig_reproduction_tpu_torch/tools/reference_runs.py``)
and chip_smoke.py's ``lstm`` phase, on the CPU: each run's argv is its
log's flag header (or its queue script's lines where the header was
thinned) less ``--save_dir``; the logs' test lines parse in both of their
formats; every argv means the same to the port's CLI and the JAX
package's; the resume decision; a tiny run cut after its first checkpoint
and resumed by the runner; and the ``lstm`` phase's flags and quality
check.
"""
import logging
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from paig_reproduction_tpu import cli as jax_cli
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.tools import reference_runs as rr
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "datasets", "spring_color")
SL12 = "color_spring_vx8_vy8_sl12_r2_k4_e6.npz"
SL30 = "color_spring_vx8_vy8_sl30_r2_k4_e6.npz"


@pytest.fixture
def one_thread():
    """One intra-op thread for a test's small models: more threads run
    them no faster, and beside the suite's other workers they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _queue_flags(where):
    """The ``--`` words of a queue script's lines ``path:first-last``."""
    path, lines = where.rsplit(":", 1)
    first, last = (int(x) for x in lines.split("-"))
    with open(os.path.join(REPO, path)) as f:
        text = f.read().splitlines()[first - 1:last]
    assert text[0].startswith("run "), text[0]
    return [w for line in text for w in line.split() if w.startswith("--")]


@pytest.mark.parametrize("name", sorted(rr.RUNS))
def test_argv_is_the_logged_flags(name):
    """The argv is the log's flag header less --save_dir; where the header
    was thinned, the queue script's lines (whose first flags a thinned
    header still shows)."""
    spec = rr.RUNS[name]
    header = rr.parse_log(rr.log_path(name))["header"]
    if spec["argv_from"] == "header":
        assert header[0] == "--save_dir=runs/" + name
        assert spec["argv"] == header[1:]
    else:
        assert spec["argv"] == _queue_flags(spec["argv_from"])
        if header:
            assert header[0] == "--save_dir=runs/" + name
            assert header[1:] == spec["argv"][:len(header) - 1]


def test_thinned_header_runs_are_the_queue_scripts():
    """Exactly the two runs whose logs were thinned read their argv from a
    queue script, and both logs say they were thinned."""
    thinned = sorted(n for n, s in rr.RUNS.items()
                     if s["argv_from"] != "header")
    assert thinned == ["lstm_proof", "spring_bf16_one1"]
    for name in thinned:
        with open(rr.log_path(name)) as f:
            assert "[...thinned...]" in f.read()


@pytest.mark.parametrize("log", [
    "benchmarks/spring_one5_test_log.txt",      # '... - paig - test - ...'
    "benchmarks/mnist_test_log.txt",            # 'INFO:paig:test - ...'
    "benchmarks/lstm_proof_log.txt", "benchmarks/half_one1_test_log.txt",
    "benchmarks/mnist_one2_test_log.txt",
    "benchmarks/spring_bf16_test_log.txt",
    "benchmarks/bounce_one1_test_log.txt"])
def test_test_line_parses_in_both_formats(log):
    """The parsed final test line is the log's last ``test - epoch=`` line,
    whichever of the two line formats it is written in."""
    with open(os.path.join(REPO, log)) as f:
        last = [line for line in f if "test - epoch=" in line][-1]
    values = dict(re.findall(r"eval_(\w+)_loss=(\S+)", last))
    parsed = rr.parse_log(os.path.join(REPO, log))
    assert parsed["test"] == {k: float(values[k]) for k in rr.KEYS}
    assert parsed["test_epoch"] == int(
        re.search(r"test - epoch=(\d+)", last).group(1))


def test_logged_results_and_events():
    """The numbers the runs are held to, as the logs give them: the final
    test lines, the arms, the trigger, the rescues and the fits."""
    got = {n: rr.parse_log(rr.log_path(n)) for n in rr.RUNS}
    assert {n: (round(g["test"]["pred"], 3), round(g["test"]["recons"], 3))
            for n, g in got.items()} == {
        "spring_one5": (0.279, 0.114), "half_one1": (2.367, 0.875),
        "mnist_one2": (2.804, 0.688), "lstm_proof": (19.160, 10.043),
        "spring_bf16_one1": (25.054, 7.525),
        "bounce_one1": (18.956, 10.393)}
    one5 = got["spring_one5"]
    assert len(one5["arms"]) == 8 and one5["arms"][6] == 8.457
    assert (one5["trigger"], one5["rescues"]) == (255, [250])
    assert one5["fits"] == [(4.2379, 5.8133)]
    assert got["mnist_one2"]["trigger"] == 1
    assert got["bounce_one1"]["rescues"] == [250, 500]
    assert got["lstm_proof"]["valid"][10]["pred"] == 20.32837677001953
    assert [n for n, g in got.items() if all(
        g["test"][k] < v for k, v in rr.RUNS[n]["bars"].items())] == [
        "spring_one5", "half_one1", "mnist_one2"]


@pytest.mark.parametrize("name", sorted(rr.RUNS))
def test_argv_means_the_same_to_both_clis(name):
    """Every flag that both CLIs have parses to the same value."""
    argv = rr.RUNS[name]["argv"] + ["--save_dir=/tmp/x"]
    port = vars(cli.build_parser().parse_args(argv))
    ref = vars(jax_cli.build_parser().parse_args(argv))
    shared = set(port) & set(ref)
    assert len(shared) >= len(ref) - 1
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    assert port["device"] == "cuda"


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("".join(f"2026-01-01 00:00:00,000 - paig - {line}\n"
                        for line in lines))


def test_resume_decision(tmp_path):
    """A fresh dir; one cut inside its arms (a log, no checkpoint); one cut
    after them (a checkpoint, no test line); one trained but without its
    seq-30 phase; a finished one."""
    assert rr.resume_decision(str(tmp_path / "none")) == "fresh"
    arms = tmp_path / "arms"
    _write(str(arms / "log.txt"),
           ["discovery restart arm 1/8: valid recons 10.349 after 150 "
            "epochs"])
    assert rr.resume_decision(str(arms)) == "restart"
    cut = tmp_path / "cut"
    _write(str(cut / "log.txt"), [
        "discovery restarts: continuing from arm 0 (valid recons 1.0)",
        "valid - epoch=50 eval_extrap_loss=1 eval_pred_loss=2 "
        "eval_recons_loss=3"])
    (cut / "model.ckpt").write_bytes(b"x")
    assert rr.resume_decision(str(cut)) == "resume"
    trained = tmp_path / "trained"
    _write(str(trained / "log.txt"), [
        "test - epoch=850 eval_extrap_loss=1 eval_pred_loss=2 "
        "eval_recons_loss=3"])
    (trained / "model.ckpt").write_bytes(b"x")
    assert rr.resume_decision(str(trained)) == "test"
    done = tmp_path / "done"
    _write(str(done / "log.txt"), [
        "test - epoch=850 eval_extrap_loss=1 eval_pred_loss=2 "
        "eval_recons_loss=3",
        "test - epoch=0 eval_extrap_loss=1 eval_pred_loss=2 "
        "eval_recons_loss=3"])
    (done / "model.ckpt").write_bytes(b"x")
    assert rr.resume_decision(str(done)) == "done"


def test_runner_raises_without_a_card(monkeypatch, tmp_path):
    """No CUDA device: the runner refuses unless --device=cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        rr.main(["--run", "spring_one5", "--save_dir", str(tmp_path / "r")])


def _tiny_data(dst, n_train=16, n_eval=8):
    (dst / "spring_color").mkdir(parents=True, exist_ok=True)
    for name in (SL12, SL30):
        with np.load(os.path.join(DATA, name)) as d:
            np.savez(dst / "spring_color" / name,
                     train_x=d["train_x"][:n_train],
                     valid_x=d["valid_x"][:n_eval],
                     test_x=d["test_x"][:n_eval])


def test_cut_run_resumes_for_exactly_the_remaining_epochs(
        tmp_path, monkeypatch, one_thread):
    """A tiny recipe run (B=8, 16/8/8 sequences at 32 px, --epochs=3, one
    discovery arm of one epoch, a save every epoch) cut by a SIGTERM right
    after its first checkpoint, then run again by the runner: it resumes
    from that checkpoint, trains the one loop epoch left (3 less the arm's
    less the one done) and ends with the seq-30 phase's test line."""
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    data = tmp_path / "data"
    _tiny_data(data)
    monkeypatch.setitem(rr.RUNS, "tiny", dict(
        argv=["--task=spring_color", "--epochs=3", "--batch_size=8",
              "--base_lr=6e-4", "--autoencoder_loss=3.0", "--color",
              "--seed=0", "--discovery_restarts=1", "--discovery_epochs=1",
              "--save_every_n_epochs=1"],
        argv_from="header", log="benchmarks/spring_one5_test_log.txt",
        bars=rr.BALL_BARS, physics=(4.0, 6.0)))
    save_dir = str(tmp_path / "run")
    save = Trainer.save

    def save_then_stop(self):
        save(self)
        raise rr._Terminated()

    with monkeypatch.context() as mp:
        mp.setattr(Trainer, "save", save_then_stop)
        with pytest.raises(SystemExit):
            rr.main(["--run", "tiny", "--save_dir", save_dir,
                     "--data_dir", str(data), "--device=cpu"])
    ckpt = torch.load(os.path.join(save_dir, "model.ckpt"),
                      weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (1, 4)  # the arm's 2 steps + 2
    assert ckpt["recipe"]["arm_epochs"] == 1
    assert rr.resume_decision(save_dir) == "resume"

    out = rr.main(["--run", "tiny", "--save_dir", save_dir,
                   "--data_dir", str(data), "--device=cpu"])
    ckpt = torch.load(os.path.join(save_dir, "model.ckpt"),
                      weights_only=True)
    assert (ckpt["total_epochs_done"], ckpt["step"]) == (2, 6)
    port = rr.parse_log(os.path.join(save_dir, "log.txt"))
    assert sorted(port["valid"]) == [0, 1, 2] and port["segments"] == 2
    assert port["test_epoch"] == 0 and rr.resume_decision(save_dir) == "done"
    assert out["segments"] == ["fresh", "resume"]
    assert out["train_steps"] == 6 and out["launches"] == 0
    assert out["port_test"] == port["test"]
    assert out["log_test"]["pred"] == rr.parse_log(
        rr.log_path("spring_one5"))["test"]["pred"]


def test_lstm_phase_is_the_logged_run():
    """chip_smoke.py's lstm phase runs lstm_proof's argv, which is
    tools/tpu_queue_r4.sh:59-62's."""
    assert chip_smoke.LSTM_PROOF == "lstm_proof"
    assert rr.RUNS["lstm_proof"]["argv_from"] == "tools/tpu_queue_r4.sh:59-62"
    assert rr.RUNS["lstm_proof"]["argv"] == _queue_flags(
        "tools/tpu_queue_r4.sh:59-62")
    args = cli.build_parser().parse_args(chip_smoke.lstm_proof_argv(
        "/d", "/s"))
    assert (args.epochs, args.cell_type, args.batch_size, args.device,
            args.print_interval) == (150, "lstm", 100, "cuda", 10)


def _port_log(path, pred10, pred_last, test):
    _write(path, [
        "valid - epoch=10 eval_extrap_loss=20 eval_pred_loss=%r "
        "eval_recons_loss=20" % pred10,
        "valid - epoch=150 eval_extrap_loss=20 eval_pred_loss=%r "
        "eval_recons_loss=10" % pred_last,
        "test - epoch=150 eval_extrap_loss=20 eval_pred_loss=19 "
        "eval_recons_loss=10",
        "test - epoch=0 eval_extrap_loss=20 eval_pred_loss=%r "
        "eval_recons_loss=%r" % test])


def test_lstm_quality_check(tmp_path):
    """The quality bound, on fabricated logs: the final test pred and recons
    at most 1.10 times the JAX log's (21.08, 11.05), the valid pred falling
    from epoch 10; a log over either bound, or with a flat curve, fails."""
    good = str(tmp_path / "good" / "log.txt")
    _port_log(good, 20.5, 19.5, (21.0, 11.0))
    result = chip_smoke.lstm_quality(good)
    assert result["limits"] == pytest.approx(
        {"pred": 1.1 * 19.16004180908203, "recons": 1.1 * 10.042754173278809})
    for name, (p10, plast, test) in {
            "pred": (20.5, 19.5, (21.1, 11.0)),
            "recons": (20.5, 19.5, (21.0, 11.1)),
            "flat": (19.5, 19.5, (21.0, 11.0))}.items():
        bad = str(tmp_path / name / "log.txt")
        _port_log(bad, p10, plast, test)
        with pytest.raises(AssertionError):
            chip_smoke.lstm_quality(bad)
