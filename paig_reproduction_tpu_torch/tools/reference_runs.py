"""The JAX package's logged single-command training runs, through the
port's CLI at full length, each held to its log's final test line.

The port's counterpart of the TPU queue scripts that launched these runs
(``tools/tpu_queue_r3.sh``, ``tools/tpu_queue_r4.sh``,
``tools/tpu_queue_r5d.sh``): their recipes, without their TPU plumbing.
``RUNS`` holds each run's argv (the logged flags but ``--save_dir``), its
log under ``benchmarks/`` and the pass bars it is held to (the reference's:
pred < 3.0 and recons < 1.5 on the ball tasks, pred < 30 on mnist). The
log's numbers are parsed from the log, never typed in:

    python -m paig_reproduction_tpu_torch.tools.reference_runs \\
        --run spring_one5 --save_dir /tmp/ref/spring_one5

writes the task's files first where they are missing (``data/generate.py``
at the presets' 5000/500/500 sequences, under
``data/generated/n5000-500-500_t500``), then runs the CLI with the recipe
on the card and prints one line: the port's final test pred / recons /
extrap beside the log's, the bars with pass or miss, wall seconds, train
steps and the decoder kernel's launches, and for the physics tasks the
learned k and equilibrium beside the generator's and the log's
``fit_physics:`` lines. A run starts from the JAX package's initial weights
at its seed, and each discovery arm from the JAX arm's
(``models/jax_init.py``), so the arms compare arm by arm with the log's.
A run cut by a time limit after its discovery arms
(its ``model.ckpt`` written, no final test line) is resumed from its last
checkpoint with ``--use_ckpt --resume_remaining_epochs`` by the same
command; one cut inside its arms (no checkpoint yet: the arms save none)
starts over, and the runner says so. ``--compare DIR`` only reads a
finished run's ``log.txt`` against the log; given several save_dirs of
one run, it then prints how many met the bars. ``--seed N`` replaces the
logged ``--seed=0`` and nothing else; the run's ``reference_run.json``
records it, and a resume at another seed is refused. The logs are the JAX
package's seed-0 runs, each dated on the compare line by its earliest
timestamp: the code they ran is the JAX package's of that day, not
necessarily the package as it stands (``spring_one5``'s log, of
2026-08-18, predates the rescue's stall guard). It runs on the card;
without a CUDA device it raises unless ``--device=cpu`` is given.

``--run 3bp_chain`` is a chained run (``CHAINS``): the stages through which
the JAX package met the bars on 3bp_color, each in its own directory under
``--save_dir`` (``chain_stages``): a slot curriculum of 1, 2 and 3 active
slots warm-started from the spring trunk ``TRUNK``, the all-slot surgery
(``tools/slot_rescue.py``), a 1000-epoch resume with the background
pinned, ``tools/fit_physics.py --write`` (gravity's A) and both test phases
with the flags of ``benchmarks/3bp_test_log.txt``'s and
``3bp_refine_test_log.txt``'s headers. The same command resumes a chain cut
by a time limit at the stage it was cut in, and runs no finished stage
again; it prints one line with each stage's valid recons beside the JAX
package's record (``CHAIN_RECORD``), A, both test lines beside the logs'
and the bars, and each stage's wall seconds, steps and launches.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import re
import signal
import sys
import time
import zipfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRACKED_DATA = os.path.join(REPO, "data", "datasets")
# The presets' sizes, (train, valid, test) of both files, and where the
# runner writes the files that are not tracked (gitignored).
PRESET_SIZES = (5000, 500, 500)
GENERATED_DATA = os.path.join(REPO, "data", "generated",
                              "n5000-500-500_t500")

BALL_BARS = {"pred": 3.0, "recons": 1.5}
MNIST_BARS = {"pred": 30.0, "recons": 1.5}
# The spring recipe of benchmarks/spring_one5_test_log.txt, less its task,
# epochs, restarts and rescues.
_SPRING_RECIPE = [
    "--batch_size=100", "--base_lr=6e-4", "--autoencoder_loss=3.0",
    "--color", "--seed=0"]
_RECIPE_TAIL = [
    "--discovery_epochs=150", "--discovery_recons_ok=4.0",
    "--aux_on_recons=3.5", "--fit_physics_every=25", "--pos_consistency=1.0",
    "--vel_anchor=1.0", "--learn_frame_offset", "--init_state_fit=3",
    "--refine_recons_pos=4", "--enhancers_eval_only", "--auto_rescue=250"]

# name -> the run's argv (its logged flags but --save_dir), where they were
# read (the log's flag header, or the queue script's lines where the log's
# header was thinned), its log, its pass bars, and the (k, equilibrium) of
# the generator of its files (None where the cell has none to learn).
RUNS = {
    "lstm_proof": dict(
        argv=["--task=spring_color", "--epochs=150"] + _SPRING_RECIPE + [
            "--cell_type=lstm", "--recurrent_units=100", "--lstm_layers=1",
            "--save_every_n_epochs=50"],
        argv_from="tools/tpu_queue_r4.sh:59-62",
        log="benchmarks/lstm_proof_log.txt", bars=BALL_BARS, physics=None),
    "spring_one5": dict(
        argv=["--task=spring_color", "--epochs=1000"] + _SPRING_RECIPE + [
            "--discovery_restarts=8"] + _RECIPE_TAIL + [
            "--max_rescues=2", "--save_every_n_epochs=50"],
        argv_from="header", log="benchmarks/spring_one5_test_log.txt",
        bars=BALL_BARS, physics=(4.0, 6.0)),
    "half_one1": dict(
        argv=["--task=spring_color_half", "--epochs=550"] + _SPRING_RECIPE
        + ["--discovery_restarts=4"] + _RECIPE_TAIL + [
            "--max_rescues=1", "--save_every_n_epochs=50"],
        argv_from="header", log="benchmarks/half_one1_test_log.txt",
        bars=BALL_BARS, physics=(4.0, 6.0)),
    "mnist_one2": dict(
        argv=["--task=mnist_spring_color", "--epochs=400"] + _SPRING_RECIPE
        + ["--discovery_restarts=2"] + _RECIPE_TAIL + [
            "--max_rescues=2", "--save_every_n_epochs=50",
            "--watchdog_secs=900"],
        argv_from="header", log="benchmarks/mnist_one2_test_log.txt",
        bars=MNIST_BARS, physics=(2.0, 12.0)),
    "spring_bf16_one1": dict(
        argv=["--task=spring_color", "--epochs=1000"] + _SPRING_RECIPE + [
            "--compute_dtype=bfloat16", "--discovery_restarts=8"]
        + _RECIPE_TAIL + ["--max_rescues=2", "--save_every_n_epochs=50"],
        argv_from="tools/tpu_queue_r4.sh:77-84",
        log="benchmarks/spring_bf16_test_log.txt", bars=BALL_BARS,
        physics=(4.0, 6.0)),
    "bounce_one1": dict(
        argv=["--task=bouncing_balls", "--epochs=800", "--batch_size=100",
              "--base_lr=3e-4", "--autoencoder_loss=2.0", "--color",
              "--seed=0", "--discovery_restarts=8", "--discovery_epochs=150",
              "--discovery_recons_ok=4.0", "--aux_on_recons=3.5",
              "--pos_consistency=1.0", "--vel_anchor=1.0",
              "--learn_frame_offset", "--init_state_fit=1",
              "--refine_enc_pos=4", "--refine_recons_pos=4",
              "--enhancers_eval_only", "--auto_rescue=250",
              "--max_rescues=2", "--save_every_n_epochs=50"],
        argv_from="header", log="benchmarks/bounce_one1_test_log.txt",
        bars=BALL_BARS, physics=None),
}

# 3bp_color's chain: the JAX package met the bars on 3bp_color only through
# these stages (benchmarks/CONVERGENCE.md:393-409, :447-457), and its end is
# scored by benchmarks/3bp_test_log.txt and 3bp_refine_test_log.txt.
# TRUNK is runs/ph7 (the spring_color run of 2026-08-16 that CONVERGENCE's
# round-3 table names) as the port's checkpoint (tests/ph7_trunk.py writes
# it): what the JAX package's restore of runs/ph7 into a 3bp_color run
# takes, the tensors whose name and shape fit and the step (37500), and none
# of its optimizer state. The step carries into every curriculum stage, so
# their LR schedules are past their anneal: they train at base_lr / 5.
TRUNK = os.path.join(REPO, "data", "checkpoints", "ph7_spring")
# The 3bp recipe (SURVEY.md:278, the reference README:67) with the test
# log's --learn_frame_offset.
_3BP_RECIPE = ["--task=3bp_color", "--base_lr=1e-3", "--autoencoder_loss=5.0",
               "--color", "--learn_frame_offset"]
CURRICULUM_EPOCHS = (300, 300, 300)
PINNED_EPOCHS = 1000
SURGERY_FLAGS = ["--rescue_slot=all", "--disk_radius=3",
                 "--set_background=median"]
TEST_LOGS = {"test": "benchmarks/3bp_test_log.txt",
             "test_refine": "benchmarks/3bp_refine_test_log.txt"}
FIT_JSON = "fit.json"
# What the JAX package's chain reached at each stage (CONVERGENCE.md; no log
# holds these): the valid recons of a warm trunk from spring (all three
# slots live, no curriculum) and of the slot curriculum's best checkpoint;
# the pinned resume's valid recons, its test recons on the train file's
# test split and its pred; gravity's A = g*m^2 written into runs/3bp_fit_ckpt
# beside the generator's (g60_m1 in the files' names).
CHAIN_RECORD = {"trunk_valid_recons": 13.7, "curriculum_valid_recons": 11.6,
                "pinned_valid_recons": 1.038, "pinned_test_recons": 1.049,
                "pinned_test_pred": 45.8, "A": 59.58, "A_generator": 60.0}


def test_flags(log) -> list:
    """A test log's flag header less ``--ckpt_dir`` and ``--save_dir``."""
    return [a for a in parse_log(os.path.join(REPO, log))["header"]
            if not a.startswith(("--ckpt_dir=", "--save_dir="))]


def chain_stages(curriculum=CURRICULUM_EPOCHS, pinned=PINNED_EPOCHS,
                 batch_size=100, save_every=50, eval_every=10) -> list:
    """3bp_color's chain, stage by stage: its ``name``, ``kind`` (train,
    surgery, fit or test), ``start`` (the stage whose checkpoint it starts
    from, or a directory) and ``argv`` (the flags of the CLI or the tool
    but the directories, the data and the device).

    The curriculum stages train 1, then 2, then 3 active slots, the first
    from TRUNK, each later one from the one before (its step, optimizer
    and recipe state). Each stage's ``--epochs`` counts the chain's epochs
    through it, with ``--resume_remaining_epochs``: a stage trains its own
    epochs, and the same flags resume it where a time limit cut it. Then
    the all-slot surgery, the pinned resume (``--bg_lr_mult=0``; the
    surgery's checkpoint starts the step, the optimizer and the chain's
    epochs at 0, so its LR anneals after 750 of its 1000 epochs),
    ``fit_physics --write`` on a copy of its checkpoint, and both test
    phases with their logs' flags. A training stage evaluates every
    ``eval_every`` epochs (the CLI's default is every epoch: 0.6 of the
    1.7 s a 3bp epoch takes on the card); the epochs given are multiples
    of it, so each stage's last epoch is evaluated."""
    model = _3BP_RECIPE + [f"--batch_size={batch_size}",
                           f"--save_every_n_epochs={save_every}",
                           f"--eval_every_n_epochs={eval_every}",
                           "--seed=0"]
    stages, start, total = [], TRUNK, 0
    for slots, epochs in enumerate(curriculum, 1):
        total += epochs
        stages.append(dict(name=f"curriculum_{slots}", kind="train",
                           start=start, argv=model + [
                               f"--active_slots={slots}",
                               f"--epochs={total}"]))
        start = f"curriculum_{slots}"
    stages += [
        dict(name="surgery", kind="surgery", start=start,
             argv=["--task=3bp_color"] + SURGERY_FLAGS),
        dict(name="pinned", kind="train", start="surgery",
             argv=model + [f"--epochs={pinned}", "--bg_lr_mult=0"]),
        dict(name="fit", kind="fit", start="pinned",
             argv=["--task=3bp_color", "--write"])]
    stages += [dict(name=name, kind="test", start="fit",
                    argv=test_flags(log), log=log)
               for name, log in TEST_LOGS.items()]
    return stages


# name -> a chained run: the function that lists its stages, where they
# were read, and its bars.
CHAINS = {
    "3bp_chain": dict(
        stages=chain_stages,
        argv_from="benchmarks/CONVERGENCE.md:447-457 (the warm trunk and "
                  "the slot curriculum, reconstructed: no log or epoch "
                  "count was kept), :393-409 (the surgery, the 1000-epoch "
                  "pinned resume, the gravity fit), the test logs' headers",
        bars=BALL_BARS),
}

KEYS = ("pred", "recons", "extrap")
_EVAL = re.compile(r"\b(valid|test) - epoch=(\d+) (\S.*)$")
_ARM = re.compile(r"discovery restart arm (\d+)/(\d+): valid recons (\S+) ")
_TRIGGER = re.compile(r"aux_on_recons trigger: valid recons (\S+) < \S+ at "
                      r"epoch (\d+)")
_RESCUE = re.compile(r"auto_rescue: epoch (\d+) valid recons (\S+) ")
_FIT = re.compile(r"fit_physics: k=(\S+) equil=(\S+) ")
_RESUME = re.compile(r"reference_runs: resuming at loop epoch (\d+)")
_STAMP = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d)")
RESUME_LINE = "reference_runs: resuming at loop epoch %d"
SIDECAR = "reference_run.json"

logger = logging.getLogger("paig")


def _losses(text):
    values = dict(kv.split("=", 1) for kv in text.split())
    return {k: float(values[f"eval_{k}_loss"]) for k in KEYS}


def parse_log(path) -> dict:
    """A run's log (the JAX package's ``... - paig - ...`` or
    ``INFO:paig:...`` lines, or the port's log.txt): ``test`` and
    ``test_epoch`` of its last ``test - epoch=`` line, ``valid`` {loop
    epoch: losses}, the arms' valid recons, the trigger's epoch, the
    rescues' epochs, the ``fit_physics:`` (k, equil) fits, ``tests``
    (every ``test - epoch=`` line's (epoch, losses), in order), the flag
    ``header`` (the ``--`` lines after the first line naming the entry
    script) and ``segments`` (1, and 1 more for each resume the runner
    marked: its loop epochs count on from the checkpoint's), and
    ``first_logged``: the earliest timestamp of its lines
    (``YYYY-MM-DD HH:MM:SS``; None without one), which dates the run. A
    timestamped line seen before is skipped: the thinned JAX logs repeat
    their first lines after the flag header."""
    out = dict(test=None, test_epoch=None, tests=[], valid={}, arms=[],
               trigger=None, rescues=[], fits=[], header=[], segments=1,
               first_logged=None)
    offset = 0
    in_header = False
    seen = set()
    with open(path, errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            stamp = _STAMP.match(line)
            if stamp and (out["first_logged"] is None
                          or stamp.group(1) < out["first_logged"]):
                out["first_logged"] = stamp.group(1)
            if " - paig - " in line:
                if line in seen:
                    continue
                seen.add(line)
            if in_header:
                if line.startswith("--"):
                    out["header"].append(line)
                    continue
                in_header = False
            if not out["header"] and (line.endswith("run_physics.py")
                                      or line.endswith("cli.py")):
                in_header = True
                continue
            m = _RESUME.search(line)
            if m:
                offset = int(m.group(1))
                out["segments"] += 1
                continue
            m = _EVAL.search(line)
            if m:
                losses = _losses(m.group(3))
                if m.group(1) == "valid":
                    out["valid"][offset + int(m.group(2))] = losses
                else:
                    out["test"], out["test_epoch"] = losses, int(m.group(2))
                    out["tests"].append((int(m.group(2)), losses))
                continue
            m = _ARM.search(line)
            if m:
                out["arms"].append(float(m.group(3)))
                continue
            m = _TRIGGER.search(line)
            if m and out["trigger"] is None:
                out["trigger"] = offset + int(m.group(2))
                continue
            m = _RESCUE.search(line)
            if m:
                out["rescues"].append(offset + int(m.group(1)))
                continue
            m = _FIT.search(line)
            if m:
                out["fits"].append((float(m.group(1)), float(m.group(2))))
    return out


def run_argv(name, seed=0) -> list:
    """Run ``name``'s logged argv with its ``--seed=0`` replaced by
    ``--seed=<seed>``."""
    return [f"--seed={seed}" if a == "--seed=0" else a
            for a in RUNS[name]["argv"]]


def log_path(name) -> str:
    return os.path.join(REPO, RUNS[name]["log"])


def flag(argv, name, default=None):
    """The value of ``--name=value`` in ``argv`` (``True`` for a bare
    ``--name``), else ``default``."""
    for a in argv:
        if a == f"--{name}":
            return True
        if a.startswith(f"--{name}="):
            return a.split("=", 1)[1]
    return default


def data_dir_for(task) -> str:
    """Where a task's files are: the tracked ones, or the presets' that the
    runner generates."""
    from paig_reproduction_tpu_torch.cli import TASK_TABLE
    if os.path.exists(os.path.join(TRACKED_DATA, TASK_TABLE[task][0])):
        return TRACKED_DATA
    return GENERATED_DATA


def _split_sizes(path) -> tuple:
    """(train, valid, test) sequences of an npz, read from its headers."""
    import numpy as np
    sizes = []
    with zipfile.ZipFile(path) as z:
        for key in ("train_x", "valid_x", "test_x"):
            with z.open(key + ".npy") as f:
                fmt = np.lib.format
                read = (fmt.read_array_header_1_0
                        if fmt.read_magic(f) == (1, 0)
                        else fmt.read_array_header_2_0)
                shape = read(f)[0]
            sizes.append(shape[0])
    return tuple(sizes)


def ensure_data(task, data_dir):
    """Writes the task's two files under ``data_dir`` at the presets' sizes
    where one is missing or unreadable (``data/generate.py``). Returns the
    seconds it took (0 when nothing was missing)."""
    from paig_reproduction_tpu_torch.cli import TASK_TABLE
    from paig_reproduction_tpu_torch.data import generate
    try:
        for rel in TASK_TABLE[task][:2]:
            _split_sizes(os.path.join(data_dir, rel))
        return 0.0
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        pass
    t0 = time.perf_counter()
    generate.generate(task, data_dir, PRESET_SIZES)
    return time.perf_counter() - t0


def resume_decision(save_dir) -> str:
    """What a run in ``save_dir`` needs: ``fresh`` (nothing there),
    ``done`` (its log has the seq-30 phase's ``test - epoch=0`` line),
    ``test`` (trained and saved, the seq-30 phase missing), ``resume`` (a
    checkpoint, which the loop writes after the arms, and no test line) or
    ``restart`` (a log but no checkpoint: cut inside its arms or before its
    first save)."""
    log = os.path.join(save_dir, "log.txt")
    if not os.path.exists(log):
        return "fresh"
    parsed = parse_log(log)
    if parsed["test_epoch"] == 0:
        return "done"
    if not os.path.exists(os.path.join(save_dir, "model.ckpt")):
        return "restart"
    return "test" if parsed["test"] is not None else "resume"


def _ckpt_scalar(ckpt_dir, key) -> int:
    """``key`` of ``ckpt_dir``'s model.ckpt (0 where it lacks one)."""
    import torch
    ckpt = torch.load(os.path.join(ckpt_dir, "model.ckpt"),
                      map_location="cpu", weights_only=True)
    return int(ckpt.get(key, 0))


def _loop_epochs_done(save_dir) -> int:
    return max(_ckpt_scalar(save_dir, "total_epochs_done"),
               _ckpt_scalar(save_dir, "epoch"))


def _append_log(save_dir, message):
    with open(os.path.join(save_dir, "log.txt"), "a") as f:
        f.write("%s - paig - %s\n" % (
            time.strftime("%Y-%m-%d %H:%M:%S,000"), message))


def _read_sidecar(save_dir) -> dict:
    path = os.path.join(save_dir, SIDECAR)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"segments": []}


def _write_sidecar(save_dir, record):
    path = os.path.join(save_dir, SIDECAR)
    with open(path + ".tmp", "w") as f:
        json.dump(record, f, indent=1)
    os.replace(path + ".tmp", path)


class _Terminated(BaseException):
    """A SIGTERM (a time limit) inside a run."""


def _on_term(signum, frame):
    raise _Terminated()


def _segment(seg, fn, device):
    """Runs ``fn()`` as one segment of a run: a SIGTERM stops it, the
    kernel's launch count starts at 0, and the log handlers it adds are
    removed after it. Sets ``seg``'s ``finished``, ``wall_s`` and
    ``launches``; returns fn's result (None where it was stopped)."""
    import torch
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd
    handlers = list(logger.handlers)
    old_term = signal.signal(signal.SIGTERM, _on_term)
    sd.LAUNCHES = 0
    t0 = time.perf_counter()
    result = None
    try:
        result = fn()
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        seg["finished"] = True
    except _Terminated:
        pass
    finally:
        seg["wall_s"] = time.perf_counter() - t0
        seg["launches"] = sd.LAUNCHES
        signal.signal(signal.SIGTERM, old_term)
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    return result


def _cli(argv):
    """The port's CLI on ``argv``, with ``sys.argv`` as a shell would set it
    (the trainer logs it as the run's flag header)."""
    from paig_reproduction_tpu_torch import cli
    old_argv = sys.argv
    sys.argv = [os.path.join(os.path.dirname(cli.__file__), "cli.py")] + argv
    try:
        return cli.main(argv)
    finally:
        sys.argv = old_argv


def _need_card(device):
    import torch
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("reference_runs: no CUDA device; these runs are "
                         "made on the card (--device=cpu for small tests)")


def run(name, save_dir, device="cuda", data_dir=None, seed=0):
    """Runs (or resumes, or finishes) reference run ``name`` at ``seed`` in
    ``save_dir`` through the port's CLI. Returns ``compare``'s result."""
    _need_card(device)
    spec = RUNS[name]
    task = flag(spec["argv"], "task")
    data_dir = data_dir or data_dir_for(task)
    decision = resume_decision(save_dir)
    if decision in ("resume", "test", "done"):
        had = _read_sidecar(save_dir).get("seed", 0)
        if had != seed:
            raise SystemExit(f"reference_runs: {name} in {save_dir} ran at "
                             f"seed {had}; refusing to go on at seed {seed}")
    gen_s = ensure_data(task, data_dir)
    argv = run_argv(name, seed) + [f"--save_dir={save_dir}",
                                   f"--data_dir={data_dir}",
                                   f"--device={device}"]
    record = (_read_sidecar(save_dir) if decision in ("resume", "test")
              else {"segments": []})
    record["data_dir"] = data_dir
    record["seed"] = seed
    if decision == "done":
        print(f"reference_runs: {name} in {save_dir} is finished")
        return compare(name, save_dir, data_dir)
    if decision == "restart":
        print(f"reference_runs: {name} in {save_dir} was cut inside its "
              f"discovery arms or before its first checkpoint (the arms "
              f"save none): starting over", flush=True)
    if decision == "resume":
        done = _loop_epochs_done(save_dir)
        _append_log(save_dir, RESUME_LINE % done)
        argv += ["--use_ckpt", "--resume_remaining_epochs"]
        print(f"reference_runs: resuming {name} from its checkpoint at loop "
              f"epoch {done}", flush=True)
    elif decision == "test":
        argv += ["--test_mode", f"--ckpt_dir={save_dir}"]
    seg = {"kind": decision, "data_s": gen_s, "launches": 0, "wall_s": 0.0,
           "finished": False}
    try:
        out = _segment(seg, lambda: _cli(argv), device)
        if out is not None and out[0] is not None:
            seg["end_step"] = int(out[0].step)
    finally:
        record["segments"].append(seg)
        _write_sidecar(save_dir, record)
    if not seg["finished"]:
        print(f"reference_runs: {name} stopped by SIGTERM; run the same "
              f"command again to resume it", flush=True)
    if device.startswith("cuda") and seg["launches"] == 0:
        raise AssertionError(f"{name}: no decode went through the CUDA "
                             f"kernel")
    if not seg["finished"]:
        raise SystemExit(3)
    return compare(name, save_dir, data_dir)


def _physics(save_dir):
    """(k, equilibrium) of the spring cell in save_dir's checkpoint, or
    None."""
    import math

    import torch
    path = os.path.join(save_dir, "model.ckpt")
    if not os.path.exists(path):
        return None
    model = torch.load(path, map_location="cpu", weights_only=True)["model"]
    keys = [k for k in model if k.endswith("log_k")]
    if not keys:
        return None
    eq = keys[0][:-len("log_k")] + "log_equil"
    return (math.exp(float(model[keys[0]])), math.exp(float(model[eq])))


def _steps(name, parsed, save_dir, data_dir):
    """Optimizer steps of the run: every arm's and every loop epoch's."""
    from paig_reproduction_tpu_torch.cli import TASK_TABLE
    argv = RUNS[name]["argv"]
    task = flag(argv, "task")
    train_n = _split_sizes(os.path.join(data_dir, TASK_TABLE[task][0]))[0]
    spe = max(1, train_n // int(flag(argv, "batch_size", 100)))
    arm_epochs = int(flag(argv, "discovery_epochs", 100))
    loop = max(parsed["valid"]) if parsed["valid"] else 0
    return (len(parsed["arms"]) * arm_epochs + loop) * spe


def compare(name, save_dir, data_dir=None) -> dict:
    """The port's run in ``save_dir`` against its log: prints one line and
    returns its numbers."""
    spec = RUNS[name]
    ref = parse_log(log_path(name))
    port = parse_log(os.path.join(save_dir, "log.txt"))
    bars = spec["bars"]

    def passes(t):
        return t is not None and all(t[k] < v for k, v in bars.items())

    task = flag(spec["argv"], "task")
    side = _read_sidecar(save_dir)
    data_dir = data_dir or side.get("data_dir") or data_dir_for(task)
    segs = side["segments"]
    out = dict(
        run=name, seed=side.get("seed", 0), port_test=port["test"],
        log_test=ref["test"], log_first_logged=ref["first_logged"],
        bars=bars, port_pass=passes(port["test"]),
        log_pass=passes(ref["test"]), arms=port["arms"],
        log_arms=ref["arms"], trigger=port["trigger"],
        log_trigger=ref["trigger"], rescues=port["rescues"],
        log_rescues=ref["rescues"], fits=port["fits"], log_fits=ref["fits"],
        wall_s=sum(s["wall_s"] for s in segs),
        data_s=sum(s.get("data_s", 0.0) for s in segs),
        launches=sum(s["launches"] for s in segs),
        segments=[s["kind"] for s in segs],
        valid={e: dict(port=port["valid"].get(e), log=ref["valid"].get(e))
               for e in sorted(set(port["valid"]) | set(ref["valid"]))
               if e in (10, 100, 250, 500) or e == max(port["valid"] or [0])
               or e == max(ref["valid"] or [0])},
        physics=_physics(save_dir), generator=spec["physics"])
    try:
        out["train_steps"] = _steps(name, port, save_dir, data_dir)
    except (OSError, KeyError):
        out["train_steps"] = None
    if out["train_steps"]:
        out["wall_ms_per_step"] = 1e3 * out["wall_s"] / out["train_steps"]

    def fmt(t):
        return ("none" if t is None else
                " ".join(f"{k}={t[k]:.4f}" for k in KEYS))

    line = (f"reference_runs: {name}: port (seed {out['seed']}) test "
            f"{fmt(port['test'])} | log (the JAX package's seed-0 run, "
            f"first logged {ref['first_logged']}) test "
            f"{fmt(ref['test'])} | bars "
            + " ".join(f"{k}<{v}" for k, v in bars.items())
            + f": port {'pass' if out['port_pass'] else 'miss'}, log "
            f"{'pass' if out['log_pass'] else 'miss'} | wall "
            f"{out['wall_s']:.1f} s, {out['train_steps']} train steps, "
            f"{out['launches']} kernel launches")
    if spec["physics"] is not None:
        phys = out["physics"]
        line += (" | k, equil: port " + ("none" if phys is None else
                                         f"{phys[0]:.4f}, {phys[1]:.4f}")
                 + f"; generator {spec['physics'][0]:g}, "
                 f"{spec['physics'][1]:g}; log fits "
                 + (", ".join(f"{k:.4f}/{e:.4f}" for k, e in ref["fits"])
                    or "none"))
    print(line, flush=True)
    print(json.dumps(out), flush=True)
    return out


def _stage_dir(save_dir, where) -> str:
    return where if os.path.isabs(where) else os.path.join(save_dir, where)


def stage_status(stage, stage_dir) -> str:
    """What a chain's stage needs: ``done``, or for a training stage
    ``resume_decision``'s answer, else ``fresh`` (a surgery without its
    checkpoint, a fit without its record, a test phase without its line
    is run again from its start)."""
    kind = stage["kind"]
    if kind == "train":
        return resume_decision(stage_dir)
    done = {"surgery": os.path.join(stage_dir, "model.ckpt"),
            "fit": os.path.join(stage_dir, FIT_JSON)}.get(kind)
    if done is not None:
        return "done" if os.path.exists(done) else "fresh"
    return "done" if resume_decision(stage_dir) == "done" else "fresh"


def _echoed(fn, argv, path):
    """fn(argv), its printed lines also written to ``path``: (fn's
    result, the text)."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = fn(argv)
    finally:
        print(buf.getvalue(), end="", flush=True)
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return result, buf.getvalue()


_GRAVITY_FIT = re.compile(r"(pointwise|trajectory) gravity fit: "
                          r"A=(?:g\*m\^2=)?(\S+) ")


def _fit(argv, start_dir, stage_dir, data_dir, device):
    """fit_physics with ``argv`` (``--write``) on a copy of ``start_dir``'s
    checkpoint in ``stage_dir``; its printed fits and the written values go
    to FIT_JSON."""
    import shutil

    from paig_reproduction_tpu_torch.tools import fit_physics
    os.makedirs(stage_dir, exist_ok=True)
    shutil.copyfile(os.path.join(start_dir, "model.ckpt"),
                    os.path.join(stage_dir, "model.ckpt"))
    fitted, printed = _echoed(fit_physics.main, argv + [
        f"--ckpt_dir={stage_dir}", f"--data_dir={data_dir}",
        f"--device={device}"], os.path.join(stage_dir, "fit_physics.txt"))
    fits = {kind: float(a) for kind, a in _GRAVITY_FIT.findall(printed)}
    with open(os.path.join(stage_dir, FIT_JSON), "w") as f:
        json.dump(dict(A_pointwise=fits["pointwise"],
                       A=fits["trajectory"],
                       log_g=float(fitted["log_g"]),
                       frame_offset=fitted["frame_offset"].tolist()), f)


def _stage_fn(stage, status, save_dir, data_dir, device, seed):
    """The call that runs ``stage`` from ``status`` (stage_status's)."""
    import shutil

    from paig_reproduction_tpu_torch.tools import slot_rescue
    d = os.path.join(save_dir, stage["name"])
    start = _stage_dir(save_dir, stage["start"])
    where = [f"--data_dir={data_dir}", f"--device={device}"]
    if stage["kind"] == "surgery":
        argv = stage["argv"] + [f"--ckpt_dir={start}", f"--out_dir={d}",
                                f"--data_dir={data_dir}"]
        os.makedirs(d, exist_ok=True)
        return lambda: _echoed(slot_rescue.main, argv,
                               os.path.join(d, "slot_rescue.txt"))
    if stage["kind"] == "fit":
        return lambda: _fit(stage["argv"], start, d, data_dir, device)
    if status in ("restart", "fresh") and os.path.exists(d):
        shutil.rmtree(d)
    if stage["kind"] == "test":
        argv = stage["argv"] + [f"--ckpt_dir={start}", f"--save_dir={d}"]
        return lambda: _cli(argv + where)
    argv = [f"--seed={seed}" if a == "--seed=0" else a
            for a in stage["argv"]] + [
        "--use_ckpt", "--resume_remaining_epochs", f"--save_dir={d}"]
    if status == "resume":
        done = _loop_epochs_done(d) - _loop_epochs_done(start)
        _append_log(d, RESUME_LINE % done)
        print(f"reference_runs: resuming {stage['name']} from its checkpoint "
              f"at its epoch {done}", flush=True)
        argv.append(f"--ckpt_dir={d}")
    elif status == "test":
        argv += ["--test_mode", f"--ckpt_dir={d}"]
    else:
        argv.append(f"--ckpt_dir={start}")
    return lambda: _cli(argv + where)


def run_chain(name, save_dir, device="cuda", data_dir=None, seed=0,
              stages=None):
    """Runs chained run ``name`` at ``seed`` in ``save_dir``, each stage in
    its own directory there, from the first stage not finished: a stage
    that a SIGTERM cut resumes where it stopped, and a finished one is not
    run again. Each segment's wall seconds and launches, and each training
    stage's steps, go to the sidecar. ``stages`` replaces the run's own
    (``chain_stages`` at another depth). Returns ``compare_chain``'s
    result."""
    _need_card(device)
    spec = CHAINS[name]
    data_dir = data_dir or data_dir_for("3bp_color")
    record = _read_sidecar(save_dir)
    if record.get("stages") and record.get("seed", 0) != seed:
        raise SystemExit(f"reference_runs: {name} in {save_dir} ran at seed "
                         f"{record.get('seed', 0)}; refusing to go on at "
                         f"seed {seed}")
    gen_s = ensure_data("3bp_color", data_dir)
    os.makedirs(save_dir, exist_ok=True)
    record.update(run=name, seed=seed, data_dir=data_dir)
    record.setdefault("stages", {})
    record.setdefault("steps", {})
    record.pop("segments", None)
    stages = stages or spec["stages"]()
    for stage in stages:
        d = os.path.join(save_dir, stage["name"])
        status = stage_status(stage, d)
        if status == "done":
            continue
        seg = {"kind": status, "data_s": gen_s, "launches": 0,
               "wall_s": 0.0, "finished": False}
        gen_s = 0.0
        fn = _stage_fn(stage, status, save_dir, data_dir, device, seed)
        try:
            _segment(seg, fn, device)
            if seg["finished"] and stage["kind"] == "train":
                start = _stage_dir(save_dir, stage["start"])
                record["steps"][stage["name"]] = (
                    _ckpt_scalar(d, "step") - _ckpt_scalar(start, "step"))
        finally:
            record["stages"].setdefault(stage["name"], []).append(seg)
            _write_sidecar(save_dir, record)
        if not seg["finished"]:
            print(f"reference_runs: {name} stopped by SIGTERM in "
                  f"{stage['name']}; run the same command again to resume "
                  f"it", flush=True)
            raise SystemExit(3)
        if (device.startswith("cuda") and stage["kind"] != "surgery"
                and seg["launches"] == 0):
            raise AssertionError(f"{name}: {stage['name']} decoded nothing "
                                 f"through the CUDA kernel")
    return compare_chain(name, save_dir, stages)


def _fmt(t):
    return ("none" if t is None else
            " ".join(f"{k}={t[k]:.4f}" for k in KEYS))


def compare_chain(name, save_dir, stages=None) -> dict:
    """A chained run in ``save_dir`` (of ``stages``, by default the run's
    own) against the JAX package's record: prints one line (each stage's
    last valid recons, the pinned stage's test line, A, both test lines
    beside their logs' and the bars, and each stage's wall seconds, steps
    and launches) and a JSON line; returns its numbers."""
    spec = CHAINS[name]
    side = _read_sidecar(save_dir)
    bars = spec["bars"]

    def passes(t):
        return t is not None and all(t[k] < v for k, v in bars.items())

    listed = stages or spec["stages"]()
    curriculum_end = next((s["start"] for s in listed
                           if s["kind"] == "surgery"), None)
    rows = {}
    for stage in listed:
        d = os.path.join(save_dir, stage["name"])
        segs = side.get("stages", {}).get(stage["name"], [])
        row = dict(kind=stage["kind"], segments=[s["kind"] for s in segs],
                   wall_s=sum(s["wall_s"] for s in segs),
                   launches=sum(s["launches"] for s in segs),
                   steps=side.get("steps", {}).get(stage["name"]))
        log = os.path.join(d, "log.txt")
        if stage["kind"] == "train" and os.path.exists(log):
            parsed = parse_log(log)
            last = max(parsed["valid"]) if parsed["valid"] else None
            row.update(valid_epoch=last, valid=parsed["valid"].get(last),
                       test=None, test_seq40=None)
            tests = parsed["tests"]
            if tests and tests[-1][0] == 0 and len(tests) > 1:
                row["test"], row["test_seq40"] = tests[-2][1], tests[-1][1]
            elif tests:
                row["test"] = tests[-1][1]
        elif stage["kind"] == "test":
            ref = parse_log(os.path.join(REPO, stage["log"]))
            port = parse_log(log) if os.path.exists(log) else {"test": None}
            row.update(test=port["test"], log_test=ref["test"],
                       log_first_logged=ref["first_logged"],
                       port_pass=passes(port["test"]),
                       log_pass=passes(ref["test"]))
        elif stage["kind"] == "fit" and os.path.exists(
                os.path.join(d, FIT_JSON)):
            with open(os.path.join(d, FIT_JSON)) as f:
                row.update(json.load(f))
        rows[stage["name"]] = row

    def recons(row):
        v = row.get("valid")
        return "none" if v is None else f"{v['recons']:.4f}"

    rec = CHAIN_RECORD
    parts = []
    for sname, row in rows.items():
        if row["kind"] == "train":
            part = f"{sname} valid recons {recons(row)}"
            if sname == "curriculum_1":
                part += (f" (record: the warm trunk's "
                         f"{rec['trunk_valid_recons']})")
            elif sname == curriculum_end:
                part += (f" (record: the curriculum's "
                         f"{rec['curriculum_valid_recons']})")
            elif sname == "pinned":
                test = row.get("test")
                part += (", test pred / recons " + (
                    "none" if test is None else
                    f"{test['pred']:.4f} / {test['recons']:.4f}")
                    + f" (record: valid {rec['pinned_valid_recons']}, test "
                    f"{rec['pinned_test_pred']} / "
                    f"{rec['pinned_test_recons']})")
            parts.append(part)
        elif row["kind"] == "fit":
            parts.append(
                "A=g*m^2 " + ("none" if "A" not in row else
                              f"pointwise {row['A_pointwise']:.4f}, "
                              f"trajectory (written) {row['A']:.4f}")
                + f" (generator {rec['A_generator']:g}, record "
                f"{rec['A']})")
        elif row["kind"] == "test":
            parts.append(
                f"{sname}: port {_fmt(row['test'])} "
                f"{'pass' if row['port_pass'] else 'miss'}; log "
                f"(the JAX package's, first logged "
                f"{row['log_first_logged']}) {_fmt(row['log_test'])} "
                f"{'pass' if row['log_pass'] else 'miss'}")
    line = (f"reference_runs: {name} (seed {side.get('seed', 0)}): "
            + " | ".join(parts) + " | bars "
            + " ".join(f"{k}<{v}" for k, v in bars.items()) + " | stages: "
            + "; ".join(f"{s} {r['wall_s']:.1f} s, {r['steps']} steps, "
                        f"{r['launches']} launches"
                        for s, r in rows.items()))
    out = dict(run=name, seed=side.get("seed", 0), stages=rows,
               record=rec, bars=bars,
               port_pass=all(r["port_pass"] for r in rows.values()
                             if r["kind"] == "test"),
               wall_s=sum(r["wall_s"] for r in rows.values()))
    print(line, flush=True)
    print(json.dumps(out), flush=True)
    return out


def mann_whitney(x, y) -> tuple:
    """The two-sided Mann-Whitney rank test of samples x and y: U counts
    the pairs in which x's value is the larger (a tie a half), and p comes
    from the normal approximation with the tie and continuity corrections
    (scipy.stats.mannwhitneyu's asymptotic method)."""
    import collections
    import math
    n1, n2 = len(x), len(y)
    n = n1 + n2
    u = sum((a > b) + 0.5 * (a == b) for a in x for b in y)
    ties = sum(c ** 3 - c for c in collections.Counter(x + y).values())
    var = n1 * n2 / 12 * ((n + 1) - ties / (n * (n - 1)))
    z = max(0.0, abs(u - n1 * n2 / 2) - 0.5) / math.sqrt(var)
    return float(u), math.erfc(z / math.sqrt(2))


def compare_many(name, save_dirs, data_dir=None) -> dict:
    """``compare`` of each of run ``name``'s save_dirs, then one line: how
    many met the bars, each run's seed, best arm and test pred / recons,
    and the rank test (``mann_whitney``) of all the runs' arms against the
    log's. Returns the count, the test and the runs' results."""
    runs = [compare(name, d, data_dir) for d in save_dirs]
    met = sum(r["port_pass"] for r in runs)
    arms = [a for r in runs for a in r["arms"]]
    log_arms = runs[0]["log_arms"]
    # A run without discovery arms (lstm_proof) has nothing to rank.
    u, p = (mann_whitney(arms, log_arms) if arms and log_arms
            else (float("nan"), float("nan")))

    def summary(r):
        best = "none" if not r["arms"] else f"{min(r['arms']):.3f}"
        test = ("none" if r["port_test"] is None else
                f"{r['port_test']['pred']:.4f} / "
                f"{r['port_test']['recons']:.4f}")
        return (f"seed {r['seed']}: best arm {best}, test pred / recons "
                f"{test}")

    print(f"reference_runs: {name}: {met} of {len(runs)} runs met the bars; "
          + "; ".join(summary(r) for r in runs)
          + f" | arms: the port's {len(arms)} against the log's "
          f"{len(log_arms)}, Mann-Whitney U={u:g}, p={p:.4f}", flush=True)
    return dict(met=met, mann_whitney=(u, p), runs=runs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run", required=True, choices=sorted(RUNS)
                   + sorted(CHAINS))
    p.add_argument("--save_dir", default="",
                   help="the run's save_dir (outside the repository, or "
                        "under a gitignored directory)")
    p.add_argument("--compare", nargs="+", default=[],
                   help="only read these finished runs' log.txt against "
                        "the log, then count those that met the bars")
    p.add_argument("--data_dir", default="",
                   help="the task's files (default: the tracked ones, or "
                        "the presets' written under " + os.path.relpath(
                            GENERATED_DATA, REPO) + ")")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda; cpu only for small tests)")
    p.add_argument("--seed", type=int, default=0,
                   help="replaces the logged --seed=0 (the initial weights "
                        "and shuffles)")
    args = p.parse_args(argv)
    if args.run in CHAINS:
        if args.compare:
            return [compare_chain(args.run, d) for d in args.compare]
        if not args.save_dir:
            p.error("--save_dir is required unless --compare is given")
        return run_chain(args.run, args.save_dir, args.device,
                         args.data_dir or None, args.seed)
    if len(args.compare) == 1:
        return compare(args.run, args.compare[0], args.data_dir or None)
    if args.compare:
        return compare_many(args.run, args.compare, args.data_dir or None)
    if not args.save_dir:
        p.error("--save_dir is required unless --compare is given")
    return run(args.run, args.save_dir, args.device, args.data_dir or None,
               args.seed)


if __name__ == "__main__":
    main()
