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
    rescues' epochs, the ``fit_physics:`` (k, equil) fits, the flag
    ``header`` (the ``--`` lines after the first line naming the entry
    script) and ``segments`` (1, and 1 more for each resume the runner
    marked: its loop epochs count on from the checkpoint's), and
    ``first_logged``: the earliest timestamp of its lines
    (``YYYY-MM-DD HH:MM:SS``; None without one), which dates the run. A
    timestamped line seen before is skipped: the thinned JAX logs repeat
    their first lines after the flag header."""
    out = dict(test=None, test_epoch=None, valid={}, arms=[], trigger=None,
               rescues=[], fits=[], header=[], segments=1, first_logged=None)
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


def _loop_epochs_done(save_dir) -> int:
    import torch
    ckpt = torch.load(os.path.join(save_dir, "model.ckpt"),
                      map_location="cpu", weights_only=True)
    return int(max(ckpt["total_epochs_done"], ckpt["epoch"]))


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


def run(name, save_dir, device="cuda", data_dir=None, seed=0):
    """Runs (or resumes, or finishes) reference run ``name`` at ``seed`` in
    ``save_dir`` through the port's CLI. Returns ``compare``'s result."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("reference_runs: no CUDA device; these runs are "
                         "made on the card (--device=cpu for small tests)")
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
    handlers = list(logger.handlers)
    old_argv, old_term = sys.argv, signal.signal(signal.SIGTERM, _on_term)
    sys.argv = [os.path.join(os.path.dirname(cli.__file__), "cli.py")] + argv
    sd.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        trainer, _ = cli.main(argv)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        seg["finished"] = True
        if trainer is not None:
            seg["end_step"] = int(trainer.step)
    except _Terminated:
        print(f"reference_runs: {name} stopped by SIGTERM; run the same "
              f"command again to resume it", flush=True)
    finally:
        seg["wall_s"] = time.perf_counter() - t0
        seg["launches"] = sd.LAUNCHES
        sys.argv = old_argv
        signal.signal(signal.SIGTERM, old_term)
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
        record["segments"].append(seg)
        _write_sidecar(save_dir, record)
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
    p.add_argument("--run", required=True, choices=sorted(RUNS))
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
