"""Probes of 3bp_color's first curriculum stage: which flags keep the
velocity head alive.

In ``reference_runs --run 3bp_chain`` the velocity head (a tanh MLP shared
across the objects) can be flung during ``curriculum_1`` (one live slot for
three balls) to one velocity for every object, far outside the frame: the
rollout then renders an empty frame, whose pred loss has no gradient with
respect to the start velocity, and nothing pulls it back. Each probe trains
``curriculum_1`` alone from the spring trunk, through ``run_chain`` (its
stage directory ``DIR/<probe>/curriculum_1``, resumed as the chain resumes
it), on top of the chain's stage flags:

* ``base``: the chain's flags (the control);
* ``a``: ``--vel_anchor=1.0``, ungated: the head tied to the encoder's
  finite differences, a gradient that does not pass through the render;
* ``b``: ``--recons_warmup --aux_warmup_epochs=N``: the prediction term off
  through the curriculum. ``--aux_warmup_epochs`` counts the trainer's
  global steps, from step 0, and the trunk carries step 37500 (1875 epochs
  of 20 steps), so N is 1875 plus the curriculum's 900 epochs;
* ``c``: ``--grad_clip=G``, G the median of the gradient norms that
  ``velocity_state`` measured at ``base``'s checkpoints after its start;
* ``d``: 100 epochs at one live slot instead of 300: ``base``'s
  checkpoint at its epoch 100 (the same flags, seed and shuffles; the LR
  schedule of both is past its anneal at the trunk's step).

A probe keeps the head alive where, at the stage's end, the objects' start
velocities differ (``spread`` over ``MIN_SPREAD``), lie within the
generator's range (95th percentile of the speeds under ``MAX_SPEED``) and
under half of the last hidden tanh layer's units are saturated: the head's
output is linear in that layer, so with it saturated the output no longer
depends on the positions. The first layer is not tested: it sees raw
pixel positions (0 to 36), and at the trunk, before any 3bp training, 68%
of its units are saturated on the first 20 valid sequences. Objects whose
encoder positions coincide (slots that find no ball) share one velocity
whatever the head's state. It prints one line a probe and a JSON line, and
writes ``DIR/probes.json``:

    python -m paig_reproduction_tpu_torch.tools.curriculum_probes \\
        --save_dir DIR [--probes base a b c d]

``--stage pinned`` probes the pinned stage instead: ``CHAIN_DIR`` first
runs ``3bp_chain_recons_warmup``'s curriculum (``run_chain``; its finished
stages are not run again), then each probe copies that run into
``DIR/<probe>`` and runs the all-slot surgery and the 1000 pinned epochs
there under the chain's flags plus its own (``PINNED_PROBES``):

* ``control``: none (``3bp_chain_recons_warmup``'s pinned stage);
* ``e``: ``--recons_warmup --aux_on_recons=3.0``: the prediction term off
  until a valid eval's recons fall under twice the recons bar;
* ``f``: ``--vel_anchor=1.0``.

A pinned probe passes where the head is alive at the stage's end (the
tests above) and its last valid recons are under ``MAX_PINNED_RECONS``;
``DIR/pinned_probes.json`` also gives the epoch ``e``'s trigger fired at
(None where it never did). Each probe's directory is a chain's save_dir
through the pinned stage, which ``reference_runs --run`` of a chain with
the same stages finishes:

    python -m paig_reproduction_tpu_torch.tools.curriculum_probes \\
        --stage pinned --chain_dir CHAIN_DIR --save_dir DIR \\
        [--probes control e f]

With ``--curriculum_dir CDIR`` in place of ``--chain_dir`` no curriculum
is run: each probe runs ``3bp_chain``'s surgery on the ``curriculum_3``
checkpoint in CDIR (for example the tracked
``data/checkpoints/3bp_curriculum_3``, ``reference_runs.CURRICULUM_3``)
and its pinned stage. ``--seed`` then changes the pinned stage's batch
order alone (the weights come from CDIR). Each probe's line also gives
its valid recons every ``RECONS_EVERY`` epochs, its wall seconds and its
kernel launches:

    python -m paig_reproduction_tpu_torch.tools.curriculum_probes \\
        --stage pinned --curriculum_dir CDIR --save_dir DIR \\
        [--probes control] [--seed S]

``--stage test`` probes what holds the test stage of a finished
``3bp_chain`` (``TEST_FROM``) in ``CHAIN_DIR``: its pinned stage is reused,
not run again (each probe copies it and the run's sidecar into
``DIR/<probe>``), and each probe runs on from it:

* ``control``: the chain's own fit and both test phases;
* ``g``: the head re-anchor, a training stage ``anchor`` of
  ``reference_runs.ANCHOR_EPOCHS`` from the pinned stage under
  ``reference_runs.ANCHOR_FLAGS`` (``--vel_anchor=1.0 --bg_lr_mult=0
  --base_lr=3e-4``), then the fit and both test phases: a chain's stages
  (``chain_stages(anchor_flags=...)``), whose head's readings in the
  stage's ``velocity.jsonl`` show whether it took gradient;
* ``h``: both test phases on the control's fit at ``--init_state_fit=8``
  in place of the logs' 3 (``MORE_ITERS``): whether more iterations from
  the head's start are accepted;
* ``i``: both test phases on the control's fitted checkpoint with its
  gravity constant set to the generator's (``log_g`` = log 60,
  ``set_gravity``): whether the fit's A alone sets pred.

``h`` and ``i`` are readings only: ``h`` departs from the logs' flags and
``i`` takes the generator's truth, so neither may become a chain stage
(``reference_runs.CHAINS``). Each test stage writes its state-fit reading
(``reference_runs.test_state``); a probe passes where both test lines are
under the bars. ``DIR/test_probes.json`` has each probe's test lines,
readings, fit and (``g``) anchor stage:

    python -m paig_reproduction_tpu_torch.tools.curriculum_probes \\
        --stage test --chain_dir CHAIN_DIR --save_dir DIR \\
        [--probes control g h i]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics

from paig_reproduction_tpu_torch.tools import reference_runs as rr

# 3bp_color's generator draws each start velocity component within +-2 px a
# time unit (data/generate.py, vx0_max, vy0_max); gravity speeds the balls
# up, so a head within three times that is within range.
MAX_SPEED = 6.0
# Objects whose start velocities lie closer than this (px a time unit, the
# median over the batch of the largest gap) move as one.
MIN_SPREAD = 0.1
MAX_SATURATED = 0.5
PROBE_EPOCHS = 300
SHORT_EPOCHS = 100
# The pinned stage's probes: the flags each adds to the chain's pinned
# stage, and the valid recons a passing one ends under (the recons bar).
PINNED_PROBES = {"control": [], "e": list(rr.PINNED_GATE_FLAGS),
                 "f": ["--vel_anchor=1.0"]}
MAX_PINNED_RECONS = 1.5
# The chain whose curriculum the pinned probes start from, and the one
# whose surgery and pinned stage they run from a given curriculum_3.
PINNED_FROM = "3bp_chain_recons_warmup"
PINNED_FROM_STATE = "3bp_chain"
# The period of a pinned probe's printed valid recons (epochs).
RECONS_EVERY = 50


def probe_flags(name, base_records=()) -> list:
    """The flags probe ``name`` adds to the chain's curriculum stages
    (``c`` needs ``base``'s velocity records)."""
    if name in ("base", "d"):
        return []
    if name == "a":
        return ["--vel_anchor=1.0"]
    if name == "b":
        return rr.recons_warmup_flags()
    if name == "c":
        return ["--grad_clip=%.6g" % clip_norm(base_records)]
    raise ValueError(name)


def clip_norm(base_records) -> float:
    """G of probe ``c``: the median gradient norm of ``base``'s
    checkpoints after its start."""
    norms = [r["grad_norm"] for r in base_records if r["epoch"] > 0]
    if not norms:
        raise ValueError("probe c needs base's velocity records")
    return statistics.median(norms)


def alive(state) -> dict:
    """The three tests of a live head on a ``velocity_state`` record."""
    return dict(differ=state["spread"] > MIN_SPREAD,
                in_range=state["speed_p95"] < MAX_SPEED,
                unsaturated=state["saturated"][-1] < MAX_SATURATED)


def _stage(flags, epochs, batch_size, save_every, eval_every):
    return rr.chain_stages((epochs,) + rr.CURRICULUM_EPOCHS[1:],
                           batch_size=batch_size, save_every=save_every,
                           eval_every=eval_every,
                           curriculum_flags=flags)[:1]


def run_probes(save_dir, names=("base", "a", "b", "c", "d"), device="cuda",
               data_dir=None, seed=0, epochs=PROBE_EPOCHS,
               short=SHORT_EPOCHS, batch_size=100, save_every=50,
               eval_every=10) -> dict:
    """Runs the probes ``names`` (``d`` and ``c`` after ``base``) in
    ``save_dir``; returns {probe: its flags, epochs, end record, valid
    losses at that epoch, the tests and whether it passed}."""
    out = {}
    base_dir = os.path.join(save_dir, "base", "curriculum_1")
    for name in [n for n in ("base", "a", "b", "c", "d") if n in names]:
        if name == "d":
            end = [r for r in rr._velocity_records(base_dir)
                   if r["epoch"] <= short][-1]
            stage_dir, flags, n_epochs = base_dir, [], short
        else:
            flags = probe_flags(name, rr._velocity_records(base_dir))
            rr.run_chain("3bp_chain", os.path.join(save_dir, name), device,
                         data_dir, seed, stages=_stage(
                             flags, epochs, batch_size, save_every,
                             eval_every))
            stage_dir = os.path.join(save_dir, name, "curriculum_1")
            end = rr._velocity_records(stage_dir)[-1]
            n_epochs = epochs
        valid = rr.parse_log(os.path.join(stage_dir, "log.txt"))[
            "valid"].get(end["epoch"])
        tests = alive(end)
        out[name] = dict(flags=flags, epochs=n_epochs, end=end, valid=valid,
                         tests=tests, passed=all(tests.values()))
        print(f"curriculum_probes: {name} ({' '.join(flags) or 'no flag'} "
              f"on the chain's) at {n_epochs} epochs: valid recons "
              f"{'none' if valid is None else '%.4f' % valid['recons']}; "
              f"{rr.velocity_line(end)}; "
              + ", ".join(f"{k} {v}" for k, v in tests.items())
              + f": {'passed' if out[name]['passed'] else 'failed'}",
              flush=True)
    first = next((n for n in ("a", "b", "c", "d")
                  if n in out and out[n]["passed"]), None)
    print(f"curriculum_probes: first passing probe {first}", flush=True)
    result = dict(probes=out, first_passing=first)
    with open(os.path.join(save_dir, "probes.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: {kk: v[kk] for kk in ("flags", "epochs", "valid",
                                               "tests", "passed")}
                      for k, v in out.items()}), flush=True)
    return result


def pinned_stages(flags, curriculum=rr.CURRICULUM_EPOCHS,
                  pinned=rr.PINNED_EPOCHS, batch_size=100, save_every=50,
                  eval_every=10, start=None) -> list:
    """PINNED_FROM's stages through the pinned stage, ``flags`` added to
    the pinned stage's; with ``start`` (a ``curriculum_3`` checkpoint's
    directory) PINNED_FROM_STATE's surgery, reading ``start``, and its
    pinned stage alone."""
    stages = rr.chain_stages(
        curriculum, pinned, batch_size, save_every, eval_every,
        curriculum_flags=() if start else rr.recons_warmup_flags(curriculum),
        pinned_flags=flags)
    stages = stages[:[s["name"] for s in stages].index("pinned") + 1]
    if start is None:
        return stages
    return [dict(stages[-2], start=os.path.abspath(start)), stages[-1]]


def pinned_passed(end, valid) -> dict:
    """The tests of a pinned probe: a live head (``alive``) and valid
    recons under MAX_PINNED_RECONS at the stage's end."""
    return dict(alive(end), recons=valid is not None
                and valid["recons"] < MAX_PINNED_RECONS)


def _copy_run(src, dst, stages):
    """``stages``' directories of the run in ``src`` into ``dst``, and its
    sidecar with those stages' segments and steps alone (a probe's own
    stages then count only their own), each unless ``dst`` has it: a
    probe resumed keeps its own record."""
    import shutil
    os.makedirs(dst, exist_ok=True)
    names = [st["name"] for st in stages]
    for name in names:
        if not os.path.exists(os.path.join(dst, name)):
            shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    if not os.path.exists(os.path.join(dst, rr.SIDECAR)):
        record = rr._read_sidecar(src)
        for key in ("stages", "steps"):
            record[key] = {k: v for k, v in record.get(key, {}).items()
                           if k in names}
        rr._write_sidecar(dst, record)


def run_pinned_probes(save_dir, chain_dir, names=("control", "e", "f"),
                      device="cuda", data_dir=None, seed=0,
                      curriculum=rr.CURRICULUM_EPOCHS,
                      pinned=rr.PINNED_EPOCHS, batch_size=100, save_every=50,
                      eval_every=10, curriculum_dir=None) -> dict:
    """Runs PINNED_FROM's curriculum in ``chain_dir`` (where not finished),
    then the pinned probes ``names`` in ``save_dir`` from its last
    stage's checkpoint, or, given ``curriculum_dir``, the probes from the
    ``curriculum_3`` checkpoint there under PINNED_FROM_STATE's flags;
    returns {probe: its flags, end record, valid losses at that epoch,
    valid recons every RECONS_EVERY epochs, trigger epoch, wall seconds,
    launches, tests and whether it passed}."""
    kw = dict(curriculum=curriculum, pinned=pinned, batch_size=batch_size,
              save_every=save_every, eval_every=eval_every)
    chain = PINNED_FROM_STATE if curriculum_dir else PINNED_FROM
    if not curriculum_dir:
        curriculum = pinned_stages([], **kw)[:-2]
        rr.run_chain(chain, chain_dir, device, data_dir, seed,
                     stages=curriculum)
    out = {}
    for name in [n for n in PINNED_PROBES if n in names]:
        flags = PINNED_PROBES[name]
        d = os.path.join(save_dir, name)
        if not curriculum_dir:
            _copy_run(chain_dir, d, curriculum)
        rr.run_chain(chain, d, device, data_dir, seed,
                     stages=pinned_stages(flags, start=curriculum_dir, **kw))
        stage_dir = os.path.join(d, "pinned")
        end = rr._velocity_records(stage_dir)[-1]
        parsed = rr.parse_log(os.path.join(stage_dir, "log.txt"))
        valid = parsed["valid"].get(end["epoch"])
        tests = pinned_passed(end, valid)
        segments = rr._read_sidecar(d)["stages"]["pinned"]
        every = {e: v["recons"] for e, v in sorted(parsed["valid"].items())
                 if e % RECONS_EVERY == 0}
        out[name] = dict(flags=flags, end=end, valid=valid,
                         recons_every=every, trigger=parsed["trigger"],
                         first_lr=(parsed["first_lr"] or [None])[0],
                         wall_s=sum(s["wall_s"] for s in segments),
                         launches=sum(s["launches"] for s in segments),
                         tests=tests, passed=all(tests.values()))
        recons = "none" if valid is None else "%.4f" % valid["recons"]
        trigger = ("never" if parsed["trigger"] is None
                   else "at epoch %d" % parsed["trigger"])
        print(f"curriculum_probes: pinned {name} "
              f"({' '.join(flags) or 'no flag'} on {chain}'s, seed "
              f"{seed}): valid recons {recons}, trigger {trigger}; every "
              f"{RECONS_EVERY} epochs "
              + ", ".join(f"{e}: {v:.4f}" for e, v in every.items())
              + f"; {out[name]['wall_s']:.1f} s, "
              f"{out[name]['launches']} launches; "
              f"{rr.velocity_line(end)}; "
              + ", ".join(f"{k} {v}" for k, v in tests.items())
              + f": {'passed' if out[name]['passed'] else 'failed'}",
              flush=True)
    first = next((n for n in ("e", "f") if n in out and out[n]["passed"]),
                 None)
    print(f"curriculum_probes: first passing pinned probe {first}",
          flush=True)
    result = dict(probes=out, first_passing=first)
    with open(os.path.join(save_dir, "pinned_probes.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: {kk: v[kk] for kk in (
        "flags", "valid", "recons_every", "trigger", "wall_s", "launches",
        "tests", "passed")} for k, v in out.items()}), flush=True)
    return result


# The test stage's probes, from a finished run of TEST_FROM.
TEST_FROM = "3bp_chain"
TEST_PROBES = ("control", "g", "h", "i")
# h's Gauss-Newton iterations at the tests, in place of the logs' 3.
MORE_ITERS = 8


def test_probe_stages(name, control_dir, pinned=rr.PINNED_EPOCHS,
                      anchor=rr.ANCHOR_EPOCHS, batch_size=100, save_every=50,
                      eval_every=10) -> list:
    """The stages test probe ``name`` runs, from TEST_FROM's pinned stage
    on (``control``, ``g``), or its test phases alone from the control's
    fit (``h``: at MORE_ITERS) or from ``fit`` (``i``: the control's fit
    with the generator's A, which the probe writes there)."""
    chain = rr.chain_stages(rr.CURRICULUM_EPOCHS, pinned, batch_size,
                            save_every, eval_every,
                            anchor_flags=rr.ANCHOR_FLAGS if name == "g"
                            else None, anchor=anchor)
    if name in ("control", "g"):
        return chain[[s["name"] for s in chain].index("pinned"):]
    tests = [s for s in chain if s["kind"] == "test"]
    if name == "h":
        fit = os.path.join(control_dir, "fit")
        return [dict(s, start=fit, argv=rr.with_flags(
            s["argv"], [f"--init_state_fit={MORE_ITERS}"])) for s in tests]
    if name == "i":
        return tests
    raise ValueError(name)


def set_gravity(src_dir, dst_dir, A):
    """``src_dir``'s checkpoint written to ``dst_dir`` with its gravity
    constant exp(log_g) exp(2 log_m) set to ``A`` (``log_m`` is frozen)."""
    import torch

    from paig_reproduction_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    ckpt = load_checkpoint(src_dir)
    model = ckpt["model"]
    log_m = float(model["log_m"]) if "log_m" in model else 0.0
    model["log_g"] = torch.tensor(math.log(A) - 2.0 * log_m,
                                  dtype=model["log_g"].dtype)
    os.makedirs(dst_dir, exist_ok=True)
    save_checkpoint(dst_dir, ckpt)


def _test_record(result, stages):
    """A test probe's record from ``run_chain``'s result: its test lines
    and readings, the fit's A and error, the anchor stage's end, and
    whether both test lines are under the bars."""
    rows = result["stages"]
    tests = [s["name"] for s in stages if s["kind"] == "test"]
    out = dict(stages=[s["name"] for s in stages],
               tests={t: rows[t]["test"] for t in tests},
               test_state={t: rows[t].get("test_state") for t in tests},
               passed=all(rows[t]["port_pass"] for t in tests))
    if "fit" in rows:
        out["fit"] = {k: rows["fit"].get(k) for k in ("A", "A_pointwise",
                                                      "A_traj_err")}
    if "anchor" in rows:
        out["anchor"] = {k: rows["anchor"].get(k) for k in (
            "valid", "first_lr", "velocity", "steps", "wall_s",
            "launches")}
    return out


def run_test_probes(save_dir, chain_dir, names=TEST_PROBES, device="cuda",
                    data_dir=None, seed=0, pinned=rr.PINNED_EPOCHS,
                    anchor=rr.ANCHOR_EPOCHS, batch_size=100, save_every=50,
                    eval_every=10) -> dict:
    """Runs the test probes ``names`` in ``save_dir`` from TEST_FROM's
    finished pinned stage in ``chain_dir`` (``h`` and ``i`` after the
    control, which they read, run where it is missing); returns {probe:
    its record (``_test_record``)} and writes ``test_probes.json``."""
    pinned_dir = os.path.join(chain_dir, "pinned")
    if rr.resume_decision(pinned_dir) != "done":
        raise SystemExit(f"curriculum_probes: {chain_dir} has no finished "
                         f"pinned stage; run reference_runs --run "
                         f"{TEST_FROM} there first")
    kw = dict(pinned=pinned, anchor=anchor, batch_size=batch_size,
              save_every=save_every, eval_every=eval_every)
    control_dir = os.path.join(save_dir, "control")
    wanted = [n for n in TEST_PROBES if n in names]
    if {"h", "i"} & set(wanted) and "control" not in wanted:
        wanted.insert(0, "control")
    out = {}
    for name in wanted:
        d = os.path.join(save_dir, name)
        stages = test_probe_stages(name, control_dir, **kw)
        if name in ("control", "g"):
            _copy_run(chain_dir, d, stages[:1])
        if name == "i":
            set_gravity(os.path.join(control_dir, "fit"),
                        os.path.join(d, "fit"),
                        rr.CHAIN_RECORD["A_generator"])
        result = rr.run_chain(TEST_FROM, d, device, data_dir, seed,
                              stages=stages)
        out[name] = _test_record(result, stages)
        states = out[name]["test_state"]
        print(f"curriculum_probes: test {name}: " + " | ".join(
            f"{t} {rr._fmt(v)}; {rr.test_state_line(states[t])}"
            for t, v in out[name]["tests"].items())
            + f": {'passed' if out[name]['passed'] else 'failed'}",
            flush=True)
    first = next((n for n in TEST_PROBES if n in out and out[n]["passed"]),
                 None)
    print(f"curriculum_probes: first passing test probe {first}", flush=True)
    result = dict(probes=out, first_passing=first)
    with open(os.path.join(save_dir, "test_probes.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: {kk: v[kk] for kk in ("tests", "passed")}
                      for k, v in out.items()}), flush=True)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--save_dir", required=True)
    p.add_argument("--stage", choices=("curriculum", "pinned", "test"),
                   default="curriculum")
    p.add_argument("--chain_dir", default="",
                   help="--stage pinned: the save_dir of the curriculum "
                        "the probes start from; --stage test: a finished "
                        "3bp_chain's save_dir")
    p.add_argument("--curriculum_dir", default="",
                   help="--stage pinned: a curriculum_3 checkpoint's "
                        "directory to run 3bp_chain's surgery and pinned "
                        "stage from, in place of --chain_dir's curriculum")
    p.add_argument("--probes", nargs="+", default=None,
                   help="default: base a b c d; control e f with --stage "
                        "pinned; control g h i with --stage test")
    p.add_argument("--data_dir", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.save_dir, exist_ok=True)
    if args.curriculum_dir and args.stage != "pinned":
        p.error("--curriculum_dir is for --stage pinned")
    if (args.stage != "curriculum" and not args.chain_dir
            and not args.curriculum_dir):
        p.error(f"--stage {args.stage} needs --chain_dir")
    if args.stage == "test":
        return run_test_probes(args.save_dir, args.chain_dir,
                               args.probes or list(TEST_PROBES), args.device,
                               args.data_dir or None, args.seed)
    if args.stage == "pinned":
        return run_pinned_probes(args.save_dir, args.chain_dir,
                                 args.probes or list(PINNED_PROBES),
                                 args.device, args.data_dir or None,
                                 args.seed,
                                 curriculum_dir=args.curriculum_dir or None)
    return run_probes(args.save_dir, args.probes or ["base", "a", "b", "c",
                                                     "d"],
                      args.device, args.data_dir or None, args.seed)


if __name__ == "__main__":
    main()
