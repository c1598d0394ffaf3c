"""3bp_color's pinned stage from one tracked state, in both packages, on
the CPU: does the port's descent lie within the JAX package's own
spread?

Every run starts from the all-slot surgery's output on the tracked
``curriculum_3`` checkpoint (``reference_runs.CURRICULUM_3``; the port's
``slot_rescue`` with ``SURGERY_FLAGS``, which
``tests/test_torch_chain_pinned.py`` holds to the JAX tool's) and trains
the chain's pinned stage (``tests/chain_pinned.py``: its flags, a fresh
RMSprop, the 1000-epoch schedule) at full width (36 px, 3 objects, B=100)
on the tracked 2000-sequence train file, 20 steps an epoch, every run on
the same index batches, and scores the valid recons with its own
package's eval on the first 200 valid sequences in two batches of 100
(the JAX package's run eagerly, its jitted value kept beside it). The
runs:

* ``port``: the port's Trainer (``train_step``, ``_losses``);
* ``jax``: the JAX package's jitted step and eval;
* ``jax_up``, ``jax_down``: the same from the start's params multiplied
  by 1 + 1e-7 and 1 - 1e-7: the JAX package's own spread;
* ``jax_up2``, ``jax_down2``, ``jax_up3``, ``jax_down3``: the same from
  the start times 1 +- 2e-7 and 1 +- 3e-7, widening that spread.

Each run is one process (``--run NAME``) and writes ``NAME.json`` into
``--out``; ``--report`` prints, at each epoch mark that the port and
``jax`` reached, every run's valid recons, the range of the JAX runs that
reached it, whether the port lies inside it and by how much it lies
outside; the same test with each run against the others; then each
run's last state's template masses and content salience (its own
package's ``train/surgery.py``) and every last state scored by one
evaluator, the port's:

    taskset -c 0,1 python tests/chain_pinned_study.py --run port \\
        --epochs 30 --eval_every 5 --threads 2 --out DIR
    (the same for each JAX run on other cores; one process each)
    python tests/chain_pinned_study.py --report --out DIR

A run resumes from its ``port.pt`` / ``NAME.pkl`` state when asked for
more epochs than it has. It runs on the CPU only (JAX and the port both).

``--ensemble K`` steps K starts of each package instead (the surgery's
output times 1 + n 1e-7 for n = 0, +-1, ..., +-(K-1)/2) for ``--steps``
steps at B=8 on the first 64 train sequences, every run on the same
batches, and prints after each step both packages' train losses (the
port's evaluator in float64 on 16 of those sequences: ``loss64``), their
medians and ranges, how many port runs lie inside the JAX runs' range and
the two-sided Mann-Whitney test of the two samples; ``ensemble.json``:

    python tests/chain_pinned_study.py --ensemble 17 --steps 12 --out DIR
"""
import argparse
import json
import os
import pickle
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import chain_pinned as cpn  # noqa: E402
from spring_pair import nudged  # noqa: E402

BATCH, VALID_N = 100, 200
RUN_NUDGES = {"port": None, "jax": 0.0, "jax_up": 1e-7, "jax_down": -1e-7,
              "jax_up2": 2e-7, "jax_down2": -2e-7, "jax_up3": 3e-7,
              "jax_down3": -3e-7}


def epoch_batches(epoch, n):
    """The index batches of pinned epoch ``epoch`` (1-based), the same for
    every run: a permutation of the train split from seed ``epoch``."""
    perm = np.random.RandomState(epoch).permutation(n)
    return perm[:cpn.STEPS_PER_EPOCH * BATCH].reshape(cpn.STEPS_PER_EPOCH,
                                                      BATCH)


def port_score(trainer, valid):
    """The port's valid recons over ``valid`` in batches of BATCH."""
    with torch.no_grad():
        return float(np.mean([
            float(trainer._losses(torch.from_numpy(
                valid[i:i + BATCH]))[1]["eval_recons_loss"])
            for i in range(0, len(valid), BATCH)]))


def _start(out_dir):
    """The surgery's output (computed once per process into its own
    directory: the tool is deterministic) and a port trainer on it."""
    start = cpn.surgery(os.path.join(out_dir, "surgery_%d" % os.getpid()))
    trainer = cpn.port_trainer(start, os.path.join(out_dir, "port_run"))
    return start, trainer


def run(name, epochs, eval_every, out_dir):
    start, trainer = _start(out_dir)
    x = trainer.train_iterator.raw_uint8.astype(np.float32) / 255
    valid = trainer.valid_iterator.raw_uint8[:VALID_N].astype(
        np.float32) / 255
    path = os.path.join(out_dir, name + ".json")
    record = dict(run=name, start=os.path.relpath(cpn.rr.CURRICULUM_3),
                  batch=BATCH, valid_n=VALID_N, epochs=[], valid_recons=[],
                  train_loss=[], seconds=0.0, threads=torch.get_num_threads())
    if os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
    done = record["epochs"][-1] if record["epochs"] else -1

    if name == "port":
        state = os.path.join(out_dir, "port.pt")
        if done >= 0:
            saved = torch.load(state, weights_only=False)
            trainer.model.load_state_dict(saved["model"])
            trainer.optimizer.load_state_dict(saved["optimizer"])
            trainer.step = saved["step"]

        def step(idx):
            return float(trainer.train_step(idx)["train_loss"])

        def score():
            return port_score(trainer, valid)

        def save():
            torch.save(dict(model=trainer.model.state_dict(),
                            optimizer=trainer.optimizer.state_dict(),
                            step=trainer.step), state)
    else:
        model = cpn.jax_model()
        params = nudged(cpn.jax_params(start, model), RUN_NUDGES[name])
        tx, jax_step = cpn.jax_step_fn(model, params)
        box = [params, tx.init(params)]
        state = os.path.join(out_dir, name + ".pkl")
        if done >= 0:
            with open(state, "rb") as f:
                box = pickle.load(f)

        def recons(p, batch):
            out, aux = model.apply({"params": p}, batch)
            return cpn.train_losses(model, batch, out,
                                    aux)[1]["eval_recons_loss"]

        recons_jit = jax.jit(recons)

        def step(idx):
            box[0], box[1], loss, _ = jax_step(box[0], box[1], x[idx])
            return float(loss)

        def score():
            # Eagerly: XLA CPU's jitted sum over a frame's pixels carries
            # about 4e-4 of relative error (ROADMAP, Queue 3), eager JAX
            # about 1e-7. The jitted eval's value is kept beside it.
            with jax.disable_jit():
                value = np.mean([float(recons(box[0], valid[i:i + BATCH]))
                                 for i in range(0, VALID_N, BATCH)])
            record.setdefault("valid_recons_jit", []).append(float(np.mean(
                [float(recons_jit(box[0], valid[i:i + BATCH]))
                 for i in range(0, VALID_N, BATCH)])))
            return float(value)

        def save():
            with open(state, "wb") as f:
                pickle.dump(jax.device_get(box), f)

    def write():
        with open(path + ".tmp", "w") as f:
            json.dump(record, f, indent=1)
        os.replace(path + ".tmp", path)

    t0 = time.perf_counter()
    if done < 0:
        record["epochs"].append(0)
        record["valid_recons"].append(score())
        record["train_loss"].append(None)
        done = 0
        write()
    for epoch in range(done + 1, epochs + 1):
        losses = [step(idx) for idx in epoch_batches(epoch, len(x))]
        if epoch % eval_every == 0 or epoch == epochs:
            record["epochs"].append(epoch)
            record["valid_recons"].append(score())
            record["train_loss"].append(float(np.mean(losses)))
            record["seconds"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            save()
            write()
            print(f"{name}: epoch {epoch} valid recons "
                  f"{record['valid_recons'][-1]:.4f} train loss "
                  f"{record['train_loss'][-1]:.4f} "
                  f"({record['seconds']:.1f} s)", flush=True)
    return record


def _last_params(out_dir, name):
    """Run ``name``'s last saved state as the port's state_dict."""
    if name == "port":
        return torch.load(os.path.join(out_dir, "port.pt"),
                          weights_only=False)["model"]
    from paig_reproduction_tpu_torch.convert import flax_to_state_dict
    with open(os.path.join(out_dir, name + ".pkl"), "rb") as f:
        return flax_to_state_dict(pickle.load(f)[0])


def slot_states(out_dir, names):
    """{run: (template masses, content salience)} of each run's last
    state, by its own package's surgery functions against the train
    file's median background."""
    from paig_reproduction_tpu.train import surgery as jax_surgery
    from paig_reproduction_tpu_torch.train import surgery
    from chain_state_study import port_to_flax
    with np.load(cpn.SL20) as d:
        bg = surgery.median_background(d["train_x"])
    out = {}
    for name in names:
        model = {k: v.numpy() for k, v in _last_params(out_dir, name).items()}
        lib, params = ((surgery, model) if name == "port" else
                       (jax_surgery, port_to_flax(
                           {k: torch.from_numpy(v) for k, v in
                            model.items()})))
        out[name] = (np.asarray(lib.slot_health(params, 3, 18)).tolist(),
                     np.asarray(lib.slot_salience(params, 3, 18, 3,
                                                  bg)).tolist())
    return out


def last_states(out_dir, names):
    """Every run's last saved state scored by the port's eval, so that all
    are read by one evaluator: {run: (epoch, valid recons)}, the
    start's own under ``start``."""
    start, trainer = _start(out_dir)
    valid = trainer.valid_iterator.raw_uint8[:VALID_N].astype(
        np.float32) / 255
    out = {"start": (0, port_score(trainer, valid))}
    for name in names:
        with open(os.path.join(out_dir, name + ".json")) as f:
            epoch = json.load(f)["epochs"][-1]
        trainer.model.load_state_dict(_last_params(out_dir, name))
        out[name] = (epoch, port_score(trainer, valid))
    return out


def report(out_dir):
    """The table of valid recons at the marks the port and ``jax`` reached,
    each by its own package's eval: the range of the JAX runs that reached
    the mark, its width, whether the port lies within it and how far
    outside; then the slot states and every run's last state by the
    port's eval."""
    runs = {}
    for name in RUN_NUDGES:
        path = os.path.join(out_dir, name + ".json")
        if os.path.exists(path):
            with open(path) as f:
                runs[name] = json.load(f)
    marks = sorted(set(runs["port"]["epochs"]) & set(runs["jax"]["epochs"]))
    print("epoch | " + " | ".join(runs) + " | JAX runs | JAX range (width) "
          "| port inside | port outside by")
    rows = []
    for e in marks:
        vals = {n: r["valid_recons"][r["epochs"].index(e)]
                for n, r in runs.items() if e in r["epochs"]}
        jax_vals = [v for n, v in vals.items() if n != "port"]
        lo, hi = min(jax_vals), max(jax_vals)
        outside = max(lo - vals["port"], vals["port"] - hi, 0.0)
        rows.append(dict(epoch=e, recons=vals, jax_runs=len(jax_vals),
                         jax_range=(lo, hi), width=hi - lo,
                         inside=outside == 0.0, outside_by=outside))
        print(f"{e} | " + " | ".join(f"{vals[n]:.4f}" if n in vals else "-"
                                     for n in runs)
              + f" | {len(jax_vals)} | {lo:.4f}-{hi:.4f} ({hi - lo:.4f}) | "
              f"{outside == 0.0} | {outside:.4f}")
    # The same test with each run in the port's place: a run exchangeable
    # with k others lies outside their range with probability 2 / (k + 1)
    # (whatever their distribution).
    odd = {}
    for name in runs:
        odd[name] = {"outside": [], "outside_by_more_than_width": []}
        for row in rows:
            if name not in row["recons"]:
                continue
            others = [v for n, v in row["recons"].items() if n != name]
            lo, hi = min(others), max(others)
            by = max(lo - row["recons"][name], row["recons"][name] - hi, 0)
            if by > 0:
                odd[name]["outside"].append(row["epoch"])
            if by > hi - lo:
                odd[name]["outside_by_more_than_width"].append(row["epoch"])
        print(f"{name} against the others: outside their range at "
              f"epochs {odd[name]['outside']}, by more than its width at "
              f"{odd[name]['outside_by_more_than_width']}")
    slots = slot_states(out_dir, list(runs))
    for name, (mass, sal) in slots.items():
        print(f"{name} at epoch {runs[name]['epochs'][-1]}: template masses "
              f"(px) {np.round(mass, 1).tolist()}, salience "
              f"{np.round(sal, 3).tolist()}")
    last = last_states(out_dir, list(runs))
    print("the last states by the port's eval: " + "; ".join(
        f"{n} (epoch {e}) {v:.4f}" for n, (e, v) in last.items()))
    print(json.dumps(dict(marks=rows, odd_one_out=odd, slots=slots,
                          port_eval=last,
                          seconds={n: r["seconds"] for n, r in runs.items()},
                          threads={n: r["threads"]
                                   for n, r in runs.items()})))
    return rows


ENSEMBLE_POOL, ENSEMBLE_BATCH, ENSEMBLE_EVAL = 64, 8, 16


def ensemble(k, steps, out_dir):
    """K nudged starts of each package stepped together (``--ensemble``);
    returns the per-step records and writes ``ensemble.json``."""
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.tools.reference_runs import mann_whitney
    start = cpn.surgery(os.path.join(out_dir, "surgery_%d" % os.getpid()))
    path = os.path.join(out_dir, "pool", "3bp.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with np.load(cpn.SL20) as f:
        np.savez(path, train_x=f["train_x"][:ENSEMBLE_POOL],
                 valid_x=f["valid_x"][:8], test_x=f["test_x"][:8])
    nudges = [0.0] + [s * n * 1e-7 for n in range(1, (k + 1) // 2)
                      for s in (1, -1)]
    net = cli.build_model(cli.build_parser().parse_args(
        cpn.pinned_argv() + ["--device=cpu"]), 20)
    records = []
    for step, (ports, jaxs, x) in enumerate(cpn.nudged_steps(
            start, path, nudges, nudges, steps, ENSEMBLE_BATCH), 1):
        p = cpn.loss64(net, ports, x[:ENSEMBLE_EVAL])
        j = cpn.loss64(net, jaxs, x[:ENSEMBLE_EVAL])
        u, pval = mann_whitney(p, j)
        inside = sum(min(j) <= v <= max(j) for v in p)
        records.append(dict(step=step, port=p, jax=j, inside=inside, u=u,
                            p=pval))
        print(f"step {step}: train loss, port median {np.median(p):.3f} "
              f"({min(p):.3f}-{max(p):.3f}), JAX median {np.median(j):.3f} "
              f"({min(j):.3f}-{max(j):.3f}); {inside} of {len(p)} port runs "
              f"inside JAX's range; Mann-Whitney U={u:.1f}, p={pval:.4f}",
              flush=True)
    with open(os.path.join(out_dir, "ensemble.json"), "w") as f:
        json.dump(dict(nudges=nudges, records=records), f, indent=1)
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run", choices=sorted(RUN_NUDGES))
    p.add_argument("--report", action="store_true")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--out", required=True)
    p.add_argument("--ensemble", type=int, default=0,
                   help="K nudged starts of each package for --steps "
                        "steps at B=8 in place of a run")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--threads", type=int, default=0,
                   help="torch's intra-op threads (0: its default)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.report:
        return report(args.out)
    if args.ensemble:
        return ensemble(args.ensemble, args.steps, args.out)
    if not args.run:
        p.error("--run NAME or --report")
    return run(args.run, args.epochs, args.eval_every, args.out)


if __name__ == "__main__":
    main()
