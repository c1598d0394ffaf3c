"""The spring recipe's loop from one undiscovered state, in both packages,
on the CPU: does the port's descent lie within the JAX package's own
spread?

Every run starts from the JAX package's ``runs/spring_s2_100`` (seed 2
after 100 plain spring_color epochs, valid recons 11.23: undiscovered, as
the port's kept discovery arms were), trains spring_one5's model as its
loop does before the ``--aux_on_recons`` trigger (``tests/spring_pair.py``:
the enhancers at eval only, the alignment losses off, a fresh RMSprop, the
recipe's schedule) on the tracked 2500-sequence spring file at B=100, 25
steps an epoch, every run on the same index batches, and scores the valid
recons with its own package's eval (the enhancers on) on the first 200
valid sequences in two batches of 100. The runs:

* ``port``: the port's Trainer (``train_step``, ``_losses``);
* ``jax``: the JAX package's jitted step and eval;
* ``jax_up``, ``jax_down``: the same from the start's params multiplied
  by 1 + 1e-7 and 1 - 1e-7: the JAX package's own spread.

Each run is one process (``--run NAME``) and writes ``NAME.json`` into
``--out``; ``--report`` prints the table of valid recons at the shared
epoch marks, each run's descent from its start, and whether the port
lies within the JAX runs' range at each, then the runs' last states
scored by one evaluator, the port's:

    python tests/spring_loop_study.py --run port --epochs 12 --out DIR
    (the same for jax, jax_up, jax_down; one process each)
    python tests/spring_loop_study.py --report --out DIR

A run resumes from its ``port.pt`` / ``NAME.pkl`` state when asked for
more epochs than it has. It runs on this package's CPU only (JAX and the port
both), at full width.
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

from spring_pair import (  # noqa: E402
    SL12,
    SPRING_S2_100,
    jax_losses,
    jax_models,
    jax_step_fn,
    load_port,
    nudged,
    port_trainer,
    recipe_args,
    start_params,
)

BATCH, STEPS_PER_EPOCH, VALID_N = 100, 25, 200
RUN_NUDGES = {"port": None, "jax": 0.0, "jax_up": 1e-7, "jax_down": -1e-7}


def port_score(trainer, valid):
    """The valid recons of the port's eval (the enhancers on) over
    ``valid`` in batches of BATCH."""
    with torch.no_grad():
        return float(np.mean([
            float(trainer._losses(torch.from_numpy(
                valid[i:i + BATCH]))[1]["eval_recons_loss"])
            for i in range(0, len(valid), BATCH)]))


def epoch_batches(epoch, n):
    """The index batches of loop epoch ``epoch`` (1-based), the same for
    every run: a permutation of the train split from seed ``epoch``."""
    perm = np.random.RandomState(epoch).permutation(n)
    return perm[:STEPS_PER_EPOCH * BATCH].reshape(STEPS_PER_EPOCH, BATCH)


def run(name, epochs, eval_every, out_dir):
    args = recipe_args()
    trainer = port_trainer(args, SL12, STEPS_PER_EPOCH)
    x = trainer.train_iterator.raw_uint8.astype(np.float32) / 255
    valid = trainer.valid_iterator.raw_uint8[:VALID_N].astype(
        np.float32) / 255
    train_model, eval_model = jax_models(trainer.model)
    params = start_params(SPRING_S2_100, train_model, x)
    path = os.path.join(out_dir, name + ".json")
    record = dict(run=name, start=os.path.relpath(SPRING_S2_100),
                  batch=BATCH, valid_n=VALID_N, epochs=[], valid_recons=[],
                  train_loss=[], seconds=0.0, threads=torch.get_num_threads())
    if os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
    done = record["epochs"][-1] if record["epochs"] else -1

    if name == "port":
        load_port(trainer, SPRING_S2_100, params)
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
        params = nudged(params, RUN_NUDGES[name])
        tx, jax_step = jax_step_fn(train_model, args, STEPS_PER_EPOCH,
                                   params)
        box = [params, tx.init(params)]
        state = os.path.join(out_dir, name + ".pkl")
        if done >= 0:
            import pickle
            with open(state, "rb") as f:
                box = pickle.load(f)

        @jax.jit
        def recons(p, batch):
            out, aux = eval_model.apply({"params": p}, batch)
            return jax_losses(eval_model, batch, out, aux["recons_out"],
                              aux_scale=0.0)[1]["eval_recons_loss"]

        def step(idx):
            box[0], box[1], loss = jax_step(box[0], box[1], x[idx])
            return float(loss)

        def score():
            return float(np.mean([float(recons(box[0], valid[i:i + BATCH]))
                                  for i in range(0, VALID_N, BATCH)]))

        def save():
            import pickle
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


def last_states(out_dir):
    """Every run's last saved state scored by the port's eval, so that all
    four are read by one evaluator: {run: (epoch, valid recons)}, the
    start's own under ``start``."""
    import pickle

    from paig_reproduction_tpu_torch.convert import flax_checkpoint_to_port
    args = recipe_args()
    trainer = port_trainer(args, SL12, STEPS_PER_EPOCH)
    valid = trainer.valid_iterator.raw_uint8[:VALID_N].astype(
        np.float32) / 255
    x = trainer.train_iterator.raw_uint8[:1].astype(np.float32) / 255
    start = start_params(SPRING_S2_100, jax_models(trainer.model)[0], x)
    load_port(trainer, SPRING_S2_100, start)
    out = {"start": (0, port_score(trainer, valid))}
    for name in RUN_NUDGES:
        path = os.path.join(out_dir, name + ".json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            epoch = json.load(f)["epochs"][-1]
        if name == "port":
            state = torch.load(os.path.join(out_dir, "port.pt"),
                               weights_only=False)["model"]
        else:
            with open(os.path.join(out_dir, name + ".pkl"), "rb") as f:
                state = flax_checkpoint_to_port(
                    {"params": pickle.load(f)[0]})["model"]
        trainer.model.load_state_dict(state)
        out[name] = (epoch, port_score(trainer, valid))
    return out


def report(out_dir):
    """The table of valid recons at the marks every run reached, each by
    its own package's eval, with each run's descent from its epoch-0 score
    (the two evals differ on the same weights), the JAX runs' range of
    both, and whether the port's lies within it; then every run's last
    state scored by the port's eval alone."""
    runs = {}
    for name in RUN_NUDGES:
        path = os.path.join(out_dir, name + ".json")
        if os.path.exists(path):
            with open(path) as f:
                runs[name] = json.load(f)
    marks = sorted(set.intersection(*(set(r["epochs"])
                                      for r in runs.values())))
    jax_names = [n for n in runs if n != "port"]
    print("epoch | " + " | ".join(runs) + " | JAX range | port within | "
          "descents " + ", ".join(runs) + " | JAX range | port within")
    rows = []
    for e in marks:
        vals = {n: r["valid_recons"][r["epochs"].index(e)]
                for n, r in runs.items()}
        falls = {n: vals[n] - r["valid_recons"][0] for n, r in runs.items()}
        row = dict(epoch=e, recons=vals, descent=falls)
        for key, got in (("recons", vals), ("descent", falls)):
            lo = min(got[n] for n in jax_names)
            hi = max(got[n] for n in jax_names)
            row[key + "_range"] = (lo, hi)
            row[key + "_inside"] = lo <= got["port"] <= hi
        rows.append(row)
        print(f"{e} | " + " | ".join(f"{vals[n]:.4f}" for n in runs)
              + " | %.4f-%.4f | %s | " % (*row["recons_range"],
                                         row["recons_inside"])
              + ", ".join(f"{falls[n]:+.4f}" for n in runs)
              + " | %+.4f to %+.4f | %s" % (*row["descent_range"],
                                           row["descent_inside"]))
    last = last_states(out_dir)
    print("the last states by the port's eval: " + "; ".join(
        f"{n} (epoch {e}) {v:.4f}" for n, (e, v) in last.items()))
    print(json.dumps(dict(marks=rows, port_eval=last, seconds={
        n: r["seconds"] for n, r in runs.items()})))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run", choices=sorted(RUN_NUDGES))
    p.add_argument("--report", action="store_true")
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--eval_every", type=int, default=2)
    p.add_argument("--out", required=True)
    p.add_argument("--threads", type=int, default=0,
                   help="torch's intra-op threads (0: its default)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.report:
        return report(args.out)
    if not args.run:
        p.error("--run NAME or --report")
    return run(args.run, args.epochs, args.eval_every, args.out)


if __name__ == "__main__":
    main()
