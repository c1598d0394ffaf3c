"""Does seed 0's live slot outlive seed_sweep's first epoch? Both packages'
``seed_sweep`` tools on the CPU, from starts moved by 1e-7.

The smoke's ``pipeline`` phase runs ``seed_sweep`` over DEAD_SEED (6) and
DISCOVERY_SEED (0) for one epoch of spring_color at B=100 (the tracked
2500-sequence file, 25 steps). At initialization seed 0's ShallowUNet
passes a mask logit for one slot and seed 6's for none (the final ReLU),
so no gradient ever reaches seed 6's UNet. Whether seed 0's live slot is
still live after the epoch is a property of the descent: this study runs
each package's own tool (the port's
``paig_reproduction_tpu_torch.tools.seed_sweep``, the JAX package's
``tools/seed_sweep.py``) at one seed from its initial weights times
``1 + nudge``, then reads the saved model with its own package:

* the two slots' encoded positions on the first 100 train sequences, and
  their mean distance (px; 0 exactly where both slots' mask logits are 0
  everywhere, the live slot's ReLU closed too);
* how many of the UNet's parameter tensors moved from their initial
  values (0 where no gradient reached it).

Each run is one process and writes ``PKG_DEVICE_seedS_N.json`` into
``--out`` (N the nudge in units of 1e-7); ``--report`` prints every run
and, for each package, device and seed, how many runs left the slots
exactly together:

    taskset -c 0,1 python tests/seed_sweep_slot_study.py --pkg port \\
        --seed 0 --nudge 3 --out DIR
    (the same for --pkg jax and other nudges, one process each)
    python tests/seed_sweep_slot_study.py --report --out DIR

JAX runs on the CPU only. The port runs on the CPU, or with ``--device
cuda`` on the card through its CUDA decoder and graphed step with cuDNN
free to pick its algorithms, as the tool runs for its users; there
``--repeat K`` runs the same start K times in one process
(``..._rI.json``), so that their spread is the card's alone.
"""
import argparse
import glob
import importlib.util
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# The JAX tool turns on a persistent compile cache under the home
# directory unless told not to.
os.environ["PAIG_COMPILE_CACHE"] = "0"

import numpy as np  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path[:0] = [TESTS, REPO]

from chip_smoke import slot_separation as separation  # noqa: E402

DATA = os.path.join(REPO, "data", "datasets")
SL12 = "color_spring_vx8_vy8_sl12_r2_k4_e6.npz"
BATCH, READ_N = 100, 100
UNIT = 1e-7


def sweep_argv(seed, save_root):
    return ["--task=spring_color", "--seeds", str(seed), "--epochs=1",
            f"--batch_size={BATCH}", f"--data_dir={DATA}",
            f"--save_root={save_root}",
            f"--out={os.path.join(save_root, 'seed_sweep.json')}"]


def run_port(seed, by, save_root, device="cpu"):
    """The port's tool on ``device`` with ``jax_init.load_initial_state``
    followed by the nudge; returns (separation, UNet tensors moved)."""
    import torch

    from paig_reproduction_tpu_torch.models import jax_init
    from paig_reproduction_tpu_torch.tools import fit_physics, seed_sweep
    load = jax_init.load_initial_state
    initial = {}

    def nudged(model, key):
        load(model, key)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + by)
        initial.update({k: v.detach().cpu().clone() for k, v in
                        model.encoder.unet.named_parameters()})

    jax_init.load_initial_state = nudged
    try:
        seed_sweep.main(sweep_argv(seed, save_root) + [f"--device={device}"])
    finally:
        jax_init.load_initial_state = load
    model, _ = fit_physics.restore_model(
        "spring_color", os.path.join(save_root, f"spring_color_seed{seed}"),
        device)
    from paig_reproduction_tpu_torch.data.iterators import get_iterators
    batch = torch.from_numpy(get_iterators(os.path.join(
        DATA, "spring_color", SL12), conv=True)[0].X[:READ_N])
    with torch.no_grad():
        pos = model(batch.to(device))[1]["enc_pos"].cpu().numpy()
    moved = sum(not torch.equal(p.detach().cpu(), initial[k]) for k, p in
                model.encoder.unet.named_parameters())
    return separation(pos), moved


def run_jax(seed, by, save_root):
    """The JAX package's tool with ``Trainer.init_params`` followed by the
    nudge; returns (separation, UNet tensors moved)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp

    from paig_reproduction_tpu.data.iterators import get_iterators
    from paig_reproduction_tpu.train.trainer import Trainer
    init = Trainer.init_params
    initial = {}

    def nudged(self, sample):
        init(self, sample)
        self.params = jax.tree.map(lambda v: v * (1 + by), self.params)
        initial["params"] = jax.device_get(self.params)
        initial["model"] = self.model

    spec = importlib.util.spec_from_file_location(
        "jax_seed_sweep", os.path.join(REPO, "tools", "seed_sweep.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    Trainer.init_params = nudged
    try:
        tool.main(sweep_argv(seed, save_root))
    finally:
        Trainer.init_params = init
    params = ocp.PyTreeCheckpointer().restore(os.path.join(
        save_root, f"spring_color_seed{seed}", "model.ckpt"))["params"]
    x = get_iterators(os.path.join(DATA, "spring_color", SL12),
                      conv=True)[0].X[:READ_N]
    _, aux = initial["model"].apply({"params": params}, x)
    moved = sum(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(params["encoder"]["ShallowUNet_0"]),
        jax.tree.leaves(initial["params"]["encoder"]["ShallowUNet_0"])))
    return separation(aux["enc_pos"]), moved


def report(out_dir):
    runs = [json.load(open(p)) for p in sorted(glob.glob(
        os.path.join(out_dir, "*_seed*_*.json")))]
    for r in runs:
        r.setdefault("device", "cpu")
    groups = {}
    for r in runs:
        groups.setdefault((r["pkg"], r["device"], r["seed"]), []).append(r)
    summary = {}
    for (pkg, device, seed), rs in sorted(groups.items()):
        rs.sort(key=lambda r: r["nudge"])
        together = [r["nudge"] for r in rs if r["separation"] == 0.0]
        # The float32 factor each nudge becomes: two nudges that round to
        # one factor are one start.
        starts = len({float(np.float32(1 + r["nudge"] * UNIT)) for r in rs})
        print(f"{pkg} on {device}, seed {seed}: " + ", ".join(
            f"{r['nudge']:+d}: {r['separation']:.6f} px "
            f"({r['unet_moved']} UNet tensors moved)" for r in rs))
        median = np.median([r["separation"] for r in rs])
        print(f"{pkg} on {device}, seed {seed}: the slots exactly together "
              f"after the "
              f"epoch in {len(together)} of {len(rs)} runs, {starts} "
              f"distinct float32 starts (nudges "
              f"{together}); median {median:.6f} px; "
              f"{min(r['seconds'] for r in rs):.1f}-"
              f"{max(r['seconds'] for r in rs):.1f} s a run")
        summary[f"{pkg} {device} {seed}"] = dict(runs=len(rs), starts=starts,
                                        together=together)
    print(json.dumps(summary))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pkg", choices=("port", "jax"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nudge", type=int, default=0,
                   help="the start's parameters times 1 + nudge * 1e-7")
    p.add_argument("--threads", type=int, default=2,
                   help="torch's intra-op threads")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                   help="the port's device (JAX runs on the CPU)")
    p.add_argument("--repeat", type=int, default=1,
                   help="runs of the same start in this process")
    p.add_argument("--out", required=True)
    p.add_argument("--report", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.report:
        return report(args.out)
    if not args.pkg:
        p.error("--pkg NAME or --report")
    if args.pkg == "jax" and args.device != "cpu":
        p.error("the JAX package runs on the CPU here")
    import torch
    torch.set_num_threads(args.threads)
    records = []
    for i in range(args.repeat):
        name = f"{args.pkg}_{args.device}_seed{args.seed}_{args.nudge}"
        if args.repeat > 1:
            name += f"_r{i}"
        t0 = time.perf_counter()
        if args.pkg == "port":
            sep, moved = run_port(args.seed, args.nudge * UNIT,
                                  os.path.join(args.out, name), args.device)
        else:
            sep, moved = run_jax(args.seed, args.nudge * UNIT,
                                 os.path.join(args.out, name))
        record = dict(pkg=args.pkg, device=args.device, seed=args.seed,
                      nudge=args.nudge, separation=sep, unet_moved=moved,
                      seconds=time.perf_counter() - t0)
        print(json.dumps(record), flush=True)
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(record, f)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
