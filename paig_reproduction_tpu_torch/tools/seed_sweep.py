"""Seed-sweep harness for seed-sensitive object discovery.

Counterpart of the JAX package's ``tools/seed_sweep.py``: trains the same
configuration across N parameter seeds (short runs) and reports per-seed
eval losses, so that a good seed can be picked before a long run:

    python -m paig_reproduction_tpu_torch.tools.seed_sweep \\
        --task spring_color --epochs 50 --seeds 0 1 2 3 \\
        --data_dir data/datasets --batch_size 100 --base_lr 6e-4 \\
        --autoencoder_loss 3.0

Each seed seeds the data shuffle (numpy's global generator, as the CLI
does) and the weights (the JAX package's initial weights at that seed,
``models/jax_init.py``, as the CLI's ``--seed`` does). On the card the trainer takes its graphed step, as the CLI
does. Each seed's run writes its log.txt and model.ckpt under
``--save_root``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile


def main(argv=None):
    """The tool's command line. Returns {seed: {metric: value}}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--base_lr", type=float, default=6e-4)
    p.add_argument("--autoencoder_loss", type=float, default=3.0)
    p.add_argument("--optimizer", default="rmsprop")
    p.add_argument("--attn_overlap_loss", type=float, default=0.0)
    p.add_argument("--recons_warmup", action="store_true")
    p.add_argument("--aux_warmup_epochs", type=int, default=0)
    p.add_argument("--data_dir", default="data/datasets")
    p.add_argument("--out", default="seed_sweep.json")
    p.add_argument("--save_root", default=os.path.join(
        tempfile.gettempdir(), "paig_seed_sweep"))
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    args = p.parse_args(argv)

    import numpy as np

    from paig_reproduction_tpu_torch.cli import TASK_TABLE
    from paig_reproduction_tpu_torch.data.iterators import get_iterators
    from paig_reproduction_tpu_torch.models import jax_init
    from paig_reproduction_tpu_torch.models.registry import get_model
    from paig_reproduction_tpu_torch.train.trainer import Trainer

    (data_file, _, cell_type, seq_len, _, input_steps, pred_steps,
     input_size) = TASK_TABLE[args.task]
    logger = logging.getLogger("paig")

    results = {}
    for seed in args.seeds:
        np.random.seed(seed)   # data-shuffle determinism (matches cli.py)
        model = get_model("PhysicsNet")(
            task=args.task, cell_type=cell_type, seq_len=seq_len,
            input_steps=input_steps, pred_steps=pred_steps,
            autoencoder_loss=args.autoencoder_loss, color=True,
            input_size=input_size,
            attn_overlap_loss=args.attn_overlap_loss,
            recons_warmup=args.recons_warmup)
        jax_init.load_initial_state(model, jax_init.prng_key(seed))
        its = get_iterators(os.path.join(args.data_dir, data_file),
                            conv=True)
        trainer = Trainer(model, device=args.device, seed=seed)
        trainer.get_data(its)
        spe = max(1, its[0].num_examples // args.batch_size)
        trainer.build_optimizer(args.base_lr, args.optimizer, True,
                                epochs=args.epochs, steps_per_epoch=spe,
                                aux_warmup_epochs=args.aux_warmup_epochs)
        save_dir = os.path.join(args.save_root,
                                f"{args.task}_seed{seed}")
        trainer.initialize_graph(save_dir, False)
        handlers = list(logger.handlers)
        try:
            metrics = trainer.train_model(
                args.epochs, args.batch_size,
                save_every_n_epochs=args.epochs,
                eval_every_n_epochs=max(1, args.epochs // 2),
                print_interval=100, debug=True)
        finally:
            # This seed's log.txt handler: the next seed logs to its own.
            for h in set(logger.handlers) - set(handlers):
                logger.removeHandler(h)
                h.close()
        results[seed] = {k: float(v) for k, v in metrics.items()}
        print(f"seed {seed}: {results[seed]}")

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    best = min(results, key=lambda s: results[s]["eval_pred_loss"])
    print(f"best seed: {best} -> {results[best]}")
    return results


if __name__ == "__main__":
    main()
