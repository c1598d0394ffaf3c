"""CLI entry point of the PyTorch/CUDA port.

``build_parser`` has the same flags, defaults and choices as
``paig_reproduction_tpu/cli.py``'s, plus ``--device``. Every flag is
ported. Dataset files come from ``TASK_TABLE`` under ``--data_dir``.

Several processes (one a card) join one run as the JAX CLI's do, through
``PAIG_COORDINATOR``/``PAIG_NUM_PROCESSES``/``PAIG_PROCESS_ID``
(``parallel/distributed.py``); ``--n_model_shards`` processes hold one copy
of the model with its TP kernels split (``parallel/mesh.py``).
``--native_loader`` feeds the train step from the C++ loader
(``data/native.py``) where the fused step is off, as in the JAX CLI.

A run trains (unless ``--test_mode``), saving ``model.ckpt`` in
``--save_dir``, with the single-command recipes as the JAX CLI wires them:
``--discovery_restarts`` arms first (counted against ``--epochs``; ignored
when resuming), then the epoch loop with the aux-loss staging, train-time
physics self-identification and the auto-rescue surgery. It then rebuilds
the model at the task's test sequence length
and evaluates the test split of the longer-sequence file from save_dir's
checkpoint, or from ``--ckpt_dir``'s under ``--test_mode``, as the JAX
package's CLI does.

The runtime flags: ``--watchdog_secs``/``--watchdog_floor_secs`` arm both
phases' trainers' watchdog (exit 75 on a hung device call);
``--resume_remaining_epochs`` with ``--use_ckpt`` trains only what the
checkpoint chain has not; ``--profile_dir`` writes a ``torch.profiler``
trace of the training phase there; ``--debug_nans`` raises
``FloatingPointError`` at the first NaN (``train/trainer.py``).
"""
from __future__ import annotations

import argparse
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA version of the PAIG training script.")
    parser.add_argument("--epochs", type=int, default=10,
                        help="Number of epochs to train")
    parser.add_argument("--batch_size", type=int, default=100,
                        help="Training batch size")
    parser.add_argument("--save_dir", type=str, default="",
                        help="Directory to save checkpoint and logs")
    parser.add_argument("--use_ckpt", action="store_true",
                        help="Whether to start from scratch or start from "
                             "checkpoint")
    parser.add_argument("--ckpt_dir", type=str, default="",
                        help="Checkpoint directory to use")
    parser.add_argument("--base_lr", type=float, default=1e-3,
                        help="Base learning rate")
    parser.add_argument("--anneal_lr", action="store_false",
                        help="Whether to anneal lr after 0.75 of total "
                             "epochs")
    parser.add_argument("--optimizer", type=str, default="rmsprop",
                        help="Optimizer to use")
    parser.add_argument("--save_every_n_epochs", type=int, default=5,
                        help="Epochs between checkpoint saves")
    parser.add_argument("--eval_every_n_epochs", type=int, default=1,
                        help="Epochs between validation run")
    parser.add_argument("--print_interval", type=int, default=10,
                        help="Print train metrics every n mini-batches")
    parser.add_argument("--debug", action="store_true",
                        help="If true, eval is not run before training")
    parser.add_argument("--test_mode", action="store_true",
                        help="If true, only run test set")
    parser.add_argument("--task", type=str, default="",
                        help="Type of task.")
    parser.add_argument("--model", type=str, default="PhysicsNet",
                        help="Model to use.")
    parser.add_argument("--recurrent_units", type=int, default=100,
                        help="Number of units for each lstm, if using "
                             "black-box dynamics.")
    parser.add_argument("--lstm_layers", type=int, default=1,
                        help="Number of lstm cells to use, if using "
                             "black-box dynamics")
    parser.add_argument("--cell_type", type=str, default="",
                        help="Type of pendulum to use.")
    parser.add_argument("--encoder_type", type=str, default="conv_encoder",
                        help="Type of encoder to use.")
    parser.add_argument("--decoder_type", type=str,
                        default="conv_st_decoder",
                        help="Type of decoder to use.")
    parser.add_argument("--autoencoder_loss", type=float, default=0.0,
                        help="Autoencoder loss weighing.")
    parser.add_argument("--alt_vel", action="store_true",
                        help="Whether to use linear velocity computation.")
    parser.add_argument("--color", action="store_true",
                        help="Whether images are RGB or grayscale.")
    parser.add_argument("--datapoints", type=int, default=0,
                        help="How many datapoints from the dataset to use. "
                             "Useful for measuring data efficiency. "
                             "Default=0 uses all data.")
    # --- extensions (not in the reference CLI) -----------------------------
    parser.add_argument("--data_dir", type=str, default="",
                        help="[extension] Root of the datasets tree "
                             "(default: <repo>/data/datasets)")
    parser.add_argument("--seed", type=int, default=0,
                        help="[extension] PRNG seed for params/init")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="[extension] Write a profiler trace here")
    parser.add_argument("--debug_nans", action="store_true",
                        help="[extension] Stop at the first NaN")
    parser.add_argument("--n_model_shards", type=int, default=1,
                        help="[extension] Size of the tensor-parallel mesh "
                             "axis (data axis gets the rest)")
    parser.add_argument("--physics_lr_mult", type=float, default=1.0,
                        help="[extension] LR multiplier for the learnable "
                             "physical parameters (the reference hints at "
                             "per-group LRs but never implements them)")
    parser.add_argument("--template_center_loss", type=float, default=0.0,
                        help="[extension] Weight of the template-centering "
                             "penalty; prevents off-center templates from "
                             "collapsing the learnable physics")
    parser.add_argument("--native_loader", action="store_true",
                        help="[extension] Use the C++ prefetching batch "
                             "loader for the host input path")
    parser.add_argument("--coarse_loss", type=float, default=0.0,
                        help="[extension] Weight of the blurred-image "
                             "auxiliary prediction loss (training only)")
    parser.add_argument("--vel_anchor", type=float, default=0.0,
                        help="[extension] Weight of the velocity-anchor "
                             "penalty (velocity head vs encoder finite "
                             "differences)")
    parser.add_argument("--pos_consistency", type=float, default=0.0,
                        help="[extension] Weight of the position-space "
                             "consistency loss (rollout positions vs the "
                             "encoder's positions for the same frames)")
    parser.add_argument("--grad_clip", type=float, default=0.0,
                        help="[extension] Global-norm gradient clipping "
                             "(0 = off)")
    parser.add_argument("--bg_lr_mult", type=float, default=1.0,
                        help="[extension] LR multiplier for the learned "
                             "background net. <1 slows background "
                             "absorption of not-yet-discovered objects "
                             "(the residual-gradient killer in hard "
                             "discovery)")
    parser.add_argument("--learn_frame_offset", action="store_true",
                        help="[extension] Learn per-object coordinate "
                             "offsets between encoder space and the "
                             "physical frame (absorbs off-center "
                             "templates)")
    parser.add_argument("--aux_warmup_epochs", type=int, default=0,
                        help="[extension] Epochs of pure reference loss "
                             "before the extension losses activate "
                             "(object discovery first, physics alignment "
                             "second)")
    parser.add_argument("--aux_on_recons", type=float, default=0.0,
                        help="[extension] Discovery-triggered staging: "
                             "hold the extension losses and train-time "
                             "physics fits off until the first valid "
                             "eval with recons below this value "
                             "(replaces the --aux_warmup_epochs guess "
                             "for single-command recipes)")
    parser.add_argument("--fit_physics_every", type=int, default=0,
                        help="[extension] Every N epochs, re-identify the "
                             "physical parameters (k/equil or g) by "
                             "trajectory least squares on the model's own "
                             "encoder positions and install them (the "
                             "train-time version of tools/fit_physics.py;"
                             " 0 = off)")
    parser.add_argument("--fit_physics_after", type=int, default=0,
                        help="[extension] First epoch --fit_physics_every "
                             "may fire (the fit needs a discovered "
                             "encoder)")
    parser.add_argument("--auto_rescue", type=int, default=0,
                        help="[extension] In-training slot-rescue surgery:"
                             " if a valid eval at epoch >= N still has "
                             "recons above --rescue_recons, reset dead "
                             "(or all-ballooned) slots to disk priors, "
                             "pin the background to the train-split "
                             "median and freeze it, and continue (the "
                             "in-place tools/slot_rescue.py pipeline; "
                             "0 = off)")
    parser.add_argument("--rescue_recons", type=float, default=3.0,
                        help="[extension] Valid recons above which "
                             "--auto_rescue considers discovery stalled")
    parser.add_argument("--max_rescues", type=int, default=1,
                        help="[extension] --auto_rescue may fire up to N "
                             "times (N epochs of cooldown between "
                             "firings); default 1 = one-shot")
    parser.add_argument("--rescue_disk_radius", type=float, default=0.0,
                        help="[extension] Template-disk radius installed "
                             "by --auto_rescue (template px; 0 = auto: "
                             "9 for >=64px tasks, else 3)")
    parser.add_argument("--rescue_seed_color", action="store_true",
                        help="[extension] --auto_rescue seeds each reset "
                             "slot's contents with the residual color "
                             "cluster no healthy slot explains (instead "
                             "of mid-gray) — gives the fresh slot an "
                             "immediate recons gradient toward the "
                             "unexplained object (bouncing_balls)")
    parser.add_argument("--watchdog_secs", type=float, default=0.0,
                        help="[extension] Exit with code 75 if no "
                             "train/eval batch completes for this many "
                             "seconds (hung device call); a "
                             "supervisor can then resume the run with "
                             "--use_ckpt. Must exceed the slowest single "
                             "compile on the target (900 is safe "
                             "for a remote accelerator). 0 = off")
    parser.add_argument("--watchdog_floor_secs", type=float, default=0.0,
                        help="[extension] Adaptive watchdog: once the "
                             "loop is in steady state, tighten the "
                             "effective timeout to ~100x the observed "
                             "batch interval, never below this floor "
                             "(covers mid-run graph recompiles; >=300 "
                             "recommended cold, less with a warm compile "
                             "cache) and never above --watchdog_secs. "
                             "Cuts wedge detection from the compile-"
                             "sized ceiling to minutes. 0 = fixed "
                             "timeout only")
    parser.add_argument("--resume_remaining_epochs", action="store_true",
                        help="[extension] With --use_ckpt: subtract the "
                             "checkpoint's saved epoch from --epochs so "
                             "a crash-resumed run finishes the original "
                             "schedule instead of training --epochs more")
    parser.add_argument("--discovery_restarts", type=int, default=0,
                        help="[extension] Random-restart discovery: train "
                             "N independent arms (fresh params/optimizer "
                             "per arm) for --discovery_epochs each, keep "
                             "the best-valid-recons arm and continue the "
                             "run from it. Counters the seed-sensitive "
                             "discovery the reference README warns about "
                             "(README.md:79-81). 0 = off; ignored with "
                             "--use_ckpt/--test_mode")
    parser.add_argument("--discovery_epochs", type=int, default=100,
                        help="[extension] Epochs each --discovery_restarts"
                             " arm trains before scoring; counted against "
                             "--epochs (the winner trains the remainder)")
    parser.add_argument("--discovery_recons_ok", type=float, default=0.0,
                        help="[extension] Stop launching further restart "
                             "arms once one scores a valid recons below "
                             "this (discovery clearly succeeded); 0 = "
                             "always run all arms")
    def _positive_int(v):
        iv = int(v)
        if iv < 1:
            raise argparse.ArgumentTypeError(
                f"must be a positive integer, got {v}")
        return iv

    parser.add_argument("--cell_substeps", type=_positive_int, default=5,
                        help="[extension] Euler substeps per rollout frame "
                             "(reference: 5; the data generators use 10)")
    parser.add_argument("--recons_warmup", action="store_true",
                        help="[extension] Also gate the prediction term "
                             "during --aux_warmup_epochs (pure "
                             "autoencoder discovery phase)")
    parser.add_argument("--enhancers_eval_only", action="store_true",
                        help="[extension] Apply the parameter-free "
                             "inference enhancers (--init_state_fit, "
                             "--refine_enc_pos, --refine_recons_pos) only "
                             "in eval/test graphs: the train step drops "
                             "them (their GN iterations multiply "
                             "train-step cost for no training benefit), "
                             "while the SAME command's evals and test "
                             "phase still score with them — the key to "
                             "fast single-command recipes")
    parser.add_argument("--init_state_fit", type=int, default=0,
                        help="[extension] Gauss-Newton iterations for the "
                             "dynamics-consistent initial-state fit over "
                             "the input window (0 = reference initializer: "
                             "last encoded position + MLP velocity)")
    parser.add_argument("--refine_enc_pos", type=int, default=0,
                        help="[extension] Gauss-Newton iterations of "
                             "render-based subpixel refinement of the "
                             "input-window positions before the rollout "
                             "(the model's own decoder as the position "
                             "sensor; 0 = off)")
    parser.add_argument("--refine_recons_pos", type=int, default=0,
                        help="[extension] GN iterations of the same "
                             "render-based refinement applied to EVERY "
                             "encoded frame before the autoencoder "
                             "decode (cuts sub-pixel edge error in "
                             "eval_recons_loss; intended for eval/test; "
                             "0 = off)")
    parser.add_argument("--attn_overlap_loss", type=float, default=0.0,
                        help="[extension] Weight of the slot-overlap "
                             "penalty (pixelwise products of object "
                             "attention masks). Breaks the both-slots-"
                             "on-one-object discovery collapse; active "
                             "from step 0 (not gated by aux warmup)")
    parser.add_argument("--template_init", type=float, default=0.0,
                        help="[extension] Object-prior template init: "
                             "templates start as a centered disk of this "
                             "radius in template px (0 = reference "
                             "random init)")
    parser.add_argument("--active_slots", type=int, default=0,
                        help="[extension] Slot curriculum: only the "
                             "first N object slots are live (0 = all). "
                             "Stage discovery runs with increasing N, "
                             "resuming via --use_ckpt")
    parser.add_argument("--slot_gate_soft", type=float, default=0.0,
                        help="[extension] Soft encoder gate for the slot "
                             "curriculum: inactive slots get this logit "
                             "handicap instead of -inf, so their "
                             "attention channels keep learning before "
                             "activation (0 = hard gate)")
    parser.add_argument("--reference_quirks", action="store_true",
                        help="[extension] bug-compatible training "
                             "gradient path: pred/extrap terms enter the "
                             "train loss detached, so only the "
                             "autoencoder term trains (the reference's "
                             "effective behavior — its pred term is a "
                             "stale no_grad eval output, base.py:142,"
                             "195). For curve-level A/B comparisons only")
    parser.add_argument("--decoder_backend", type=str, default="auto",
                        choices=("auto", "xla", "pallas"),
                        help="[extension] ST-decoder compute backend "
                             "(auto and pallas = the fused CUDA kernel on "
                             "a CUDA device; xla = the plain PyTorch "
                             "decode)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="[extension] encoder conv-stack computation "
                             "dtype")
    parser.add_argument("--device", type=str, default="cuda",
                        help="[extension] torch device to train on "
                             "(cuda, or cpu for small runs)")
    return parser


# Task table (reference torch_run_physics.py:49-75):
# task -> (data_file, test_data_file, cell_type, seq_len, test_seq_len,
#          input_steps, pred_steps, input_size)
TASK_TABLE = {
    "bouncing_balls": (
        "bouncing/color_bounce_vx8_vy8_sl12_r2.npz",
        "bouncing/color_bounce_vx8_vy8_sl30_r2.npz",
        "bouncing_ode_cell", 12, 30, 4, 6, 32 * 32),
    "spring_color": (
        "spring_color/color_spring_vx8_vy8_sl12_r2_k4_e6.npz",
        "spring_color/color_spring_vx8_vy8_sl30_r2_k4_e6.npz",
        "spring_ode_cell", 12, 30, 4, 6, 32 * 32),
    "spring_color_half": (
        "spring_color_half/color_spring_vx4_vy4_sl12_r2_k4_e6_halfpane.npz",
        "spring_color_half/color_spring_vx4_vy4_sl30_r2_k4_e6_halfpane.npz",
        "spring_ode_cell", 12, 30, 4, 6, 32 * 32),
    "3bp_color": (
        "3bp_color/color_3bp_vx2_vy2_sl20_r2_g60_m1_dt05.npz",
        "3bp_color/color_3bp_vx2_vy2_sl40_r2_g60_m1_dt05.npz",
        "gravity_ode_cell", 20, 40, 4, 12, 36 * 36),
    "mnist_spring_color": (
        "mnist_spring_color/color_mnist_spring_vx8_vy8_sl12_r2_k2_e12.npz",
        "mnist_spring_color/color_mnist_spring_vx8_vy8_sl30_r2_k2_e12.npz",
        "spring_ode_cell", 12, 30, 3, 7, 64 * 64),
}


def epochs_to_train(epochs, epochs_done, resume_remaining):
    """The epochs a run trains: ``--epochs``, or with
    ``--resume_remaining_epochs`` what the checkpoint chain's
    ``epochs_done`` leaves of them, at least one (as the JAX CLI counts).
    The chain's epochs include its discovery arms', which count against
    ``--epochs``: a deliberate departure from the JAX CLI, which leaves
    them out, so that a resumed recipe run trains the arms' epochs once
    more. Nothing else of a resume departs: a rescue after it sizes its
    schedule as the JAX trainer's does."""
    return max(1, epochs - epochs_done) if resume_remaining else epochs


def build_model(args, seq_len):
    """The model of the parsed flags ``args`` for ``args.task`` at sequence
    length ``seq_len``, with the JAX package's initial weights at ``--seed``
    (``models/jax_init.py``)."""
    from paig_reproduction_tpu_torch.models import jax_init
    from paig_reproduction_tpu_torch.models.registry import get_model
    (_, _, cell_type, _, _, input_steps, pred_steps,
     input_size) = TASK_TABLE[args.task]
    model = get_model(args.model)(
        task=args.task, recurrent_units=args.recurrent_units,
        lstm_layers=args.lstm_layers,
        cell_type=args.cell_type if args.cell_type else cell_type,
        seq_len=seq_len, input_steps=input_steps, pred_steps=pred_steps,
        autoencoder_loss=args.autoencoder_loss, alt_vel=args.alt_vel,
        color=args.color, input_size=input_size,
        encoder_type=args.encoder_type, decoder_type=args.decoder_type,
        decoder_backend=args.decoder_backend,
        cell_substeps=args.cell_substeps,
        template_center_loss=args.template_center_loss,
        coarse_loss=args.coarse_loss, vel_anchor=args.vel_anchor,
        pos_consistency=args.pos_consistency,
        learn_frame_offset=args.learn_frame_offset,
        recons_warmup=args.recons_warmup,
        init_state_fit=args.init_state_fit,
        refine_enc_pos=args.refine_enc_pos,
        refine_recons_pos=args.refine_recons_pos,
        attn_overlap_loss=args.attn_overlap_loss,
        active_slots=args.active_slots,
        slot_gate_soft=args.slot_gate_soft,
        template_init=args.template_init,
        reference_quirks=args.reference_quirks,
        compute_dtype=args.compute_dtype)
    return jax_init.load_initial_state(model, jax_init.prng_key(args.seed))


def main(argv=None):
    """Train and test a model as the JAX package's CLI does. Returns
    ``(trainer, test_trainer)``: the training phase's Trainer (None under
    ``--test_mode``) and the seq-``test_seq_len`` test phase's."""
    parser = build_parser()
    args = parser.parse_args(argv)

    logger = logging.getLogger("paig")
    logger.setLevel(logging.DEBUG)
    ch = logging.StreamHandler()
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(
        logging.Formatter("%(asctime)s - %(name)s - %(message)s"))
    logger.addHandler(ch)

    import numpy as np

    # --seed seeds the weights and the global numpy RNG that drives
    # dataset shuffling.
    np.random.seed(args.seed)

    from paig_reproduction_tpu_torch.data.iterators import get_iterators
    from paig_reproduction_tpu_torch.parallel.distributed import (
        init_distributed,
    )
    from paig_reproduction_tpu_torch.parallel.mesh import make_mesh
    from paig_reproduction_tpu_torch.train.trainer import Trainer

    # Several processes: joins their group when PAIG_COORDINATOR /
    # PAIG_NUM_PROCESSES / PAIG_PROCESS_ID are set (no-op otherwise).
    init_distributed(device=args.device)
    mesh = make_mesh(n_model=args.n_model_shards)

    data_file, test_data_file, _, seq_len, test_seq_len = \
        TASK_TABLE[args.task][:5]
    data_root = args.data_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.realpath(__file__))),
        "data", "datasets")

    def runtime_flags(t):
        t.watchdog_secs = args.watchdog_secs
        t.watchdog_floor_secs = args.watchdog_floor_secs
        t.debug_nans = args.debug_nans

    trainer = None
    if not args.test_mode:
        data_iterators = get_iterators(os.path.join(data_root, data_file),
                                       conv=True,
                                       datapoints=args.datapoints)
        trainer = Trainer(build_model(args, seq_len), device=args.device,
                          seed=args.seed,
                          enhancers_eval_only=args.enhancers_eval_only,
                          profile_dir=args.profile_dir,
                          native_loader=args.native_loader, mesh=mesh)
        runtime_flags(trainer)
        trainer.get_data(data_iterators)
        steps_per_epoch = max(
            1, data_iterators[0].num_examples // args.batch_size)
        trainer.build_optimizer(args.base_lr, args.optimizer,
                                args.anneal_lr, epochs=args.epochs,
                                steps_per_epoch=steps_per_epoch,
                                physics_lr_mult=args.physics_lr_mult,
                                grad_clip=args.grad_clip,
                                aux_warmup_epochs=args.aux_warmup_epochs,
                                bg_lr_mult=args.bg_lr_mult)
        trainer.fit_physics_every = args.fit_physics_every
        trainer.fit_physics_after = args.fit_physics_after
        trainer.auto_rescue = args.auto_rescue
        trainer.rescue_recons = args.rescue_recons
        trainer.rescue_disk_radius = args.rescue_disk_radius
        trainer.rescue_seed_color = args.rescue_seed_color
        trainer.max_rescues = args.max_rescues
        if args.aux_on_recons > 0:
            trainer.set_aux_trigger(args.aux_on_recons)
        trainer.initialize_graph(args.save_dir, args.use_ckpt,
                                 args.ckpt_dir)
        resume = args.use_ckpt and args.resume_remaining_epochs
        done = trainer._chain_epochs
        remaining = epochs_to_train(args.epochs, done, resume)
        if resume and done:
            logger.info("resume_remaining_epochs: checkpoint chain has %d "
                        "epochs done, training %d more", done, remaining)
        if args.discovery_restarts > 0 and not args.use_ckpt:
            # Counted against --epochs, leaving at least one normal epoch
            # (and its final save).
            arm_epochs = min(args.discovery_epochs, max(1, args.epochs - 1))
            trainer.run_discovery_restarts(
                args.batch_size, args.discovery_restarts, arm_epochs,
                keep_going_below=args.discovery_recons_ok)
            remaining = max(1, args.epochs - arm_epochs)
        elif args.discovery_restarts > 0:
            logger.info("discovery_restarts ignored: resuming from a "
                        "checkpoint")
        trainer.train_model(remaining, args.batch_size,
                            args.save_every_n_epochs,
                            args.eval_every_n_epochs, args.print_interval,
                            args.debug)

    # The test phase: the same weights at the longer test sequence length.
    # After training it scores save_dir's final checkpoint; --ckpt_dir
    # routes the restore only under --test_mode.
    data_iterators = get_iterators(os.path.join(data_root, test_data_file),
                                   conv=True, datapoints=args.datapoints)
    test_trainer = Trainer(build_model(args, test_seq_len), device=args.device,
                           mesh=mesh)
    runtime_flags(test_trainer)
    test_trainer.get_data(data_iterators)
    test_trainer.build_optimizer(args.base_lr, args.optimizer,
                                 args.anneal_lr)
    test_trainer.initialize_graph(args.save_dir, True,
                                  args.ckpt_dir if args.test_mode else "")
    test_trainer.train_model(0, args.batch_size, args.save_every_n_epochs,
                             args.eval_every_n_epochs, args.print_interval,
                             args.debug)
    return trainer, test_trainer


if __name__ == "__main__":
    main()
