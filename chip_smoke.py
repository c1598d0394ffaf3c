"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:

1. device     - the card's name and power limit (nvidia-smi), and whether
                PIL and matplotlib import here (a record: the port uses
                neither);
2. build      - nvcc builds every CUDA source of the port (ptxas registers
                and shared memory are printed);
3. kernel     - each kernel against its plain PyTorch version on the card,
                at the main path's shapes, the other tasks' shapes and the
                edges of its grid, with its device time (CUDA graph replays
                between CUDA events) at each task's train shape and at the
                seq-30 test phase's N=2600 beside the plain version's, its
                bound and its share of the bound, and at the main path's
                shapes the store-only floor (csrc/store_floor.cu: the
                decoder's grid writing a constant in full-line stores);
   kernel st_decode jvp - torch.func.jvp through the kernel's wrapper at
                the main path's N=1000, with a tangent on the positions and
                one on all four inputs, against the plain decode's
                torch.func.jvp: the primal within 2e-5, the tangent within
                1e-4 of its largest value; the kernel's count must rise;
4. train      - the port's CLI entry trains spring_color for 2 epochs at
                B=100 on the tracked dataset, saves model.ckpt and runs the
                seq-30 test phase, with every kernel's launch count set to
                0 just before and read just after; losses must be finite
                and fall, every decode of both phases must have gone
                through the kernel, and every artifact must be there;
5. test_mode  - ``--test_mode --ckpt_dir=<the run>`` alone, timed: the
                seq-30 phase's wall time and its own launch count;
6. checkpoint - the run's model.ckpt restored into a fresh trainer at
                seq 12: its valid eval and its next train step must equal
                the finished trainer's within 1e-6 relative;
7. step       - the median host time of a synchronized eager train step;
8. recipe     - the single-command spring recipe
                (benchmarks/spring_one5_test_log.txt's flags) through the
                CLI entry at full width (B=100, the tracked files), its
                depth cut so that every hook fires: two discovery arms of
                one epoch, the aux trigger, physics self-identification, one
                auto-rescue, evals and the seq-30 phase with the Gauss-Newton
                state fit and position refinement. Every decode must go
                through the kernel, the refinement's renders included
                (counted apart); then a resume with --use_ckpt must bring
                the rescue and trigger state back. It prints the recipe's
                train step and an eval batch's time with and without the
                enhancers. Then the recipe's state changes, graphed against
                eager (``recipe_swaps_vs_eager``): a graphed trainer, an
                eager one and a second eager one as the noise floor, cuDNN
                deterministic, each through two discovery arms of one epoch
                (the first kept, so the optimizer restored is not the last
                one made), 5 steps, a forced rescue, 5 steps, the aux
                trigger, 5 steps; after each block the parameters' largest
                relative difference graphed against eager beside eager
                against eager (1e-5), and every decode counted;
9. tasks      - the other four tasks of the task table (bouncing_balls,
                3bp_color, spring_color_half, mnist_spring_color), each
                through the CLI entry at B=100 and full width, its depth
                cut (``TASK_RUNS``: the epochs, and for the two tasks
                whose files are not tracked the sequence counts that
                data/generate.py writes under data/generated/ at first
                use, started in the background when the script starts),
                with the model flags of its logged recipe: train, evals,
                checkpoint, the seq-30 or seq-40 test phase and the
                artifacts. Losses must be finite and fall, the test phase
                must restore the run's checkpoint, every artifact must be
                there, and the kernel's launch count must equal the count
                of every decode (the refinement's included). It prints
                each task's median train step;
10. graph     - the fused step, captured as a CUDA graph, on every
                configuration a run takes it on (GRAPH_CONFIGS: spring_color,
                3bp_color, the LSTM, mnist_spring_color, bf16,
                bouncing_balls, spring_color_half and the spring recipe's
                model flags) at B=100: 10 graphed steps against 10 eager
                ones from the same weights, cuDNN deterministic (parameters
                within 1e-5 relative; bitwise equality said where it
                holds), beside a second eager run's difference from the
                first, also after 10 more steps with cuDNN not
                deterministic; a replayed valid eval epoch against the
                eager one;
                the median graphed and eager step, one replay and two
                decoder launches a step; and the main path's matrix
                FLOPs a step (utils/flops.py) with their rate in the graphed
                step. Every CLI run of the other phases must log
                ``fused step: on (captured CUDA graph)`` (the runtime
                phase's --debug_nans run: off, by name);
11. native_loader - the main path's command with --native_loader for 2
                epochs under PAIG_FUSED=0 (the fused path off, so that the
                loader feeds the step): finite, falling losses, the steps'
                batches equal to the port's NativeBatcher at the run's seed,
                every decode counted (the captured step fed through its
                static batch buffer); then the same command with the fused
                path on, where the flag changes nothing, as in the JAX
                trainer: the log says ``fused step: on (captured CUDA
                graph)`` and no loader is built;
12. parallel  - DP and TP (--n_model_shards=2) in 2 processes against 1
                process on the same global batch of spring_color B=100,
                which computes the ranks' work and adds it in the same
                order (PARALLEL_ARGS): the losses within 1e-5 relative, the
                gradients within 1e-4 of the largest (of the split kernels'
                largest for them). NCCL with
                2 or more cards; on one card gloo on CUDA tensors (eager)
                and a 1-process NCCL group through the graphed step, its
                parameters after 10 steps against eager ones. It prints
                which ran;
13. lstm      - the LSTM baseline's logged run at full length
                (benchmarks/lstm_proof_log.txt: 150 epochs at
                tools/tpu_queue_r4.sh:59-62's flags, the reference runner's
                ``lstm_proof``) through the CLI entry, with the checkpoint,
                the seq-30 phase and the artifacts: losses finite and
                falling, the launch count exact (every rollout decoded in
                one call); its final test pred and recons at most
                LSTM_QUALITY = 1.10 times the log's and its valid pred
                falling from epoch 10 to the last eval (``lstm_quality``);
                then ``--test_mode`` alone; it prints its test line beside
                the log's, its wall time and the host time of its evals,
                the median train step and the seq-30 phase's wall time;
14. bf16      - the main path's command with ``--compute_dtype=bfloat16``
                for 2 epochs through the CLI entry (every decode counted,
                the checkpoint, the seq-30 phase, the artifacts, then
                ``--test_mode`` alone): the median step
                beside the float32 one of the ``step`` phase, the UNet's
                output dtype (a forward hook) and float32 weights and
                optimizer state, and the card's bf16 positions held to the
                same model's on the CPU on one batch (BF16_POS_ATOL);
15. runtime   - ``--watchdog_secs --watchdog_floor_secs --profile_dir
                --debug_nans`` on a 1-epoch run (a trace file and a stopped
                watchdog after it); a subprocess whose train step sleeps
                past a 3 s watchdog must exit with 75; ``--use_ckpt
                --resume_remaining_epochs --epochs=3`` from the ``train``
                phase's 2-epoch checkpoint must train exactly 1 epoch
                (counted in its log.txt);
16. pipeline  - docs/TRAINING.md's training pipeline through the port's
                offline tools (paig_reproduction_tpu_torch/tools/) at the
                main path's width, its depth cut: discovery (the main
                path's command for PIPELINE_EPOCHS epochs from
                DISCOVERY_SEED; the valid recons must fall), ``fit_physics
                --write`` on its checkpoint (the fits finite, the
                checkpoint holding the printed values, the card's encoder
                positions within PIPELINE_POS_ATOL of the CPU's), the
                aligned resume (ALIGN_ARGS, 2 epochs: the
                restored log_k, log_equil and frame_offset are the written
                ones), ``analyze_tail`` on the sl30 file's 200 test
                sequences, ``slot_rescue --rescue_slot=auto
                --set_background=median`` on the tasks phase's 3bp_color
                checkpoint and a 1-epoch resume with --bg_lr_mult=0 (the
                background stays the installed median), and ``seed_sweep``
                over DEAD_SEED and DISCOVERY_SEED for 1 epoch (the
                first's UNet at its initial values and its slots at one
                position, the second's UNet moved). Each
                stage prints its wall
                seconds and its decoder launches, which must equal the
                decodes it made;
17. chain     - 3bp_color's multi-stage chain through the reference
                runner (tools/reference_runs.py's CHAIN, 3bp_chain with
                the prediction off through the curriculum and gated in
                the pinned stage) at cut depth on the tracked files,
                B=100: the slot curriculum's three stages
                (CHAIN_CURRICULUM epochs, the first warm-started from the
                converted spring trunk), the all-slot surgery, the pinned
                resume (CHAIN_PINNED epochs), ``fit_physics --write`` and
                both test phases with their logs' flags. Each stage prints
                its wall seconds and its decoder launches, replays and the
                runner's readings of the velocity head included, which
                must equal the decodes it made (``chain_launches``), and
                each training stage the velocity head's state at its end
                (``reference_runs.velocity_state``) and the learning rate
                of its first step, with the optimizer count it was read
                at: ``curriculum_1`` (from the trunk, whose step is past
                its schedule's anneal and which brings no optimizer state)
                and ``pinned`` (from the surgery) must start at
                ``--base_lr``; its numbers must be finite and each
                training stage must take its steps on the graphed step;
                each test stage prints the state fit's reading of its
                start (``reference_runs.test_state``: the accepted
                share, the head's and the fitted speeds, A), which must
                be finite with its share in [0, 1]. Then the pinned
                stage's step from the tracked ``curriculum_3``
                (``pinned_card_vs_cpu``): the chain's surgery on it, two
                pinned-flag steps on the card (the capture's warm-up,
                then one graphed step) and the same two eager steps on
                the CPU, on the same batches; the two updates'
                difference, relative to the CPU's update (L2 over all
                parameters), must be within PINNED_UPDATE_RTOL, each
                step's losses within PINNED_LOSS_RTOL, and the card's
                decoder launches two a step;
    Before the kernels line, one line with every phase's wall seconds.
18. kernels   - one JSON line with every kernel's launches, error, times,
                share of its bound and store-only floor, at the main
                path's N=1000 and at N=2600, the recipe's launches (and
                its state changes' launches and differences), each
                task's launches, the LSTM, bf16, runtime, native-loader,
                pipeline and chain runs' launches (graph replays
                included), the kernel at the tasks' shapes and the graph
                phase's numbers.

With ``--parent OLD/csrc/st_decoder.cu`` (an earlier source of the kernel
whose C entry, ``st_decode_forward``, takes no ``slots`` argument) the
kernel phase also builds that source and times it beside the kernel at
every timed shape, in the order earlier, kernel, kernel, earlier, each held
to the plain version first.

The last line is {"ok": true, "device": {...}}. Any failure raises, and the
script exits non-zero without that line; without a CUDA device it fails at
once. It writes under a temporary directory, and the generated datasets
under data/generated/ (gitignored).
"""
from __future__ import annotations

import argparse
import atexit
import copy
import ctypes
import glob
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, redirect_stdout

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(REPO, "data", "datasets")
# Where the tasks without tracked files get theirs (gitignored).
GENERATED_DIR = os.path.join(REPO, "data", "generated")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Forward tolerance of a kernel against its plain version: both compute in
# f32 (TF32 off) and differ only in the order of their sums.
FWD_ATOL = 2e-5
# Gradient tolerance: the backward is the plain version's autograd in both.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# A restored trainer against the one that saved: the same float32
# operations on the same values, with deterministic cuDNN algorithms.
RESTORE_RTOL = 1e-6
# The run's artifacts (the JAX package's set).
ARTIFACTS = ("log.txt", "code.zip", "model.ckpt", "outputs.npz",
             "extra_outputs.npz", "example0.jpg", "templates.jpg")
TRAIN_ARGS = ["--task=spring_color", "--base_lr=6e-4",
              "--autoencoder_loss=3.0", "--color", "--print_interval=1",
              "--device=cuda"]
# The single-command spring recipe (benchmarks/spring_one5_test_log.txt)
# with its depth cut so that every hook fires once in a short run: two
# discovery arms of one epoch, the aux trigger on the first eval, a physics
# fit every epoch, a rescue from epoch 2 whatever the recons.
REFINE_ITERS = 4
# The recipe's model flags: the extension losses and the enhancers.
RECIPE_MODEL_FLAGS = [
    "--pos_consistency=1.0", "--vel_anchor=1.0", "--learn_frame_offset",
    "--init_state_fit=3", f"--refine_recons_pos={REFINE_ITERS}",
    "--enhancers_eval_only"]
RECIPE_ARGS = TRAIN_ARGS + [
    "--epochs=4", "--discovery_restarts=2", "--discovery_epochs=1",
    "--discovery_recons_ok=4.0", "--aux_on_recons=1e9", "--fit_physics_every=1", "--auto_rescue=2",
    "--rescue_recons=0", "--max_rescues=1", "--eval_every_n_epochs=1",
    *RECIPE_MODEL_FLAGS, "--save_every_n_epochs=1"]
# bf16 with the recipe's enhancers (benchmarks/spring_bf16_test_log.txt's
# model flags), cut to one discovery arm of one epoch and one loop epoch,
# each eval with the enhancers.
BF16_RECIPE_ARGS = TRAIN_ARGS + [
    "--compute_dtype=bfloat16", "--epochs=2", "--discovery_restarts=1",
    "--discovery_epochs=1", "--eval_every_n_epochs=1", *RECIPE_MODEL_FLAGS]
# The other four tasks, each at B=100 and full width with the model flags
# of the logged recipe `log` (its epoch count and its discovery, trigger and
# rescue flags cut), `extra` flags that cut its depth, `epochs`, and for a
# task whose files are not tracked the sizes data/generate.py writes:
# (train, valid, test) of the train-length file and the test sequences of
# the longer one.
TASK_RUNS = {
    "bouncing_balls": dict(
        log="benchmarks/bounce_one1_test_log.txt",
        flags=["--base_lr=3e-4", "--autoencoder_loss=2.0", "--color",
               "--pos_consistency=1.0", "--vel_anchor=1.0",
               "--learn_frame_offset", "--init_state_fit=1",
               "--refine_enc_pos=4", "--refine_recons_pos=4",
               "--enhancers_eval_only"],
        extra=[], epochs=1, generate=None),
    "3bp_color": dict(
        log="benchmarks/3bp_test_log.txt",
        flags=["--color", "--autoencoder_loss=5.0", "--learn_frame_offset",
               "--init_state_fit=3"],
        extra=["--fit_physics_every=1"], epochs=1, generate=None),
    "spring_color_half": dict(
        log="benchmarks/half_one1_test_log.txt",
        flags=["--base_lr=6e-4", "--autoencoder_loss=3.0", "--color",
               "--pos_consistency=1.0", "--vel_anchor=1.0",
               "--learn_frame_offset", "--init_state_fit=3",
               "--refine_recons_pos=4", "--enhancers_eval_only"],
        extra=[], epochs=4, generate=((200, 100, 100), 20)),
    "mnist_spring_color": dict(
        log="benchmarks/mnist_one2_test_log.txt",
        flags=["--base_lr=6e-4", "--autoencoder_loss=3.0", "--color",
               "--pos_consistency=1.0", "--vel_anchor=1.0",
               "--learn_frame_offset", "--init_state_fit=3",
               "--refine_recons_pos=4", "--enhancers_eval_only"],
        extra=[], epochs=4, generate=((200, 100, 100), 20)),
}
# The LSTM baseline of benchmarks/lstm_proof_log.txt (its recurrent flags
# are the CLI defaults, written out) and the bf16 encoder, each added to the
# main path's flags.
LSTM_ARGS = ["--cell_type=lstm", "--recurrent_units=100", "--lstm_layers=1"]
BF16_ARGS = ["--compute_dtype=bfloat16"]
# The lstm phase runs the LSTM baseline's logged run at full length: the
# reference runner's lstm_proof (tools/tpu_queue_r4.sh:59-62's flags, 150
# epochs), its final test pred and recons held to at most LSTM_QUALITY times
# the JAX package's (benchmarks/lstm_proof_log.txt, parsed), and its valid
# pred at the last eval below the one at epoch 10. One-sided: the port must
# train at least as well. The JAX curve is flat from epoch 30 (pred 20.28
# to 19.27, recons 10.4 to 10.1) and the port starts from the same weights
# (the CLI's --seed: models/jax_init.py), so it lands within 10%.
LSTM_PROOF = "lstm_proof"
LSTM_QUALITY = 1.10
# Every configuration that a run of the port takes the graphed step on:
# the main path, the tasks' logged model flags, the LSTM, bf16 and the
# spring recipe's model flags (its extension losses in the step, its
# enhancers in the eval).
GRAPH_CONFIGS = {
    "spring_color": TRAIN_ARGS,
    "3bp_color": ["--task=3bp_color", "--device=cuda"]
    + TASK_RUNS["3bp_color"]["flags"],
    "lstm": TRAIN_ARGS + LSTM_ARGS,
    "mnist_spring_color": ["--task=mnist_spring_color", "--device=cuda"]
    + TASK_RUNS["mnist_spring_color"]["flags"],
    "bf16": TRAIN_ARGS + BF16_ARGS,
    "bouncing_balls": ["--task=bouncing_balls", "--device=cuda"]
    + TASK_RUNS["bouncing_balls"]["flags"],
    "spring_color_half": ["--task=spring_color_half", "--device=cuda"]
    + TASK_RUNS["spring_color_half"]["flags"],
    "spring_recipe": TRAIN_ARGS + RECIPE_MODEL_FLAGS,
}
# The recipe phase's state changes, graphed against eager
# (recipe_swaps_vs_eager): the spring recipe's model flags with the aux
# trigger armed at a threshold that the first eval handed to it passes,
# SWAP_ARMS discovery arms of one epoch, and SWAP_STEPS steps after each of
# the kept arm's restore, a forced rescue and the trigger.
SWAP_ARGS = TRAIN_ARGS + RECIPE_MODEL_FLAGS + ["--aux_on_recons=1e9"]
SWAP_ARMS, SWAP_STEPS = 2, 5
SWAP_BLOCKS = ("kept arm restored", "rescue", "trigger")
# bf16 positions on the card against the same model's on the CPU: both
# round their bf16 products once after f32 sums, in orders that may differ,
# so a value can land one bf16 step away and move a position by thousandths
# of a pixel (the CPU against the JAX package: at most 3.9e-3 px,
# tests/test_torch_bf16.py; an NVIDIA H100 80GB HBM3 at 700 W against the
# CPU: 1.9e-6 px). Held to 1e-2 px.
BF16_POS_ATOL = 1e-2
# The runtime phase's watchdog timeout for the subprocess that hangs.
HANG_WATCHDOG_SECS = 3
# The graph phase: graphed parameters after 10 steps against eager ones
# from the same weights (the same operations, cuDNN deterministic; RMSprop
# divides by the root of a running mean of squared gradients, so a
# difference in the last bit of a near-zero gradient moves a parameter
# far), and the configurations whose graphed and eager steps it times: the
# main path, the tasks' logged model flags and the LSTM's.
GRAPH_PARAM_RTOL = 1e-5
# The parallel phase: the losses of 2 ranks against 1 process's, and the
# gradients over the largest gradient (of the split kernels' largest for
# them); the ranks sum partial products and gradients in another order.
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_GRAD_TOL = 1e-4
# The parallel phase runs the main path's spring cell. Its gradient at
# initialization moves by 1e-3 of its largest value when the input moves by
# as little as 1e-15 (float64, on the CPU), while the forward moves in
# proportion: any reordered sum changes it that far, so the one process
# that the ranks are held to computes what they compute (DP: each data
# rank's rows in a forward and backward of their own, the gradients added;
# TP: each split kernel's pieces, their partial products added or
# concatenated) and adds in the same order. PERF.md, section 7.
PARALLEL_ARGS = TRAIN_ARGS
# What log.txt says of a run's train step on the card: the fused step,
# captured as a CUDA graph.
FUSED_ON = "fused step: on (captured CUDA graph)"
# The pipeline phase (docs/TRAINING.md's pipeline through the port's tools):
# the discovery run's epochs (the JAX package's spring discovery had found
# the objects by epoch 50: runs/spring500/log.txt:136, valid recons 6.74),
# the aligned resume's extension flags (docs/TRAINING.md's fine-tune), and
# the card's encoder positions against the CPU's on the same checkpoint and
# batch: both compute in float32 (TF32 off) and differ in the order of their
# sums.
PIPELINE_EPOCHS = 50
# The discovery run evaluates every 10 epochs (the JAX package's spring500
# run: every 25) and starts from seed 0, spring500's: the CLI's --seed
# gives the JAX package's initial weights, so discovery starts where
# spring500 started (its valid recons 6.74 at epoch 50). The ShallowUNet
# ends in a ReLU on the slots' mask logits (the reference's architecture,
# in both packages): where the final 1x1 conv's output is negative
# everywhere for a slot at initialization, no gradient reaches it. Seed 0
# has one live slot, seed 1 two, seed 6 (the first) none, so its slots
# stay at one position for good (tests/test_torch_chip_smoke.py; the
# pipeline's seed_sweep stage runs DEAD_SEED beside DISCOVERY_SEED on the
# card). With the JAX package's seed 1 the main path had not separated the
# objects after 50 epochs on the card (valid recons 11.345, a pointwise
# fit that is not finite: PERF.md).
DISCOVERY_EVAL_EVERY = 10
DISCOVERY_SEED = 0
DEAD_SEED = 6
ALIGN_ARGS = ["--pos_consistency=1.0", "--vel_anchor=1.0",
              "--learn_frame_offset"]
PIPELINE_POS_ATOL = 1e-3
# The decoded background after the --bg_lr_mult=0 resume against the
# installed median: the frozen parameters are the written ones bitwise, and
# the decode's sigmoid of the surgery's float32 logit returns the median
# (clipped to [1e-3, 1 - 1e-3]) within float32 rounding.
BACKGROUND_ATOL = 1e-5
# The tangent's tolerance, relative to its largest value: through the
# kernel's wrapper the tangent is the plain decode's JVP of the same inputs,
# so the two differ only where the card's sums run in another order.
JVP_RTOL = 1e-4
# The chain phase: 3bp_color's chain (the reference runner's CHAIN) at cut
# depth, its curriculum stages' epochs and the pinned resume's, a save every
# epoch. curriculum_1's 4 epochs put its schedule's anneal (at 3 epochs)
# past its first step: at the optimizer's count it starts at --base_lr, at
# the trunk's step it would start at --base_lr / 5.
CHAIN_CURRICULUM = (4, 1, 1)
CHAIN_PINNED = 2
# The chain the phase drives: the one whose pinned stage the probes of
# tools/curriculum_probes.py --stage pinned chose (the other chains' stages
# are held on the CPU by tests/test_torch_chain.py).
CHAIN = "3bp_chain_pinned_gated"
# The training stages that must start at --base_lr: those whose restore
# brings no optimizer state, so the optimizer's count starts at 0.
CHAIN_FRESH_COUNT = ("curriculum_1", "pinned")
# The pinned stage's two steps from the tracked curriculum_3
# (``pinned_card_vs_cpu``) on the card against the CPU. The parameters are
# held by their updates: the L2 norm of the card's update less the CPU's,
# over all parameters, relative to the L2 norm of the CPU's update. A
# fresh RMSprop moves a parameter by about 10 x lr a step whatever its
# gradient's size, so the gradients near 0 whose sign the order of a sum
# sets move their parameters 0.02 one way or the other: on the CPU,
# float32 against float64 gave 0.0458 after these two steps (3684 of
# 2.43 M parameters more than lr apart), one float32 thread against two
# 0.0063. A negated gradient gives 2, a skipped one 1. Each step's
# losses, relative: float32 against float64 3.2e-7 on the CPU.
PINNED_UPDATE_RTOL = 0.1
PINNED_LOSS_RTOL = 1e-5
PINNED_STEPS = 2
# Each phase's wall seconds, in order (``phase``).
PHASE_SECONDS = {}


@contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"== phase {name}: {PHASE_SECONDS[name]:.2f} s", flush=True)


# (N, img, T, o, ch): the main path's train (N=1000) and eval (N=800)
# decodes at 32/16/2/3, and the seq-30 test phase's 26 rollout frames x
# B=100 (N=2600, several slabs a warp); the other tasks' decodes at B=100:
# 3bp_color's 16 reconstruction and 16 rollout frames a sequence (N=1600)
# and the seq-40 phase's 36 rollout frames (N=3600); 64x64
# mnist_spring_color's 10 reconstruction frames (N=1000, in one and three
# channels, 64/32/2/3 being the largest block the kernel stages), 9 rollout
# frames (N=900) and the seq-30 phase's 27 (N=2700); small N of those
# shapes; and the edges of the persistent grid: one frame and an N that the
# grid does not divide.
TIMED_SHAPES = [(1000, 32, 16, 2, 3), (800, 32, 16, 2, 3),
                (2600, 32, 16, 2, 3), (1600, 36, 18, 3, 3),
                (3600, 36, 18, 3, 3), (1000, 64, 32, 2, 1),
                (1000, 64, 32, 2, 3), (900, 64, 32, 2, 3),
                (2700, 64, 32, 2, 3)]
ST_DECODE_SHAPES = TIMED_SHAPES + [
    (37, 36, 18, 3, 3), (19, 64, 32, 2, 1), (5, 32, 16, 2, 1),
    (3, 64, 32, 2, 3), (1, 32, 16, 2, 3), (1001, 32, 16, 2, 3)]
# The kernel's slab height at 2 objects (csrc/st_decoder.cu, slab_rows).
SLAB_ROWS = 8


def time_ms(fn, runs=21, reps=10):
    """Device time of one call of `fn` (ms): `reps` calls are captured in a
    CUDA graph, so the host's launch overhead is not timed, and the median
    over `runs` replays timed with CUDA events is divided by `reps`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def eager_ms(fn, calls=20):
    """Time of one eager call of `fn` (ms), host work included: CUDA events
    around `calls` calls after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def st_decode_bound(n, img, tmpl, n_objs, ch):
    """Least time (ms) the card needs for one decode, and what bounds it.

    Bytes: each input read once, the output written once. Operations: the
    work these inputs need. Each interpolation row has at most two
    non-zeros, so a warped value is 4 taps (2 ops each) per plane; per
    pixel that is n_objs*(8*(ch+1) + 1) for the warps and the -5, 4*(o+1)
    for the softmax (max, subtract, exp, sum) and 2*(o+1)*ch for the
    composite."""
    f32 = 4
    bytes_moved = f32 * (n * 2 * n_objs + n_objs * tmpl * tmpl * (1 + ch)
                         + img * img * ch + n * img * img * ch)
    per_pixel = (n_objs * (8 * (ch + 1) + 1) + 4 * (n_objs + 1)
                 + 2 * (n_objs + 1) * ch)
    ops = n * img * img * per_pixel
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decoder_inputs(n, img, tmpl, n_objs, ch, seed, template_logit=None):
    import torch
    from paig_reproduction_tpu_torch.models.decoder import (
        DecoderAssets,
        DecoderConfig,
    )
    g = torch.Generator().manual_seed(seed)
    template = torch.randn(n_objs, tmpl, tmpl, generator=g)
    if template_logit is not None:
        template.fill_(template_logit)
    assets = DecoderAssets(
        template=template,
        contents=torch.randn(n_objs, tmpl, tmpl, ch, generator=g),
        background=torch.rand(img, img, ch, generator=g))
    # Positions over the frame and up to a quarter-frame beyond each edge,
    # so the zero padding of the warp is exercised.
    pos = torch.rand(n, 2 * n_objs, generator=g) * 1.5 * img - 0.25 * img
    cfg = DecoderConfig(img_hw=(img, img), tmpl_size=tmpl, n_objs=n_objs,
                        conv_ch=ch, log_sig=1.0)
    return (DecoderAssets(*(x.cuda() for x in assets)), pos.cuda(), cfg)


def store_floor_fn():
    """csrc/store_floor.cu's entry: out [N, img, img, ch] <- 0.5 through the
    decoder's grid, in 16-byte stores."""
    import torch
    from paig_reproduction_tpu_torch.ops.cuda import build
    fn = build.load("store_floor").store_floor
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(out):
        n, img, _, ch = out.shape
        err = fn(out.data_ptr(), n, img, ch, SLAB_ROWS,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"store_floor failed: CUDA error {err}")
        return out
    return run


def start_parent_build(src):
    """Starts nvcc on an earlier st_decoder.cu; returns (process, library
    path)."""
    from paig_reproduction_tpu_torch.ops.cuda import build
    lib = os.path.join(tempfile.mkdtemp(prefix="paig_parent_"),
                       "libst_decoder_parent.so")
    proc = subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def parent_fn(proc, lib):
    """The earlier source's decode, once its build has ended: a function of
    (assets, pos, cfg) writing a new output, as the kernel's wrapper
    does."""
    import torch
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the earlier source:\n{log}")
    fn = ctypes.CDLL(lib).st_decode_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(assets, pos, cfg):
        img = cfg.img_hw[0]
        out = torch.empty((pos.shape[0], img, img, cfg.conv_ch),
                          device=pos.device)
        err = fn(pos.data_ptr(), assets.template.data_ptr(),
                 assets.contents.data_ptr(), assets.background.data_ptr(),
                 out.data_ptr(), pos.shape[0], img, cfg.tmpl_size,
                 cfg.n_objs, cfg.conv_ch, float(cfg.log_sig),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the earlier st_decode_forward failed: "
                               f"CUDA error {err}")
        return out
    return run


def check_st_decode(parent=None):
    """The ST-decoder kernel against its plain version, and `parent` (an
    earlier source's decode) beside it if given. Returns the JSON fields
    measured here."""
    import torch
    from paig_reproduction_tpu_torch.models.decoder import DecoderAssets
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    store_floor = store_floor_fn()
    max_err = 0.0
    timings = {}
    for n, img, tmpl, n_objs, ch in ST_DECODE_SHAPES:
        assets, pos, cfg = decoder_inputs(n, img, tmpl, n_objs, ch, seed=n)
        with torch.no_grad():
            out = sd.st_decode_fused(assets, pos, cfg)
            torch.cuda.synchronize()
            ref = sd.st_decode_plain(assets, pos, cfg)
        err = (out - ref).abs().max().item()
        shape = f"N={n} img={img} T={tmpl} o={n_objs} ch={ch}"
        print(f"st_decode {shape}: max_abs_err={err:.3e} (tolerance "
              f"{FWD_ATOL})")
        if not err <= FWD_ATOL:
            raise AssertionError(f"st_decode disagrees with its plain "
                                 f"version: {err} > {FWD_ATOL}")
        max_err = max(max_err, err)
        if (n, img, tmpl, n_objs, ch) not in TIMED_SHAPES:
            continue
        ms = time_ms(lambda: sd.launch(assets, pos, cfg))
        plain_ms = time_ms(lambda: sd.st_decode_plain(assets, pos, cfg))
        bound_ms, bound_by = st_decode_bound(n, img, tmpl, n_objs, ch)
        timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, share_of_bound=bound_ms / ms)
        line = (f"st_decode {shape}: kernel {ms * 1e3:.3f} us, plain "
                f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
                f"({bound_by}), share of bound {bound_ms / ms:.3f}")
        if (img, tmpl, n_objs, ch) == (32, 16, 2, 3):
            floor = torch.empty_like(out)
            store_floor(floor)
            torch.cuda.synchronize()
            if not bool((floor == 0.5).all()):
                raise AssertionError("store_floor did not write every frame")
            timing["store_floor_ms"] = time_ms(lambda: store_floor(floor))
            line += (f", store-only floor "
                     f"{timing['store_floor_ms'] * 1e3:.3f} us")
        print(line)
        if parent is not None:
            old = parent(assets, pos, cfg)
            torch.cuda.synchronize()
            old_err = (old - ref).abs().max().item()
            if not old_err <= FWD_ATOL:
                raise AssertionError(f"the earlier source disagrees with the "
                                     f"plain version: {old_err}")
            ab = [(name, time_ms(fn)) for name, fn in (
                ("earlier", lambda: parent(assets, pos, cfg)),
                ("kernel", lambda: sd.launch(assets, pos, cfg)),
                ("kernel", lambda: sd.launch(assets, pos, cfg)),
                ("earlier", lambda: parent(assets, pos, cfg)))]
            timing["ab_us"] = ab
            print(f"st_decode {shape} A/B (us): " + ", ".join(
                f"{name} {t * 1e3:.3f}" for name, t in ab))
        timings[n, img, tmpl, n_objs, ch] = timing

    assets, pos, cfg = decoder_inputs(64, 32, 16, 2, 3, seed=1,
                                      template_logit=90.0)
    out = sd.launch(assets, pos, cfg)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("st_decode is not finite at template logit 90")
    print("st_decode template logit 90: finite")

    assets, pos, cfg = decoder_inputs(1000, 32, 16, 2, 3, seed=2)
    weight = torch.rand((1000, 32, 32, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3))
    grads = []
    for fn in (sd.st_decode_fused, sd.st_decode_plain):
        leaves = [x.clone().requires_grad_(True) for x in (*assets, pos)]
        out = fn(DecoderAssets(*leaves[:3]), leaves[3], cfg)
        grads.append(torch.autograd.grad((out * weight).sum(), leaves))
    for name, g_k, g_p in zip(("template", "contents", "background", "pos"),
                              *grads):
        torch.testing.assert_close(g_k, g_p, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        print(f"st_decode grad {name}: max_abs_diff="
              f"{(g_k - g_p).abs().max().item():.3e}")
    return max_err, timings


def check_st_decode_jvp():
    """torch.func.jvp through the kernel's wrapper at the main path's N=1000
    against the plain decode's, with a tangent on the positions (the
    Gauss-Newton refinement's case) and one on all four inputs. Returns
    (the largest primal error, the largest relative tangent error, the
    kernel path's and the plain path's jvp time in ms)."""
    import torch
    from paig_reproduction_tpu_torch.models.decoder import DecoderAssets
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    assets, pos, cfg = decoder_inputs(1000, 32, 16, 2, 3, seed=4)
    g = torch.Generator("cuda").manual_seed(5)
    tangents = [torch.randn(x.shape, device="cuda", generator=g)
                for x in (*assets, pos)]

    def through(fn, argnums):
        def f(*xs):
            full = [*assets, pos]
            for i, x in zip(argnums, xs):
                full[i] = x
            return fn(DecoderAssets(*full[:3]), full[3], cfg)
        primals = tuple([*assets, pos][i] for i in argnums)
        return lambda: torch.func.jvp(
            f, primals, tuple(tangents[i] for i in argnums))

    worst_primal = worst_tangent = 0.0
    times = {}
    for name, argnums in (("pos", (3,)), ("all four", (0, 1, 2, 3))):
        before = sd.LAUNCHES
        out, tan = through(sd.st_decode_fused, argnums)()
        torch.cuda.synchronize()
        if sd.LAUNCHES != before + 1:
            raise AssertionError("the jvp did not launch the kernel once")
        ref_out, ref_tan = through(sd.st_decode_plain, argnums)()
        err = (out - ref_out).abs().max().item()
        rel = ((tan - ref_tan).abs().max()
               / ref_tan.abs().max().clamp_min(1e-30)).item()
        print(f"st_decode jvp, tangent on {name}: primal max_abs_err "
              f"{err:.3e} (tolerance {FWD_ATOL}), tangent max error "
              f"{rel:.3e} of its largest value (tolerance {JVP_RTOL})")
        if not (err <= FWD_ATOL and rel <= JVP_RTOL):
            raise AssertionError("the kernel's jvp disagrees with the plain "
                                 "decode's")
        worst_primal = max(worst_primal, err)
        worst_tangent = max(worst_tangent, rel)
        if name == "pos":
            times = {"ms": eager_ms(through(sd.st_decode_fused, argnums)),
                     "plain_ms": eager_ms(through(sd.st_decode_plain,
                                                  argnums))}
            print(f"st_decode jvp on pos, N=1000 (eager calls, host work "
                  f"included): through the kernel {times['ms']:.3f} ms, "
                  f"plain {times['plain_ms']:.3f} ms")
    return worst_primal, worst_tangent, times


def read_log(path):
    """(train losses, every eval loss, the seq-30 test phase's losses by
    name or None)."""
    train, evals, test30 = [], [], None
    with open(path) as f:
        for line in f:
            m = re.search(r"train - iter=(\d+) train_loss=(\S+)", line)
            if m:
                train.append(float(m.group(2)))
            m = re.search(r"(valid|test) - epoch=(\d+) (.*)", line)
            if m:
                values = {k: float(v) for k, v in
                          (kv.split("=") for kv in m.group(3).split())}
                evals.extend(values.values())
                if m.group(1) == "test" and m.group(2) == "0":
                    test30 = values
    return train, evals, test30


def check_fused_line(log_path, expected=FUSED_ON):
    """log.txt names the train step the run took: ``expected`` (the
    captured CUDA graph by default)."""
    with open(log_path) as f:
        lines = [line.split(" - paig - ", 1)[1].strip() for line in f
                 if " - paig - fused step: " in line]
    print(f"log.txt: {lines}")
    if not lines or not all(line.startswith(expected) for line in lines):
        raise AssertionError(f"log.txt does not say {expected!r}: {lines}")


def eval_batches(n, batch_size):
    """Batches of one eval of a split of n sequences: a split under 100 is
    one batch, a larger one its full batches."""
    return 1 if n < 100 else max(1, n // batch_size)


def expected_launches(steps, valid_n, test_n, test30_n, batch_size, epochs,
                      eval_every=1):
    """Kernel launches of one CLI run (an eval every `eval_every` epochs):
    two decodes (reconstructions and rollout) per train step, per eval
    batch and per visualization forward, which follows every valid and test
    eval: the valid evals before training and after every `eval_every`-th
    epoch, the test eval after training and the seq-30 phase's test
    eval."""
    valid_evals = 1 + epochs // eval_every
    evals = (valid_evals * eval_batches(valid_n, batch_size)
             + eval_batches(test_n, batch_size)
             + eval_batches(test30_n, batch_size))
    return 2 * (steps + evals + valid_evals + 2)


@contextmanager
def cli_run():
    """Removes the log handlers a CLI run adds, so a later run in this
    process logs to its own log.txt only."""
    import logging
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        yield
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()


def check_artifacts(save_dir, required=ARTIFACTS):
    """Every artifact in `required` and an animation gif are there and
    non-empty; each JPEG starts with FF D8 and ends with FF D9, each GIF
    starts with GIF89a."""
    names = sorted(os.listdir(save_dir))
    gifs = [n for n in names if re.fullmatch(r"animation\d+\.gif", n)]
    if not gifs:
        raise AssertionError(f"no animation gif in {names}")
    for name in tuple(required) + tuple(gifs):
        if name not in names or not os.path.getsize(
                os.path.join(save_dir, name)):
            raise AssertionError(f"artifact {name} is missing or empty")
    for name in names:
        with open(os.path.join(save_dir, name), "rb") as f:
            data = f.read()
        if name.endswith(".jpg") and not (data[:2] == b"\xff\xd8"
                                          and data[-2:] == b"\xff\xd9"):
            raise AssertionError(f"{name} is not a JPEG")
        if name.endswith(".gif") and data[:6] != b"GIF89a":
            raise AssertionError(f"{name} is not a GIF89a")
    print("artifacts: " + ", ".join(
        f"{n} {os.path.getsize(os.path.join(save_dir, n))} B"
        for n in names))


def train(batch_size=100, epochs=2, extra=(), argv_fn=None):
    """Drive the port's CLI entry on spring_color with the main path's
    flags and `extra` (or with ``argv_fn(data_dir, save_dir)``'s argv, whose
    batch size and epochs the checks read): train, save, the seq-30 test
    phase and the artifacts. Returns (launch count, the training Trainer,
    its save_dir, the seq-30 losses)."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    save_dir = os.path.join(tempfile.mkdtemp(prefix="paig_smoke_"), "run")
    if argv_fn is None:
        argv = TRAIN_ARGS + [f"--batch_size={batch_size}",
                             f"--epochs={epochs}", f"--data_dir={DATA_DIR}",
                             f"--save_dir={save_dir}", *extra]
    else:
        argv = argv_fn(DATA_DIR, save_dir)
        parsed = cli.build_parser().parse_args(argv)
        batch_size, epochs = parsed.batch_size, parsed.epochs
    with cli_run():
        sd.LAUNCHES = 0
        trainer, test_trainer = cli.main(argv)
        torch.cuda.synchronize()
        launches = sd.LAUNCHES

    check_fused_line(os.path.join(save_dir, "log.txt"))
    train_losses, eval_losses, test30 = read_log(
        os.path.join(save_dir, "log.txt"))
    print(f"train losses: first {train_losses[0]:.4f}, last "
          f"{train_losses[-1]:.4f} over {len(train_losses)} steps")
    print(f"seq-30 test phase: {test30}")
    if test30 is None or not all(math.isfinite(v) for v in test30.values()):
        raise AssertionError("no finite 'test - epoch=0' line")
    if not all(math.isfinite(v) for v in train_losses + eval_losses):
        raise AssertionError("a logged loss is not finite")
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError("the last train_loss is not below the first")
    if trainer.step != epochs * (trainer.train_iterator.num_examples
                                 // batch_size):
        raise AssertionError(f"unexpected step count {trainer.step}")
    if test_trainer.step != trainer.step:
        raise AssertionError("the seq-30 phase did not restore the run's "
                             "checkpoint")
    needed = expected_launches(
        trainer.step, trainer.valid_iterator.num_examples,
        trainer.test_iterator.num_examples,
        test_trainer.test_iterator.num_examples, batch_size, epochs)
    print(f"st_decode launches: {launches} (train steps {trainer.step}, "
          f"expected {needed} with the evals, the seq-30 phase and the "
          f"visualizations)")
    if launches != needed:
        raise AssertionError("the main path did not decode through the "
                             "kernel on every decode")
    check_artifacts(save_dir)
    return launches, trainer, save_dir, test30


def run_test_mode(save_dir, test30, batch_size=100, extra=()):
    """``--test_mode --ckpt_dir=save_dir`` alone (with the run's `extra`
    model flags): its wall time and launch count; its losses agree with the
    training run's seq-30 phase (the same checkpoint and split, the batches
    grouped differently) within 1e-5 relative."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    out_dir = os.path.join(os.path.dirname(save_dir), "test_mode")
    argv = TRAIN_ARGS + [f"--batch_size={batch_size}", "--test_mode",
                         f"--ckpt_dir={save_dir}", f"--data_dir={DATA_DIR}",
                         f"--save_dir={out_dir}", *extra]
    with cli_run():
        sd.LAUNCHES = 0
        t0 = time.perf_counter()
        _, test_trainer = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = sd.LAUNCHES
    _, _, losses = read_log(os.path.join(out_dir, "log.txt"))
    needed = 2 * (eval_batches(test_trainer.test_iterator.num_examples,
                               batch_size) + 1)
    print(f"--test_mode: {seconds:.3f} s wall, st_decode launches "
          f"{launches} (expected {needed}), {losses}")
    if launches != needed:
        raise AssertionError("--test_mode did not decode through the kernel")
    for k, v in test30.items():
        if not abs(losses[k] - v) <= 1e-5 * abs(v):
            raise AssertionError(f"--test_mode {k}={losses[k]} against the "
                                 f"run's {v}")
    # A test-mode run saves no checkpoint of its own.
    check_artifacts(out_dir, [n for n in ARTIFACTS if n != "model.ckpt"])
    return seconds


def check_checkpoint(trainer, save_dir, batch_size=100, epochs=2):
    """Restore the run's model.ckpt into a fresh Trainer at seq 12 (other
    initial weights): its valid eval, on the same batches, and one train
    step on fixed indices equal the finished trainer's within
    RESTORE_RTOL."""
    import numpy as np
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.data.iterators import get_iterators
    from paig_reproduction_tpu_torch.models import PhysicsNet
    from paig_reproduction_tpu_torch.train.trainer import Trainer

    m = trainer.model
    fresh = Trainer(PhysicsNet(**m.config), device="cuda")
    fresh.get_data(get_iterators(
        os.path.join(DATA_DIR, cli.TASK_TABLE[m.task][0]), conv=True))
    n_train = fresh.train_iterator.num_examples
    fresh.build_optimizer(6e-4, "rmsprop", True, epochs=epochs,
                          steps_per_epoch=n_train // batch_size)
    with cli_run():
        fresh.initialize_graph(
            os.path.join(os.path.dirname(save_dir), "restored"),
            use_ckpt=True, ckpt_dir=save_dir)
        if fresh.step != trainer.step:
            raise AssertionError(f"restored step {fresh.step}, saved "
                                 f"{trainer.step}")
        # The same batches: each iterator shuffles its own order in place.
        fresh.valid_iterator.indices = trainer.valid_iterator.indices.copy()
        evals = []
        for t in (trainer, fresh):
            np.random.seed(0)
            evals.append(t.eval_performance(batch_size, type="valid"))
            t.flush_artifacts()

    def rel(a, b):
        return float(abs(a - b) / max(abs(b), 1e-30))

    worst = max(rel(evals[1][k], evals[0][k]) for k in evals[0])
    print(f"restored valid eval {evals[1]}, saver's {evals[0]}: max "
          f"relative difference {worst:.3e} (tolerance {RESTORE_RTOL})")
    if not worst <= RESTORE_RTOL:
        raise AssertionError("the restored eval differs")

    idx = np.random.RandomState(0).choice(n_train, batch_size, replace=False)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        steps = [t.train_step(idx) for t in (trainer, fresh)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    worst_loss = max(rel(float(steps[1][k]), float(steps[0][k]))
                     for k in steps[0])
    saved = trainer.model.state_dict()
    worst_param = max(
        float((t - saved[n]).abs().max() / saved[n].abs().max().clamp_min(
            1e-30)) for n, t in fresh.model.state_dict().items())
    print(f"next step after restore: max relative difference of the losses "
          f"{worst_loss:.3e}, of the parameters {worst_param:.3e} "
          f"(tolerance {RESTORE_RTOL})")
    if not (worst_loss <= RESTORE_RTOL and worst_param <= RESTORE_RTOL):
        raise AssertionError("the step after restore differs")


def step_ms(trainer, batch_size=100, steps=20):
    """Median host time of one synchronized train step (ms)."""
    import numpy as np
    import torch
    rs = np.random.RandomState(0)
    n = trainer.train_iterator.num_examples
    times = []
    for i in range(steps + 3):
        idx = rs.choice(n, batch_size, replace=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(idx)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def recipe_decodes(train_steps, eval_batches, forwards, refine_iters):
    """Kernel launches of a recipe run: two decodes (reconstructions and
    rollout) per train step, whose model runs without the enhancers; and per
    eval batch and per other forward of the model with them (the
    visualizations, the physics fit's encodings and its rendered offsets)
    the same two decodes and one render per Gauss-Newton iteration of the
    position refinement (its cu2 tangents ride as a batch axis, so one
    launch an iteration). Returns (launches, the refinement's share)."""
    refine = refine_iters * (eval_batches + forwards)
    return 2 * (train_steps + eval_batches + forwards) + refine, refine


def recipe_counts(log_path, arms, arm_epochs, loop_epochs, steps_per_epoch,
                  valid_batches, test_batches, test30_batches):
    """(train steps, eval batches, other forwards) of a recipe run with an
    eval every epoch, from its flags and its log: the arms' steps and
    scoring evals, the loop's steps, its valid evals (before the loop and
    after each epoch), the test eval and the seq-30 phase's; a visualization
    forward after each valid and test eval; and five forwards per physics
    fit that ran (four batches of encodings and the rendered offsets)."""
    with open(log_path) as f:
        fits = sum(1 for line in f if "- fit_physics: " in line
                   and "first accepted fit" not in line)
    steps = (arms * arm_epochs + loop_epochs) * steps_per_epoch
    valid_evals = 1 + loop_epochs
    batches = (arms * valid_batches + valid_evals * valid_batches
               + test_batches + test30_batches)
    return steps, batches, valid_evals + 2 + 5 * fits


@contextmanager
def refinement_launches():
    """Counts the kernel's launches inside the Gauss-Newton position
    refinement, in eager calls and in replays of captured steps. A capture
    runs nothing, so each captured step keeps the refinement's launches
    that its capture recorded, and every replay of it adds them. Yields a
    function that returns the count."""
    from paig_reproduction_tpu_torch.models import physics_net
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd
    from paig_reproduction_tpu_torch.train.graphs import CapturedStep

    count = {"n": 0}
    captured = []
    refine, init = physics_net.refine_positions, CapturedStep.__init__

    def counted_refine(*args, **kwargs):
        before = sd.LAUNCHES
        out = refine(*args, **kwargs)
        count["n"] += sd.LAUNCHES - before
        return out

    def counted_init(self, fn, signature=None):
        before = count["n"]
        init(self, fn, signature)
        self.refine_launches = count["n"] - before
        count["n"] = before
        captured.append(self)

    physics_net.refine_positions = counted_refine
    CapturedStep.__init__ = counted_init
    try:
        yield lambda: count["n"] + sum(g.refine_launches * g.replays
                                       for g in captured)
    finally:
        physics_net.refine_positions = refine
        CapturedStep.__init__ = init


def counted_cli(argv):
    """The CLI entry with `argv` on the card, every kernel launch counted
    and the Gauss-Newton refinement's apart. Returns (the training
    Trainer, the seq-30 phase's, wall s, launches, the refinement's
    launches)."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    with refinement_launches() as refine_count, cli_run():
        sd.LAUNCHES = 0
        t0 = time.perf_counter()
        trainer, test_trainer = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return (trainer, test_trainer, seconds, sd.LAUNCHES,
                refine_count())


def check_recipe_launches(name, log_path, trainer, test_trainer, launches,
                          refine_launches, arms, loop_epochs, batch_size):
    """A recipe run (`arms` discovery arms of one epoch, `loop_epochs`, an
    eval every epoch) launched the kernel on every decode: as many
    launches as recipe_counts and recipe_decodes expect, the refinement's
    too; raises otherwise."""
    counts = recipe_counts(
        log_path, arms=arms, arm_epochs=1, loop_epochs=loop_epochs,
        steps_per_epoch=trainer.train_iterator.num_examples // batch_size,
        valid_batches=eval_batches(trainer.valid_iterator.num_examples,
                                   batch_size),
        test_batches=eval_batches(trainer.test_iterator.num_examples,
                                  batch_size),
        test30_batches=eval_batches(
            test_trainer.test_iterator.num_examples, batch_size))
    needed, needed_refine = recipe_decodes(*counts, REFINE_ITERS)
    print(f"{name}: st_decode launches {launches} (expected {needed}: "
          f"{counts[0]} train steps, {counts[1]} eval batches, {counts[2]} "
          f"other forwards), of them in the Gauss-Newton refinement "
          f"{refine_launches} (expected {needed_refine})")
    if launches != needed or refine_launches != needed_refine:
        raise AssertionError(f"the {name} did not decode through the "
                             f"kernel on every decode")


def recipe(batch_size=100):
    """The single-command spring recipe through the CLI entry at full
    width, with every hook asserted from log.txt and every decode counted;
    then a resume from its checkpoint. Returns the phase's numbers."""
    import numpy as np
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.data.iterators import gather_batch

    save_dir = os.path.join(tempfile.mkdtemp(prefix="paig_recipe_"), "run")
    argv = RECIPE_ARGS + [f"--batch_size={batch_size}",
                          f"--data_dir={DATA_DIR}", f"--save_dir={save_dir}"]
    trainer, test_trainer, seconds, launches, refine_launches = \
        counted_cli(argv)
    log_path = os.path.join(save_dir, "log.txt")
    check_fused_line(log_path)
    with open(log_path) as f:
        log = f.read()
    for needle in ("discovery restart arm 1/2", "discovery restart arm 2/2",
                   "discovery restarts: continuing from arm",
                   "aux_on_recons trigger: ", "- fit_physics: ",
                   "auto_rescue: epoch "):
        if needle not in log:
            raise AssertionError(f"the recipe's log has no {needle!r}")
    print("recipe hooks in log.txt: " + "; ".join(
        line.split(" - paig - ")[1] for line in log.splitlines()
        if re.search(r"discovery restarts:|trigger|fit_physics|auto_rescue",
                     line)))
    train_losses, eval_losses, test30 = read_log(log_path)
    if not all(math.isfinite(v) for v in train_losses + eval_losses):
        raise AssertionError("a logged loss of the recipe is not finite")
    if test30 is None or not all(math.isfinite(v) for v in test30.values()):
        raise AssertionError("the recipe's seq-30 phase logged no finite "
                             "'test - epoch=0' line")
    if not (test_trainer.model.init_state_fit
            and test_trainer.model.refine_recons_pos == REFINE_ITERS):
        raise AssertionError("the seq-30 phase ran without the enhancers")
    if trainer._rescue_count != 1 or not trainer._aux_triggered:
        raise AssertionError("the rescue or the trigger did not fire")

    check_recipe_launches("recipe", log_path, trainer, test_trainer,
                          launches, refine_launches, arms=2, loop_epochs=3,
                          batch_size=batch_size)
    print(f"recipe: {seconds:.3f} s wall; seq-30 phase {test30}")
    check_artifacts(save_dir)

    # The recipe's train step, and an eval batch with and without the
    # enhancers (valid sequences, no gradient).
    step = step_ms(trainer)
    idx = np.arange(batch_size)
    batch = gather_batch(trainer._split_u8("valid"), idx)
    with torch.no_grad():
        eval_on = eager_ms(lambda: trainer._losses(batch), calls=10)
        eval_off = eager_ms(lambda: trainer._losses(batch, trainer.train_net),
                            calls=10)
    print(f"recipe train step {step:.2f} ms; eval batch of {batch_size} "
          f"with the enhancers {eval_on:.2f} ms, without {eval_off:.2f} ms")

    # Resume: the rescue budget and the trigger come back, and the discovery
    # arms are skipped.
    with cli_run():
        resumed, _ = cli.main(argv + ["--use_ckpt", "--epochs=1"])
    if not (resumed._rescue_count == trainer._rescue_count
            and resumed._rescue_step == trainer._rescue_step
            and resumed._aux_triggered):
        raise AssertionError("the resume lost the rescue or trigger state")
    with open(log_path) as f:
        if f.read().count("discovery restart arm 1/2") != 1:
            raise AssertionError("the resume ran the discovery arms again")
    print(f"resumed: rescue step {resumed._rescue_step}, rescues used "
          f"{resumed._rescue_count}, aux trigger at step "
          f"{resumed.aux_warmup_steps}")
    return dict(launches=launches, refine_launches=refine_launches,
                seconds=seconds, step_ms=step, eval_ms=eval_on,
                eval_plain_ms=eval_off)


def bf16_recipe(batch_size=100):
    """bf16 with the recipe's enhancers through the CLI entry
    (BF16_RECIPE_ARGS): the arm, the loop epoch, the evals with the
    enhancers and the seq-30 phase, every decode counted exactly. Returns
    the phase's numbers."""
    save_dir = os.path.join(tempfile.mkdtemp(prefix="paig_bf16r_"), "run")
    argv = BF16_RECIPE_ARGS + [f"--batch_size={batch_size}",
                               f"--data_dir={DATA_DIR}",
                               f"--save_dir={save_dir}"]
    trainer, test_trainer, seconds, launches, refine_launches = \
        counted_cli(argv)
    log_path = os.path.join(save_dir, "log.txt")
    check_fused_line(log_path)
    with open(log_path) as f:
        if "discovery restart arm 1/1: valid recons" not in f.read():
            raise AssertionError("the bf16 recipe ran no discovery arm")
    train_losses, eval_losses, test30 = read_log(log_path)
    if not all(math.isfinite(v) for v in train_losses + eval_losses):
        raise AssertionError("a logged loss of the bf16 recipe is not finite")
    if test30 is None or not all(math.isfinite(v) for v in test30.values()):
        raise AssertionError("the bf16 recipe's seq-30 phase logged no "
                             "finite 'test - epoch=0' line")
    for t in (trainer, test_trainer):
        if not (t.model.init_state_fit
                and t.model.refine_recons_pos == REFINE_ITERS
                and t.model.compute_dtype == "bfloat16"):
            raise AssertionError("a bf16 recipe eval ran without bf16 or "
                                 "the enhancers")
    check_recipe_launches("bf16 recipe", log_path, trainer, test_trainer,
                          launches, refine_launches, arms=1, loop_epochs=1,
                          batch_size=batch_size)
    print(f"bf16 recipe: {seconds:.3f} s wall; seq-30 phase {test30}")
    return dict(launches=launches, refine_launches=refine_launches,
                seconds=seconds, test30=test30)


def variant(extra, batch_size=100):
    """The main path's command with `extra` flags through the CLI entry as
    the ``train`` phase drives it (2 epochs, the seq-30 phase, every decode
    counted), then ``--test_mode`` alone and the median train step. Returns
    the phase's numbers and the training Trainer."""
    launches, trainer, save_dir, test30 = train(batch_size, extra=extra)
    seconds = run_test_mode(save_dir, test30, batch_size, extra=extra)
    step = step_ms(trainer, batch_size)
    return dict(launches=launches, step_ms=step, seq30_s=seconds), trainer


def lstm_proof_argv(data_dir, save_dir):
    """The lstm phase's CLI argv: the reference runner's lstm_proof on the
    card."""
    from paig_reproduction_tpu_torch.tools.reference_runs import RUNS
    return RUNS[LSTM_PROOF]["argv"] + ["--device=cuda",
                                       f"--data_dir={data_dir}",
                                       f"--save_dir={save_dir}"]


def lstm_quality(port_log, factor=LSTM_QUALITY):
    """The lstm phase's quality check of the run's log.txt against
    benchmarks/lstm_proof_log.txt (both parsed by the reference runner):
    the final test pred and recons at most `factor` times the log's, the
    valid pred at the last eval below the one at epoch 10. Returns the
    numbers; raises on a miss."""
    from paig_reproduction_tpu_torch.tools import reference_runs as rr
    port = rr.parse_log(port_log)
    ref = rr.parse_log(rr.log_path(LSTM_PROOF))
    limits = {k: factor * ref["test"][k] for k in ("pred", "recons")}
    last = max(port["valid"])
    out = dict(test=port["test"], log_test=ref["test"], limits=limits,
               valid10_pred=port["valid"][10]["pred"], last_epoch=last,
               last_pred=port["valid"][last]["pred"],
               log_valid10_pred=ref["valid"][10]["pred"])
    print(f"lstm_proof: port test pred {out['test']['pred']:.4f} recons "
          f"{out['test']['recons']:.4f} extrap {out['test']['extrap']:.4f}; "
          f"JAX log (benchmarks/lstm_proof_log.txt) pred "
          f"{ref['test']['pred']:.4f} recons {ref['test']['recons']:.4f} "
          f"extrap {ref['test']['extrap']:.4f}; limits pred "
          f"{limits['pred']:.4f} recons {limits['recons']:.4f}; valid pred "
          f"epoch 10 {out['valid10_pred']:.4f} (log "
          f"{out['log_valid10_pred']:.4f}), epoch {last} "
          f"{out['last_pred']:.4f}")
    missed = [k for k in limits if not port["test"][k] <= limits[k]]
    if missed or not out["last_pred"] < out["valid10_pred"]:
        raise AssertionError(f"lstm_proof misses its quality bound: {out}")
    return out


def lstm_proof(batch_size=100):
    """The lstm phase: the logged LSTM run at full length through the CLI
    entry (``train``'s checks: every decode counted, the checkpoint, the
    seq-30 phase, the artifacts), its quality against the log
    (``lstm_quality``), ``--test_mode`` alone and the median step. The host
    time inside the evals (every valid eval, the test and seq-30 evals,
    with their visualizations) is measured apart."""
    from paig_reproduction_tpu_torch.train.trainer import Trainer

    evals = []
    original = Trainer.eval_performance

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(self, *args, **kwargs)
        finally:
            evals.append(time.perf_counter() - t0)

    Trainer.eval_performance = timed
    t0 = time.perf_counter()
    try:
        launches, trainer, save_dir, test30 = train(
            batch_size, argv_fn=lstm_proof_argv)
    finally:
        Trainer.eval_performance = original
    wall = time.perf_counter() - t0
    quality = lstm_quality(os.path.join(save_dir, "log.txt"))
    seconds = run_test_mode(save_dir, test30, batch_size, extra=LSTM_ARGS)
    step = step_ms(trainer, batch_size)
    print(f"lstm_proof: {wall:.3f} s wall for {trainer.step} train steps; "
          f"{len(evals)} evals took {sum(evals):.3f} s of it")
    return dict(launches=launches, step_ms=step, seq30_s=seconds,
                wall_s=wall, steps=trainer.step, evals=len(evals),
                eval_s=sum(evals), **quality), trainer


def check_bf16(trainer, n=10):
    """The bf16 run's encoder ran in bf16 (the UNet's output dtype, seen by
    a forward hook) with float32 weights and optimizer state, and its
    positions on the card agree with the same model's on the CPU on the
    first `n` valid sequences within BF16_POS_ATOL. Returns the error."""
    import numpy as np
    import torch
    from paig_reproduction_tpu_torch.data.iterators import gather_batch

    model = trainer.model
    seen = []
    hook = model.encoder.unet.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    batch = gather_batch(trainer._split_u8("valid"), np.arange(n))
    try:
        with torch.no_grad():
            _, aux = model(batch)
    finally:
        hook.remove()
    weights = {p.dtype for p in model.parameters()}
    state = {t.dtype for st in trainer.optimizer.state.values()
             for t in st.values()}
    print(f"bf16: UNet output {seen}, weights {weights}, optimizer state "
          f"{state}")
    if seen != [torch.bfloat16]:
        raise AssertionError("the encoder's UNet did not run in bf16")
    if weights != {torch.float32} or state != {torch.float32}:
        raise AssertionError("the master weights or the optimizer state "
                             "are not float32")
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        _, aux_cpu = cpu(batch.cpu())
    err = (aux["enc_pos"].cpu() - aux_cpu["enc_pos"]).abs().max().item()
    print(f"bf16 enc_pos on the card against the CPU ({n} sequences): "
          f"max_abs_err={err:.3e} px (tolerance {BF16_POS_ATOL})")
    if not err <= BF16_POS_ATOL:
        raise AssertionError("the card's bf16 positions disagree with the "
                             "CPU's")
    return err


def hang_under_watchdog(argv):
    """The CLI entry with `argv` for 1 epoch, no pre-train eval and a
    HANG_WATCHDOG_SECS watchdog, in a subprocess whose train step (eager or
    a fused chunk) sleeps 120 s. Returns (its exit code, the watchdog's log
    lines, its seconds)."""
    argv = list(argv) + ["--epochs=1", "--debug",
                         f"--watchdog_secs={HANG_WATCHDOG_SECS}"]
    code = ("import sys, time\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from paig_reproduction_tpu_torch import cli\n"
            "from paig_reproduction_tpu_torch.train.trainer import Trainer\n"
            "Trainer.train_step = lambda self, idx: time.sleep(120)\n"
            "Trainer.train_chunk = lambda self, b, k: time.sleep(120)\n"
            f"cli.main({argv!r})\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    fired = [line for line in proc.stderr.splitlines()
             if "device watchdog: no loop progress" in line]
    if proc.returncode != 75:
        print(proc.stderr[-3000:])
    return proc.returncode, fired, time.perf_counter() - t0


def runtime(train_dir, batch_size=100):
    """The runtime flags through the CLI entry: the watchdog, the profiler
    and the NaN checks on a 1-epoch run; a watchdog firing in a subprocess
    whose train step hangs; and --resume_remaining_epochs from `train_dir`'s
    2-epoch checkpoint. Returns the phase's numbers."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    base = tempfile.mkdtemp(prefix="paig_runtime_")
    prof_dir = os.path.join(base, "profile")
    argv = TRAIN_ARGS + [f"--batch_size={batch_size}", "--epochs=1",
                         "--datapoints=300", f"--data_dir={DATA_DIR}",
                         f"--save_dir={os.path.join(base, 'flags')}",
                         "--watchdog_secs=600", "--watchdog_floor_secs=60",
                         f"--profile_dir={prof_dir}", "--debug_nans"]
    with cli_run():
        sd.LAUNCHES = 0
        t0 = time.perf_counter()
        trainer, test_trainer = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = sd.LAUNCHES
    check_fused_line(os.path.join(base, "flags", "log.txt"),
                     "fused step: off (--debug_nans")
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(traces) != 1 or not os.path.getsize(traces[0]):
        raise AssertionError(f"--profile_dir wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    device_events = sum(1 for e in events if e.get("cat") == "kernel")
    needed = expected_launches(
        trainer.step, trainer.valid_iterator.num_examples,
        trainer.test_iterator.num_examples,
        test_trainer.test_iterator.num_examples, batch_size, 1)
    print(f"runtime flags: {seconds:.3f} s wall, {trainer.step} steps, "
          f"st_decode launches {launches} (expected {needed}); trace "
          f"{os.path.getsize(traces[0])} B, {len(events)} events, "
          f"{device_events} of them device kernels")
    if launches != needed:
        raise AssertionError("the run with the runtime flags did not decode "
                             "through the kernel on every decode")
    for t in (trainer, test_trainer):
        if t._watchdog is None or t._watchdog._armed:
            raise AssertionError("a watchdog was not armed, or not stopped "
                                 "before the last artifacts")

    code, fired, hang_s = hang_under_watchdog(
        TRAIN_ARGS + [f"--batch_size={batch_size}", f"--data_dir={DATA_DIR}",
                      f"--save_dir={os.path.join(base, 'hang')}"])
    print(f"hung train step under a {HANG_WATCHDOG_SECS} s watchdog: exit "
          f"{code} after {hang_s:.1f} s; {fired}")
    if code != 75 or not fired:
        raise AssertionError("the watchdog did not end the hung run with 75")

    resumed_dir = os.path.join(base, "resumed")
    argv = TRAIN_ARGS + [f"--batch_size={batch_size}", "--epochs=3",
                         "--use_ckpt", "--resume_remaining_epochs",
                         f"--ckpt_dir={train_dir}", f"--data_dir={DATA_DIR}",
                         f"--save_dir={resumed_dir}"]
    with cli_run():
        sd.LAUNCHES = 0
        resumed, resumed_test = cli.main(argv)
        torch.cuda.synchronize()
        resume_launches = sd.LAUNCHES
    with open(os.path.join(resumed_dir, "log.txt")) as f:
        log = f.read()
    epochs = [int(e) for e in re.findall(r"valid - epoch=(\d+) ", log)]
    steps = len(re.findall(r"train - iter=", log))
    spe = resumed.train_iterator.num_examples // batch_size
    needed = expected_launches(
        steps, resumed.valid_iterator.num_examples,
        resumed.test_iterator.num_examples,
        resumed_test.test_iterator.num_examples, batch_size, 1)
    print(f"--resume_remaining_epochs --epochs=3 from 2 epochs done: valid "
          f"evals at loop epochs {epochs}, {steps} train steps ({spe} an "
          f"epoch), step {resumed.step}; st_decode launches "
          f"{resume_launches} (expected {needed})")
    if epochs != [0, 1] or steps != spe or resumed.step != 3 * spe:
        raise AssertionError("the resume did not train exactly 1 epoch")
    if resume_launches != needed:
        raise AssertionError("the resumed run did not decode through the "
                             "kernel on every decode")
    return dict(launches=launches, resume_launches=resume_launches,
                seconds=seconds, hang_seconds=hang_s)


@contextmanager
def fused_env(value):
    """PAIG_FUSED set to `value` (None: unset) inside the block."""
    old = os.environ.get("PAIG_FUSED")
    if value is None:
        os.environ.pop("PAIG_FUSED", None)
    else:
        os.environ["PAIG_FUSED"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PAIG_FUSED", None)
        else:
            os.environ["PAIG_FUSED"] = old


def make_trainer(argv, data_dir, batch_size=100, device="cuda"):
    """A Trainer on `device` (the card) with the model and optimizer that
    the CLI builds from `argv` (weights from its --seed) and the task's
    train-length file under `data_dir`, without the CLI's run."""
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.data.iterators import get_iterators
    from paig_reproduction_tpu_torch.train.trainer import Trainer

    args = cli.build_parser().parse_args(argv)
    entry = cli.TASK_TABLE[args.task]
    trainer = Trainer(cli.build_model(args, entry[3]), device=device,
                      seed=args.seed,
                      enhancers_eval_only=args.enhancers_eval_only)
    trainer.get_data(get_iterators(os.path.join(data_dir, entry[0]),
                                   conv=True))
    trainer.build_optimizer(
        args.base_lr, args.optimizer, args.anneal_lr, epochs=args.epochs,
        steps_per_epoch=trainer.train_iterator.num_examples // batch_size,
        physics_lr_mult=args.physics_lr_mult, grad_clip=args.grad_clip,
        aux_warmup_epochs=args.aux_warmup_epochs, bg_lr_mult=args.bg_lr_mult)
    return trainer


def feed_indices(trainer, idxs):
    """The trainer's next chunks draw their index batches from `idxs`
    instead of its train iterator (until `release`d)."""
    import numpy as np
    rows = iter(list(idxs))

    def next_batches(batch_size, max_k):
        return np.stack([r for _, r in zip(range(max_k), rows)])

    trainer.train_iterator.next_index_batches = next_batches


def release(trainer):
    del trainer.train_iterator.next_index_batches


def rel_diff(a, b):
    """max |a - b| / max |b| over tensors of the same shape."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def params_diff(trainer, ref):
    """(the largest rel_diff of `trainer`'s parameters from `ref`'s,
    whether all are bitwise equal)."""
    import torch
    pairs = [(p.detach(), q.detach()) for p, q in
             zip(trainer.model.parameters(), ref.model.parameters())]
    return (max(rel_diff(p, q) for p, q in pairs),
            all(torch.equal(p, q) for p, q in pairs))


def said(rel, bitwise):
    return f"{rel:.3e}{' (bitwise equal)' if bitwise else ''}"


def graph_vs_eager(argv, data_dir, steps=10, batch_size=100):
    """`steps` graphed steps (one chunk: the warm-up step, the capture,
    then replays) against as many eager steps on the same index batches
    from the same weights, and a second eager run of the same steps as the
    noise floor, cuDNN deterministic; then one valid eval epoch replayed
    against the eager one; then 10 more steps of both eager runs with
    cuDNN free to pick nondeterministic algorithms (the default). Returns
    the largest relative difference of the parameters (graphed and eager:
    ``param_rel``; eager and eager: ``eager_rel``, then ``free_rel``),
    whether each pair is bitwise equal, and the eval losses' largest
    relative difference (``eval_rel``)."""
    import numpy as np
    import torch

    eager, again, graphed = (make_trainer(argv, data_dir, batch_size)
                             for _ in range(3))
    for t in (again, graphed):
        t.model.load_state_dict(eager.model.state_dict())
    n = eager.train_iterator.num_examples
    rs = np.random.RandomState(0)
    idxs = np.stack([rs.choice(n, batch_size, replace=False)
                     for _ in range(steps)])

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with fused_env("0"):
            for idx in idxs:
                eager.train_step(idx)
                again.train_step(idx)
        with fused_env(None):
            if graphed.fused_off_reason(batch_size) is not None:
                raise AssertionError("the fused step is off on the card: "
                                     + graphed.fused_off_reason(batch_size))
            feed_indices(graphed, idxs)
            done, _ = graphed.train_chunk(batch_size, steps)
            release(graphed)
        torch.cuda.synchronize()
        out = dict(zip(("param_rel", "bitwise"), params_diff(graphed, eager)))
        out.update(zip(("eager_rel", "eager_bitwise"),
                       params_diff(again, eager)))
        evals = []
        for t, env in ((eager, "0"), (graphed, None)):
            t.valid_iterator.indices = np.arange(
                t.valid_iterator.num_examples)
            np.random.seed(0)
            with fused_env(env):
                evals.append(torch.from_numpy(
                    t._eval_losses("valid", batch_size)[0]))
        out["eval_rel"] = rel_diff(evals[1], evals[0])
        # The noise floor a run gets by default: both eager trainers 10
        # more steps with cuDNN free to pick nondeterministic algorithms.
        torch.backends.cudnn.deterministic = False
        with fused_env("0"):
            for idx in idxs:
                eager.train_step(idx)
                again.train_step(idx)
        torch.cuda.synchronize()
        out.update(zip(("free_rel", "free_bitwise"),
                       params_diff(again, eager)))
    finally:
        torch.backends.cudnn.deterministic = deterministic

    print(f"{done} graphed steps against {steps} eager ones from the same "
          f"weights: parameters' largest relative difference "
          f"{said(out['param_rel'], out['bitwise'])}; eager against eager "
          f"{said(out['eager_rel'], out['eager_bitwise'])} (tolerance "
          f"{GRAPH_PARAM_RTOL}); graphs {graphed.graph_stats()}; valid eval "
          f"epoch replayed against eager: {out['eval_rel']:.3e}; the two "
          f"eager runs after 10 more steps each, cuDNN not deterministic: "
          f"{said(out['free_rel'], out['free_bitwise'])}")
    if not (done == steps and out["param_rel"] <= GRAPH_PARAM_RTOL
            and out["eval_rel"] <= GRAPH_PARAM_RTOL):
        raise AssertionError("the graphed step or eval disagrees with the "
                             "eager one")
    return out


def recipe_swaps_vs_eager(argv, data_dir, steps=SWAP_STEPS, batch_size=100,
                          device="cuda"):
    """The recipe's state changes, graphed against eager: a trainer on the
    fused path (captured on the card), an eager one and a second eager one
    as the noise floor, cuDNN deterministic, from the same weights and on
    the same shuffles, each through the same blocks:

    1. SWAP_ARMS discovery arms of one epoch (``run_discovery_restarts``),
       every arm after the first scored as infinite so that the first is
       kept: the optimizer restored is not the last one made; then `steps`
       steps;
    2. a forced rescue (``_do_auto_rescue``: the surgery, and a new
       optimizer with the background group at scale 0); `steps` steps;
    3. the aux trigger (``_after_valid_eval`` on a valid eval, the trigger
       armed by `argv`'s --aux_on_recons): the aux scale turns to 1 at the
       step it fires; `steps` steps.

    After each block the parameters' largest relative difference graphed
    against eager, and eager against eager, are printed and held to
    GRAPH_PARAM_RTOL. The decoder's launches of the fused trainer and of
    the first eager one, replays included, are held to ``recipe_decodes``
    of the blocks' train steps and eval batches (the arms' scores and the
    trigger's eval), the refinement's apart. Returns the blocks' numbers,
    the counts and the arms' scores."""
    import numpy as np
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd
    from paig_reproduction_tpu_torch.train.trainer import logger

    handlers = list(logger.handlers)
    trainers = [make_trainer(argv, data_dir, batch_size, device)
                for _ in range(3)]
    graphed, eager, again = trainers
    # The fused path: PAIG_FUSED=1 captures on the card and calls the step
    # body directly on the CPU.
    envs = ("1", "0", "0")
    # Each trainer's valid recons: its arms' scores, then its trigger's.
    scores = [[] for _ in trainers]
    threshold = cli.build_parser().parse_args(argv).aux_on_recons
    for t in trainers:
        t.model.load_state_dict(graphed.model.state_dict())
        t.save_dir = tempfile.mkdtemp(prefix="paig_swaps_")
        t.set_aux_trigger(threshold)
        for it in (t.train_iterator, t.valid_iterator):
            it._rng = np.random.RandomState(0)
            it.indices = np.arange(it.num_examples)
            it.reset_epoch()
    n = graphed.train_iterator.num_examples
    rs = np.random.RandomState(2)
    idxs = [np.stack([rs.choice(n, batch_size, replace=False)
                      for _ in range(steps)]) for _ in SWAP_BLOCKS]

    def train(t, env, block):
        if env == "0":
            for idx in idxs[block]:
                t.train_step(idx)
        else:
            feed_indices(t, idxs[block])
            done, _ = t.train_chunk(batch_size, steps)
            release(t)
            if done != steps:
                raise AssertionError(f"a chunk of {steps} steps ran {done}")

    def arms(t, env):
        sc, real = scores[trainers.index(t)], t._quick_valid_recons

        def scored(bs):
            sc.append(real(bs))
            return sc[-1] if len(sc) == 1 else math.inf

        t._quick_valid_recons = scored
        try:
            t.run_discovery_restarts(batch_size, SWAP_ARMS, 1)
        finally:
            del t._quick_valid_recons
        if t.optimizer is t._made[-1]:
            raise AssertionError("the kept arm's optimizer is the last one "
                                 "made")
        train(t, env, 0)

    def rescue(t, env):
        t._do_auto_rescue(1, scores[trainers.index(t)][0])
        train(t, env, 1)

    def trigger(t, env):
        scores[trainers.index(t)].append(t._quick_valid_recons(batch_size))
        t._after_valid_eval(2, scores[trainers.index(t)][-1])
        if not (t._aux_triggered and t.aux_warmup_steps == t.step):
            raise AssertionError("the aux trigger did not fire")
        train(t, env, 2)

    out = dict(blocks={}, launches=[0, 0], refine_launches=[0, 0])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for t in trainers:
            # Every optimizer the trainer makes, in order.
            made = t._made = []
            make = t._make_optimizer
            t._make_optimizer = lambda *a, make=make, made=made, **k: \
                made.append(make(*a, **k)) or made[-1]
        with refinement_launches() as refine_count:
            for block, (name, fn) in enumerate(zip(
                    SWAP_BLOCKS, (arms, rescue, trigger))):
                for i, (t, env) in enumerate(zip(trainers, envs)):
                    before, refine_before = sd.LAUNCHES, refine_count()
                    with fused_env(env):
                        fn(t, env)
                    if device != "cpu":
                        torch.cuda.synchronize()
                    if i < 2:
                        out["launches"][i] += sd.LAUNCHES - before
                        out["refine_launches"][i] += (refine_count()
                                                      - refine_before)
                rel = dict(zip(("param_rel", "bitwise"),
                               params_diff(graphed, eager)))
                rel.update(zip(("eager_rel", "eager_bitwise"),
                               params_diff(again, eager)))
                out["blocks"][name] = rel
                print(f"recipe swaps, after the {name} block and {steps} "
                      f"steps: parameters' largest relative difference, "
                      f"graphed against eager "
                      f"{said(rel['param_rel'], rel['bitwise'])}; eager "
                      f"against eager "
                      f"{said(rel['eager_rel'], rel['eager_bitwise'])} "
                      f"(tolerance {GRAPH_PARAM_RTOL})", flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    valid_batches = eval_batches(graphed.valid_iterator.num_examples,
                                 batch_size)
    spe = graphed.train_iterator.num_examples // batch_size
    out["expected"], out["expected_refine"] = recipe_decodes(
        SWAP_ARMS * spe + len(SWAP_BLOCKS) * steps,
        (SWAP_ARMS + 1) * valid_batches, 0, REFINE_ITERS)
    out["scores"] = scores
    out["score_rel"] = max(abs(a - b) / abs(b)
                           for a, b in zip(scores[0], scores[1]))
    out["graph_stats"] = graphed.graph_stats()
    print(f"recipe swaps: st_decode launches, fused / eager "
          f"{out['launches'][0]} / {out['launches'][1]} (expected "
          f"{out['expected']}: {SWAP_ARMS} arms of {spe} steps, "
          f"{len(SWAP_BLOCKS)} x {steps} steps, {SWAP_ARMS + 1} valid evals "
          f"of {valid_batches} batches), of them in the refinement "
          f"{out['refine_launches'][0]} / {out['refine_launches'][1]} "
          f"(expected {out['expected_refine']}); arms' and trigger's valid "
          f"recons, fused {scores[0]}, eager {scores[1]}, second eager "
          f"{scores[2]} (fused against eager {out['score_rel']:.3e}); "
          f"graphs "
          f"{out['graph_stats']}", flush=True)
    if any(r["param_rel"] > GRAPH_PARAM_RTOL
           for r in out["blocks"].values()):
        raise AssertionError("the graphed step disagrees with the eager one "
                             "across the recipe's state changes")
    if (out["launches"] != [out["expected"]] * 2
            or out["refine_launches"] != [out["expected_refine"]] * 2):
        raise AssertionError("the recipe's state changes did not decode "
                             "through the kernel on every decode")
    if out["score_rel"] > GRAPH_PARAM_RTOL:
        raise AssertionError("the fused evals' scores differ from the "
                             "eager ones")
    return out


def graphed_step_ms(trainer, batch_size=100, steps=10, runs=5):
    """Median time of a graphed step (ms): runs of `steps` steps in one
    chunk each, timed on the host around the chunk and a synchronize, after
    a warm-up chunk that captures. Returns (ms, replays a step, decoder
    launches a step)."""
    import numpy as np
    import torch
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    n = trainer.train_iterator.num_examples
    rs = np.random.RandomState(1)
    times = []
    for run in range(runs + 1):
        feed_indices(trainer, [rs.choice(n, batch_size, replace=False)
                               for _ in range(steps)])
        replays0 = sum(r for r, _ in trainer.graph_stats().values())
        launches0 = sd.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_chunk(batch_size, steps)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3 / steps
        release(trainer)
        if run:
            times.append(dt)
    replays = sum(r for r, _ in trainer.graph_stats().values()) - replays0
    return statistics.median(times), replays / steps, \
        (sd.LAUNCHES - launches0) / steps


def graph(eager_spring_ms, batch_size=100):
    """The graph phase, for each configuration of GRAPH_CONFIGS: graphed
    against eager (parameters after 10 steps, beside two eager runs' own
    difference, and an eval epoch), then the median graphed and eager
    step, replays and launches counted; and the main path's matrix FLOPs
    a step and their rate in the graphed step."""
    from paig_reproduction_tpu_torch.utils.flops import step_flops

    steps = {}
    for name, argv in GRAPH_CONFIGS.items():
        task = argv[0].split("=")[1]
        data_dir = (generated_dir(task) if TASK_RUNS.get(task, {}).get(
            "generate") else DATA_DIR)
        print(f"{name}:")
        steps[name] = graph_vs_eager(argv, data_dir, batch_size=batch_size)
        trainer = make_trainer(argv, data_dir, batch_size)
        with fused_env(None):
            ms, replays, launches = graphed_step_ms(trainer, batch_size)
        if replays != 1 or launches != 2:
            raise AssertionError(f"{name}: {replays} replays and {launches} "
                                 f"decoder launches a graphed step, "
                                 f"expected 1 and 2")
        eager = (eager_spring_ms if name == "spring_color"
                 else step_ms(trainer, batch_size))
        steps[name].update(graphed_ms=ms, eager_ms=eager,
                           replays_per_step=replays,
                           launches_per_step=launches)
        print(f"{name}: graphed step {ms:.3f} ms, eager {eager:.3f} ms "
              f"(x{eager / ms:.2f}); {replays:.0f} replay and "
              f"{launches:.0f} decoder launches a step")
        if name == "spring_color":
            flops = step_flops(trainer.model, batch_size)
            steps[name]["flops"] = flops
            print(f"spring_color matrix FLOPs a step (utils/flops.py): "
                  f"{flops}; {flops / ms / 1e9:.3f} TFLOP/s in the graphed "
                  f"step")
        del trainer
    return dict(param_rel=max(v["param_rel"] for v in steps.values()),
                bitwise=all(v["bitwise"] for v in steps.values()),
                eval_rel=max(v["eval_rel"] for v in steps.values()),
                steps=steps)


def native_loader(batch_size=100, epochs=2):
    """The main path's command with --native_loader through the CLI entry,
    first under PAIG_FUSED=0, where the loader feeds the step: finite,
    falling losses; the steps' batches equal the port's loader's at the
    run's seed; every decode counted, replays included. Then with the fused
    path on, where the JAX trainer builds no loader: the log says FUSED_ON,
    no batch comes from the loader and every decode is counted. Returns the
    phase's numbers."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.data import native
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    base = tempfile.mkdtemp(prefix="paig_native_")
    seen = []
    into = native.NativeBatcher.next_batch_into

    def recorded(self, dst, rows=slice(None)):
        into(self, dst, rows)
        seen.append(dst.clone())

    def run(name, fused):
        save_dir = os.path.join(base, name)
        argv = TRAIN_ARGS + [f"--batch_size={batch_size}",
                             f"--epochs={epochs}", f"--data_dir={DATA_DIR}",
                             f"--save_dir={save_dir}", "--native_loader"]
        seen.clear()
        native.NativeBatcher.next_batch_into = recorded
        try:
            with cli_run(), fused_env(fused):
                sd.LAUNCHES = 0
                t0 = time.perf_counter()
                trainer, test_trainer = cli.main(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = sd.LAUNCHES
        finally:
            native.NativeBatcher.next_batch_into = into
        log_path = os.path.join(save_dir, "log.txt")
        train_losses, eval_losses, _ = read_log(log_path)
        if not all(math.isfinite(v) for v in train_losses + eval_losses):
            raise AssertionError(f"a logged loss of the {name} run is not "
                                 f"finite")
        if not train_losses[-1] < train_losses[0]:
            raise AssertionError(f"the {name} run's last train_loss is not "
                                 f"below the first")
        needed = expected_launches(
            trainer.step, trainer.valid_iterator.num_examples,
            trainer.test_iterator.num_examples,
            test_trainer.test_iterator.num_examples, batch_size, epochs)
        print(f"--native_loader ({name}): {seconds:.3f} s wall, "
              f"{trainer.step} steps, train losses {train_losses[0]:.4f} -> "
              f"{train_losses[-1]:.4f}; {len(seen)} batches from the "
              f"loader; st_decode launches {launches} (expected {needed})")
        if launches != needed:
            raise AssertionError(f"the {name} run did not decode through "
                                 f"the kernel on every decode")
        return trainer, log_path, launches, seconds

    trainer, log_path, launches, seconds = run("PAIG_FUSED=0", "0")
    check_fused_line(log_path, "fused step: off (PAIG_FUSED=0)")
    ref = native.NativeBatcher(trainer.train_iterator.raw_uint8, batch_size,
                               seed=trainer.seed)
    same = all(torch.equal(b.cpu(), torch.from_numpy(ref.next_batch_x()))
               for b in seen)
    ref.close()
    print(f"{len(seen)} batches equal to NativeBatcher(seed={trainer.seed})"
          f"'s: {same}")
    if not same or len(seen) != trainer.step:
        raise AssertionError("the steps' batches are not the loader's")

    _, log_path, fused_launches, fused_seconds = run("fused", None)
    check_fused_line(log_path)
    with open(log_path) as f:
        built = "using native C++ prefetching loader" in f.read()
    if seen or built:
        raise AssertionError("the fused run built the native loader")
    return dict(launches=launches, seconds=seconds,
                fused_launches=fused_launches, fused_seconds=fused_seconds)


# One process of the parallel phase (PARALLEL_ARGS at B=100 on the tracked
# file, weights from seed 0), rank 0 saving to $OUT. MODE=grads: the losses
# and gradients of one forward and backward on its rows of a global batch,
# every split tensor made whole; outside a group, EMULATE=dp or tp computes
# the 2 ranks' work in this one process (see PARALLEL_ARGS). MODE=steps: 10
# train steps as the trainer runs them (graphed where its predicate admits
# it) and the whole parameters after them.
PARALLEL_WORKER = r"""
import functools, os, sys
import numpy as np
import torch
import torch.nn.functional as F
sys.path.insert(0, os.environ["PAIG_REPO"])
from paig_reproduction_tpu_torch import cli
from paig_reproduction_tpu_torch.data.iterators import gather_batch
from paig_reproduction_tpu_torch.data.iterators import get_iterators
from paig_reproduction_tpu_torch.parallel.distributed import init_distributed
from paig_reproduction_tpu_torch.parallel.mesh import make_mesh, split_dims
from paig_reproduction_tpu_torch.train.trainer import EVAL_KEYS, Trainer
from paig_reproduction_tpu_torch.utils.misc import use_full_f32


def emulated_split(dim, n, layer, x):
    # The n model ranks' partial products of a kernel split on its input
    # dim, added in rank order, or their output columns concatenated.
    dt = layer.compute_dtype or x.dtype
    if dim == 1:
        per = layer.weight.shape[1] // n
        y = None
        for r in range(n):
            part = F.linear(x.narrow(-1, r * per, per).to(dt),
                            layer.weight.narrow(1, r * per, per)
                            .contiguous().to(dt))
            y = part if y is None else y + part
    else:
        per = layer.weight.shape[0] // n
        y = torch.cat([F.linear(x.to(dt), layer.weight.narrow(
            0, r * per, per).to(dt)) for r in range(n)], dim=-1)
    return y + layer.bias.to(dt)


use_full_f32()
torch.backends.cudnn.deterministic = True
args = cli.build_parser().parse_args(sys.argv[1:])
B = int(os.environ.get("BATCH", "100"))
grads_mode = os.environ["MODE"] == "grads"
emulate = os.environ.get("EMULATE", "")
pid = init_distributed(device=args.device,
                       backend=os.environ.get("BACKEND") or None)
m = make_mesh(int(os.environ["N_MODEL"]))
t = Trainer(cli.build_model(args, 12), device=args.device, mesh=m)
t.get_data(get_iterators(os.path.join(
    args.data_dir, cli.TASK_TABLE[args.task][0]), conv=True))
t.build_optimizer(args.base_lr)
rs = np.random.RandomState(0)
n = t.train_iterator.num_examples
idxs = np.stack([rs.choice(n, B, replace=False) for _ in range(11)])
out = {"split": np.array(sorted(t._split))}
reason = t.fused_off_reason(B)
if grads_mode:
    t._fill_scalars(0)
    data = t._split_u8("train")
    if emulate == "tp":
        modules = dict(t.model.named_modules())
        for name, dim in split_dims(t.model, 2).items():
            modules[name.rsplit(".", 1)[0]].tp_forward = functools.partial(
                emulated_split, dim, 2)
        out["split"] = np.array(sorted(split_dims(t.model, 2)))
    if emulate == "dp":
        losses, grads = [], []
        for half in (idxs[0][:B // 2], idxs[0][B // 2:]):
            loss, ev = t._losses(gather_batch(data, half), t.train_net,
                                 aux_scale=t._scalars[1])
            t.optimizer.zero_grad(set_to_none=True)
            (loss * 0.5).backward()
            losses.append(torch.stack([ev[k] for k in EVAL_KEYS] + [loss]))
            grads.append({k: p.grad.clone()
                          for k, p in t.model.named_parameters()
                          if p.grad is not None})
        out["losses"] = ((losses[0] + losses[1]) / 2).detach().cpu().numpy()
        out.update({"g/" + k: (g + grads[1][k]).cpu().numpy()
                    for k, g in grads[0].items()})
    else:
        batch = gather_batch(data, idxs[0][m.rows(B)])
        out["losses"] = t._forward_backward(batch).cpu().numpy()
        out.update({"g/" + k: t._whole(k, p.grad).cpu().numpy()
                    for k, p in t.model.named_parameters()
                    if p.grad is not None})
else:
    if reason is None:
        rows = iter(idxs[1:])
        t.train_iterator.next_index_batches = lambda b, k: np.stack(
            [next(rows) for _ in range(k)])
        k, losses = t.train_chunk(B, 10)
        out["losses"] = losses[-1].cpu().numpy()
    else:
        for idx in idxs[1:]:
            losses = t.train_step(idx)
        out["losses"] = torch.stack(list(losses.values())).cpu().numpy()
    out["graphs"] = np.array(len(t._graphs))
    out.update({"p/" + k: t._whole(k, p.detach()).cpu().numpy()
                for k, p in t.model.named_parameters()})
if pid == 0:
    np.savez(os.environ["OUT"], **out)
print("rank", pid, os.environ["MODE"], emulate or "", "fused step:",
      "on" if reason is None else f"off ({reason})",
      "graphs", t.graph_stats(), flush=True)
"""


def parallel_errors(ref, got):
    """How far a parallel run's results `got` are from one process's `ref`
    (dicts of the worker's arrays): the losses' largest relative
    difference; with gradients, their largest difference over the largest
    gradient and the same over the split kernels alone (None without);
    with parameters, their largest difference relative to each tensor's
    largest value."""
    import numpy as np
    out = {"loss_rel": float(np.max(np.abs(got["losses"] - ref["losses"])
                                    / np.abs(ref["losses"])))}
    for prefix in ("g/", "p/"):
        names = [k for k in ref if k.startswith(prefix)]
        if sorted(names) != sorted(k for k in got if k.startswith(prefix)):
            raise AssertionError("the runs have different parameters")
    grads = [k for k in ref if k.startswith("g/")]
    if grads:
        def over_largest(names):
            largest = max(np.abs(ref[k]).max() for k in names)
            return float(max(np.abs(got[k] - ref[k]).max() for k in names)
                         / largest)
        split = ["g/" + k for k in got["split"]]
        out["grad"] = over_largest(grads)
        out["split_grad"] = over_largest(split) if split else None
    params = [k for k in ref if k.startswith("p/")]
    if params:
        out["param_rel"] = max(float(np.abs(got[k] - ref[k]).max()
                                     / max(np.abs(ref[k]).max(), 1e-30))
                               for k in params)
    return out


def run_ranks(mode, n, n_model, out, backend=None, fused=None, emulate="",
              extra=(), env_extra=None, timeout=300):
    """PARALLEL_WORKER in MODE `mode` in `n` processes (without the PAIG_*
    variables when `n` is 0: one process outside any group, emulating the
    ranks with `emulate`), with `extra` flags after PARALLEL_ARGS. Returns
    their outputs."""
    return finish_ranks(start_ranks(mode, n, n_model, out, backend, fused,
                                    emulate, extra, env_extra), timeout)


def start_ranks(mode, n, n_model, out, backend=None, fused=None, emulate="",
                extra=(), env_extra=None):
    """``run_ranks``' processes, started; ``finish_ranks`` waits for
    them."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(max(n, 1)):
        env = {k: v for k, v in os.environ.items()
               if k not in ("PAIG_COORDINATOR", "PAIG_NUM_PROCESSES",
                            "PAIG_PROCESS_ID", "PAIG_FUSED")}
        env.update(PAIG_REPO=REPO, OUT=out, N_MODEL=str(n_model),
                   BACKEND=backend or "", MODE=mode, EMULATE=emulate,
                   **(env_extra or {}))
        if fused is not None:
            env["PAIG_FUSED"] = fused
        if n:
            env.update(PAIG_COORDINATOR=f"localhost:{port}",
                       PAIG_NUM_PROCESSES=str(n), PAIG_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PARALLEL_WORKER, *PARALLEL_ARGS,
             f"--data_dir={DATA_DIR}", *extra], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def finish_ranks(procs, timeout=300):
    """The outputs of ``start_ranks``' processes, once they have ended."""
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        if p.returncode:
            raise RuntimeError(f"a parallel worker failed:\n{log[-4000:]}")
    return [line for log in logs for line in log.splitlines()
            if line.startswith("rank ")]


def parallel():
    """DP and TP (--n_model_shards=2) in 2 processes against 1 process on
    the same global batch that computes the ranks' work and adds it in the
    same order (PARALLEL_ARGS): NCCL with a card each where there are 2 or
    more; on one card, gloo on CUDA tensors (eager: gloo's collectives
    cannot be captured), and a 1-process NCCL group through the graphed
    step against one process's eager steps. Returns the phase's
    numbers."""
    import numpy as np
    import torch

    base = tempfile.mkdtemp(prefix="paig_parallel_")

    def path(name):
        return os.path.join(base, name + ".npz")

    def load(name):
        return dict(np.load(path(name)))

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    print(f"{cards} card(s): 2 ranks over {backend}")
    results = {"backend": backend, "cards": cards}
    # Each group beside its one process (the pairs share the card; cuDNN
    # picks its algorithms by heuristics, not by timing them, so sharing
    # changes no result).
    for name, n_model in (("dp", 1), ("tp", 2)):
        one = start_ranks("grads", 0, 1, path("one_" + name), emulate=name)
        two = start_ranks("grads", 2, n_model, path(name), backend=backend)
        print(finish_ranks(one))
        print(finish_ranks(two))
        ref, got = load("one_" + name), load(name)
        errors = parallel_errors(ref, got)
        results[name] = errors
        print(f"{name}, 2 {backend} ranks against 1 process: "
              f"{errors}; split: {list(got['split'])}")
        if not (errors["loss_rel"] <= PARALLEL_LOSS_RTOL
                and errors["grad"] <= PARALLEL_GRAD_TOL
                and (errors["split_grad"] or 0.0) <= PARALLEL_GRAD_TOL):
            raise AssertionError(f"{name} disagrees with one process")
        if list(got["split"]) != list(ref["split"]) or (
                n_model == 2 and not len(got["split"])):
            raise AssertionError(f"{name} split other kernels than the "
                                 f"one process: {list(got['split'])}")
    if cards < 2:
        one = start_ranks("steps", 0, 1, path("one_steps"), fused="0")
        nccl = start_ranks("steps", 1, 1, path("nccl1"), backend="nccl")
        print(finish_ranks(one))
        print(finish_ranks(nccl))
        got = load("nccl1")
        errors = parallel_errors(load("one_steps"), got)
        results["nccl_1_rank_graphed"] = errors
        print(f"1-rank NCCL group, graphed, against 1 process eager "
              f"(10 steps): {errors}; {int(got['graphs'])} "
              f"graph(s)")
        if not (int(got["graphs"]) >= 1
                and errors["param_rel"] <= GRAPH_PARAM_RTOL
                and errors["loss_rel"] <= PARALLEL_LOSS_RTOL):
            raise AssertionError("the graphed 1-rank NCCL step disagrees")
    return results


def generated_dir(task):
    """The directory of a task's generated files, named by its sizes."""
    (n_train, n_valid, n_test), n_test30 = TASK_RUNS[task]["generate"]
    return os.path.join(GENERATED_DIR,
                        f"n{n_train}-{n_valid}-{n_test}_t{n_test30}")


def start_generation():
    """Starts data/generate.py, one process a task, for every task of
    TASK_RUNS whose files are not tracked and not generated yet. Returns
    {task: (process, start time)}."""
    from paig_reproduction_tpu_torch import cli
    procs = {}
    for task, run in TASK_RUNS.items():
        if run["generate"] is None:
            continue
        out = generated_dir(task)
        if all(os.path.exists(os.path.join(out, rel))
               for rel in cli.TASK_TABLE[task][:2]):
            continue
        (n_train, n_valid, n_test), n_test30 = run["generate"]
        procs[task] = (subprocess.Popen(
            [sys.executable, "-m", "paig_reproduction_tpu_torch.data.generate",
             f"--task={task}", f"--out_dir={out}", f"--train={n_train}",
             f"--valid={n_valid}", f"--test={n_test}", "--test_train=0",
             "--test_valid=0", f"--test_test={n_test30}"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), time.perf_counter())
    # A phase that fails before finish_generation leaves none running.
    atexit.register(lambda: [p.kill() for p, _ in procs.values()
                             if p.poll() is None])
    return procs


def finish_generation(procs):
    """Waits for the generators and prints their times."""
    for task, run in TASK_RUNS.items():
        if run["generate"] is None:
            continue
        if task not in procs:
            print(f"{task}: generated files found in {generated_dir(task)}")
            continue
        proc, t0 = procs[task]
        log, _ = proc.communicate()
        waited = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"generating {task} failed:\n{log}")
        # The generator's own times of each file (the wait above also
        # holds the phases that ran beside it).
        for line in log.splitlines():
            if " sequences of " in line:
                print(f"{task}: generated {line.split('] ', 1)[1]}")
        print(f"{task}: generation ended by {waited:.1f} s after the "
              f"script started it")


def task_argv(task, data_dir, save_dir, batch_size=100):
    run = TASK_RUNS[task]
    return ([f"--task={task}", "--print_interval=1", "--device=cuda",
             f"--epochs={run['epochs']}", f"--batch_size={batch_size}",
             f"--data_dir={data_dir}", f"--save_dir={save_dir}"]
            + run["flags"] + run["extra"])


def refine_iters(argv):
    """Gauss-Newton refinement iterations of a model built from argv: the
    reconstructions' (every encoded frame), else the input window's."""
    flags = dict(a[2:].split("=", 1) for a in argv if "=" in a)
    recons = int(flags.get("refine_recons_pos", 0))
    return recons or int(flags.get("refine_enc_pos", 0))


def run_task(task, data_dir, batch_size=100):
    """One task through the CLI entry: train, evals, checkpoint, the long
    test phase and the artifacts, every decode counted. Returns the
    phase's numbers."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    run = TASK_RUNS[task]
    save_dir = os.path.join(tempfile.mkdtemp(prefix=f"paig_{task}_"), "run")
    argv = task_argv(task, data_dir, save_dir, batch_size)
    with cli_run():
        sd.LAUNCHES = 0
        t0 = time.perf_counter()
        trainer, test_trainer = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = sd.LAUNCHES

    log_path = os.path.join(save_dir, "log.txt")
    check_fused_line(log_path)
    train_losses, eval_losses, test_long = read_log(log_path)
    print(f"{task}: train losses first {train_losses[0]:.4f}, last "
          f"{train_losses[-1]:.4f} over {len(train_losses)} steps; seq-"
          f"{test_trainer.model.seq_len} test phase {test_long}")
    if test_long is None or not all(math.isfinite(v)
                                    for v in test_long.values()):
        raise AssertionError(f"{task}: no finite 'test - epoch=0' line")
    if not all(math.isfinite(v) for v in train_losses + eval_losses):
        raise AssertionError(f"{task}: a logged loss is not finite")
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError(f"{task}: the last train_loss is not below the "
                             f"first")
    spe = trainer.train_iterator.num_examples // batch_size
    if trainer.step != run["epochs"] * spe:
        raise AssertionError(f"{task}: unexpected step count {trainer.step}")
    if test_trainer.step != trainer.step:
        raise AssertionError(f"{task}: the test phase did not restore the "
                             f"run's checkpoint")
    iters = refine_iters(argv)
    counts = recipe_counts(
        log_path, arms=0, arm_epochs=0, loop_epochs=run["epochs"],
        steps_per_epoch=spe,
        valid_batches=eval_batches(trainer.valid_iterator.num_examples,
                                   batch_size),
        test_batches=eval_batches(trainer.test_iterator.num_examples,
                                  batch_size),
        test30_batches=eval_batches(
            test_trainer.test_iterator.num_examples, batch_size))
    needed, _ = recipe_decodes(*counts, iters)
    print(f"{task}: {seconds:.3f} s wall; st_decode launches {launches} "
          f"(expected {needed}: {counts[0]} train steps, {counts[1]} eval "
          f"batches, {counts[2]} other forwards, {iters} refinement "
          f"iterations a forward with the enhancers)")
    if launches != needed:
        raise AssertionError(f"{task} did not decode through the kernel on "
                             f"every decode")
    check_artifacts(save_dir)
    step = step_ms(trainer, batch_size)
    print(f"{task}: median train step {step:.2f} ms at B={batch_size}")
    return dict(launches=launches, seconds=seconds, step_ms=step,
                train_sequences=trainer.train_iterator.num_examples,
                test_sequences=test_trainer.test_iterator.num_examples,
                save_dir=save_dir)


def echoed(fn, *args):
    """Calls fn(*args), printing what it prints as it would and also
    returning it: (fn's result, its printed text)."""
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            result = fn(*args)
    finally:
        print(buf.getvalue(), end="", flush=True)
    return result, buf.getvalue()


@contextmanager
def stage(name, stages):
    """One stage of the pipeline phase: the kernel's launch count set to 0
    before it and read after it, with its wall seconds, into
    ``stages[name]``, and printed."""
    import torch
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd
    sd.LAUNCHES = 0
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    stages[name] = dict(seconds=time.perf_counter() - t0,
                        launches=sd.LAUNCHES)
    print(f"pipeline stage {name}: {stages[name]['seconds']:.3f} s wall, "
          f"st_decode launches {stages[name]['launches']}", flush=True)


def valid_recons(log_path):
    """{epoch: eval_recons_loss} of a run's ``valid - epoch=`` lines."""
    out = {}
    with open(log_path) as f:
        for line in f:
            m = re.search(r"valid - epoch=(\d+) .*eval_recons_loss=(\S+)",
                          line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out


def fit_lines(printed):
    """The numbers fit_physics printed: the offsets and, per fit
    (``pointwise``, ``trajectory``), its parameters by name."""
    m = re.search(r"offsets \(image px, per object x,y\): \[([^\]]*)\]",
                  printed)
    out = {"offsets": [float(v) for v in m.group(1).split()]}
    for kind in ("pointwise", "trajectory"):
        m = re.search(rf"{kind} spring fit: k=(\S+) equil=(\S+) ", printed)
        out[kind] = {"k": float(m.group(1)), "equil": float(m.group(2))}
    return out


def slot_separation(enc_pos):
    """Mean distance (px) between the two objects' encoded positions,
    ``enc_pos`` [..., 4] object-major."""
    import numpy as np
    p = enc_pos.reshape(-1, 2, 2)
    return float(np.linalg.norm(p[:, 0] - p[:, 1], axis=-1).mean())


def unet_moved(model, seed):
    """How many of ``model``'s ShallowUNet parameter tensors differ from
    their initial values at ``seed`` (the JAX package's initial weights,
    as the CLI's ``--seed`` and seed_sweep draw them): 0 where no gradient
    reached the UNet."""
    import torch

    from paig_reproduction_tpu_torch import cli
    args = cli.build_parser().parse_args(
        [a for a in TRAIN_ARGS if a != "--device=cuda"]
        + ["--device=cpu", f"--seed={seed}"])
    initial = dict(cli.build_model(args, 12).encoder.unet.named_parameters())
    return sum(not torch.equal(p.detach().cpu(), initial[name])
               for name, p in model.encoder.unet.named_parameters())


def tool_launches(n_batches, forwards_with_extras=1):
    """Decoder launches of fit_physics: two decodes (reconstructions and
    rollout) per encoded batch and per forward with extras (whose extras
    take the plain decode)."""
    return 2 * (n_batches + forwards_with_extras)


def analyze_tail_launches(n, batch):
    """Decoder launches of analyze_tail over n sequences: per batch the
    model's two decodes and the all-frames encoder model's two."""
    return 4 * -(-n // batch)


def sweep_launches(steps, valid_n, test_n, batch_size, epochs):
    """Decoder launches of one seed_sweep seed (debug: no eval before
    training; a valid eval every epoch at 1 or 2 epochs): two decodes per
    train step, per eval batch and per visualization forward after each
    valid and the test eval."""
    evals = (epochs * eval_batches(valid_n, batch_size)
             + eval_batches(test_n, batch_size))
    return 2 * (steps + evals + epochs + 1)


def cli_phase(argv):
    """One CLI run inside the pipeline: (trainer, test trainer, its
    save_dir's log.txt), the log's losses finite and its train step the
    graphed one."""
    from paig_reproduction_tpu_torch import cli
    with cli_run():
        trainer, test_trainer = cli.main(argv)
    log_path = os.path.join(trainer.save_dir, "log.txt")
    check_fused_line(log_path)
    train_losses, eval_losses, _ = read_log(log_path)
    if not all(math.isfinite(v) for v in train_losses + eval_losses):
        raise AssertionError(f"a logged loss of {argv} is not finite")
    return trainer, test_trainer, log_path


def pipeline(bp_dir, batch_size=100):
    """docs/TRAINING.md's pipeline through the port's tools on the card
    (phase 16 of the module docstring); `bp_dir` holds the tasks phase's
    3bp_color checkpoint. Returns {stage: {seconds, launches}}."""
    import logging

    import numpy as np
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.data.iterators import get_iterators
    from paig_reproduction_tpu_torch.tools import (
        analyze_tail,
        fit_physics,
        seed_sweep,
        slot_rescue,
    )
    from paig_reproduction_tpu_torch.train import surgery
    from paig_reproduction_tpu_torch.train.checkpoint import load_checkpoint
    from paig_reproduction_tpu_torch.train.trainer import Trainer

    base = tempfile.mkdtemp(prefix="paig_pipeline_")
    stages = {}
    sl30 = os.path.join(DATA_DIR, cli.TASK_TABLE["spring_color"][1])

    # 1. Discovery: the main path's command for PIPELINE_EPOCHS epochs.
    disc = os.path.join(base, "discovery")
    with stage("discovery", stages):
        trainer, test_trainer, log_path = cli_phase(TRAIN_ARGS + [
            f"--batch_size={batch_size}", f"--epochs={PIPELINE_EPOCHS}",
            f"--data_dir={DATA_DIR}", f"--save_dir={disc}",
            f"--eval_every_n_epochs={DISCOVERY_EVAL_EVERY}",
            f"--seed={DISCOVERY_SEED}"])
    recons = valid_recons(log_path)
    print("discovery valid recons by epoch: " + ", ".join(
        f"{e}: {r:.3f}" for e, r in sorted(recons.items())))
    if not recons[PIPELINE_EPOCHS] < recons[0]:
        raise AssertionError("the discovery run's valid recons did not "
                             "fall")
    needed = expected_launches(
        trainer.step, trainer.valid_iterator.num_examples,
        trainer.test_iterator.num_examples,
        test_trainer.test_iterator.num_examples, batch_size,
        PIPELINE_EPOCHS, eval_every=DISCOVERY_EVAL_EVERY)
    if stages["discovery"]["launches"] != needed:
        raise AssertionError(f"discovery: {stages['discovery']['launches']} "
                             f"launches, expected {needed}")
    del trainer, test_trainer

    # 2. fit_physics --write on the card.
    with stage("fit_physics", stages):
        fitted, printed = echoed(fit_physics.main, [
            "--task=spring_color", f"--ckpt_dir={disc}",
            f"--data_dir={DATA_DIR}", "--write", "--device=cuda"])
    fits = fit_lines(printed)
    numbers = [v for kind in ("pointwise", "trajectory")
               for v in fits[kind].values()] + fits["offsets"]
    if not all(math.isfinite(v) for v in numbers) or not all(
            np.all(np.isfinite(v)) for v in fitted.values()):
        raise AssertionError(f"a fit is not finite (the objects have not "
                             f"separated?): {fits}")
    written = load_checkpoint(disc)["model"]
    for name, value in fitted.items():
        if not np.array_equal(written[name].numpy(), value):
            raise AssertionError(f"the checkpoint's {name} is not the "
                                 f"fitted value")
    traj = fits["trajectory"]
    for name, key in (("log_k", "k"), ("log_equil", "equil")):
        if not abs(math.exp(float(fitted[name])) - traj[key]) <= (
                5e-5 + 1e-6 * traj[key]):
            raise AssertionError(f"the checkpoint's {name} is not the "
                                 f"printed {key}={traj[key]}")
    if not np.abs(fitted["frame_offset"] - np.asarray(
            fits["offsets"])).max() <= 0.005 + 1e-6:
        raise AssertionError("the checkpoint's frame_offset is not the "
                             "printed offsets")
    needed = tool_launches(8)
    if stages["fit_physics"]["launches"] != needed:
        raise AssertionError(f"fit_physics: "
                             f"{stages['fit_physics']['launches']} "
                             f"launches, expected {needed}")
    # The card's encoder positions against the CPU's (not counted).
    batch = get_iterators(os.path.join(
        DATA_DIR, cli.TASK_TABLE["spring_color"][0]),
        conv=True)[0].X[:batch_size]
    pos = {}
    for device in ("cuda", "cpu"):
        model, _ = fit_physics.restore_model("spring_color", disc, device)
        with torch.no_grad():
            pos[device] = model(torch.from_numpy(batch).to(device))[1][
                "enc_pos"].cpu().numpy()
    pos_err = float(np.abs(pos["cuda"] - pos["cpu"]).max())
    print(f"fit_physics: k={traj['k']} equil={traj['equil']} offsets "
          f"{fits['offsets']}; the card's encoder positions against the "
          f"CPU's on {batch_size} train sequences: {pos_err:.3e} px "
          f"(tolerance {PIPELINE_POS_ATOL}); the slots "
          f"{slot_separation(pos['cuda']):.3f} px apart")
    if not pos_err <= PIPELINE_POS_ATOL:
        raise AssertionError("the card's encoder positions differ from the "
                             "CPU's")

    # 3. The aligned resume from the written checkpoint.
    aligned = os.path.join(base, "aligned")
    restored = {}
    init = Trainer.initialize_graph

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if not restored:     # the training phase's trainer restores first
            restored.update({n: getattr(self.model, n).detach().cpu()
                             .numpy().copy() for n in fitted})

    Trainer.initialize_graph = recording
    try:
        with stage("aligned", stages):
            trainer, test_trainer, log_path = cli_phase(TRAIN_ARGS + [
                f"--batch_size={batch_size}", "--epochs=2",
                f"--data_dir={DATA_DIR}", f"--save_dir={aligned}",
                "--use_ckpt", f"--ckpt_dir={disc}", *ALIGN_ARGS])
    finally:
        Trainer.initialize_graph = init
    for name, value in fitted.items():
        if not np.array_equal(restored[name], value):
            raise AssertionError(f"the aligned resume restored {name}="
                                 f"{restored[name]}, not the written "
                                 f"{value}")
    with open(log_path) as f:
        steps = len(re.findall(r"train - iter=", f.read()))
    needed = expected_launches(
        steps, trainer.valid_iterator.num_examples,
        trainer.test_iterator.num_examples,
        test_trainer.test_iterator.num_examples, batch_size, 2)
    print(f"aligned resume: restored {sorted(restored)} as written; "
          f"{steps} steps to step {trainer.step}; st_decode launches "
          f"{stages['aligned']['launches']} (expected {needed})")
    if stages["aligned"]["launches"] != needed:
        raise AssertionError("the aligned resume did not decode through "
                             "the kernel on every decode")
    del trainer, test_trainer

    # 4. analyze_tail on the aligned checkpoint over the sl30 test split.
    with stage("analyze_tail", stages):
        report, printed = echoed(analyze_tail.main, [
            f"--ckpt_dir={aligned}", "--task=spring_color",
            f"--data={sl30}", "--device=cuda",
            f"--out={os.path.join(base, 'tail.npz')}"])
    parsed = json.loads(printed.split("saved arrays ->")[0])
    n = parsed["n_sequences"]
    needed = analyze_tail_launches(n, 50)
    if parsed != report or n != 200:
        raise AssertionError(f"analyze_tail's report: {parsed}")
    if stages["analyze_tail"]["launches"] != needed:
        raise AssertionError(f"analyze_tail: "
                             f"{stages['analyze_tail']['launches']} "
                             f"launches, expected {needed}")

    # 5. slot_rescue on the tasks phase's 3bp_color checkpoint, then a
    # 1-epoch resume with the background frozen.
    rescue = os.path.join(base, "rescue")
    with stage("slot_rescue", stages):
        echoed(slot_rescue.main, [
            f"--ckpt_dir={bp_dir}", f"--out_dir={rescue}",
            "--task=3bp_color", "--rescue_slot=auto",
            "--set_background=median", f"--data_dir={DATA_DIR}"])
    if stages["slot_rescue"]["launches"]:
        raise AssertionError("slot_rescue launched the kernel")
    written = load_checkpoint(rescue)
    if set(written) != {"model", "step"} or written["step"] != 0:
        raise AssertionError(f"slot_rescue wrote {sorted(written)}")
    notices = []
    handler = logging.Handler()
    handler.emit = lambda record: notices.append(record.getMessage())
    logging.getLogger("paig").addHandler(handler)
    argv = (["--task=3bp_color", "--print_interval=1", "--device=cuda",
             "--epochs=1", f"--batch_size={batch_size}",
             f"--data_dir={DATA_DIR}",
             f"--save_dir={os.path.join(base, 'rescued')}"]
            + TASK_RUNS["3bp_color"]["flags"]
            + ["--use_ckpt", f"--ckpt_dir={rescue}", "--bg_lr_mult=0"])
    try:
        with stage("rescue_resume", stages):
            trainer, test_trainer, log_path = cli_phase(argv)
    finally:
        logging.getLogger("paig").removeHandler(handler)
    if not any(m.startswith("checkpoint restore: ") and "not in checkpoint"
               in m for m in notices):
        raise AssertionError("the resume logged no partial-restore notice")
    bg_names = [n for n in written["model"]
                if n.startswith("var_net_background.")]
    frozen = all(torch.equal(trainer.model.state_dict()[n].cpu(),
                             written["model"][n]) for n in bg_names)
    with np.load(os.path.join(DATA_DIR, cli.TASK_TABLE["3bp_color"][0])) as d:
        median = surgery.median_background(d[d.files[0]])
    with torch.no_grad():
        bg = torch.sigmoid(trainer.model.var_net_background()).cpu().numpy()
    bg_err = float(np.abs(bg.reshape(median.shape)
                          - np.clip(median, 1e-3, 1 - 1e-3)).max())
    spe = trainer.train_iterator.num_examples // batch_size
    counts = recipe_counts(
        log_path, arms=0, arm_epochs=0, loop_epochs=1, steps_per_epoch=spe,
        valid_batches=eval_batches(trainer.valid_iterator.num_examples,
                                   batch_size),
        test_batches=eval_batches(trainer.test_iterator.num_examples,
                                  batch_size),
        test30_batches=eval_batches(
            test_trainer.test_iterator.num_examples, batch_size))
    needed, _ = recipe_decodes(*counts, refine_iters(argv))
    print(f"rescue resume (--bg_lr_mult=0): background parameters as "
          f"written: {frozen}; decoded background against the installed "
          f"median: {bg_err:.3e} (tolerance {BACKGROUND_ATOL}); st_decode "
          f"launches {stages['rescue_resume']['launches']} (expected "
          f"{needed})")
    if not frozen or not bg_err <= BACKGROUND_ATOL:
        raise AssertionError("the frozen background moved")
    if stages["rescue_resume"]["launches"] != needed:
        raise AssertionError("the rescue resume did not decode through the "
                             "kernel on every decode")
    del trainer, test_trainer

    # 6. seed_sweep over DEAD_SEED and DISCOVERY_SEED, 1 epoch; its
    # trainers log to their log.txt at INFO, as the CLI's do.
    seeds = (DEAD_SEED, DISCOVERY_SEED)
    sweep = os.path.join(base, "sweep")
    logger = logging.getLogger("paig")
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        with stage("seed_sweep", stages):
            results, printed = echoed(seed_sweep.main, [
                "--task=spring_color", "--seeds", *map(str, seeds),
                "--epochs=1",
                f"--batch_size={batch_size}", f"--data_dir={DATA_DIR}",
                f"--save_root={sweep}",
                f"--out={os.path.join(sweep, 'seed_sweep.json')}",
                "--device=cuda"])
    finally:
        logger.setLevel(level)
    with open(os.path.join(sweep, "seed_sweep.json")) as f:
        saved = json.load(f)
    if sorted(saved) != sorted(map(str, seeds)) or not re.search(
            rf"^best seed: ({DEAD_SEED}|{DISCOVERY_SEED}) -> ", printed,
            re.M):
        raise AssertionError(f"seed_sweep wrote {saved}")
    for seed in seeds:
        check_fused_line(os.path.join(sweep, f"spring_color_seed{seed}",
                                      "log.txt"))
        if not all(math.isfinite(v) for v in saved[str(seed)].values()):
            raise AssertionError(f"seed {seed}: {saved[str(seed)]}")
    with np.load(os.path.join(DATA_DIR,
                              cli.TASK_TABLE["spring_color"][0])) as d:
        n_train, n_valid, n_test = (d[k].shape[0] for k in (
            "train_x", "valid_x", "test_x"))
    needed = 2 * sweep_launches(n_train // batch_size, n_valid, n_test,
                                batch_size, 1)
    if stages["seed_sweep"]["launches"] != needed:
        raise AssertionError(f"seed_sweep: "
                             f"{stages['seed_sweep']['launches']} "
                             f"launches, expected {needed}")
    # Why discovery starts from DISCOVERY_SEED (not counted): no gradient
    # ever reaches DEAD_SEED's UNet, its final ReLU passing no mask logit,
    # so its parameters stay at their initial values and its slots at one
    # position; DISCOVERY_SEED's one live slot takes the UNet's gradient
    # from the first step. Whether that slot is still live after the
    # epoch is the descent's: in both packages' seed_sweep on the CPU,
    # from starts moved by 1e-7, it closed in some runs, its slots then
    # exactly together (tests/seed_sweep_slot_study.py), so their
    # distance is printed, not held.
    apart, moved = {}, {}
    for seed in seeds:
        model, _ = fit_physics.restore_model(
            "spring_color", os.path.join(sweep, f"spring_color_seed{seed}"),
            "cuda")
        with torch.no_grad():
            apart[seed] = slot_separation(model(torch.from_numpy(batch).to(
                "cuda"))[1]["enc_pos"].cpu().numpy())
        moved[seed] = unet_moved(model, seed)
    print(f"seed_sweep: after 1 epoch, seed {DEAD_SEED}'s UNet "
          f"{moved[DEAD_SEED]} parameter tensors moved, its slots "
          f"{apart[DEAD_SEED]:.6f} px apart; seed {DISCOVERY_SEED}'s "
          f"{moved[DISCOVERY_SEED]} moved, its slots "
          f"{apart[DISCOVERY_SEED]:.6f} px apart (mean over {batch_size} "
          f"train sequences)")
    if not (moved[DEAD_SEED] == 0 and apart[DEAD_SEED] == 0
            and moved[DISCOVERY_SEED] > 0):
        raise AssertionError(f"a gradient reached seed {DEAD_SEED}'s UNet, "
                             f"or none seed {DISCOVERY_SEED}'s")
    print("pipeline: " + "; ".join(
        f"{k} {v['seconds']:.3f} s, {v['launches']} launches"
        for k, v in stages.items()))
    return stages


def chain_launches(stage, epochs, n_train, valid_n, test_n, test40_n,
                   batch_size):
    """Decoder launches of one stage of the chain: a training stage's CLI
    run of ``epochs`` (``expected_launches``: its seq-40 phase is the
    seq-30 phase's counterpart) and the runner's reading of the velocity
    head at the stage's start and after each of its saves (a save every
    epoch here; one forward, two decodes, each), none in the surgery (host
    numpy), fit_physics's (``tool_launches``), or a test phase alone: its
    eval batch and visualization forward, two decodes each and a render per
    refinement iteration (``recipe_decodes``), and the runner's reading
    of the state fit at its start (``reference_runs.test_state``: one
    forward of the first test batch)."""
    kind = stage["kind"]
    if kind == "train":
        return expected_launches(epochs * (n_train // batch_size), valid_n,
                                 test_n, test40_n, batch_size,
                                 epochs) + 2 * (epochs + 1)
    if kind == "surgery":
        return 0
    if kind == "fit":
        return tool_launches(8)
    return recipe_decodes(0, eval_batches(test40_n, batch_size), 2,
                          refine_iters(stage["argv"]))[0]


def chain_epochs(curriculum=CHAIN_CURRICULUM, pinned=CHAIN_PINNED):
    """{stage: epochs} of the chain's training stages."""
    out = {f"curriculum_{i}": e for i, e in enumerate(curriculum, 1)}
    out["pinned"] = pinned
    return out


def check_test_state(name, state):
    """Prints a test stage's state-fit reading (``test_state``) and fails
    where it is missing, a number of it is not finite or its accepted
    share lies outside [0, 1]."""
    from paig_reproduction_tpu_torch.tools import reference_runs as rr
    print(f"chain stage {name}: {rr.test_state_line(state)}", flush=True)
    numbers = [] if state is None else [
        v for k, v in state.items() if k != "accepted" and v is not None]
    if (state is None or not all(math.isfinite(v) for v in numbers)
            or not 0.0 <= state["accepted_share"] <= 1.0
            or state["accepted_share"] != (sum(state["accepted"])
                                           / len(state["accepted"]))):
        raise AssertionError(f"chain: {name}'s state-fit reading is "
                             f"missing or out of range: {state}")


def chain(batch_size=100, data_dir=DATA_DIR, device="cuda",
          curriculum=CHAIN_CURRICULUM, pinned=CHAIN_PINNED):
    """3bp_color's chain (phase 17 of the module docstring) through the
    reference runner at cut depth on the tracked files. Returns {stage:
    {seconds, launches}} and the runner's result."""
    import numpy as np
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.tools import reference_runs as rr

    base = tempfile.mkdtemp(prefix="paig_chain_")
    stages = rr.CHAINS[CHAIN]["stages"](curriculum, pinned, batch_size,
                                        save_every=1, eval_every=1)
    out = rr.run_chain(CHAIN, base, device, data_dir, stages=stages)
    sizes = {}
    for i in (0, 1):
        with np.load(os.path.join(data_dir,
                                  cli.TASK_TABLE["3bp_color"][i])) as d:
            sizes[i] = [d[k].shape[0] for k in ("train_x", "valid_x",
                                                "test_x")]
    (n_train, valid_n, test_n), test40_n = sizes[0], sizes[1][2]
    epochs = chain_epochs(curriculum, pinned)
    result = {}
    for stage in stages:
        name = stage["name"]
        row = out["stages"][name]
        needed = chain_launches(stage, epochs.get(name, 0), n_train, valid_n,
                                test_n, test40_n, batch_size)
        result[name] = dict(seconds=row["wall_s"], launches=row["launches"])
        print(f"chain stage {name}: {row['wall_s']:.3f} s wall, st_decode "
              f"launches {row['launches']} (expected {needed})", flush=True)
        if row["launches"] != needed:
            raise AssertionError(f"chain: {name} did not decode through the "
                                 f"kernel on every decode")
        numbers = [v for key in ("valid", "test", "test_seq40")
                   for v in (row.get(key) or {}).values()]
        numbers += [row[k] for k in ("A", "A_pointwise", "A_traj_err")
                    if k in row]
        if not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"chain: {name} has a number that is not "
                                 f"finite: {row}")
        if stage["kind"] == "test":
            if row["test"] is None:
                raise AssertionError(f"chain: {name} logged no test line")
            check_test_state(name, row.get("test_state"))
        if stage["kind"] == "train":
            print(f"chain stage {name}: "
                  f"{rr.velocity_line(row['velocity'])}", flush=True)
            lr = row["first_lr"]
            base_lr = float(rr.flag(stage["argv"], "base_lr"))
            print(f"chain stage {name}: first step's learning rate "
                  + ("not logged" if lr is None else
                     f"{lr[0]:.9g} (optimizer count {lr[1]}, step "
                     f"{lr[2]}); --base_lr {base_lr:g}"), flush=True)
            if lr is None or (name in CHAIN_FRESH_COUNT
                              and (lr[0], lr[1]) != (base_lr, 0)):
                raise AssertionError(f"chain: {name} did not start at "
                                     f"--base_lr at optimizer count 0: "
                                     f"{lr}")
            if row["valid"] is None or row["test_seq40"] is None:
                raise AssertionError(f"chain: {name} logged no valid eval "
                                     f"or no seq-40 test line")
            velocity = row["velocity"] or {}
            if velocity.get("epoch") != epochs[name] or not all(
                    math.isfinite(v) for v in list(np.ravel(
                        velocity["velocities"])) + [
                        velocity["spread"], velocity["grad_norm"]]):
                raise AssertionError(f"chain: {name}'s velocity head was "
                                     f"not read at its end: {velocity}")
            if row["steps"] != epochs[name] * (n_train // batch_size):
                raise AssertionError(f"chain: {name} took {row['steps']} "
                                     f"steps")
            if device == "cuda":
                check_fused_line(os.path.join(base, name, "log.txt"))
    return result, out


def pinned_card_vs_cpu(batch_size=100, data_dir=DATA_DIR, device="cuda"):
    """The chain's all-slot surgery on the tracked ``curriculum_3``
    (``reference_runs.CURRICULUM_3``), then PINNED_STEPS steps of
    3bp_chain's pinned stage from its output on ``device`` (one fused
    chunk: on the card the capture's warm-up step, then graphed steps) and
    the same eager steps of the port on the CPU, on the same index batches.
    Prints the two updates' difference relative to the CPU's update (L2
    over all parameters) beside PINNED_UPDATE_RTOL and the steps' losses'
    beside PINNED_LOSS_RTOL, and fails over either, or where the card's
    decoder launches are not two (reconstructions and rollout) per step.
    Returns {rel, loss_rel, seconds, launches}."""
    import numpy as np
    import torch

    from paig_reproduction_tpu_torch.ops.cuda import st_decoder
    from paig_reproduction_tpu_torch.tools import reference_runs as rr
    from paig_reproduction_tpu_torch.tools import slot_rescue

    t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="paig_pinned_")
    start = os.path.join(base, "surgery")
    echoed(slot_rescue.main, [f"--ckpt_dir={rr.CURRICULUM_3}",
                              f"--out_dir={start}", "--task=3bp_color",
                              f"--data_dir={data_dir}", *rr.SURGERY_FLAGS])
    argv = next(s["argv"] for s in rr.CHAINS["3bp_chain"]["stages"](
        batch_size=batch_size) if s["name"] == "pinned")
    card, cpu = (make_trainer(argv, data_dir, batch_size, device=where)
                 for where in (device, "cpu"))
    for name, t in (("card", card), ("cpu", cpu)):
        t.initialize_graph(os.path.join(base, name), use_ckpt=True,
                           ckpt_dir=start)
    before_steps = [p.detach().clone() for p in cpu.model.parameters()]
    n = cpu.train_iterator.num_examples
    rs = np.random.RandomState(0)
    idxs = np.stack([rs.choice(n, batch_size, replace=False)
                     for _ in range(PINNED_STEPS)])
    cpu_losses = torch.stack([torch.stack(list(cpu.train_step(idx).values()))
                              for idx in idxs])
    before = st_decoder.LAUNCHES
    with fused_env(None if device == "cuda" else "1"):
        if card.fused_off_reason(batch_size) is not None:
            raise AssertionError("the fused step is off: "
                                 + card.fused_off_reason(batch_size))
        feed_indices(card, idxs)
        done, card_losses = card.train_chunk(batch_size, PINNED_STEPS)
        release(card)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = st_decoder.LAUNCHES - before
    needed = 2 * PINNED_STEPS if device == "cuda" else 0
    got = [p.detach().cpu().double() for p in card.model.parameters()]
    want = [p.detach().double() for p in cpu.model.parameters()]
    moved = math.sqrt(sum(float(((w - s.double()) ** 2).sum())
                          for w, s in zip(want, before_steps)))
    rel = math.sqrt(sum(float(((g - w) ** 2).sum())
                        for g, w in zip(got, want))) / moved
    loss_rel = float(((card_losses.cpu() - cpu_losses).abs()
                      / cpu_losses.abs()).max())
    seconds = time.perf_counter() - t0
    print(f"pinned stage from {os.path.relpath(rr.CURRICULUM_3, REPO)} "
          f"after the surgery: {done} steps on {device} (graphs "
          f"{card.graph_stats()}, {launches} decoder launches, expected "
          f"{needed}) against {PINNED_STEPS} eager steps on the CPU: the "
          f"updates' difference {rel:.3e} of the CPU's update (L2 "
          f"{moved:.4f}; tolerance {PINNED_UPDATE_RTOL}); the steps' losses "
          f"{card_losses.cpu().tolist()} against "
          f"{cpu_losses.tolist()}, {loss_rel:.3e} relative (tolerance "
          f"{PINNED_LOSS_RTOL}); {seconds:.3f} s", flush=True)
    if device == "cuda" and card.graph_stats().get(
            ("train", batch_size), (0,))[0] != PINNED_STEPS - 1:
        raise AssertionError("pinned: the step was not graphed")
    if launches != needed:
        raise AssertionError(f"pinned: {launches} decoder launches, "
                             f"expected {needed}")
    if not (done == PINNED_STEPS and rel <= PINNED_UPDATE_RTOL
            and loss_rel <= PINNED_LOSS_RTOL):
        raise AssertionError("pinned: the card's steps disagree with the "
                             "CPU's")
    return dict(rel=rel, loss_rel=loss_rel, seconds=seconds,
                launches=launches)


def kernels_line(launches, max_err, timings, jvp, runs):
    """The contract's ``{"kernels": [...]}`` line: the kernel's launches on
    the main path, its error, its times at the main path's N=1000 and the
    seq-30 N=2600 (``timings`` by shape), the ``jvp`` numbers, the other
    phases' launches (``runs`` by phase: recipe, tasks, lstm, bf16,
    runtime, native, graph, pipeline, chain) and its times at the tasks'
    shapes."""
    main_path = timings[TIMED_SHAPES[0]]
    seq30 = timings[2600, 32, 16, 2, 3]
    gr = runs["graph"]
    return json.dumps({"kernels": [{
        "name": "st_decode",
        "route": "cuda",
        "source": "paig_reproduction_tpu_torch/csrc/st_decoder.cu",
        "replaces": "paig_reproduction_tpu/ops/pallas/st_decoder.py:115",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
        "share_of_bound": main_path["share_of_bound"],
        "store_floor_ms": main_path["store_floor_ms"],
        "seq30_n2600": {k: seq30[k] for k in (
            "ms", "plain_ms", "bound_ms", "share_of_bound",
            "store_floor_ms")},
        "jvp": jvp,
        "recipe_launches": runs["recipe"]["launches"],
        "recipe_refine_launches": runs["recipe"]["refine_launches"],
        "recipe_swaps": {
            "launches": runs["recipe"]["swaps"]["launches"],
            "refine_launches": runs["recipe"]["swaps"]["refine_launches"],
            **{k: v["param_rel"] for k, v in
               runs["recipe"]["swaps"]["blocks"].items()}},
        "task_launches": {t: r["launches"]
                          for t, r in runs["tasks"].items()},
        "lstm_launches": runs["lstm"]["launches"],
        "lstm_proof": {k: runs["lstm"][k] for k in (
            "test", "valid10_pred", "last_pred", "wall_s", "steps",
            "eval_s", "step_ms")},
        "bf16_launches": runs["bf16"]["launches"],
        "bf16_recipe_launches": runs["bf16"]["recipe"]["launches"],
        "runtime_launches": runs["runtime"]["launches"],
        "native_loader_launches": runs["native"]["launches"],
        "native_loader_fused_launches": runs["native"]["fused_launches"],
        "pipeline_launches": {k: v["launches"]
                              for k, v in runs["pipeline"].items()},
        "chain_launches": {k: v["launches"]
                           for k, v in runs["chain"].items()},
        "graph": {"param_rel": gr["param_rel"], "bitwise": gr["bitwise"],
                  "eval_rel": gr["eval_rel"], "steps": gr["steps"]},
        "task_shapes": [dict(
            zip(("n", "img", "tmpl", "objects", "ch"), shape),
            **{k: timings[shape][k] for k in (
                "ms", "plain_ms", "bound_ms", "share_of_bound")})
            for shape in TIMED_SHAPES[3:]],
    }]})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="an earlier st_decoder.cu to time beside the "
                             "kernel")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    from paig_reproduction_tpu_torch.ops.cuda import build
    from paig_reproduction_tpu_torch.utils.misc import use_full_f32

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(smi)
        for module in ("PIL", "matplotlib"):
            found = subprocess.run([sys.executable, "-c", f"import {module}"],
                                   capture_output=True).returncode == 0
            print(f"{module} imports on this machine: {found}")
        kind = torch.cuda.get_device_name(0)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {kind} count {torch.cuda.device_count()}")
        use_full_f32()

    generation = start_generation()

    with phase("build"):
        parent_build = (start_parent_build(os.path.abspath(args.parent))
                        if args.parent else None)
        for name, (seconds, log) in build.build().items():
            print(log.strip())
            print(f"built {name}.cu in {seconds:.2f} s")
        parent = parent_fn(*parent_build) if parent_build else None

    with phase("kernel st_decode"):
        max_err, timings = check_st_decode(parent)

    with phase("kernel st_decode jvp"):
        jvp_err, jvp_rel, jvp_times = check_st_decode_jvp()

    with phase("train"):
        launches, trainer, save_dir, test30 = train()

    with phase("test_mode"):
        seconds = run_test_mode(save_dir, test30)
        print(f"seq-30 test phase alone: {seconds:.3f} s on {smi}")

    with phase("checkpoint"):
        check_checkpoint(trainer, save_dir)

    with phase("step"):
        ms = step_ms(trainer)
        print(f"median train step: {ms:.2f} ms at B=100 on {smi}")

    with phase("recipe"):
        rec = recipe()
        print(f"recipe on {smi}: train step {rec['step_ms']:.2f} ms, eval "
              f"batch {rec['eval_ms']:.2f} ms with the enhancers, "
              f"{rec['eval_plain_ms']:.2f} ms without")
        rec["swaps"] = recipe_swaps_vs_eager(SWAP_ARGS, DATA_DIR)
        print(f"recipe swaps on {smi}: " + "; ".join(
            f"{k} graphed against eager {v['param_rel']:.3e}, eager against "
            f"eager {v['eager_rel']:.3e}" for k, v in
            rec["swaps"]["blocks"].items()))

    with phase("tasks"):
        finish_generation(generation)
        tasks = {}
        for task, run in TASK_RUNS.items():
            data_dir = DATA_DIR if run["generate"] is None else \
                generated_dir(task)
            tasks[task] = run_task(task, data_dir)
        print(f"tasks on {smi}: " + "; ".join(
            f"{t} step {r['step_ms']:.2f} ms, {r['launches']} launches"
            for t, r in tasks.items()))

    with phase("graph"):
        gr = graph(ms)
        print(f"graph on {smi}: " + "; ".join(
            f"{k} graphed {v['graphed_ms']:.3f} ms, eager "
            f"{v['eager_ms']:.3f} ms" for k, v in gr["steps"].items()))

    with phase("native_loader"):
        nat = native_loader()
        print(f"native_loader on {smi}: PAIG_FUSED=0 {nat['seconds']:.3f} "
              f"s, {nat['launches']} launches; fused "
              f"{nat['fused_seconds']:.3f} s, {nat['fused_launches']} "
              f"launches")

    with phase("parallel"):
        par = parallel()
        print(f"parallel on {smi}: {par['cards']} card(s), 2 ranks over "
              f"{par['backend']}; speed across cards is not measured here")

    with phase("lstm"):
        lstm, _ = lstm_proof()
        print(f"lstm on {smi}: {LSTM_PROOF} test pred "
              f"{lstm['test']['pred']:.4f} recons "
              f"{lstm['test']['recons']:.4f} against the JAX log's "
              f"{lstm['log_test']['pred']:.4f} / "
              f"{lstm['log_test']['recons']:.4f}; {lstm['wall_s']:.3f} s "
              f"for {lstm['steps']} steps ({lstm['eval_s']:.3f} s in "
              f"{lstm['evals']} evals); median train step "
              f"{lstm['step_ms']:.2f} ms at B=100, seq-30 phase alone "
              f"{lstm['seq30_s']:.3f} s, {lstm['launches']} launches")

    with phase("bf16"):
        bf16, bf16_trainer = variant(BF16_ARGS)
        bf16["enc_pos_err"] = check_bf16(bf16_trainer)
        del bf16_trainer
        bf16["recipe"] = bf16_recipe()
        print(f"bf16 on {smi}: median train step {bf16['step_ms']:.2f} ms "
              f"against float32's {ms:.2f} ms (step phase), seq-30 phase "
              f"alone {bf16['seq30_s']:.3f} s, {bf16['launches']} launches")

    with phase("runtime"):
        rt = runtime(save_dir)

    with phase("pipeline"):
        pipe = pipeline(tasks["3bp_color"]["save_dir"])
        print(f"pipeline on {smi}: " + "; ".join(
            f"{k} {v['seconds']:.3f} s" for k, v in pipe.items()))

    with phase("chain"):
        ch, _ = chain()
        print(f"chain on {smi}: " + "; ".join(
            f"{k} {v['seconds']:.3f} s, {v['launches']} launches"
            for k, v in ch.items()))
        pinned = pinned_card_vs_cpu()
        print(f"pinned card against CPU on {smi}: updates "
              f"{pinned['rel']:.3e} (tolerance {PINNED_UPDATE_RTOL}), losses "
              f"{pinned['loss_rel']:.3e} (tolerance {PINNED_LOSS_RTOL}), "
              f"{pinned['seconds']:.3f} s")

    print("phase seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in PHASE_SECONDS.items())
        + f"; {sum(PHASE_SECONDS.values()):.2f} in all", flush=True)

    with phase("kernels"):
        print(kernels_line(launches, max_err, timings,
                           dict(primal_max_abs_err=jvp_err,
                                tangent_max_rel_err=jvp_rel, **jvp_times),
                           dict(recipe=rec, tasks=tasks, lstm=lstm,
                                bf16=bf16, runtime=rt, native=nat, graph=gr,
                                pipeline=pipe, chain=ch)))

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
