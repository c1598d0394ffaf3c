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
7. step       - the median host time of a synchronized train step;
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
                enhancers;
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
10. lstm      - the main path's command with the LSTM baseline
                (``--cell_type=lstm``, 100 units, 1 layer:
                benchmarks/lstm_proof_log.txt's defaults) for 2 epochs
                through the CLI entry, with the checkpoint, the seq-30 phase
                and the artifacts: losses finite and falling, the launch
                count exact (every rollout decoded in one call), then
                ``--test_mode`` alone; it prints the median train step and
                the seq-30 phase's wall time;
11. bf16      - the same with ``--compute_dtype=bfloat16``: the median step
                beside the float32 one of the ``step`` phase, the UNet's
                output dtype (a forward hook) and float32 weights and
                optimizer state, and the card's bf16 positions held to the
                same model's on the CPU on one batch (BF16_POS_ATOL);
12. runtime   - ``--watchdog_secs --watchdog_floor_secs --profile_dir
                --debug_nans`` on a 1-epoch run (a trace file and a stopped
                watchdog after it); a subprocess whose train step sleeps
                past a 3 s watchdog must exit with 75; ``--use_ckpt
                --resume_remaining_epochs --epochs=3`` from the ``train``
                phase's 2-epoch checkpoint must train exactly 1 epoch
                (counted in its log.txt);
13. kernels   - one JSON line with every kernel's launches, error, times,
                share of its bound and store-only floor, at the main
                path's N=1000 and at N=2600, the recipe's launches, each
                task's launches, the LSTM, bf16 and runtime runs' launches
                and the kernel at the tasks' shapes.

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
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

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
RECIPE_ARGS = TRAIN_ARGS + [
    "--epochs=4", "--discovery_restarts=2", "--discovery_epochs=1",
    "--discovery_recons_ok=4.0", "--aux_on_recons=1e9", "--fit_physics_every=1", "--auto_rescue=2",
    "--rescue_recons=0", "--max_rescues=1", "--eval_every_n_epochs=1",
    "--pos_consistency=1.0", "--vel_anchor=1.0", "--learn_frame_offset",
    "--init_state_fit=3", f"--refine_recons_pos={REFINE_ITERS}",
    "--enhancers_eval_only", "--save_every_n_epochs=1"]
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
# bf16 positions on the card against the same model's on the CPU: both
# round their bf16 products once after f32 sums, in orders that may differ,
# so a value can land one bf16 step away and move a position by thousandths
# of a pixel (the CPU against the JAX package: at most 3.9e-3 px,
# tests/test_torch_bf16.py; an NVIDIA H100 80GB HBM3 at 700 W against the
# CPU: 1.9e-6 px). Held to 1e-2 px.
BF16_POS_ATOL = 1e-2
# The runtime phase's watchdog timeout for the subprocess that hangs.
HANG_WATCHDOG_SECS = 3
# The tangent's tolerance, relative to its largest value: through the
# kernel's wrapper the tangent is the plain decode's JVP of the same inputs,
# so the two differ only where the card's sums run in another order.
JVP_RTOL = 1e-4


@contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


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


def eval_batches(n, batch_size):
    """Batches of one eval of a split of n sequences: a split under 100 is
    one batch, a larger one its full batches."""
    return 1 if n < 100 else max(1, n // batch_size)


def expected_launches(steps, valid_n, test_n, test30_n, batch_size, epochs):
    """Kernel launches of one CLI run (eval every epoch): two decodes
    (reconstructions and rollout) per train step, per eval batch and per
    visualization forward, which follows every valid and test eval: the
    valid evals before training and after each epoch, the test eval after
    training and the seq-30 phase's test eval."""
    valid_evals = 1 + epochs
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


def train(batch_size=100, epochs=2, extra=()):
    """Drive the port's CLI entry on spring_color with the main path's
    flags and `extra`: train, save, the seq-30 test phase and the
    artifacts. Returns (launch count, the training Trainer, its save_dir,
    the seq-30 losses)."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    save_dir = os.path.join(tempfile.mkdtemp(prefix="paig_smoke_"), "run")
    argv = TRAIN_ARGS + [f"--batch_size={batch_size}", f"--epochs={epochs}",
                         f"--data_dir={DATA_DIR}", f"--save_dir={save_dir}",
                         *extra]
    with cli_run():
        sd.LAUNCHES = 0
        trainer, test_trainer = cli.main(argv)
        torch.cuda.synchronize()
        launches = sd.LAUNCHES

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
    fresh = Trainer(PhysicsNet(**m.config,
                               generator=torch.Generator().manual_seed(1)),
                    device="cuda")
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


def recipe(batch_size=100):
    """The single-command spring recipe through the CLI entry at full
    width, with every hook asserted from log.txt and every decode counted;
    then a resume from its checkpoint. Returns the phase's numbers."""
    import numpy as np
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.data.iterators import gather_batch
    from paig_reproduction_tpu_torch.models import physics_net
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    save_dir = os.path.join(tempfile.mkdtemp(prefix="paig_recipe_"), "run")
    argv = RECIPE_ARGS + [f"--batch_size={batch_size}",
                          f"--data_dir={DATA_DIR}", f"--save_dir={save_dir}"]
    refine = physics_net.refine_positions
    refine_launches = 0

    def counted_refine(*args, **kwargs):
        nonlocal refine_launches
        before = sd.LAUNCHES
        out = refine(*args, **kwargs)
        refine_launches += sd.LAUNCHES - before
        return out

    physics_net.refine_positions = counted_refine
    try:
        with cli_run():
            sd.LAUNCHES = 0
            t0 = time.perf_counter()
            trainer, test_trainer = cli.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = sd.LAUNCHES
    finally:
        physics_net.refine_positions = refine

    log_path = os.path.join(save_dir, "log.txt")
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

    spe = trainer.train_iterator.num_examples // batch_size
    counts = recipe_counts(
        log_path, arms=2, arm_epochs=1, loop_epochs=3, steps_per_epoch=spe,
        valid_batches=eval_batches(trainer.valid_iterator.num_examples,
                                   batch_size),
        test_batches=eval_batches(trainer.test_iterator.num_examples,
                                  batch_size),
        test30_batches=eval_batches(
            test_trainer.test_iterator.num_examples, batch_size))
    needed, needed_refine = recipe_decodes(*counts, REFINE_ITERS)
    print(f"recipe: {seconds:.3f} s wall; st_decode launches {launches} "
          f"(expected {needed}: {counts[0]} train steps, {counts[1]} eval "
          f"batches, {counts[2]} other forwards), of them in the "
          f"Gauss-Newton refinement {refine_launches} (expected "
          f"{needed_refine}); seq-30 phase {test30}")
    if launches != needed or refine_launches != needed_refine:
        raise AssertionError("the recipe did not decode through the kernel "
                             "on every decode")
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


def variant(extra, batch_size=100):
    """The main path's command with `extra` flags through the CLI entry as
    the ``train`` phase drives it (2 epochs, the seq-30 phase, every decode
    counted), then ``--test_mode`` alone and the median train step. Returns
    the phase's numbers and the training Trainer."""
    launches, trainer, save_dir, test30 = train(batch_size, extra=extra)
    seconds = run_test_mode(save_dir, test30, batch_size, extra=extra)
    step = step_ms(trainer, batch_size)
    return dict(launches=launches, step_ms=step, seq30_s=seconds), trainer


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
    HANG_WATCHDOG_SECS watchdog, in a subprocess whose train step sleeps 120
    s. Returns (its exit code, the watchdog's log lines, its seconds)."""
    argv = list(argv) + ["--epochs=1", "--debug",
                         f"--watchdog_secs={HANG_WATCHDOG_SECS}"]
    code = ("import sys, time\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from paig_reproduction_tpu_torch import cli\n"
            "from paig_reproduction_tpu_torch.train.trainer import Trainer\n"
            "Trainer.train_step = lambda self, idx: time.sleep(120)\n"
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
                test_sequences=test_trainer.test_iterator.num_examples)


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

    with phase("lstm"):
        lstm, _ = variant(LSTM_ARGS)
        print(f"lstm on {smi}: median train step {lstm['step_ms']:.2f} ms "
              f"at B=100, seq-30 phase alone {lstm['seq30_s']:.3f} s, "
              f"{lstm['launches']} launches")

    with phase("bf16"):
        bf16, bf16_trainer = variant(BF16_ARGS)
        bf16["enc_pos_err"] = check_bf16(bf16_trainer)
        del bf16_trainer
        print(f"bf16 on {smi}: median train step {bf16['step_ms']:.2f} ms "
              f"against float32's {ms:.2f} ms (step phase), seq-30 phase "
              f"alone {bf16['seq30_s']:.3f} s, {bf16['launches']} launches")

    with phase("runtime"):
        rt = runtime(save_dir)

    with phase("kernels"):
        main_path = timings[TIMED_SHAPES[0]]
        seq30 = timings[2600, 32, 16, 2, 3]
        print(json.dumps({"kernels": [{
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
            "jvp": {"primal_max_abs_err": jvp_err,
                    "tangent_max_rel_err": jvp_rel, **jvp_times},
            "recipe_launches": rec["launches"],
            "recipe_refine_launches": rec["refine_launches"],
            "task_launches": {t: r["launches"] for t, r in tasks.items()},
            "lstm_launches": lstm["launches"],
            "bf16_launches": bf16["launches"],
            "runtime_launches": rt["launches"],
            "task_shapes": [dict(
                zip(("n", "img", "tmpl", "objects", "ch"), shape),
                **{k: timings[shape][k] for k in (
                    "ms", "plain_ms", "bound_ms", "share_of_bound")})
                for shape in TIMED_SHAPES[3:]],
        }]}))

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
