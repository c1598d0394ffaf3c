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
8. kernels    - one JSON line with every kernel's launches, error, times,
                share of its bound and store-only floor, at the main
                path's N=1000 and at N=2600.

With ``--parent OLD/csrc/st_decoder.cu`` (an earlier source of the kernel
whose C entry, ``st_decode_forward``, takes no ``slots`` argument) the
kernel phase also builds that source and times it beside the kernel at
every timed shape, in the order earlier, kernel, kernel, earlier, each held
to the plain version first.

The last line is {"ok": true, "device": {...}}. Any failure raises, and the
script exits non-zero without that line; without a CUDA device it fails at
once. It writes only under a temporary directory.
"""
from __future__ import annotations

import argparse
import ctypes
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


@contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


# (N, img, T, o, ch): the main path's train (N=1000) and eval (N=800)
# decodes at 32/16/2/3, and the seq-30 test phase's 26 rollout frames x
# B=100 (N=2600, several slabs a warp); the other tasks' train decodes at
# B=100 (3bp_color's 16 frames a sequence; 64x64 mnist_spring_color's 10,
# in one and three channels, 64/32/2/3 being the largest block the kernel
# stages); small N of those shapes; and the edges of the persistent grid:
# one frame and an N that the grid does not divide.
TIMED_SHAPES = [(1000, 32, 16, 2, 3), (800, 32, 16, 2, 3),
                (2600, 32, 16, 2, 3), (1600, 36, 18, 3, 3),
                (1000, 64, 32, 2, 1), (1000, 64, 32, 2, 3)]
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


def train(batch_size=100, epochs=2):
    """Drive the port's CLI entry on spring_color: train, save, the seq-30
    test phase and the artifacts. Returns (launch count, the training
    Trainer, its save_dir, the seq-30 losses)."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    save_dir = os.path.join(tempfile.mkdtemp(prefix="paig_smoke_"), "run")
    argv = TRAIN_ARGS + [f"--batch_size={batch_size}", f"--epochs={epochs}",
                         f"--data_dir={DATA_DIR}", f"--save_dir={save_dir}"]
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


def run_test_mode(save_dir, test30, batch_size=100):
    """``--test_mode --ckpt_dir=save_dir`` alone: its wall time and launch
    count; its losses agree with the training run's seq-30 phase (the same
    checkpoint and split, the batches grouped differently) within 1e-5
    relative."""
    import torch
    from paig_reproduction_tpu_torch import cli
    from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd

    out_dir = os.path.join(os.path.dirname(save_dir), "test_mode")
    argv = TRAIN_ARGS + [f"--batch_size={batch_size}", "--test_mode",
                         f"--ckpt_dir={save_dir}", f"--data_dir={DATA_DIR}",
                         f"--save_dir={out_dir}"]
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
    fresh = Trainer(PhysicsNet(
        task=m.task, cell_type=m.cell_type, seq_len=m.seq_len,
        input_steps=m.input_steps, pred_steps=m.pred_steps,
        autoencoder_loss=m.autoencoder_loss, color=m.conv_ch == 3,
        input_size=m.img_size ** 2,
        generator=torch.Generator().manual_seed(1)), device="cuda")
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

    with phase("build"):
        parent_build = (start_parent_build(os.path.abspath(args.parent))
                        if args.parent else None)
        for name, (seconds, log) in build.build().items():
            print(log.strip())
            print(f"built {name}.cu in {seconds:.2f} s")
        parent = parent_fn(*parent_build) if parent_build else None

    with phase("kernel st_decode"):
        max_err, timings = check_st_decode(parent)

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
        }]}))

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
