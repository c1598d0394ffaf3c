"""Where the time of one train step goes, on a CUDA card.

    python -m paig_reproduction_tpu_torch.profile_step [--batch_size 100]
        [--task spring_color] [--data_dir DIR] [--autoencoder_loss 3.0]
        [--init_state_fit N] [--learn_frame_offset]
        [--cell_type lstm] [--compute_dtype bfloat16]

Builds the task's model as the CLI does (seed 0, the task's train file
under ``--data_dir``, the tracked datasets by default), with the given
model fields, takes a few warm-up steps, then traces ``--steps`` train steps
with ``torch.profiler``. The step is the one the trainer runs: the fused
step, captured as a CUDA graph and replayed (``train_chunk``), unless the
trainer's predicate turns it off (``PAIG_FUSED=0``: the eager step). Prints
the median untraced step time, the traced host time per step, the device's
busy time per step (the union of its kernels' intervals) and its idle share
of the untraced step, the number of kernel launches (device operations) and
graph replays per step, the kernels that take the most device time, and the
ST decoder's device time and launches per step on both sides of autograd:
its CUDA kernel in the forward, and the plain decode's recompute and
gradient inside the ``st_decode.backward`` range (the eager step only: a
replay runs no Python range).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from paig_reproduction_tpu_torch.cli import TASK_TABLE
from paig_reproduction_tpu_torch.data.iterators import get_iterators
from paig_reproduction_tpu_torch.models import PhysicsNet
from paig_reproduction_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _range_kernels(event):
    """The device kernels launched inside a profiler range, its nested
    operators' included."""
    kernels = list(event.kernels)
    for child in event.cpu_children:
        kernels += _range_kernels(child)
    return kernels


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch_size", type=int, default=100)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--task", default="spring_color",
                        choices=sorted(TASK_TABLE))
    parser.add_argument("--data_dir",
                        default=os.path.join(REPO, "data", "datasets"))
    parser.add_argument("--autoencoder_loss", type=float, default=3.0)
    parser.add_argument("--init_state_fit", type=int, default=0)
    parser.add_argument("--learn_frame_offset", action="store_true")
    parser.add_argument("--cell_type", default="",
                        help="the task's cell by default")
    parser.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    (data_file, _, cell_type, seq_len, _, input_steps, pred_steps,
     input_size) = TASK_TABLE[args.task]
    model = PhysicsNet(task=args.task, cell_type=args.cell_type or cell_type,
                       seq_len=seq_len, input_steps=input_steps,
                       pred_steps=pred_steps,
                       autoencoder_loss=args.autoencoder_loss,
                       color=True, input_size=input_size,
                       init_state_fit=args.init_state_fit,
                       learn_frame_offset=args.learn_frame_offset,
                       compute_dtype=args.compute_dtype,
                       generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, device="cuda")
    trainer.get_data(get_iterators(os.path.join(args.data_dir, data_file),
                                   conv=True))
    trainer.build_optimizer(6e-4, "rmsprop", True, epochs=2,
                            steps_per_epoch=25)
    rs = np.random.RandomState(0)
    n = trainer.train_iterator.num_examples
    reason = trainer.fused_off_reason(args.batch_size)

    def steps(count):
        """`count` train steps as the trainer runs them."""
        if reason is not None:
            for _ in range(count):
                trainer.train_step(rs.choice(n, args.batch_size,
                                             replace=False))
            return
        done = 0
        while done < count:
            done += trainer.train_chunk(args.batch_size, count - done)[0]

    def replays():
        return sum(r for r, _ in trainer.graph_stats().values())

    steps(5)
    torch.cuda.synchronize()
    untraced = []
    for _ in range(5):
        t0 = time.perf_counter()
        steps(10)
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3 / 10)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    replays0 = replays()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        steps(args.steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    replays_per_step = (replays() - replays0) / args.steps

    # Device activity, without the ranges that user annotations (such as
    # the optimizer's step) leave on the device timeline.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    per_step = wall_us / args.steps / 1e3
    print(f"{args.task}, {model.cell_type}, {args.compute_dtype}, "
          f"B={args.batch_size}, {args.steps} traced steps on "
          f"{torch.cuda.get_device_name(0)}; step: "
          + ("graphed (captured CUDA graph, replayed)" if reason is None
             else f"eager ({reason})"))
    print(f"graph replays per step: {replays_per_step:.1f}")
    untraced_ms = float(np.median(untraced))
    print(f"untraced step: median {untraced_ms:.3f} ms over 5 runs of 10")
    print(f"host time per traced step: {per_step:.3f} ms")
    if not kernels:
        print("device time: not measured (the trace holds no device "
              "events)")
        return
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels]) / args.steps / 1e3
    print(f"device busy per step: {busy:.3f} ms; idle share of the "
          f"untraced step {1 - busy / untraced_ms:.3f}")
    print(f"kernel launches per step: {len(kernels) / args.steps:.1f}")
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    print(f"top {args.top} kernels by device time (ms per step, launches "
          f"per step, name):")
    for name, (total, count) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:args.top]:
        print(f"  {total / args.steps / 1e3:8.3f} {count / args.steps:7.1f}"
              f"  {name[:110]}")
    # The ST decoder on both sides of autograd. Its forward kernel comes from
    # a library with its own CUDA runtime, which the profiler does not link
    # to the calling range, so it is found by name; the backward is the
    # plain decode's recompute and gradient inside its range.
    forward = [e for e in kernels if "st_decode_kernel" in e.name]
    backward = [k for e in prof.events()
                if e.name == "st_decode.backward"
                and e.device_type == torch.autograd.DeviceType.CPU
                for k in _range_kernels(e)]
    for side, ms, count in (
            ("forward (the CUDA kernel)",
             sum(e.time_range.elapsed_us() for e in forward), len(forward)),
            ("backward (plain recompute and gradient)",
             sum(k.duration for k in backward), len(backward))):
        if not count:
            print(f"st_decode {side}: not measured (no such kernels in the "
                  f"trace)")
            continue
        print(f"st_decode {side}: {ms / args.steps / 1e3:.3f} ms device "
              f"per step, {count / args.steps:.1f} launches per step")


if __name__ == "__main__":
    main()
