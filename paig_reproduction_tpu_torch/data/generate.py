"""Dataset-generation CLI: the JAX package's presets, with the port's numpy
generators.

Each preset writes the two files the task table expects (the train-length
file and the longer test file) under ``--out_dir``, e.g.::

    python -m paig_reproduction_tpu_torch.data.generate \
        --task mnist_spring_color --out_dir data/generated \
        --train 200 --valid 100 --test 100

``--test_train`` / ``--test_valid`` / ``--test_test`` size the longer file
apart (default: the same counts), since its sequences cost more: only its
test split is read, by the test phase. The two files are written at once,
each in a process of its own (each file seeds its own stream, so the bytes
are those of one process).
"""
from __future__ import annotations

import argparse
import os
import time

from paig_reproduction_tpu_torch.data import generators as g


def presets():
    """task -> [(relative npz path, generator, keyword arguments but the
    split sizes)]: the train-length file first, then the test file."""
    def spring(path, seq_len, half=False):
        return (path, g.generate_spring_balls_dataset, dict(
            seq_len=seq_len, img_size=[32, 32], radius=2, dt=0.3, k=4,
            equil=6, vx0_max=4.0 if half else 8.0,
            vy0_max=4.0 if half else 8.0, color=True))

    def bounce(path, seq_len):
        return (path, g.generate_bouncing_balls_video_dataset, dict(
            seq_len=seq_len, img_size=[32, 32], radius=2, dt=0.3,
            vx0_max=8.0, vy0_max=8.0, n_balls=2, color=True))

    def threebp(path, seq_len):
        return (path, g.generate_3_body_problem_dataset, dict(
            seq_len=seq_len, img_size=[36, 36], radius=2, dt=0.5, g=60.0,
            m=1.0, vx0_max=2.0, vy0_max=2.0, color=True))

    def mnist(path, seq_len):
        return (path, g.generate_spring_mnist_dataset, dict(
            seq_len=seq_len, img_size=[64, 64], dt=0.3, k=2, equil=12,
            vx0_max=8.0, vy0_max=8.0, color=True, cifar_background=True))

    return {
        "bouncing_balls": [
            bounce("bouncing/color_bounce_vx8_vy8_sl12_r2.npz", 12),
            bounce("bouncing/color_bounce_vx8_vy8_sl30_r2.npz", 30)],
        "spring_color": [
            spring("spring_color/color_spring_vx8_vy8_sl12_r2_k4_e6.npz",
                   12),
            spring("spring_color/color_spring_vx8_vy8_sl30_r2_k4_e6.npz",
                   30)],
        "spring_color_half": [
            spring("spring_color_half/"
                   "color_spring_vx4_vy4_sl12_r2_k4_e6_halfpane.npz", 12,
                   half=True),
            spring("spring_color_half/"
                   "color_spring_vx4_vy4_sl30_r2_k4_e6_halfpane.npz", 30,
                   half=True)],
        "3bp_color": [
            threebp("3bp_color/color_3bp_vx2_vy2_sl20_r2_g60_m1_dt05.npz",
                    20),
            threebp("3bp_color/color_3bp_vx2_vy2_sl40_r2_g60_m1_dt05.npz",
                    40)],
        "mnist_spring_color": [
            mnist("mnist_spring_color/"
                  "color_mnist_spring_vx8_vy8_sl12_r2_k2_e12.npz", 12),
            mnist("mnist_spring_color/"
                  "color_mnist_spring_vx8_vy8_sl30_r2_k2_e12.npz", 30)],
    }


def _write_file(task, dest, fn, kwargs, n_train, n_valid, n_test):
    print(f"[{task}] generating {dest}")
    t0 = time.perf_counter()
    fn(dest, train_set_size=n_train, valid_set_size=n_valid,
       test_set_size=n_test, **kwargs)
    print(f"[{task}] {n_train}/{n_valid}/{n_test} sequences of "
          f"{kwargs['seq_len']} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)


def generate(task, out_dir, sizes, test_sizes=None):
    """Write `task`'s two files under out_dir: the train-length file with
    `sizes` = (train, valid, test) sequences and the test file with
    `test_sizes` (default `sizes`), each in a forked process of its own.
    Returns their paths."""
    import multiprocessing
    jobs = [(task, os.path.join(out_dir, rel), fn, kwargs, *n)
            for (rel, fn, kwargs), n in zip(presets()[task],
                                            (sizes, test_sizes or sizes))]
    procs = [multiprocessing.get_context("fork").Process(
        target=_write_file, args=job) for job in jobs]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join()
    failed = [job[1] for job, proc in zip(jobs, procs) if proc.exitcode]
    if failed:
        raise RuntimeError(f"generating {failed} failed")
    return [job[1] for job in jobs]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", required=True,
                   help="one of the 5 task names, or 'all'")
    p.add_argument("--out_dir", default="data/datasets")
    p.add_argument("--train", type=int, default=5000)
    p.add_argument("--valid", type=int, default=500)
    p.add_argument("--test", type=int, default=500)
    p.add_argument("--test_train", type=int, default=None,
                   help="train sequences of the test file (default "
                        "--train)")
    p.add_argument("--test_valid", type=int, default=None,
                   help="valid sequences of the test file (default "
                        "--valid)")
    p.add_argument("--test_test", type=int, default=None,
                   help="test sequences of the test file (default --test)")
    args = p.parse_args(argv)

    sizes = (args.train, args.valid, args.test)
    test_sizes = tuple(a if a is not None else b for a, b in zip(
        (args.test_train, args.test_valid, args.test_test), sizes))
    tasks = list(presets()) if args.task == "all" else [args.task]
    for task in tasks:
        generate(task, args.out_dir, sizes, test_sizes)


if __name__ == "__main__":
    main()
