"""Checkpoint surgery CLI: revive dead discovery slots / pin the background.

Counterpart of the JAX package's ``tools/slot_rescue.py`` on the port's
checkpoint, through the port's ``train/surgery.py``: host-side numpy on the
checkpoint's ``model`` dict. Typical rescue (mnist: one digit discovered,
the other absorbed by the learned background):

    python -m paig_reproduction_tpu_torch.tools.slot_rescue \\
        --ckpt_dir=runs/mnist_disc1 --out_dir=runs/mnist_rescue_ckpt \\
        --task=mnist_spring_color --rescue_slot=auto --disk_radius=9 \\
        --set_background=median

    python -m paig_reproduction_tpu_torch --task=mnist_spring_color \\
        --use_ckpt --ckpt_dir=runs/mnist_rescue_ckpt \\
        --save_dir=runs/mnist_rescue --bg_lr_mult=0 ...
        # frozen true background: the unexplained digit is the only
        # residual left

The output holds ``model`` and ``step`` and no optimizer state: stale
RMSProp/Adam moments of surgically edited layers point the wrong way, and
the trainer's partial restore starts the optimizer's state afresh, with its
logged notice.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from paig_reproduction_tpu_torch.cli import TASK_TABLE
from paig_reproduction_tpu_torch.train import surgery
from paig_reproduction_tpu_torch.train.checkpoint import (
    CKPT_NAME,
    load_checkpoint,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--task", required=True, choices=sorted(TASK_TABLE))
    ap.add_argument("--rescue_slot", default="",
                    help="'auto' (measured-failure-mode policy: dead / "
                         "content-dead / ballooned / least-healthy; "
                         "salience-aware when --set_background=median "
                         "supplies frames), 'all', a comma list of slot "
                         "indices, or '' to skip slot surgery")
    ap.add_argument("--disk_radius", type=float, default=9.0,
                    help="template-disk prior radius (template px)")
    ap.add_argument("--template_init", type=float, default=0.0,
                    help="MUST match the --template_init the checkpoint "
                         "was trained with: the training-time prior is a "
                         "graph constant on top of the template MLP, so "
                         "health ranking and installed disks account for "
                         "it")
    ap.add_argument("--content_rgb", default="0.5,0.5,0.5",
                    help="flat content color for the rescued slot")
    ap.add_argument("--set_background", default="",
                    help="'median' (pixelwise median of the train split) "
                         "or a path to an [H,W,C] .npy in [0,1]")
    ap.add_argument("--data_dir", default="",
                    help="datasets root (default <repo>/data/datasets)")
    ap.add_argument("--keep_step", action="store_true",
                    help="keep the checkpoint's step counter (default: "
                         "reset to 0 so LR schedules restart)")
    args = ap.parse_args(argv)

    restored = load_checkpoint(args.ckpt_dir)
    params = {k: v.numpy() for k, v in restored["model"].items()}

    _, _, _, _, _, _, _, input_size = TASK_TABLE[args.task]
    img = int(np.sqrt(input_size))
    tmpl = img // 2
    ch = 3
    n_objs = {"3bp_color": 3}.get(args.task, 2)

    health = surgery.slot_health(params, n_objs, tmpl,
                                 template_init=args.template_init)
    print(f"slot template mask mass (px): {health}")

    # With train frames on hand (--set_background=median), 'auto' slot
    # selection uses content salience: mask mass alone marks a
    # big-mask/background-colored slot healthiest (bounce_one1 mode).
    salience = None
    bg = None
    if args.set_background == "median":
        root = args.data_dir or os.path.join(REPO, "data", "datasets")
        data_file = TASK_TABLE[args.task][0]
        with np.load(os.path.join(root, data_file)) as d:
            frames = d[d.files[0]]
        bg = surgery.median_background(frames)
        salience = surgery.slot_salience(params, n_objs, tmpl, ch, bg,
                                         template_init=args.template_init)
        print(f"slot content salience vs background: "
              f"{np.round(salience, 3)}")

    if args.rescue_slot != "":
        if args.rescue_slot == "auto":
            slots = surgery.select_dead_slots(
                health, tmpl_px=tmpl * tmpl, salience=salience)
        elif args.rescue_slot == "all":
            slots = list(range(n_objs))
        else:
            slots = [int(v) for v in args.rescue_slot.split(",")]
        rgb = [float(v) for v in args.content_rgb.split(",")]
        for slot in slots:
            print(f"rescuing slot {slot}: disk r={args.disk_radius}, "
                  f"content {rgb}")
            params = surgery.rescue_slot(params, slot, n_objs, tmpl, ch,
                                         radius=args.disk_radius,
                                         content_rgb=rgb,
                                         template_init=args.template_init)

    if args.set_background:
        if args.set_background != "median":
            bg = np.load(args.set_background)
        assert bg.shape == (img, img, ch), bg.shape
        print(f"installing background (mean {bg.mean():.3f}) "
              "— freeze it on resume with --bg_lr_mult=0")
        params = surgery.set_background(params, bg)

    step = int(restored.get("step", 0)) if args.keep_step else 0
    os.makedirs(args.out_dir, exist_ok=True)
    save_checkpoint(args.out_dir, {
        "model": {k: torch.from_numpy(np.array(v)) for k, v in
                  params.items()},
        "step": step})
    print(f"wrote {args.out_dir}/{CKPT_NAME}")


if __name__ == "__main__":
    main()
