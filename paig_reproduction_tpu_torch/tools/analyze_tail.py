"""Per-sequence loss-tail analysis for a trained checkpoint.

Counterpart of the JAX package's ``tools/analyze_tail.py`` on the port's
checkpoint, with the same flags and the same JSON report. The median
rollout position error can be sub-pixel while the mean eval_pred_loss is
large: the mean is driven by a per-sequence tail. This tool quantifies it:

* per-sequence pred/extrap pixel losses with percentiles and the worst
  sequences' ids;
* rollout-vs-encoder position error per sequence (the encoder run on ALL
  frames gives an observed trajectory to hold the physics rollout to, no
  ground-truth positions needed);
* identity swaps: frames where swapping the object slots would reduce the
  rollout-vs-observed position error;
* velocity-estimate error: the velocity head's output against the central
  difference of observed positions around the rollout start.

Usage::

    python -m paig_reproduction_tpu_torch.tools.analyze_tail \\
        --ckpt_dir runs/ph7 --task spring_color \\
        --data data/datasets/spring_color/color_spring_vx8_vy8_sl30_r2_k4_e6.npz
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None):
    """The tool's command line. Returns the report it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--task", default="spring_color")
    ap.add_argument("--data", required=True)
    ap.add_argument("--split", default="test_x")
    ap.add_argument("--seq_len", type=int, default=30)
    ap.add_argument("--input_steps", type=int, default=4)
    ap.add_argument("--pred_steps", type=int, default=6)
    ap.add_argument("--cell_type", default="spring_ode_cell")
    ap.add_argument("--cell_substeps", type=int, default=5)
    # As in the JAX tool: store_true with default=True, so the flag cannot
    # be turned off (a model without frame_offset still restores, the
    # offset at its initial zeros).
    ap.add_argument("--learn_frame_offset", action="store_true",
                    default=True)
    ap.add_argument("--init_state_fit", type=int, default=0)
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (cuda, or cpu)")
    args = ap.parse_args(argv)

    from paig_reproduction_tpu_torch.models import PhysicsNet
    from paig_reproduction_tpu_torch.ops import cells
    from paig_reproduction_tpu_torch.train.checkpoint import (
        restore_checkpoint,
    )
    from paig_reproduction_tpu_torch.utils.misc import use_full_f32

    with np.load(args.data) as d:
        data = d[args.split]                       # [N, T, H, W, C] uint8
    x = data.astype(np.float32) / 255.0
    x = np.ascontiguousarray(np.transpose(x, (0, 1, 4, 2, 3)))
    n, t = x.shape[:2]
    img = x.shape[-1]
    device = torch.device(args.device)
    if device.type == "cuda":
        use_full_f32()      # as the trainer computes on the card

    def physics_net(seq_len, pred_steps, **extra):
        return PhysicsNet(
            task=args.task, cell_type=args.cell_type, seq_len=seq_len,
            input_steps=args.input_steps, pred_steps=pred_steps,
            autoencoder_loss=3.0, color=True, input_size=img * img,
            cell_substeps=args.cell_substeps,
            learn_frame_offset=args.learn_frame_offset,
            **extra).to(device)

    model = physics_net(args.seq_len, args.pred_steps,
                        init_state_fit=args.init_state_fit)
    restore_checkpoint(args.ckpt_dir, model)
    # Encoder-only view over ALL frames: a model whose input+pred covers
    # the whole sequence, so enc_pos spans [0, T), with the same weights.
    enc_model = physics_net(args.seq_len + 1,
                            args.seq_len - args.input_steps)
    enc_model.load_state_dict(model.state_dict())

    pred_seq_loss = np.zeros(n)
    extrap_seq_loss = np.zeros(n)
    frame_loss = np.zeros((n, t - args.input_steps))
    roll_pos_all = []
    enc_pos_all = []
    vel_all = []
    with torch.no_grad():
        for i in range(0, n, args.batch):
            b = torch.from_numpy(x[i:i + args.batch]).to(device)
            out, aux = model(b)
            # One frame padded, so that seq_len+1 > input+pred holds.
            _, enc_aux = enc_model(torch.cat([b, b[:, -1:]], dim=1))
            tgt = b[:, args.input_steps:]
            l = torch.sum((tgt - out) ** 2, dim=(2, 3, 4)).cpu().numpy()
            frame_loss[i:i + args.batch] = l
            pred_seq_loss[i:i + args.batch] = l[:, :args.pred_steps].mean(1)
            extrap_seq_loss[i:i + args.batch] = \
                l[:, args.pred_steps:].mean(1)
            pv = aux["pos_vel_seq"].cpu().numpy()  # [B, 1+n_steps, 2*cu2]
            cu2 = pv.shape[-1] // 2
            roll_pos_all.append(pv[:, 1:, :cu2])
            vel_all.append(pv[:, 0, cu2:])
            enc_pos_all.append(enc_aux["enc_pos"][:, :t].cpu().numpy())

    roll_pos = np.concatenate(roll_pos_all)        # [N, T-in, cu2]
    enc_pos = np.concatenate(enc_pos_all)          # [N, T, cu2]
    vel0 = np.concatenate(vel_all)                 # [N, cu2]
    n_objs = roll_pos.shape[-1] // 2
    obs = enc_pos[:, args.input_steps:]            # aligned with rollout

    rp = roll_pos.reshape(n, -1, n_objs, 2)
    ob = obs.reshape(n, -1, n_objs, 2)
    err_id = np.linalg.norm(rp - ob, axis=-1).mean(-1)       # [N, T-in]
    if n_objs == 2:
        err_sw = np.linalg.norm(rp - ob[:, :, ::-1], axis=-1).mean(-1)
    else:
        err_sw = np.full_like(err_id, np.inf)
    swap_frames = (err_sw < err_id)

    # velocity error: central difference of observed positions around the
    # rollout start (frame input_steps-1), dt from the cell table
    dt = cells.CELLS[args.cell_type][1]
    s = args.input_steps
    vel_fd = (enc_pos[:, s] - enc_pos[:, s - 2]) / (2 * dt)
    vel_err = np.linalg.norm(
        (vel0 - vel_fd).reshape(n, n_objs, 2), axis=-1).mean(-1)

    def pct(a):
        return {f"p{q}": round(float(np.percentile(a, q)), 3)
                for q in (50, 75, 90, 95, 99)}

    worst = np.argsort(pred_seq_loss)[::-1][:15]
    report = {
        "n_sequences": int(n),
        "pred_loss_mean": round(float(pred_seq_loss.mean()), 3),
        "pred_loss_pct": pct(pred_seq_loss),
        "extrap_loss_mean": round(float(extrap_seq_loss.mean()), 3),
        "extrap_loss_pct": pct(extrap_seq_loss),
        "rollout_pos_err_px_pred_mean": round(
            float(err_id[:, :args.pred_steps].mean()), 3),
        "rollout_pos_err_px_pred_pct": pct(
            err_id[:, :args.pred_steps].mean(1)),
        "vel_err_px_per_frame": pct(vel_err * dt),
        "seqs_with_any_swap_frame": int(swap_frames.any(1).sum()),
        "worst15_ids": worst.tolist(),
        "worst15_pred_loss": [round(float(pred_seq_loss[i]), 2)
                              for i in worst],
        "worst15_poserr_px": [round(float(
            err_id[i, :args.pred_steps].mean()), 2) for i in worst],
        "worst15_velerr_pxpf": [round(float(vel_err[i] * dt), 2)
                                for i in worst],
        "worst15_swap": [bool(swap_frames[i, :args.pred_steps].any())
                         for i in worst],
        # how much of the mean the top-k worst sequences carry
        "top5pct_share_of_mean": round(float(
            np.sort(pred_seq_loss)[-max(1, n // 20):].sum()
            / pred_seq_loss.sum()), 3),
    }
    print(json.dumps(report, indent=1))
    if args.out:
        np.savez_compressed(
            args.out, pred_seq_loss=pred_seq_loss,
            extrap_seq_loss=extrap_seq_loss, frame_loss=frame_loss,
            roll_pos=roll_pos, enc_pos=enc_pos, vel0=vel0,
            err_id=err_id, err_sw=err_sw)
        print("saved arrays ->", args.out)
    return report


if __name__ == "__main__":
    main()
