"""Closed-form physical-parameter identification from encoder positions.

Counterpart of the JAX package's ``tools/fit_physics.py`` on the port's
checkpoint. The pixel loss gives the physical parameters a vanishing
gradient once predicted and target objects stop overlapping, but given a
trained encoder they are identifiable by least squares on the encoder's
own position sequences (``ops/identify.py``): the spring's k and
equilibrium length, gravity's A = g*m^2.

Usage (after a discovery-phase run):

    python -m paig_reproduction_tpu_torch.tools.fit_physics \\
        --task spring_color --ckpt_dir runs/spring_s2 \\
        --data_dir data/datasets

Estimates the parameters from encoder positions over the train split,
reports the pointwise and trajectory fits, and with ``--write`` sets
``log_k``/``log_equil`` (or ``log_g``) and ``frame_offset`` in the
checkpoint's ``model`` dict, every other entry (the optimizer and recipe
state included) kept, so that training can resume from the identified
physics. A model without ``frame_offset`` (no ``--learn_frame_offset``)
ignores it on restore, with the restore's logged notice.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from paig_reproduction_tpu_torch.ops.identify import (
    fit_gravity,
    fit_gravity_trajectory,
    fit_spring,
    fit_spring_trajectory,
)


def restore_model(task, ckpt_dir, device="cuda"):
    """The tool's PhysicsNet for ``task`` (the JAX tool's fields: the task
    table's, autoencoder loss 3, colour) on ``device`` with ``ckpt_dir``'s
    model.ckpt restored by name; what the checkpoint lacks keeps its
    initial value from seed 0. On the card it computes in full float32, as
    the trainer does. Returns (model, the checkpoint dict)."""
    from paig_reproduction_tpu_torch.cli import TASK_TABLE
    from paig_reproduction_tpu_torch.models import PhysicsNet
    from paig_reproduction_tpu_torch.train.checkpoint import (
        load_checkpoint,
        restore_checkpoint,
    )
    from paig_reproduction_tpu_torch.utils.misc import use_full_f32

    if torch.device(device).type == "cuda":
        use_full_f32()

    (_, _, cell_type, seq_len, _, input_steps, pred_steps,
     input_size) = TASK_TABLE[task]
    model = PhysicsNet(task=task, cell_type=cell_type, seq_len=seq_len,
                       input_steps=input_steps, pred_steps=pred_steps,
                       autoencoder_loss=3.0, color=True,
                       input_size=input_size)
    model = model.to(device)
    restore_checkpoint(ckpt_dir, model)
    return model, load_checkpoint(ckpt_dir)


def encoder_positions(task, ckpt_dir, data_dir, n_batches=8,
                      batch_size=100, device="cuda"):
    """The encoder's positions of ``n_batches`` train batches, each
    corrected by the rendered-appearance offsets. Returns (positions [N,
    input+pred, n_objs*2], the model, the checkpoint dict, the offsets)."""
    from paig_reproduction_tpu_torch.cli import TASK_TABLE
    from paig_reproduction_tpu_torch.data.iterators import get_iterators
    from paig_reproduction_tpu_torch.train.recipes import rendered_offsets

    model, ckpt = restore_model(task, ckpt_dir, device)
    its = get_iterators(os.path.join(data_dir, TASK_TABLE[task][0]),
                        conv=True)
    seqs = []
    with torch.no_grad():
        for _ in range(n_batches):
            bx, _ = its[0].next_batch(batch_size)
            _, aux = model(torch.from_numpy(bx).to(device))
            seqs.append(aux["enc_pos"].cpu().numpy())
    enc = np.concatenate(seqs, 0)          # [N, t_in, n_objs*2]

    # Render-measured per-object offsets: the centroid of each object's own
    # rendered appearance minus the encoder position it was rendered at,
    # the median over the frames of 8 sequences. This is the offset a pixel
    # tracker sees; a template centroid breaks on complex templates (mnist
    # digits: up to 6 px, or the wrong sign).
    offsets = rendered_offsets(model, its[0].X[:8], device)
    print("rendered-appearance offsets (image px, per object x,y):",
          np.round(offsets, 2))
    enc = enc + offsets[None, None, :]
    return enc, model, ckpt, offsets


def main(argv=None):
    """The tool's command line. Returns the fitted entries of the model
    dict ({name: float32 value}, ``frame_offset`` included), written into
    the checkpoint with ``--write``, or None for a cell without physical
    parameters."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", required=True)
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--data_dir", default="data/datasets")
    ap.add_argument("--write", action="store_true",
                    help="write the fitted parameters into the checkpoint")
    ap.add_argument("--substeps", type=int, default=5,
                    help="Euler substeps the fitted cell will use "
                         "(match --cell_substeps; the data generators "
                         "integrate with 10)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (cuda, or cpu)")
    args = ap.parse_args(argv)

    from paig_reproduction_tpu_torch.ops import cells
    from paig_reproduction_tpu_torch.train.checkpoint import save_checkpoint

    enc, model, ckpt, offsets = encoder_positions(
        args.task, args.ckpt_dir, args.data_dir, device=args.device)
    _, dt = cells.CELLS[model.cell_type]

    if model.cell_type == "spring_ode_cell":
        k_pt, e_pt, rms = fit_spring(enc, dt)
        print(f"pointwise spring fit: k={k_pt:.4f} equil={e_pt:.4f} "
              f"(residual rms {rms:.3f})")
        k, equil, traj_err = fit_spring_trajectory(
            enc, dt, input_steps=model.input_steps,
            substeps=args.substeps)
        print(f"trajectory spring fit: k={k:.4f} equil={equil:.4f} "
              f"(median traj err {traj_err:.3f})")
        updates = {"log_k": np.log(max(k, 1e-3)),
                   "log_equil": np.log(max(equil, 1e-3))}
    elif model.cell_type == "gravity_ode_cell":
        A_pt, rms = fit_gravity(enc, dt)
        print(f"pointwise gravity fit: A=g*m^2={A_pt:.4f} "
              f"(residual rms {rms:.3f})")
        A, traj_err = fit_gravity_trajectory(
            enc, dt, input_steps=model.input_steps,
            substeps=args.substeps)
        # A = exp(log_g) * exp(2 log_m); log_m frozen at 0 -> log_g = log A
        print(f"trajectory gravity fit: A={A:.4f} "
              f"(median traj err {traj_err:.3f})")
        updates = {"log_g": np.log(max(A, 1e-3))}
    else:
        print(f"cell {model.cell_type} has no learnable physics")
        return None

    fitted = {name: np.float32(val) for name, val in updates.items()}
    # The frame-offset parameter (pos_phys = pos_enc + b) seeded with the
    # measured offsets, for --learn_frame_offset resumes.
    fitted["frame_offset"] = offsets.astype(np.float32)
    if args.write:
        for name, val in fitted.items():
            ckpt["model"][name] = torch.from_numpy(np.array(val))
        path = save_checkpoint(args.ckpt_dir, ckpt)
        print(f"wrote {sorted(updates)} + frame_offset into {path}")
    return fitted


if __name__ == "__main__":
    main()
