"""PhysicsNet: the PAIG model as a ``torch.nn.Module``.

Counterpart of ``paig_reproduction_tpu/models/physics_net.py`` with its
default configuration: encoder -> velocity estimator -> spring-cell rollout
-> ST decoder, trained unsupervised from video.

* Decoder assets (templates/contents/background) are computed once per
  forward pass.
* The rollout is a Python loop over the (tiny) physics state; all B*T
  rollout frames are decoded afterwards in ONE batched decode, as the JAX
  package does after its ``lax.scan``.
* The public layout is the JAX package's ``[B, T, C, H, W]``; inside, the
  encoder runs NCHW and the decoder returns channels-last frames.
* The loss consumes the fresh rollout output, so the velocity encoder and
  the physical parameters train end to end.

The extension fields of the JAX model (object-discovery aids, inference
enhancers, bf16, the LSTM cell) are not ported yet: a value other than the
default raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paig_reproduction_tpu_torch.models.blocks import (
    ConvolutionalEncoder,
    VariableFromNetwork,
    VelocityEncoder,
)
from paig_reproduction_tpu_torch.models.decoder import (
    BACKENDS,
    DecoderAssets,
    DecoderConfig,
    st_decode,
)
from paig_reproduction_tpu_torch.ops import cells

# Latent units per task: coord_units = n_objects * 2 (dims) * 2 (pos+vel).
COORD_UNITS = {
    "bouncing_balls": 8,
    "spring_color": 8,
    "spring_color_half": 8,
    "3bp_color": 12,
    "mnist_spring_color": 8,
}

# Extension fields of the JAX PhysicsNet and their defaults; only the
# defaults are ported.
EXTENSION_DEFAULTS = {
    "reference_quirks": False,
    "compute_dtype": "float32",
    "template_center_loss": 0.0,
    "coarse_loss": 0.0,
    "vel_anchor": 0.0,
    "recons_warmup": False,
    "learn_frame_offset": False,
    "pos_consistency": 0.0,
    "attn_overlap_loss": 0.0,
    "active_slots": 0,
    "template_init": 0.0,
    "slot_gate_soft": 0.0,
    "init_state_fit": 0,
    "refine_enc_pos": 0,
    "refine_recons_pos": 0,
}


class PhysicsNet(nn.Module):
    """See module docstring. Constructor arguments mirror the JAX model's
    fields; ``generator`` seeds the initial weights."""

    def __init__(self, task: str = "spring_color",
                 cell_type: str = "spring_ode_cell",
                 seq_len: int = 12, input_steps: int = 4, pred_steps: int = 6,
                 autoencoder_loss: float = 0.0, alt_vel: bool = False,
                 color: bool = True, input_size: int = 32 * 32,
                 encoder_type: str = "conv_encoder",
                 decoder_type: str = "conv_st_decoder",
                 decoder_backend: str = "auto", cell_substeps: int = 5,
                 generator: Optional[torch.Generator] = None,
                 **extensions):
        super().__init__()
        for name, value in extensions.items():
            if name not in EXTENSION_DEFAULTS:
                raise TypeError(f"unexpected argument {name!r}")
            if value != EXTENSION_DEFAULTS[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet (only "
                    f"{EXTENSION_DEFAULTS[name]!r})")
        if task not in COORD_UNITS:
            raise ValueError(f"unknown task {task!r}")
        if cell_type not in cells.CELLS:
            raise NotImplementedError(f"cell {cell_type!r} is not ported "
                                      f"yet; ported: {sorted(cells.CELLS)}")
        if not (seq_len > input_steps + pred_steps and input_steps >= 1
                and pred_steps >= 1):
            raise ValueError("need seq_len > input_steps + pred_steps and "
                             "input_steps, pred_steps >= 1")
        if encoder_type != "conv_encoder":
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        if decoder_type != "conv_st_decoder":
            raise ValueError(f"unknown decoder_type {decoder_type!r}")
        if decoder_backend not in BACKENDS:
            raise ValueError(f"unknown decoder_backend {decoder_backend!r}")
        self.task = task
        self.cell_type = cell_type
        self.seq_len = seq_len
        self.input_steps = input_steps
        self.pred_steps = pred_steps
        self.autoencoder_loss = autoencoder_loss
        self.decoder_backend = decoder_backend
        self.cell_substeps = cell_substeps
        self.conv_ch = 3 if color else 1
        self.img_size = int(np.sqrt(input_size))
        self.coord_units = COORD_UNITS[task]
        self.n_objs = self.coord_units // 4
        self.extrap_steps = seq_len - input_steps - pred_steps
        self.tmpl_size = self.img_size // 2

        o, t, img, ch = self.n_objs, self.tmpl_size, self.img_size, self.conv_ch
        self.var_net_content = VariableFromNetwork((o, t, t, ch), generator)
        self.var_net_background = VariableFromNetwork((img, img, ch),
                                                      generator)
        self.var_net_template = VariableFromNetwork((o, t, t), generator)
        self.encoder = ConvolutionalEncoder((img, img), ch, n_objs=o,
                                            hidden_dim=200, out_features=2,
                                            generator=generator)
        self.velocity_encoder = (
            VelocityEncoder(alt_vel, input_steps, o, generator)
            if input_steps > 1 else None)
        self.log_k = nn.Parameter(torch.zeros(()))
        self.log_equil = nn.Parameter(torch.zeros(()))
        self.decoder_cfg = DecoderConfig(img_hw=(img, img), tmpl_size=t,
                                         n_objs=o, conv_ch=ch, log_sig=1.0)

    def forward(self, inp: torch.Tensor, with_extras: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """inp: [B, T, C, H, W] float32 in [0, 1].

        Returns (output_seq [B, pred+extrap, C, H, W], aux dict with
        recons_out [B, input+pred, C, H, W], enc_pos and pos_vel_seq).
        With ``with_extras`` aux also holds ``extras``, the visualization
        tensors in the JAX package's layouts (``extra_outputs.npz``); they
        come from one more decode of the encoder's positions through the
        plain path, while the outputs still go through ``decoder_backend``.
        """
        b = inp.shape[0]
        img, ch = self.img_size, self.conv_ch
        t_in = self.input_steps + self.pred_steps
        cfg = self.decoder_cfg

        template_raw = self.var_net_template()
        contents_raw = self.var_net_content()
        assets = DecoderAssets(
            template=template_raw, contents=contents_raw,
            background=torch.sigmoid(self.var_net_background()))

        # --- encode input+pred frames (batch and time flattened) ----------
        frames = inp[:, :t_in].reshape(b * t_in, ch, img, img)
        enc_pos_flat, enc_masks, masked_objs = self.encoder(frames)

        # --- autoencoder path ---------------------------------------------
        recons_flat, _ = st_decode(assets, enc_pos_flat, cfg,
                                   backend=self.decoder_backend)
        recons_out = recons_flat.reshape(b, t_in, img, img, ch)
        enc_pos = enc_pos_flat.reshape(b, t_in, self.coord_units // 2)

        # --- initial state ---------------------------------------------------
        if self.velocity_encoder is not None:
            vel = self.velocity_encoder(enc_pos[:, :self.input_steps])
        else:
            vel = torch.zeros((b, self.coord_units // 2), dtype=inp.dtype,
                              device=inp.device)
        pos = enc_pos[:, self.input_steps - 1]

        # --- rollout, then one batched decode of every rollout frame ------
        step_fn, dt = cells.CELLS[self.cell_type]
        params = cells.CellParams.initial(inp.device)._replace(
            log_k=self.log_k, log_equil=self.log_equil)
        n_steps = self.pred_steps + self.extrap_steps
        p, v = pos, vel
        pos_roll, vel_roll = [], []
        for _ in range(n_steps):
            p, v = step_fn(params, p, v, dt, substeps=self.cell_substeps)
            # BPTT stabilizer: identity forward, clipped cotangent backward.
            p = cells.clip_cotangent(p)
            v = cells.clip_cotangent(v)
            pos_roll.append(p)
            vel_roll.append(v)
        pos_roll = torch.stack(pos_roll, dim=1)                     # [B, T, k]
        vel_roll = torch.stack(vel_roll, dim=1)
        frames_flat, _ = st_decode(assets, pos_roll.reshape(b * n_steps, -1),
                                   cfg, backend=self.decoder_backend)
        output_seq = frames_flat.reshape(b, n_steps, img, img, ch)
        pos_vel_seq = torch.cat(
            [torch.cat([pos, vel], dim=1)[:, None],
             torch.cat([pos_roll, vel_roll], dim=2)], dim=1)

        aux = {"recons_out": recons_out.permute(0, 1, 4, 2, 3),
               "enc_pos": enc_pos,
               "pos_vel_seq": pos_vel_seq}
        if with_extras:
            _, dec_extras = st_decode(assets, enc_pos_flat, cfg,
                                      return_extras=True)
            aux["extras"] = {
                "contents": contents_raw.permute(0, 3, 1, 2),
                "templates": template_raw[:, None],
                "background_content": assets.background.permute(
                    2, 0, 1)[None],
                "transf_contents": dec_extras["transf_contents"],
                "transf_masks": dec_extras["transf_masks"],
                "enc_masks": enc_masks.permute(0, 2, 3, 1),
                "masked_objs": masked_objs.permute(0, 2, 3, 1),
            }
        return output_seq.permute(0, 1, 4, 2, 3), aux


def compute_losses(model: PhysicsNet, inp: torch.Tensor,
                   output_seq: torch.Tensor, recons_out: torch.Tensor):
    """Squared error summed over (C, H, W), meaned over batch/time slices.

    inp: [B, T, C, H, W]; output_seq: [B, pred+extrap, C, H, W];
    recons_out: [B, input+pred, C, H, W].

    Returns (train_loss, dict of eval losses).
    """
    t_in = model.input_steps + model.pred_steps
    recons_loss = torch.mean(torch.sum((inp[:, :t_in] - recons_out) ** 2,
                                       dim=(2, 3, 4)))
    loss = torch.sum((inp[:, model.input_steps:] - output_seq) ** 2,
                     dim=(2, 3, 4))
    pred_loss = torch.mean(loss[:, :model.pred_steps])
    extrap_loss = torch.mean(loss[:, model.pred_steps:])

    train_loss = pred_loss
    if model.autoencoder_loss > 0.0:
        train_loss = train_loss + model.autoencoder_loss * recons_loss
    return train_loss, {
        "eval_pred_loss": pred_loss,
        "eval_extrap_loss": extrap_loss,
        "eval_recons_loss": recons_loss,
    }
