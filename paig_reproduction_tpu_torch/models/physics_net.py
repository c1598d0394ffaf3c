"""PhysicsNet: the PAIG model as a ``torch.nn.Module``.

Counterpart of ``paig_reproduction_tpu/models/physics_net.py``: encoder ->
velocity estimator -> physics-cell (or LSTM) rollout -> ST decoder, trained
unsupervised from video.

* Decoder assets (templates/contents/background) are computed once per
  forward pass.
* The rollout is a Python loop over the (tiny) physics state; all B*T
  rollout frames are decoded afterwards in ONE batched decode, as the JAX
  package does after its ``lax.scan``. The LSTM rollout is decoded the same
  way (see ``_lstm_rollout``).
* The public layout is the JAX package's ``[B, T, C, H, W]``; inside, the
  encoder runs NCHW and the decoder returns channels-last frames.
* The loss consumes the fresh rollout output, so the velocity encoder and
  the physical parameters train end to end.

The JAX model's extension fields are ported: the discovery aids
(``template_init``, ``active_slots``/``slot_gate_soft``,
``attn_overlap_loss``), the physics-alignment losses
(``template_center_loss``, ``coarse_loss``, ``vel_anchor``,
``pos_consistency``, ``recons_warmup``, ``reference_quirks``), the learned
``frame_offset`` (``learn_frame_offset``) and the inference enhancers
(``init_state_fit``, ``refine_enc_pos``, ``refine_recons_pos``). The three
physics cells are ported, each with the JAX model's parameters (spring:
``log_k``, ``log_equil``; gravity: ``log_g`` and the frozen ``log_m``;
bouncing: none). ``cell_type="lstm"`` is the JAX model's black-box
baseline: a stack of ``lstm_layers`` LSTM cells of ``recurrent_units`` and a
``lstm_proj`` projection in place of the physics cell, with no physical
parameter and no frame offset. ``compute_dtype="bfloat16"`` runs the
encoder's UNet and hidden MLP layers in bf16 with float32 master weights
(``models/blocks.py``); everything after the encoder's positions, the decode
included, stays float32.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paig_reproduction_tpu_torch.models.blocks import (
    ConvolutionalEncoder,
    TorchDense,
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
from paig_reproduction_tpu_torch.ops.pos_refine import refine_positions
from paig_reproduction_tpu_torch.ops.state_fit import (
    fit_initial_state,
    fit_initial_state_bouncing,
)

# Latent units per task: coord_units = n_objects * 2 (dims) * 2 (pos+vel).
COORD_UNITS = {
    "bouncing_balls": 8,
    "spring_color": 8,
    "spring_color_half": 8,
    "3bp_color": 12,
    "mnist_spring_color": 8,
}

# Extension fields of the JAX PhysicsNet and their defaults (see the JAX
# model's field notes for what each does).
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
# compute_dtype's values and the encoder's computation dtype for each
# (None: the input's, float32).
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# The inference enhancers: parameter-free, so a model without them
# (``without_enhancers``) shares every parameter.
ENHANCERS = ("init_state_fit", "refine_enc_pos", "refine_recons_pos")
# Each cell's learnable physical parameters (scalars, log-space, zero at
# init), as the JAX model creates them.
CELL_PARAMS = {
    "spring_ode_cell": ("log_k", "log_equil"),
    "gravity_ode_cell": ("log_g", "log_m"),
    "bouncing_ode_cell": (),
    "lstm": (),
}


def _lstm_cell(in_features: int, hidden: int) -> nn.LSTMCell:
    """An ``nn.LSTMCell`` with flax ``OptimizedLSTMCell``'s parameters. flax
    keeps a kernel per gate (i, f, g, o: torch's order too), input kernels
    without bias, recurrent kernels with one. So ``bias_ih`` is a zero
    buffer rather than a parameter: a trained input bias would move the
    gates' bias at twice the rate. flax's initialization (LeCun-normal
    input kernels, orthogonal recurrent kernels, a zero bias) is
    ``models/jax_init.py``'s."""
    cell = nn.LSTMCell(in_features, hidden)
    del cell.bias_ih
    cell.register_buffer("bias_ih", torch.zeros(4 * hidden),
                         persistent=False)
    return cell


class PhysicsNet(nn.Module):
    """See module docstring. Constructor arguments mirror the JAX model's
    fields. The weights start at torch's initialization;
    ``models/jax_init.py`` gives the JAX package's initial weights at a
    seed (the CLI's ``--seed``)."""

    def __init__(self, task: str = "spring_color",
                 recurrent_units: int = 100, lstm_layers: int = 1,
                 cell_type: str = "spring_ode_cell",
                 seq_len: int = 12, input_steps: int = 4, pred_steps: int = 6,
                 autoencoder_loss: float = 0.0, alt_vel: bool = False,
                 color: bool = True, input_size: int = 32 * 32,
                 encoder_type: str = "conv_encoder",
                 decoder_type: str = "conv_st_decoder",
                 decoder_backend: str = "auto", cell_substeps: int = 5,
                 **extensions):
        super().__init__()
        for name in extensions:
            if name not in EXTENSION_DEFAULTS:
                raise TypeError(f"unexpected argument {name!r}")
        if task not in COORD_UNITS:
            raise ValueError(f"unknown task {task!r}")
        if cell_type not in CELL_PARAMS:
            raise ValueError(f"unknown cell {cell_type!r}; cells: "
                             f"{sorted(CELL_PARAMS)}")
        if lstm_layers < 1:
            raise ValueError(f"lstm_layers={lstm_layers} (need >= 1)")
        dtype = extensions.get("compute_dtype",
                               EXTENSION_DEFAULTS["compute_dtype"])
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {dtype!r}; dtypes: "
                             f"{sorted(COMPUTE_DTYPES)}")
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
        # The constructor's arguments, to build a model of the same shape
        # (fresh weights for --discovery_restarts arms).
        self.config = dict(
            task=task, recurrent_units=recurrent_units,
            lstm_layers=lstm_layers, cell_type=cell_type, seq_len=seq_len,
            input_steps=input_steps, pred_steps=pred_steps,
            autoencoder_loss=autoencoder_loss, alt_vel=alt_vel, color=color,
            input_size=input_size, encoder_type=encoder_type,
            decoder_type=decoder_type, decoder_backend=decoder_backend,
            cell_substeps=cell_substeps, **extensions)
        for name, default in EXTENSION_DEFAULTS.items():
            setattr(self, name, extensions.get(name, default))
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
        self.var_net_content = VariableFromNetwork((o, t, t, ch))
        self.var_net_background = VariableFromNetwork((img, img, ch))
        tmpl_prior = None
        if self.template_init > 0:
            # Centred-disk logit prior: +6 inside the radius, -6 outside.
            c = (t - 1) / 2.0
            yy, xx = np.mgrid[:t, :t]
            disk = np.where(np.sqrt((yy - c) ** 2 + (xx - c) ** 2)
                            <= self.template_init, 6.0, -6.0)
            tmpl_prior = np.tile(disk[None], (o, 1, 1))
        self.var_net_template = VariableFromNetwork((o, t, t),
                                                    init_bias=tmpl_prior)
        self.encoder = ConvolutionalEncoder(
            (img, img), ch, n_objs=o, hidden_dim=200, out_features=2,
            active_slots=self.active_slots,
            slot_gate_soft=self.slot_gate_soft,
            dtype=COMPUTE_DTYPES[self.compute_dtype])
        self.velocity_encoder = (
            VelocityEncoder(alt_vel, input_steps, o)
            if input_steps > 1 else None)
        for name in CELL_PARAMS[cell_type]:
            setattr(self, name, nn.Parameter(torch.zeros(())))
        self.lstm_layers = lstm_layers
        if cell_type == "lstm":
            for i in range(lstm_layers):
                setattr(self, f"lstm_{i}", _lstm_cell(
                    self.coord_units if i == 0 else recurrent_units,
                    recurrent_units))
            self.lstm_proj = TorchDense(recurrent_units, self.coord_units)
        # The JAX model's LSTM branch creates no frame offset.
        if self.learn_frame_offset and cell_type != "lstm":
            self.frame_offset = nn.Parameter(
                torch.zeros(self.coord_units // 2))
        self.decoder_cfg = DecoderConfig(img_hw=(img, img), tmpl_size=t,
                                         n_objs=o, conv_ch=ch, log_sig=1.0)

    def without_enhancers(self) -> "PhysicsNet":
        """A shallow copy with the inference enhancers off, sharing every
        parameter, buffer and submodule (``--enhancers_eval_only``: the train
        step runs it while evals keep the enhancers)."""
        clone = copy.copy(self)
        for name in ENHANCERS:
            object.__setattr__(clone, name, 0)
        return clone

    def _render_fn(self, assets: DecoderAssets):
        """The decoder as a function of positions alone, on detached assets:
        the renderer of the Gauss-Newton position refinement."""
        fixed = DecoderAssets(*(a.detach() for a in assets))
        return lambda p: st_decode(fixed, p, self.decoder_cfg,
                                   backend=self.decoder_backend)[0]

    def forward(self, inp: torch.Tensor, with_extras: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """inp: [B, T, C, H, W] float32 in [0, 1].

        Returns (output_seq [B, pred+extrap, C, H, W], aux dict with
        recons_out [B, input+pred, C, H, W], enc_pos, pos_vel_seq and the
        penalties compute_losses reads: center_penalty,
        attn_overlap_penalty, vel_anchor_penalty, coarse_pred_loss and
        pos_consistency_loss). With ``with_extras`` aux also holds
        ``extras``, the visualization tensors in the JAX package's layouts
        (``extra_outputs.npz``); they come from one more decode of the
        encoder's positions through the plain path, while the outputs still
        go through ``decoder_backend``.
        """
        b = inp.shape[0]
        img, ch = self.img_size, self.conv_ch
        t_in = self.input_steps + self.pred_steps
        s = self.input_steps
        cfg = self.decoder_cfg
        cu2 = self.coord_units // 2

        template_raw = self.var_net_template()
        contents_raw = self.var_net_content()
        if 0 < self.active_slots < self.n_objs:
            # Slot curriculum: an inactive slot's template logits go to
            # -1e4, which hides it wherever the warp places it.
            gate = torch.arange(self.n_objs, device=template_raw.device
                                ) < self.active_slots
            template_raw = torch.where(gate[:, None, None], template_raw,
                                       torch.full_like(template_raw, -1e4))
        assets = DecoderAssets(
            template=template_raw, contents=contents_raw,
            background=torch.sigmoid(self.var_net_background()))

        # --- encode input+pred frames (batch and time flattened) ----------
        frames = inp[:, :t_in].reshape(b * t_in, ch, img, img)
        enc_pos_flat, enc_masks, masked_objs = self.encoder(frames)
        if self.refine_recons_pos > 0:
            enc_pos_flat = refine_positions(
                self._render_fn(assets), frames.permute(0, 2, 3, 1),
                enc_pos_flat, iters=self.refine_recons_pos)

        # --- autoencoder path ---------------------------------------------
        recons_flat, _ = st_decode(assets, enc_pos_flat, cfg,
                                   backend=self.decoder_backend)
        recons_out = recons_flat.reshape(b, t_in, img, img, ch)
        enc_pos = enc_pos_flat.reshape(b, t_in, cu2)

        # --- initial state ---------------------------------------------------
        if self.velocity_encoder is not None:
            vel = self.velocity_encoder(enc_pos[:, :s])
        else:
            vel = torch.zeros((b, cu2), dtype=inp.dtype, device=inp.device)
        # The observation window of the rollout start and the state fit,
        # refined against the renderer with --refine_enc_pos (the encoder's
        # positions still drive the autoencoder loss).
        obs_win = enc_pos[:, :s]
        if self.refine_enc_pos > 0 and self.refine_recons_pos == 0:
            obs_win = refine_positions(
                self._render_fn(assets),
                inp[:, :s].reshape(b * s, ch, img, img).permute(0, 2, 3, 1),
                obs_win.reshape(b * s, -1),
                iters=self.refine_enc_pos).reshape(b, s, -1)
        pos = obs_win[:, -1]

        # --- rollout, then one batched decode of every rollout frame ------
        n_steps = self.pred_steps + self.extrap_steps
        if self.cell_type == "lstm":
            start, pos_roll, vel_roll = self._lstm_rollout(pos, vel, n_steps)
            dt = None
        else:
            start, pos_roll, vel_roll, dt = self._cell_rollout(
                inp, obs_win, pos, vel, n_steps)
        frames_flat, _ = st_decode(assets, pos_roll.reshape(b * n_steps, -1),
                                   cfg, backend=self.decoder_backend)
        output_seq = frames_flat.reshape(b, n_steps, img, img, ch)
        pos_vel_seq = torch.cat(
            [start[:, None], torch.cat([pos_roll, vel_roll], dim=2)], dim=1)

        aux = {"recons_out": recons_out.permute(0, 1, 4, 2, 3),
               "enc_pos": enc_pos,
               "pos_vel_seq": pos_vel_seq,
               **self._penalties(inp, template_raw, enc_masks, enc_pos, vel,
                                 output_seq, pos_vel_seq, dt)}
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

    def _cell_rollout(self, inp, obs_win, pos, vel, n_steps):
        """The physics cell's rollout from the encoder's last position and
        the estimated velocity (after the state fit, with
        ``init_state_fit``), in the learned frame offset's coordinates.
        Returns (the start state [B, coord_units], positions and velocities
        [B, n_steps, cu2] in encoder coordinates, the cell's dt)."""
        cu2 = self.coord_units // 2
        step_fn, dt = cells.CELLS[self.cell_type]
        params = cells.CellParams.initial(inp.device)._replace(
            **{name: getattr(self, name)
               for name in CELL_PARAMS[self.cell_type]})
        frame_off = (self.frame_offset if self.learn_frame_offset else
                     torch.zeros(cu2, dtype=inp.dtype, device=inp.device))
        pos_phys0, vel0 = pos + frame_off, vel
        if self.init_state_fit > 0 and self.input_steps > 1:
            if self.cell_type == "bouncing_ode_cell":
                # Reflections break the Gauss-Newton linearization; the
                # unfolded-coordinate fit is exact for free flight.
                pos_phys0, vel0 = fit_initial_state_bouncing(
                    obs_win + frame_off, vel, dt)
            else:
                pos_phys0, vel0 = fit_initial_state(
                    step_fn, params, obs_win + frame_off, vel, dt,
                    self.cell_substeps, self.init_state_fit)
        p, v = pos_phys0, vel0
        pos_roll, vel_roll = [], []
        for _ in range(n_steps):
            p, v = step_fn(params, p, v, dt, substeps=self.cell_substeps)
            # BPTT stabilizer: identity forward, clipped cotangent backward.
            p = cells.clip_cotangent(p)
            v = cells.clip_cotangent(v)
            pos_roll.append(p)
            vel_roll.append(v)
        pos_roll = torch.stack(pos_roll, dim=1) - frame_off         # [B, T, k]
        return (torch.cat([pos_phys0 - frame_off, vel0], dim=1), pos_roll,
                torch.stack(vel_roll, dim=1), dt)

    def _lstm_rollout(self, pos, vel, n_steps):
        """The black-box baseline: the LSTM stack, its carries at zero,
        reads ``[pos, vel]`` each step and ``lstm_proj`` gives the next
        ``[pos, vel]``. No state fit, frame offset or cotangent clip, as in
        the JAX model's branch. The JAX loop decodes each step's positions
        as it goes (T decodes of B frames); the decoded frame never feeds
        back into the LSTM, so the caller decodes all B*T positions in one
        call instead: the same function in fewer launches. Returns (the
        start state, positions and velocities [B, n_steps, cu2])."""
        b = pos.shape[0]
        cells_ = [getattr(self, f"lstm_{i}") for i in range(self.lstm_layers)]
        carries = [(pos.new_zeros(b, c.hidden_size),
                    pos.new_zeros(b, c.hidden_size)) for c in cells_]
        start = torch.cat([pos, vel], dim=1)
        hid, pos_vels = start, []
        for _ in range(n_steps):
            for i, cell in enumerate(cells_):
                carries[i] = cell(hid, carries[i])
                hid = carries[i][0]
            hid = self.lstm_proj(hid)
            pos_vels.append(hid)
        pos_vels = torch.stack(pos_vels, dim=1)                  # [B, T, k]
        cu2 = self.coord_units // 2
        return start, pos_vels[..., :cu2], pos_vels[..., cu2:]

    def _penalties(self, inp, template_raw, enc_masks, enc_pos, vel,
                   output_seq, pos_vel_seq, dt) -> Dict[str, torch.Tensor]:
        """The extension losses, as the JAX model computes them whatever
        their weights (compute_losses applies the weights)."""
        b, s = inp.shape[0], self.input_steps
        img, ch, t = self.img_size, self.conv_ch, self.tmpl_size
        # Template centring: squared distance of each template mask's
        # centroid from the template centre, in template pixels.
        mask = torch.sigmoid(template_raw)                          # [o, T, T]
        coords = torch.arange(t, dtype=mask.dtype, device=mask.device)
        total = torch.sum(mask, dim=(1, 2)) + 1e-6
        cy = torch.sum(mask.sum(dim=2) * coords, dim=1) / total
        cx = torch.sum(mask.sum(dim=1) * coords, dim=1) / total
        centre = (t - 1) / 2.0
        center_penalty = torch.sum((cy - centre) ** 2 + (cx - centre) ** 2)

        # Slot overlap: the sum over pixels of the products of distinct
        # object attention masks.
        attn_obj = enc_masks[:, :self.n_objs]                   # [N, o, H, W]
        pair = (torch.sum(attn_obj, dim=1) ** 2
                - torch.sum(attn_obj ** 2, dim=1))
        attn_overlap_penalty = 0.5 * torch.mean(torch.sum(pair, dim=(1, 2)))

        # Velocity anchor: the central difference around the rollout's start
        # frame s-1 (frame s is inside the encoder window). The LSTM has no
        # dt and no anchor.
        vel_anchor_penalty = torch.zeros((), dtype=inp.dtype,
                                         device=inp.device)
        if s > 1 and dt is not None:
            vel_fd = (enc_pos[:, s] - enc_pos[:, s - 2]) / (2 * dt)
            vel_anchor_penalty = torch.mean((vel - vel_fd) ** 2)

        # Blurred-frame prediction loss: a 7x7 box blur, SAME, always
        # divided by 49 (the zero padding counts).
        coarse_pred_loss = torch.zeros((), dtype=inp.dtype, device=inp.device)
        if self.coarse_loss > 0.0:
            tr = output_seq.shape[1]

            def blur(x):                                    # [B*tr, C, H, W]
                return torch.nn.functional.avg_pool2d(
                    x, 7, 1, 3, count_include_pad=True)

            target = inp[:, s:].reshape(b * tr, ch, img, img)
            out = output_seq.reshape(b * tr, img, img, ch).permute(0, 3, 1, 2)
            diff = (blur(target) - blur(out)).reshape(b, tr, -1)
            coarse_pred_loss = torch.mean(torch.sum(diff ** 2, dim=2))

        # Position consistency: rollout step t gives frame s+t's state; the
        # encoder saw those frames too (its positions are the target).
        cu2 = self.coord_units // 2
        roll_pos = pos_vel_seq[:, 1:1 + self.pred_steps, :cu2]
        enc_tgt = enc_pos[:, s:].detach()
        pos_consistency_loss = torch.mean(
            torch.sum((roll_pos - enc_tgt) ** 2, dim=-1))
        return {"center_penalty": center_penalty,
                "attn_overlap_penalty": attn_overlap_penalty,
                "vel_anchor_penalty": vel_anchor_penalty,
                "coarse_pred_loss": coarse_pred_loss,
                "pos_consistency_loss": pos_consistency_loss}


# The penalties of PhysicsNet's aux dict, each with the model field that
# weighs it in the train loss.
PENALTY_WEIGHTS = {
    "center_penalty": "template_center_loss",
    "vel_anchor_penalty": "vel_anchor",
    "coarse_pred_loss": "coarse_loss",
    "pos_consistency_loss": "pos_consistency",
    "attn_overlap_penalty": "attn_overlap_loss",
}


def compute_losses(model: PhysicsNet, inp: torch.Tensor,
                   output_seq: torch.Tensor, recons_out: torch.Tensor,
                   aux: Optional[Dict[str, Any]] = None,
                   aux_scale: float = 1.0):
    """Squared error summed over (C, H, W), meaned over batch/time slices,
    plus the weighted extension losses found in ``aux`` (PhysicsNet's aux
    dict). Every extension loss but the slot overlap is scaled by
    ``aux_scale`` (0 during --aux_warmup_epochs and until the
    --aux_on_recons trigger), and with ``recons_warmup`` the prediction term
    is too.

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

    pred_weight = aux_scale if model.recons_warmup else 1.0
    # --reference_quirks: the prediction term enters the train loss detached.
    train_pred = pred_loss.detach() if model.reference_quirks else pred_loss
    train_loss = pred_weight * train_pred
    if model.autoencoder_loss > 0.0:
        train_loss = train_loss + model.autoencoder_loss * recons_loss
    for key, field in PENALTY_WEIGHTS.items():
        weight = getattr(model, field)
        if weight > 0.0 and aux is not None and key in aux:
            # The slot-overlap loss is a discovery-phase loss: never gated.
            scale = 1.0 if key == "attn_overlap_penalty" else aux_scale
            train_loss = train_loss + scale * weight * aux[key]
    return train_loss, {
        "eval_pred_loss": pred_loss,
        "eval_extrap_loss": extrap_loss,
        "eval_recons_loss": recons_loss,
    }
