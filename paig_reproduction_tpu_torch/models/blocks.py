"""Neural building blocks as ``torch.nn`` modules (NCHW inside).

Counterparts of ``paig_reproduction_tpu/models/blocks.py``:
``TorchDense``, ``TorchConv``, ``ShallowUNet`` (inputs under 40 px),
``UNet`` (40 px and more), ``ConvolutionalEncoder``, ``VelocityEncoder``
and ``VariableFromNetwork``.

Every layer draws its kernel and bias from U(+-1/sqrt(fan_in)), torch's own
Linear/Conv2d default, from an explicit ``torch.Generator``. Weights can
instead be carried over from the JAX package with ``convert.py``.

``dtype`` (``None`` = the input's) is a layer's computation dtype, as in the
JAX package: the weights stay float32 (the master weights the optimizer and
the checkpoint see) and are cast with the input on every call. With
``torch.bfloat16`` the encoder's UNet and its two hidden MLP layers run in
bf16; the mask softmax, the final 2-unit projection and the tanh stay in the
input's dtype. The bias is added after the product, in that dtype, as flax
does: rounding the product before the sum halves the gap to the JAX
model's bf16 positions (tests/test_torch_bf16.py). The casts are explicit rather than ``torch.autocast``, which
picks its own set of operations (it would also cast the final projection
and the decoder's resize GEMMs).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paig_reproduction_tpu_torch.ops.resize import resize_bilinear


def _fan_in_uniform_(module: nn.Module, fan_in: int,
                     generator: Optional[torch.Generator]):
    bound = 1.0 / np.sqrt(fan_in)
    with torch.no_grad():
        module.weight.uniform_(-bound, bound, generator=generator)
        module.bias.uniform_(-bound, bound, generator=generator)


class TorchDense(nn.Linear):
    """``nn.Linear`` with its kernel and bias drawn from ``generator``,
    computing in ``dtype`` (see the module docstring). Under tensor
    parallelism (``parallel/mesh.py``, ``shard_model``) ``tp_forward``
    computes the layer from this process's slice of its kernel."""

    tp_forward = None

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        _fan_in_uniform_(self, in_features, generator)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_forward is not None:
            return self.tp_forward(self, x)
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class TorchConv(nn.Conv2d):
    """k x k SAME convolution (3 x 3 by default), NCHW, computing in
    ``dtype`` (see the module docstring)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size,
                         padding=kernel_size // 2)
        _fan_in_uniform_(self, in_ch * kernel_size ** 2, generator)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return (self._conv_forward(x.to(dt), self.weight.to(dt), None)
                + self.bias.to(dt)[:, None, None])


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class ShallowUNet(nn.Module):
    """Two-level UNet for inputs under 40 px: channel progression h/2h/4h,
    bilinear-resize upsampling, skip concatenations, no ReLU after the
    post-resize convs (6 and 9) and a ReLU on the final 1x1 conv."""

    def __init__(self, in_ch: int, hidden: int = 8, out_features: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        h = hidden
        shapes = [(in_ch, h), (h, h), (h, 2 * h), (2 * h, 2 * h),
                  (2 * h, 4 * h), (4 * h, 4 * h),
                  (4 * h, 2 * h), (4 * h, 2 * h), (2 * h, 2 * h),
                  (2 * h, 2 * h), (3 * h, h), (h, h)]
        self.convs = nn.ModuleList(
            [TorchConv(i, o, generator=generator, dtype=dtype)
             for i, o in shapes]
            + [TorchConv(h, out_features, kernel_size=1,
                         generator=generator, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, C, H, W]
        c = self.convs
        height, width = x.shape[2], x.shape[3]
        x = F.relu(c[0](x))
        x1 = F.relu(c[1](x))
        x = _max_pool2(x1)
        x = F.relu(c[2](x))
        x2 = F.relu(c[3](x))
        x = _max_pool2(x2)
        x = F.relu(c[4](x))
        x = F.relu(c[5](x))

        x = c[6](resize_bilinear(x, (height // 2, width // 2)))
        x = torch.cat([x, x2], dim=1)
        x = F.relu(c[7](x))
        x = F.relu(c[8](x))

        x = c[9](resize_bilinear(x, (height, width)))
        x = torch.cat([x, x1], dim=1)
        x = F.relu(c[10](x))
        x = F.relu(c[11](x))
        return F.relu(c[12](x))


class UNet(nn.Module):
    """Three-level UNet for inputs of 40 px and more: channel progression
    h/2h/4h/8h down, 8h -> 2h and skip concatenations up, bilinear-resize
    upsampling, no ReLU after the post-resize convs (9, 12 and 15) and none
    on the final 1x1 conv."""

    def __init__(self, in_ch: int, hidden: int = 16, out_features: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        h = hidden
        shapes = [(in_ch, h), (h, h), (h, 2 * h), (2 * h, 2 * h),
                  (2 * h, 4 * h), (4 * h, 4 * h), (4 * h, 8 * h),
                  (8 * h, 8 * h), (8 * h, 2 * h), (6 * h, 4 * h),
                  (4 * h, 4 * h), (4 * h, 2 * h), (4 * h, 2 * h),
                  (2 * h, 2 * h), (2 * h, 2 * h), (3 * h, h), (h, h)]
        self.convs = nn.ModuleList(
            [TorchConv(i, o, generator=generator, dtype=dtype)
             for i, o in shapes]
            + [TorchConv(h, out_features, kernel_size=1,
                         generator=generator, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, C, H, W]
        c = self.convs
        height, width = x.shape[2], x.shape[3]
        x = F.relu(c[0](x))
        x1 = F.relu(c[1](x))
        x = _max_pool2(x1)
        x = F.relu(c[2](x))
        x2 = F.relu(c[3](x))
        x = _max_pool2(x2)
        x = F.relu(c[4](x))
        x3 = F.relu(c[5](x))
        x = _max_pool2(x3)
        x = F.relu(c[6](x))
        x = F.relu(c[7](x))

        x = c[8](resize_bilinear(x, (height // 4, width // 4)))
        x = torch.cat([x, x3], dim=1)                           # 2h + 4h
        x = F.relu(c[9](x))
        x = F.relu(c[10](x))

        x = c[11](resize_bilinear(x, (height // 2, width // 2)))
        x = torch.cat([x, x2], dim=1)                           # 2h + 2h
        x = F.relu(c[12](x))
        x = F.relu(c[13](x))

        x = c[14](resize_bilinear(x, (height, width)))
        x = torch.cat([x, x1], dim=1)                           # 2h + h
        x = F.relu(c[15](x))
        x = F.relu(c[16](x))
        return c[17](x)


class ConvolutionalEncoder(nn.Module):
    """UNet attention-mask encoder -> per-object 2D pixel coordinates.

    The UNet (``ShallowUNet`` under 40 px, ``UNet`` from 40 px) emits one
    mask logit per object; a constant ones channel is appended for the
    background; softmax over channels; each object mask multiplies the
    input frame; objects are folded into the batch for a shared 3-layer MLP
    coordinate head that reads the masked frame in (H, W, C) order, 2x2
    average-pooled from 40 px; the output is tanh * (W/2) + (W/2).

    With ``0 < active_slots < n_objs`` only the first ``active_slots``
    slots take part in the softmax: the others' logits become -1e6 (a hard
    gate), or with ``slot_gate_soft > 0`` are lowered by that much.

    ``dtype`` is the UNet's and the two hidden MLP layers' computation
    dtype; their outputs are cast back to the input's dtype before the
    softmax and before the final projection.

    Input [N, C, H, W]. Returns (positions [N, n_objs*2] object-major,
    enc_masks [N, n_objs+1, H, W], masked_objs [n_objs*N, C, H, W]).
    """

    def __init__(self, input_hw, in_ch: int, n_objs: int = 2,
                 hidden_dim: int = 200, out_features: int = 2,
                 generator: Optional[torch.Generator] = None,
                 active_slots: int = 0, slot_gate_soft: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        height, width = input_hw
        self.input_hw = tuple(input_hw)
        self.n_objs = n_objs
        self.out_features = out_features
        self.active_slots = active_slots
        self.slot_gate_soft = slot_gate_soft
        self.small = width < 40
        if self.small:
            self.unet = ShallowUNet(in_ch, 8, n_objs, generator, dtype)
            head_in = height * width * in_ch
        else:
            self.unet = UNet(in_ch, 16, n_objs, generator, dtype)
            head_in = (height // 2) * (width // 2) * in_ch
        self.dense = nn.ModuleList([
            TorchDense(head_in, hidden_dim, generator, dtype),
            TorchDense(hidden_dim, hidden_dim, generator, dtype),
            TorchDense(hidden_dim, out_features, generator)])

    def forward(self, inp: torch.Tensor):
        n, ch = inp.shape[0], inp.shape[1]
        height, width = self.input_hw
        o = self.n_objs
        logits = self.unet(inp).to(inp.dtype)                   # [N, o, H, W]
        if 0 < self.active_slots < o:
            gate = (torch.arange(o, device=logits.device)
                    < self.active_slots)[None, :, None, None]
            gated = (logits - self.slot_gate_soft if self.slot_gate_soft > 0
                     else torch.full_like(logits, -1e6))
            logits = torch.where(gate, logits, gated)
        ones = torch.ones((n, 1, height, width), dtype=logits.dtype,
                          device=logits.device)
        enc_masks = torch.softmax(torch.cat([logits, ones], dim=1), dim=1)

        # Object-major fold into the batch: [o, N, C, H, W].
        masked = enc_masks[:, :o].transpose(0, 1)[:, :, None] * inp[None]
        masked = masked.reshape(o * n, ch, height, width)

        x = masked if self.small else F.avg_pool2d(masked, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(o * n, -1)
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x)).to(inp.dtype)
        x = self.dense[2](x)                                    # [o*N, 2]

        x = x.reshape(o, n, self.out_features).transpose(0, 1)
        x = x.reshape(n, o * self.out_features)
        x = torch.tanh(x) * (width / 2) + (width / 2)
        return x, enc_masks, masked


class VelocityEncoder(nn.Module):
    """Initial-velocity estimator from the first ``input_steps`` encoded
    positions: a per-object MLP over the stacked positions, or with
    ``alt_vel`` a learned linear combination of frame-to-frame differences.
    Objects are folded into the batch so weights are shared across them."""

    def __init__(self, alt_vel: bool, input_steps: int, n_objs: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.alt_vel = alt_vel
        self.input_steps = input_steps
        self.n_objs = n_objs
        if alt_vel:
            self.dense = nn.ModuleList(
                [TorchDense((input_steps - 1) * 2, 2, generator)])
        else:
            self.dense = nn.ModuleList([
                TorchDense(input_steps * 2, 100, generator),
                TorchDense(100, 100, generator),
                TorchDense(100, 2, generator)])

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        b, s, o = pos.shape[0], self.input_steps, self.n_objs
        if self.alt_vel:
            h = pos[:, 1:] - pos[:, :-1]                        # [B, S-1, o*2]
            h = h.reshape(b, s - 1, o, 2).permute(2, 0, 1, 3)
            h = self.dense[0](h.reshape(o * b, (s - 1) * 2))
        else:
            h = pos.reshape(b, s, o, 2).permute(2, 0, 1, 3)
            h = torch.tanh(self.dense[0](h.reshape(o * b, s * 2)))
            h = torch.tanh(self.dense[1](h))
            h = self.dense[2](h)
        return h.reshape(o, b, 2).transpose(0, 1).reshape(b, o * 2)


class VariableFromNetwork(nn.Module):
    """A free variable of arbitrary shape generated by a 2-layer MLP applied
    to a constant ones(1, 10) input (the learned object templates, contents
    and background). ``init_bias``, a constant array of ``shape``, is added
    to the output: the variable starts at that prior and the MLP learns
    deltas around it. It is a buffer, not a parameter, and is not saved."""

    def __init__(self, shape: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 init_bias=None):
        super().__init__()
        self.shape = tuple(shape)
        self.dense = nn.ModuleList([
            TorchDense(10, 200, generator),
            TorchDense(200, int(np.prod(self.shape)), generator)])
        self.register_buffer(
            "init_bias", None if init_bias is None else
            torch.as_tensor(init_bias, dtype=torch.float32).reshape(
                self.shape), persistent=False)

    def forward(self) -> torch.Tensor:
        w = self.dense[0].weight
        x = torch.ones((1, 10), dtype=w.dtype, device=w.device)
        x = torch.tanh(self.dense[0](x))
        x = self.dense[1](x).reshape(self.shape)
        if self.init_bias is not None:
            x = x + self.init_bias
        return x
