"""Matrix-product FLOPs of one train step.

Counterpart of ``paig_reproduction_tpu/utils/flops.py``, which sums the
``dot_general`` and ``conv_general_dilated`` FLOPs (2*M*N*K a contraction)
of the step's jaxpr through the plain (XLA) decode. ``step_flops`` counts the
same operations of the port's step with ``torch.utils.flop_counter``'s
``FlopCounterMode`` (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the
convolutions and their backward), running one forward, the losses and the
backward of a copy of the model on the ``meta`` device, through the plain
decode: nothing is computed, only shapes flow. The optimizer's update has no
matrix product. Divided by a measured step time it is the step's achieved
matrix FLOP/s, the yardstick of an MFU.
"""
from __future__ import annotations

import copy

import torch


def step_flops(model, batch_size: int, aux_scale: float = 1.0) -> int:
    """Matrix-product and convolution FLOPs of one train step of ``model``
    (forward and backward) at ``batch_size``, with the extension losses at
    ``aux_scale``."""
    from torch.utils.flop_counter import FlopCounterMode

    from paig_reproduction_tpu_torch.models.physics_net import compute_losses

    meta = copy.deepcopy(model).to("meta")
    meta.decoder_backend = "xla"
    img, ch = meta.img_size, meta.conv_ch
    inp = torch.rand((batch_size, meta.seq_len, ch, img, img),
                     device="meta")
    with FlopCounterMode(display=False) as counter:
        out, aux = meta(inp)
        loss, _ = compute_losses(meta, inp, out, aux["recons_out"], aux,
                                 aux_scale=aux_scale)
        loss.backward()
    return int(counter.get_total_flops())
