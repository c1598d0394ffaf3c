"""Spatial-transformer decoder: place learned templates at 2D positions and
softmax-composite them over a learned background.

Counterpart of ``paig_reproduction_tpu/models/decoder.py``. The template,
contents and background networks are evaluated once per forward pass
(``DecoderAssets``). Each object's warp is axis-aligned (translation plus a
fixed scale sigma), so it is two bilinear interpolation matrices applied on
either side of the object's planes. The template is shifted by +5 before
the zero-padded warp and back by -5 after, so pixels outside the template
get mask logit -5 and lose the softmax against the background's constant
logit of +1.

``backend`` keeps the JAX package's names: ``"xla"`` is the plain PyTorch
path below; ``"pallas"`` and ``"auto"`` go to the fused CUDA kernel
(``ops/cuda/st_decoder.py``), which computes the plain path on a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from paig_reproduction_tpu_torch.ops.stn import _base_coords, _interp_matrix

BACKENDS = ("auto", "xla", "pallas")


class DecoderAssets(NamedTuple):
    """Per-forward constants produced by the VariableFromNetwork heads."""

    template: torch.Tensor    # [n_objs, T, T]      raw logits
    contents: torch.Tensor    # [n_objs, T, T, C]   raw (pre-sigmoid)
    background: torch.Tensor  # [H, W, C]           sigmoid-ed


class DecoderConfig(NamedTuple):
    img_hw: tuple            # (H, W)
    tmpl_size: int           # H // 2
    n_objs: int
    conv_ch: int
    log_sig: float = 1.0     # sigma of the warp (1.0 in every task)


def _warp_weights(pos_1d: torch.Tensor, sigma: float, img_size: int,
                  tmpl_size: int, out_size: int) -> torch.Tensor:
    """Interpolation matrix for one axis of the decoder warp.

    pos_1d: [N] object coordinate along this axis (pixels, in [0, img]).
    Returns W: [N, out_size, tmpl_size], for translation
    t = (img/2 - pos) / tmpl_size * sigma and scale sigma under
    align_corners=False normalization.
    """
    t = (img_size / 2.0 - pos_1d) / tmpl_size * sigma               # [N]
    base = _base_coords(out_size, pos_1d.dtype, pos_1d.device)
    grid = sigma * base[None, :] + t[:, None]
    src = ((grid + 1.0) * tmpl_size - 1.0) / 2.0                    # [N, out]
    return _interp_matrix(src, tmpl_size)                           # [N, out, in]


def st_decode(assets: DecoderAssets, pos: torch.Tensor, cfg: DecoderConfig,
              return_extras: bool = False, backend: str = "xla"):
    """Decode per-object positions into composited frames.

    pos: [N, n_objs*2] object-major pixel coordinates [x1, y1, x2, y2, ...].
    Returns (frames [N, H, W, C], extras or None). With ``return_extras``
    the extras dict holds the per-object masks and warped contents; the
    extras path is always the plain one.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown decoder backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend != "xla" and not return_extras:
        from paig_reproduction_tpu_torch.ops.cuda.st_decoder import (
            st_decode_fused,
        )
        return st_decode_fused(assets, pos, cfg), None

    n = pos.shape[0]
    h, w = cfg.img_hw
    sigma = float(cfg.log_sig)

    pos = pos.reshape(n, cfg.n_objs, 2)
    # x translates the width axis, y the height axis.
    px = pos[..., 0].reshape(-1)                                    # [N*o]
    py = pos[..., 1].reshape(-1)
    wx = _warp_weights(px, sigma, w, cfg.tmpl_size, w)
    wy = _warp_weights(py, sigma, h, cfg.tmpl_size, h)
    wx = wx.reshape(n, cfg.n_objs, w, cfg.tmpl_size)
    wy = wy.reshape(n, cfg.n_objs, h, cfg.tmpl_size)

    # Channel stack per object: [template+5, sigmoid(contents)...]
    joint = torch.cat([assets.template[..., None] + 5.0,
                       torch.sigmoid(assets.contents)], dim=-1)     # [o,T,T,C+1]

    # warped[b, o, H, W, c] = sum_ij Wy[b,o,H,i] joint[o,i,j,c] Wx[b,o,W,j]
    tmp = torch.einsum("bohi,oijc->bohjc", wy, joint)
    warped = torch.einsum("bohjc,bowj->bohwc", tmp, wx)

    mask_logits = warped[..., 0] - 5.0                              # [b,o,H,W]
    contents_w = warped[..., 1:]                                    # [b,o,H,W,C]

    bg_logit = torch.ones((n, 1, h, w), dtype=pos.dtype, device=pos.device)
    masks = torch.softmax(torch.cat([mask_logits, bg_logit], dim=1), dim=1)

    out = torch.einsum("bohw,bohwc->bhwc", masks[:, :cfg.n_objs], contents_w)
    out = out + masks[:, cfg.n_objs][..., None] * assets.background[None]

    if not return_extras:
        return out, None
    return out, {"transf_masks": masks, "transf_contents": contents_w}
