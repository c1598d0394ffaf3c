"""Bilinear resize of the ShallowUNet decoder path.

Counterpart of ``paig_reproduction_tpu/ops/resize.py::resize_bilinear``
(``jax.image.resize``, method 'linear', no antialias). Like that resize it
is separable: one interpolation matrix per axis, built with the same rule
(half-pixel sample positions, a triangle kernel, weights renormalised over
the taps inside the input), applied with two matrix products. On the card
those are cuBLAS GEMMs; ``F.interpolate``'s NCHW bilinear kernel loops over
batch and channels inside each thread and took 6 ms per UNet upsample at
B=100 on an H100 (PERF.md).
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """W [n_out, n_in] with W @ signal == the linear resize of the signal,
    by jax.image.resize's weight rule (antialias off), computed in float32
    and cast to ``dtype`` as jax.image.resize casts its weights to the
    input's dtype."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)
    sample = ((torch.arange(n_out, dtype=f32, device=device) + 0.5)
              * inv_scale - 0.5)                                  # [out]
    taps = torch.arange(n_in, dtype=f32, device=device)           # [in]
    w = torch.clamp(1.0 - torch.abs(sample[:, None] - taps[None, :]),
                    min=0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w)).to(dtype)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x: [N, C, H, W] -> [N, C, out_h, out_w]."""
    wy = _resize_matrix(x.shape[-2], int(out_hw[0]), x.dtype, x.device)
    wx = _resize_matrix(x.shape[-1], int(out_hw[1]), x.dtype, x.device)
    x = torch.matmul(x, wx.t())                                   # [N,C,H,ow]
    x = torch.matmul(x.transpose(-1, -2), wy.t())                 # [N,C,ow,oh]
    return x.transpose(-1, -2).contiguous()
