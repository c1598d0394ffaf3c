"""Interpolation helpers of the axis-aligned spatial-transformer warp.

Counterparts of ``paig_reproduction_tpu/ops/stn.py::_base_coords`` and
``_interp_matrix``. The decoder's warp is a translation plus a fixed scale,
so it factorises into two bilinear interpolation matrices, one per image
axis, applied on either side of a template (``Wy @ T @ Wx^T``).
"""
from __future__ import annotations

import torch


def _base_coords(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized output-pixel centers, align_corners=False convention:
    x_i = (2i + 1)/n - 1."""
    i = torch.arange(n, dtype=dtype, device=device)
    return (2.0 * i + 1.0) / n - 1.0


def _interp_matrix(src_coords: torch.Tensor, n_in: int) -> torch.Tensor:
    """Bilinear interpolation matrix with zero padding.

    src_coords: [..., n_out] fractional source pixel indices.
    Returns W: [..., n_out, n_in] with W @ signal == linear interpolation of
    the signal at src_coords (zero outside [0, n_in-1]); each row has at
    most two non-zeros.
    """
    i = torch.arange(n_in, dtype=src_coords.dtype, device=src_coords.device)
    d = src_coords[..., None] - i
    return torch.clamp(1.0 - torch.abs(d), min=0.0)
