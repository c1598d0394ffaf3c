"""Spatial-transformer ops: affine grid, bilinear sampling and the separable
axis-aligned warp.

Counterparts of ``paig_reproduction_tpu/ops/stn.py``:

* ``affine_grid`` / ``grid_sample`` are defined as torch's defaults
  (``align_corners=False``, bilinear, zero padding), which is what the
  reference's ``stn()`` uses, and written out as the JAX package writes
  them (elementwise, and four gathers) so that they round as its do.
  ``stn`` and ``batch_transformer`` are the reference's entry points over
  them.
* ``separable_warp``: the decoder's warp is a translation plus a fixed
  scale, so it factorises into two bilinear interpolation matrices, one per
  image axis, applied on either side of a template (``Wy @ T @ Wx^T``); the
  decoder builds the same matrices from ``_base_coords`` and
  ``_interp_matrix``.

No model path uses the first four: they are the reference's API and the
oracle the separable warp is held to.
"""
from __future__ import annotations

import torch


def _base_coords(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized output-pixel centers, align_corners=False convention:
    x_i = (2i + 1)/n - 1."""
    i = torch.arange(n, dtype=dtype, device=device)
    return (2.0 * i + 1.0) / n - 1.0


def affine_grid(theta: torch.Tensor, size) -> torch.Tensor:
    """``F.affine_grid(theta, size, align_corners=False)``, written as the
    JAX package writes it (``F.affine_grid``'s matrix product rounds
    otherwise, and grid_sample scales a grid's error by half the input's
    width). theta: [N, 2, 3]; size: (N, C, H, W). Returns grid
    [N, H, W, 2] whose last dim is (x, y) in normalized [-1, 1] input
    coordinates."""
    _, _, h, w = size
    xs = _base_coords(w, theta.dtype, theta.device)[None, None, :]
    ys = _base_coords(h, theta.dtype, theta.device)[None, :, None]
    t = theta[..., None, None]                               # [N, 2, 3, 1, 1]
    gx = t[:, 0, 0] * xs + t[:, 0, 1] * ys + t[:, 0, 2]
    gy = t[:, 1, 0] * xs + t[:, 1, 1] * ys + t[:, 1, 2]
    return torch.stack([gx, gy], dim=-1)


def grid_sample(inp: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(inp, grid)`` with torch's defaults (bilinear,
    padding_mode='zeros', align_corners=False), written as the JAX package
    writes it: four gathers of the corner taps, zero outside the input,
    weighted by products of the fractional offsets. ``F.grid_sample`` forms
    its weights another way and lands up to 2e-6 away. inp: [N, C, Hi, Wi];
    grid: [N, Ho, Wo, 2] (x, y normalized). Returns [N, C, Ho, Wo]."""
    n, c, hi, wi = inp.shape
    ix = ((grid[..., 0] + 1.0) * wi - 1.0) / 2.0                # [N, Ho, Wo]
    iy = ((grid[..., 1] + 1.0) * hi - 1.0) / 2.0
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    ix1, iy1 = ix0 + 1, iy0 + 1
    wx1, wy1 = ix - ix0, iy - iy0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = inp.reshape(n, c, hi * wi)

    def gather(iy_, ix_):
        valid = (ix_ >= 0) & (ix_ <= wi - 1) & (iy_ >= 0) & (iy_ <= hi - 1)
        idx = (iy_.clamp(0, hi - 1).long() * wi
               + ix_.clamp(0, wi - 1).long()).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        return vals.reshape(n, c, *ix_.shape[1:]) * valid[:, None].to(
            inp.dtype)

    return (gather(iy0, ix0) * (wy0 * wx0)[:, None]
            + gather(iy0, ix1) * (wy0 * wx1)[:, None]
            + gather(iy1, ix0) * (wy1 * wx0)[:, None]
            + gather(iy1, ix1) * (wy1 * wx1)[:, None])


def stn(inp: torch.Tensor, theta: torch.Tensor, out_size) -> torch.Tensor:
    """The reference's ``stn()``: theta is [N, 6] (or [N, 2, 3]); out_size
    is (H, W)."""
    n, c = inp.shape[:2]
    grid = affine_grid(theta.reshape(-1, 2, 3),
                       (n, c, out_size[0], out_size[1]))
    return grid_sample(inp, grid)


def batch_transformer(inp: torch.Tensor, thetas: torch.Tensor, out_size):
    """``num_transforms`` thetas applied to each input (the reference's
    ``batch_transformer``): inp [N, C, H, W], thetas [N, K, 6]; returns
    [N*K, C, Ho, Wo], each input's K warps together."""
    num_batch, num_transforms = thetas.shape[:2]
    rep = torch.repeat_interleave(inp, num_transforms, dim=0)
    return stn(rep, thetas.reshape(num_batch * num_transforms, -1), out_size)


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


def separable_warp(templates: torch.Tensor, sx, tx, sy, ty, out_hw):
    """Axis-aligned bilinear warp as two matrix products.

    Samples ``templates`` [N, C, Hi, Wi] at output pixel (h, w) whose
    normalized coords are (x_w * sx + tx, y_h * sy + ty): exactly
    ``grid_sample(affine_grid(diag(sx, sy) + (tx, ty)))``. sx/tx/sy/ty: [N];
    out_hw: (Ho, Wo). Returns [N, C, Ho, Wo].
    """
    n, c, hi, wi = templates.shape
    ho, wo = out_hw
    dtype, device = templates.dtype, templates.device
    gx = sx[:, None] * _base_coords(wo, dtype, device)[None] + tx[:, None]
    gy = sy[:, None] * _base_coords(ho, dtype, device)[None] + ty[:, None]
    wx = _interp_matrix(((gx + 1.0) * wi - 1.0) / 2.0, wi)      # [N, Wo, Wi]
    wy = _interp_matrix(((gy + 1.0) * hi - 1.0) / 2.0, hi)      # [N, Ho, Hi]
    tmp = torch.einsum("nhi,ncij->nchj", wy, templates)
    return torch.einsum("nchj,nwj->nchw", tmp, wx)
