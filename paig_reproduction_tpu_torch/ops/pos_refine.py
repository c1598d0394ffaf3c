"""Subpixel position refinement against the model's own renderer.

Counterpart of ``paig_reproduction_tpu/ops/pos_refine.py``
(``--refine_recons_pos``, ``--refine_enc_pos``). Starting from the encoder's
positions, a few Levenberg-damped Gauss-Newton steps minimise
``||render(p) - frame||^2`` per frame, with the model's ST decoder as the
renderer.

The render's Jacobian with respect to the ``cu2`` position coordinates comes
from forward mode: the ``cu2`` basis tangents ride as an extra batch axis, so
each iteration is one ``torch.func.jvp`` of the render over ``cu2 * N``
frames. Its primal (the first ``N`` frames) is the render at the current
positions. On a CUDA tensor that primal is a launch of the decoder kernel and
the tangent is its forward-mode rule (``ops/cuda/st_decoder.py``).
"""
from __future__ import annotations

import torch


def refine_positions(render_fn, frames: torch.Tensor, pos0: torch.Tensor,
                     iters: int = 3, damping: float = 1e-1,
                     max_step: float = 1.5) -> torch.Tensor:
    """Gauss-Newton refinement of object positions against observed frames.

    render_fn: positions [M, cu2] -> frames [M, H, W, C], batched over M
    (the decoder with fixed assets); frames: [N, H, W, C] observed;
    pos0: [N, cu2] initial positions. Returns positions [N, cu2] with a
    straight-through gradient to ``pos0``.

    Damping is relative (on diag(JtJ)); each step is clipped to
    ``max_step`` px; a coordinate that ends non-finite keeps ``pos0``.
    """
    y = frames.detach().reshape(frames.shape[0], -1)
    p0 = pos0.detach()
    n, cu2 = p0.shape
    basis = torch.eye(cu2, dtype=p0.dtype, device=p0.device)
    tangents = basis.repeat_interleave(n, dim=0)              # [cu2*N, cu2]
    p = p0
    for _ in range(iters):
        out, jt = torch.func.jvp(render_fn, (p.repeat(cu2, 1),), (tangents,))
        j = jt.reshape(cu2, n, -1).permute(1, 2, 0)          # [N, HWC, cu2]
        r = out[:n].reshape(n, -1) - y
        jtj = torch.einsum("nik,nil->nkl", j, j)
        jtr = torch.einsum("nik,ni->nk", j, r)
        diag = torch.diagonal(jtj, dim1=1, dim2=2)
        lm = jtj + (damping * diag + 1e-8)[..., None] * basis
        dp = -torch.linalg.solve_ex(lm, jtr[..., None])[0][..., 0]
        p = p + torch.clamp(dp, -max_step, max_step)
    p = torch.where(torch.isfinite(p), p, p0)
    return pos0 + (p - p0).detach()
