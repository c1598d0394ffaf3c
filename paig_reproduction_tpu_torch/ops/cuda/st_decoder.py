"""The fused ST-decoder forward as a CUDA kernel (``csrc/st_decoder.cu``).

Replaces the TPU kernel ``paig_reproduction_tpu/ops/pallas/st_decoder.py``
(``_decode_kernel``). The gradient is the same split the JAX package makes
in ``models/decoder.py::_pallas_decode_fn``: the forward is the kernel, the
backward re-runs the plain decode under autograd. The kernel and the plain
path compute the same function, so that backward is exact.

On a CPU tensor ``st_decode_fused`` computes the plain version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from paig_reproduction_tpu_torch.models.decoder import (
    DecoderAssets,
    DecoderConfig,
    st_decode,
)
from paig_reproduction_tpu_torch.ops.cuda import build

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that the main path went through the kernel).
LAUNCHES = 0

# The kernel keeps per-pixel colour sums for at most this many channels and
# stages the object planes in at most 48 KB of shared memory.
MAX_CH = 3
MAX_SHARED_BYTES = 48 * 1024


def st_decode_plain(assets: DecoderAssets, pos: torch.Tensor,
                    cfg: DecoderConfig) -> torch.Tensor:
    """The kernel's function in plain PyTorch: frames [N, H, W, C]."""
    return st_decode(assets, pos, cfg, backend="xla")[0]


@functools.cache
def _forward_fn():
    fn = build.load("st_decoder").st_decode_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(assets: DecoderAssets, pos: torch.Tensor, cfg: DecoderConfig):
    h, w = cfg.img_hw
    t, o, ch = cfg.tmpl_size, cfg.n_objs, cfg.conv_ch
    expected = {"pos": (pos.shape[0], 2 * o), "template": (o, t, t),
                "contents": (o, t, t, ch), "background": (h, w, ch)}
    tensors = {"pos": pos, "template": assets.template,
               "contents": assets.contents, "background": assets.background}
    for name, x in tensors.items():
        if x.device != pos.device or x.device.type != "cuda":
            raise ValueError(f"{name} must be on pos's CUDA device, "
                             f"got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {expected[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h != w:
        raise ValueError(f"the kernel takes square frames, got {cfg.img_hw}")
    if not 1 <= ch <= MAX_CH:
        raise ValueError(f"the kernel takes 1..{MAX_CH} channels, got {ch}")
    if 4 * o * (ch + 1) * t * t > MAX_SHARED_BYTES:
        raise ValueError(f"{o} objects of {ch + 1} {t}x{t} planes exceed "
                         f"{MAX_SHARED_BYTES} bytes of shared memory")


def launch(assets: DecoderAssets, pos: torch.Tensor,
           cfg: DecoderConfig) -> torch.Tensor:
    """One kernel launch on the current stream: frames [N, H, W, C]."""
    global LAUNCHES
    _check(assets, pos, cfg)
    h, w = cfg.img_hw
    out = torch.empty((pos.shape[0], h, w, cfg.conv_ch), dtype=pos.dtype,
                      device=pos.device)
    with torch.cuda.device(pos.device):
        err = _forward_fn()(
            pos.data_ptr(), assets.template.data_ptr(),
            assets.contents.data_ptr(), assets.background.data_ptr(),
            out.data_ptr(), pos.shape[0], h, cfg.tmpl_size, cfg.n_objs,
            cfg.conv_ch, float(cfg.log_sig),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"st_decode_forward launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


class _STDecode(torch.autograd.Function):
    """Kernel forward; backward through the plain decode (exact, since the
    two compute the same function)."""

    @staticmethod
    def forward(ctx, template, contents, background, pos, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(template, contents, background, pos)
        return launch(DecoderAssets(template, contents, background), pos,
                      cfg)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:4])]
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = st_decode_plain(DecoderAssets(*inputs[:3]), inputs[3],
                                      ctx.cfg)
                grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if x.requires_grad else None
                  for x in inputs), None)


def st_decode_fused(assets: DecoderAssets, pos: torch.Tensor,
                    cfg: DecoderConfig) -> torch.Tensor:
    """Decoded frames [N, H, W, C]: the plain version for CPU tensors, the
    CUDA kernel (with the plain version's gradient) for CUDA tensors."""
    if pos.device.type == "cpu":
        return st_decode_plain(assets, pos, cfg)
    return _STDecode.apply(assets.template.contiguous(),
                           assets.contents.contiguous(),
                           assets.background.contiguous(),
                           pos.contiguous(), cfg)
