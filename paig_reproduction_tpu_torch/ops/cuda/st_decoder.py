"""The fused ST-decoder forward as a CUDA kernel (``csrc/st_decoder.cu``).

Replaces the TPU kernel ``paig_reproduction_tpu/ops/pallas/st_decoder.py``
(``_decode_kernel``). The gradient is the same split the JAX package makes
in ``models/decoder.py::_pallas_decode_fn``: the forward is the kernel, the
backward re-runs the plain decode under autograd. The kernel and the plain
path compute the same function, so that backward is exact. Forward mode
(``torch.func.jvp``, used by the Gauss-Newton position refinement) makes the
same split: the primal is the kernel, the tangent the plain decode's JVP.

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

# The kernel keeps per-pixel colour sums for at most MAX_CH channels and the
# warped values of at most MAX_OBJS objects in registers, and stages the
# planes, the background and its tables in the shared memory one block may
# use on an H100 (227 KB). A block is WARPS warps.
MAX_CH = 3
MAX_OBJS = 4
WARPS = 32
MAX_SHARED_BYTES = 227 * 1024


def st_decode_plain(assets: DecoderAssets, pos: torch.Tensor,
                    cfg: DecoderConfig) -> torch.Tensor:
    """The kernel's function in plain PyTorch: frames [N, H, W, C]."""
    return st_decode(assets, pos, cfg, backend="xla")[0]


@functools.cache
def _lib():
    lib = build.load("st_decoder")
    lib.st_decode_configure.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.st_decode_configure.restype = ctypes.c_int
    lib.st_decode_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.st_decode_forward.restype = ctypes.c_int
    return lib


def shared_bytes(cfg: DecoderConfig) -> int:
    """Dynamic shared memory of one block (csrc/st_decoder.cu,
    shared_bytes): the planes as one float4 per texel, the background, each
    warp's 32-row y table of float4s, the raw planes as the prologue copies
    them and one base coordinate a row."""
    img, t, o, ch = cfg.img_hw[0], cfg.tmpl_size, cfg.n_objs, cfg.conv_ch
    return 4 * (4 * o * t * t + -(-img * img * ch // 4) * 4 + WARPS * 32 * 4
                + o * t * t * (1 + ch) + img)


def check_limits(cfg: DecoderConfig):
    """Raises ValueError for a configuration the kernel does not take."""
    h, w = cfg.img_hw
    o, ch = cfg.n_objs, cfg.conv_ch
    if h != w:
        raise ValueError(f"the kernel takes square frames, got {cfg.img_hw}")
    if not 1 <= ch <= MAX_CH:
        raise ValueError(f"the kernel takes 1..{MAX_CH} channels, got {ch}")
    if not 1 <= o <= MAX_OBJS:
        raise ValueError(f"the kernel takes 1..{MAX_OBJS} objects, got {o}")
    if shared_bytes(cfg) > MAX_SHARED_BYTES:
        raise ValueError(f"{shared_bytes(cfg)} bytes of shared memory for "
                         f"{cfg} exceed the {MAX_SHARED_BYTES} a block may "
                         f"use")


@functools.cache
def _slots(device: int, cfg: DecoderConfig) -> int:
    """Checks `cfg` against the kernel's limits and sets the kernel up for
    it on a device, once: its shared-memory limit, and how many of its
    blocks the device runs at once (returned)."""
    check_limits(cfg)
    slots = ctypes.c_int()
    with torch.cuda.device(device):
        err = _lib().st_decode_configure(cfg.img_hw[0], cfg.tmpl_size,
                                         cfg.n_objs, cfg.conv_ch,
                                         ctypes.byref(slots))
    if err:
        raise RuntimeError(f"st_decode_configure failed: CUDA error {err}")
    return slots.value


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


def launch(assets: DecoderAssets, pos: torch.Tensor,
           cfg: DecoderConfig) -> torch.Tensor:
    """One kernel launch on the current stream: frames [N, H, W, C]."""
    global LAUNCHES
    _check(assets, pos, cfg)
    slots = _slots(pos.device.index, cfg)
    img, t, o, ch = cfg.img_hw[0], cfg.tmpl_size, cfg.n_objs, cfg.conv_ch
    out = torch.empty((pos.shape[0], img, img, ch), dtype=pos.dtype,
                      device=pos.device)
    with torch.cuda.device(pos.device):
        err = _lib().st_decode_forward(
            pos.data_ptr(), assets.template.data_ptr(),
            assets.contents.data_ptr(), assets.background.data_ptr(),
            out.data_ptr(), pos.shape[0], img, t, o, ch,
            float(cfg.log_sig), slots,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"st_decode_forward launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


class _STDecode(torch.autograd.Function):
    """Kernel forward. The backward and the forward-mode (``jvp``) rules are
    the plain decode's, under autograd and under ``torch.func.jvp``: exact,
    since the kernel and the plain decode compute the same function. The
    ``jvp`` rule serves ``torch.func`` transforms; inside a
    ``torch.autograd.forward_ad`` dual level it raises, as PyTorch does not
    nest forward-mode levels."""

    @staticmethod
    def forward(template, contents, background, pos, cfg):
        with torch.profiler.record_function("st_decode.forward"):
            return launch(DecoderAssets(template, contents, background),
                          pos, cfg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, ctx.cfg = inputs
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:4])]
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad(), torch.profiler.record_function(
                    "st_decode.backward"):
                out = st_decode_plain(DecoderAssets(*inputs[:3]), inputs[3],
                                      ctx.cfg)
                grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if x.requires_grad else None
                  for x in inputs), None)

    @staticmethod
    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        tangents = [torch.zeros_like(x) if t is None else t
                    for x, t in zip(primals, tangents[:4])]
        cfg = ctx.cfg
        with torch.profiler.record_function("st_decode.jvp"):
            return torch.func.jvp(
                lambda t, c, b, p: st_decode_plain(DecoderAssets(t, c, b), p,
                                                   cfg),
                tuple(primals), tuple(tangents))[1]


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
