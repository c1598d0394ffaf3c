"""Parity: the port's ST decoder (models/decoder.py and the CPU path of the
kernel wrapper ops/cuda/st_decoder.py) against the JAX package's st_decode
and its Pallas kernel run in interpret mode.

Tolerances: the forward is held to atol 2e-5, the Pallas kernel's own
parity bound (tests/test_pallas_decoder.py): both sides compute in f32 and
differ only in the order of their sums. Gradients are held to rtol 1e-4 /
atol 1e-5 against jax.vjp, the bound of the JAX package's own backend
parity test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import decoder as jdec
from paig_reproduction_tpu.ops.pallas.st_decoder import st_decode_pallas
from paig_reproduction_tpu_torch.models import decoder as tdec
from paig_reproduction_tpu_torch.ops.cuda import st_decoder as tkernel

# (img, tmpl, n_objs, n): the three task families (32 px spring/bouncing,
# 36 px 3-body, 64 px mnist).
FAMILIES = [(32, 16, 2, 6), (36, 18, 3, 5), (64, 32, 2, 3)]


def _inputs(img, tmpl, n_objs, ch, n, seed):
    rs = np.random.RandomState(seed)
    template = rs.randn(n_objs, tmpl, tmpl).astype(np.float32)
    contents = rs.randn(n_objs, tmpl, tmpl, ch).astype(np.float32)
    background = rs.rand(img, img, ch).astype(np.float32)
    # Positions over the frame and beyond its edges (zero padding).
    pos = (rs.rand(n, n_objs * 2) * 1.5 * img - 0.25 * img).astype(
        np.float32)
    return template, contents, background, pos


def _jax_cfg(img, tmpl, n_objs, ch):
    return jdec.DecoderConfig(img_hw=(img, img), tmpl_size=tmpl,
                              n_objs=n_objs, conv_ch=ch, log_sig=1.0)


def _torch_cfg(img, tmpl, n_objs, ch):
    return tdec.DecoderConfig(img_hw=(img, img), tmpl_size=tmpl,
                              n_objs=n_objs, conv_ch=ch, log_sig=1.0)


@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("img,tmpl,n_objs,n", FAMILIES)
def test_plain_decode_matches_jax_and_pallas(img, tmpl, n_objs, n, ch):
    template, contents, background, pos = _inputs(img, tmpl, n_objs, ch, n,
                                                  seed=img + ch)
    jcfg = _jax_cfg(img, tmpl, n_objs, ch)

    @jax.jit
    def jax_decodes(t, c, b, p):
        ref, _ = jdec.st_decode(jdec.DecoderAssets(t, c, b), p, jcfg)
        joint = jnp.concatenate([t[..., None] + 5.0, jax.nn.sigmoid(c)],
                                axis=-1)
        return ref, st_decode_pallas(p, joint, b, img=img, tmpl=tmpl,
                                     n_objs=n_objs, ch=ch, sigma=1.0,
                                     b_tile=4, interpret=True)

    j_ref, j_pallas = jax_decodes(template, contents, background, pos)

    t_assets = tdec.DecoderAssets(torch.from_numpy(template),
                                  torch.from_numpy(contents),
                                  torch.from_numpy(background))
    cfg = _torch_cfg(img, tmpl, n_objs, ch)
    out, extras = tdec.st_decode(t_assets, torch.from_numpy(pos), cfg)
    assert extras is None
    np.testing.assert_allclose(out.numpy(), np.asarray(j_ref), atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_pallas), atol=2e-5)
    # The kernel's names route to the wrapper, which is the plain path on
    # a CPU tensor.
    for backend in ("auto", "pallas"):
        fused, _ = tdec.st_decode(t_assets, torch.from_numpy(pos), cfg,
                                  backend=backend)
        np.testing.assert_allclose(fused.numpy(), out.numpy(), atol=0)


@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("img,tmpl,n_objs,n", FAMILIES)
def test_decode_grads_match_jax_vjp(img, tmpl, n_objs, n, ch):
    template, contents, background, pos = _inputs(img, tmpl, n_objs, ch, n,
                                                  seed=7 * img + ch)
    cot = np.random.RandomState(1).randn(n, img, img, ch).astype(np.float32)
    jcfg = _jax_cfg(img, tmpl, n_objs, ch)

    def jfn(t, c, b, p):
        return jdec.st_decode(jdec.DecoderAssets(t, c, b), p, jcfg)[0]

    @jax.jit
    def jax_grads(t, c, b, p, g):
        return jax.vjp(jfn, t, c, b, p)[1](g)

    j_grads = jax_grads(template, contents, background, pos, cot)

    leaves = [torch.tensor(a, requires_grad=True)
              for a in (template, contents, background, pos)]
    out = tkernel.st_decode_fused(tdec.DecoderAssets(*leaves[:3]), leaves[3],
                                  _torch_cfg(img, tmpl, n_objs, ch))
    t_grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for name, tg, jg in zip(("template", "contents", "background", "pos"),
                            t_grads, j_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_return_extras_match_jax():
    img, tmpl, n_objs, ch, n = 32, 16, 2, 3, 4
    template, contents, background, pos = _inputs(img, tmpl, n_objs, ch, n,
                                                  seed=11)
    _, j_extras = jdec.st_decode(
        jdec.DecoderAssets(jnp.asarray(template), jnp.asarray(contents),
                           jnp.asarray(background)),
        jnp.asarray(pos), _jax_cfg(img, tmpl, n_objs, ch),
        return_extras=True)
    # The extras path is the plain one whatever the backend.
    _, t_extras = tdec.st_decode(
        tdec.DecoderAssets(torch.from_numpy(template),
                           torch.from_numpy(contents),
                           torch.from_numpy(background)),
        torch.from_numpy(pos), _torch_cfg(img, tmpl, n_objs, ch),
        return_extras=True, backend="pallas")
    for key in ("transf_masks", "transf_contents"):
        np.testing.assert_allclose(t_extras[key].numpy(),
                                   np.asarray(j_extras[key]), atol=2e-5)


def test_large_template_logits_stay_finite():
    img, tmpl, n_objs, ch, n = 32, 16, 2, 3, 4
    template, contents, background, pos = _inputs(img, tmpl, n_objs, ch, n,
                                                  seed=2)
    template[:] = 90.0
    out, _ = tdec.st_decode(
        tdec.DecoderAssets(torch.from_numpy(template),
                           torch.from_numpy(contents),
                           torch.from_numpy(background)),
        torch.from_numpy(pos), _torch_cfg(img, tmpl, n_objs, ch))
    assert bool(torch.isfinite(out).all())


def test_unknown_backend_raises():
    template, contents, background, pos = _inputs(32, 16, 2, 3, 2, seed=3)
    with pytest.raises(ValueError):
        tdec.st_decode(tdec.DecoderAssets(torch.from_numpy(template),
                                          torch.from_numpy(contents),
                                          torch.from_numpy(background)),
                       torch.from_numpy(pos), _torch_cfg(32, 16, 2, 3),
                       backend="triton")


def test_kernel_launch_rejects_cpu_tensors():
    """The launcher itself takes CUDA tensors only; the CPU path never
    reaches it."""
    template, contents, background, pos = _inputs(32, 16, 2, 3, 2, seed=4)
    assets = tdec.DecoderAssets(torch.from_numpy(template),
                                torch.from_numpy(contents),
                                torch.from_numpy(background))
    before = tkernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.launch(assets, torch.from_numpy(pos),
                       _torch_cfg(32, 16, 2, 3))
    tkernel.st_decode_fused(assets, torch.from_numpy(pos),
                            _torch_cfg(32, 16, 2, 3))
    assert tkernel.LAUNCHES == before


@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("img,tmpl,n_objs,n", FAMILIES)
def test_kernel_limits_take_every_task(img, tmpl, n_objs, n, ch):
    """Every task family fits the kernel: shared memory within one
    block's."""
    cfg = _torch_cfg(img, tmpl, n_objs, ch)
    tkernel.check_limits(cfg)
    assert tkernel.shared_bytes(cfg) <= tkernel.MAX_SHARED_BYTES


def test_kernel_shared_bytes_of_the_main_path():
    # 8 KB of float4 planes, the 12 KB background, 32 warps' 512-byte y
    # tables, the 8 KB of raw planes and 32 row coordinates at 32/16/2/3.
    cfg = _torch_cfg(32, 16, 2, 3)
    assert tkernel.shared_bytes(cfg) == 44 * 1024 + 4 * 32


@pytest.mark.parametrize("img_hw,tmpl,n_objs,ch,match", [
    ((128, 128), 64, 4, 3, "shared memory"),
    ((32, 32), 16, 5, 3, "objects"),
    ((32, 32), 16, 0, 3, "objects"),
    ((32, 32), 16, 2, 4, "channels"),
    ((32, 36), 16, 2, 3, "square"),
    ((256, 256), 16, 1, 1, "shared memory"),
])
def test_kernel_limits_reject(img_hw, tmpl, n_objs, ch, match):
    cfg = tdec.DecoderConfig(img_hw=img_hw, tmpl_size=tmpl, n_objs=n_objs,
                             conv_ch=ch, log_sig=1.0)
    with pytest.raises(ValueError, match=match):
        tkernel.check_limits(cfg)


def test_kernel_limits_take_odd_widths_without_a_tile():
    # Stored from registers, a 31x31x3 frame needs no 16-byte rows.
    tkernel.check_limits(_torch_cfg(31, 15, 2, 3))
