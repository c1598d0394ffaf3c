"""Parity of the port's ``ops/pos_refine.refine_positions`` (the
``--refine_recons_pos`` / ``--refine_enc_pos`` Gauss-Newton refinement)
with the JAX package's, with the plain ``st_decode`` as the renderer; the
forward-mode derivative of the port's plain decode against ``jax.jvp`` of
the JAX one; and the CUDA kernel's ``autograd.Function`` rules (forward,
backward, ``jvp``), run here with its launch stood in by the plain decode.

Tolerances: positions within 1e-3 px in f32 (4 Gauss-Newton iterations of
sums in another order) and 1e-9 in float64; JVPs within 1e-5 of their
largest value in f32; through the Function, the tangent and gradients
equal the plain decode's exactly (the same computation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paig_reproduction_tpu.models import decoder as jax_decoder
from paig_reproduction_tpu.ops.pos_refine import (
    refine_positions as jax_refine,
)
from paig_reproduction_tpu_torch.models import decoder
from paig_reproduction_tpu_torch.ops.cuda import st_decoder as sd
from paig_reproduction_tpu_torch.ops.pos_refine import refine_positions

CFG = dict(img_hw=(32, 32), tmpl_size=16, n_objs=2, conv_ch=3, log_sig=1.0)


def _problem(n=6, seed=0):
    """Assets with a bright centred blob per object, frames rendered at
    true positions plus noise, and starting positions about 1 px off."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:16, :16]
    blob = 8.0 * np.exp(-((yy - 7.5) ** 2 + (xx - 7.5) ** 2) / 8.0) - 4.0
    template = (blob[None] + rs.randn(2, 16, 16) * 0.3).astype(np.float32)
    contents = (rs.randn(2, 16, 16, 3) * 2.0).astype(np.float32)
    background = rs.rand(32, 32, 3).astype(np.float32) * 0.2
    truth = rs.uniform(8, 24, (n, 4)).astype(np.float32)
    assets = decoder.DecoderAssets(*(torch.from_numpy(a) for a in
                                     (template, contents, background)))
    cfg = decoder.DecoderConfig(**CFG)
    frames = decoder.st_decode(assets, torch.from_numpy(truth), cfg)[0]
    frames = frames.numpy() + rs.randn(*frames.shape).astype(np.float32) * .02
    pos0 = truth + rs.randn(n, 4).astype(np.float32) * 0.8
    return (template, contents, background), frames, pos0, truth


def _jax_render(arrays):
    assets = jax_decoder.DecoderAssets(*(jnp.asarray(a) for a in arrays))
    cfg = jax_decoder.DecoderConfig(**CFG)
    return lambda p: jax_decoder.st_decode(assets, p, cfg, backend="xla")[0]


def _port_render(arrays):
    assets = decoder.DecoderAssets(*(torch.from_numpy(a) for a in arrays))
    cfg = decoder.DecoderConfig(**CFG)
    return lambda p: decoder.st_decode(assets, p, cfg)[0]


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-3),
                                       (np.float64, 1e-9)])
def test_refine_matches_jax(dtype, tol):
    arrays, frames, pos0, truth = _problem()
    arrays = [a.astype(dtype) for a in arrays]
    with jax.enable_x64(dtype == np.float64):
        j_pos = np.asarray(jax_refine(_jax_render(arrays),
                                      jnp.asarray(frames, dtype),
                                      jnp.asarray(pos0, dtype), iters=4))
    pos = refine_positions(_port_render(arrays),
                           torch.from_numpy(frames.astype(dtype)),
                           torch.from_numpy(pos0.astype(dtype)), iters=4)
    np.testing.assert_allclose(pos.numpy(), j_pos, rtol=0, atol=tol)
    # The refinement moved the positions toward the truth.
    assert (np.abs(pos.numpy() - truth).mean()
            < 0.5 * np.abs(pos0 - truth).mean())


def test_refine_straight_through_gradient():
    arrays, frames, pos0, _ = _problem(seed=1)
    w = np.random.RandomState(2).randn(*pos0.shape).astype(np.float32)
    p0 = torch.from_numpy(pos0).requires_grad_()
    out = refine_positions(_port_render(arrays), torch.from_numpy(frames),
                           p0, iters=2)
    (out * torch.from_numpy(w)).sum().backward()
    j_grad = jax.grad(lambda p: jnp.sum(jax_refine(
        _jax_render(arrays), jnp.asarray(frames), p, iters=2) * w))(
            jnp.asarray(pos0))
    np.testing.assert_allclose(p0.grad.numpy(), w, rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(j_grad), w, rtol=1e-6)


def test_refine_keeps_positions_without_support():
    """A frame whose objects render off-screen has a zero Jacobian: the
    damping holds the positions still."""
    arrays, frames, _, _ = _problem(n=2, seed=3)
    far = np.full((2, 4), -500.0, np.float32)
    pos = refine_positions(_port_render(arrays), torch.from_numpy(frames),
                           torch.from_numpy(far), iters=3)
    np.testing.assert_array_equal(pos.numpy(), far)


@pytest.mark.parametrize("argnums", [(3,), (0, 1, 2, 3)],
                         ids=["pos", "all"])
def test_plain_decode_jvp_matches_jax(argnums):
    """torch.func.jvp of the port's plain st_decode against jax.jvp of the
    JAX st_decode (xla), tangents on the positions or on all four
    inputs."""
    arrays, _, pos0, _ = _problem(n=5, seed=4)
    primals = [*arrays, pos0]
    rs = np.random.RandomState(5)
    tangents = [rs.randn(*np.shape(x)).astype(np.float32) for x in primals]
    j_cfg = jax_decoder.DecoderConfig(**CFG)
    cfg = decoder.DecoderConfig(**CFG)

    def j_f(*xs):
        full = list(map(jnp.asarray, primals))
        for i, x in zip(argnums, xs):
            full[i] = x
        return jax_decoder.st_decode(jax_decoder.DecoderAssets(*full[:3]),
                                     full[3], j_cfg, backend="xla")[0]

    def f(*xs):
        full = [torch.from_numpy(x) for x in primals]
        for i, x in zip(argnums, xs):
            full[i] = x
        return decoder.st_decode(decoder.DecoderAssets(*full[:3]), full[3],
                                 cfg)[0]

    j_out, j_tan = jax.jvp(j_f, tuple(jnp.asarray(primals[i])
                                      for i in argnums),
                           tuple(jnp.asarray(tangents[i]) for i in argnums))
    out, tan = torch.func.jvp(f, tuple(torch.from_numpy(primals[i])
                                       for i in argnums),
                              tuple(torch.from_numpy(tangents[i])
                                    for i in argnums))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5)
    scale = np.abs(np.asarray(j_tan)).max()
    np.testing.assert_allclose(tan.numpy(), np.asarray(j_tan), rtol=0,
                               atol=1e-5 * scale)


@pytest.fixture
def stand_in_launch(monkeypatch):
    """The kernel's launch stood in by the plain decode (no card here),
    recording whether it was handed plain tensors, as the C entry needs."""
    handed = []

    def launch(assets, pos, cfg):
        handed.append(not any(torch._C._functorch.is_functorch_wrapped_tensor(
            x) for x in (*assets, pos)))
        sd.LAUNCHES += 1
        return sd.st_decode_plain(assets, pos, cfg)

    monkeypatch.setattr(sd, "launch", launch)
    monkeypatch.setattr(sd, "LAUNCHES", 0)
    return handed


def _function_inputs(seed=6):
    arrays, _, pos0, _ = _problem(n=4, seed=seed)
    return [torch.from_numpy(a) for a in (*arrays, pos0)]


@pytest.mark.parametrize("argnums", [(3,), (0, 1, 2, 3)],
                         ids=["pos", "all"])
def test_kernel_function_jvp_is_the_plain_jvp(stand_in_launch, argnums):
    """torch.func.jvp through the kernel's autograd.Function: the primal
    comes from one launch, handed plain tensors; the tangent equals the
    plain decode's, also under no_grad (the evals)."""
    inputs = _function_inputs()
    cfg = decoder.DecoderConfig(**CFG)
    rs = np.random.RandomState(7)
    tangents = [torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
                for x in inputs]

    def through(fn):
        def f(*xs):
            full = list(inputs)
            for i, x in zip(argnums, xs):
                full[i] = x
            return fn(*full)
        return torch.func.jvp(f, tuple(inputs[i] for i in argnums),
                              tuple(tangents[i] for i in argnums))

    ref = through(lambda t, c, b, p: sd.st_decode_plain(
        decoder.DecoderAssets(t, c, b), p, cfg))
    for grad_mode in (torch.enable_grad, torch.no_grad):
        with grad_mode():
            got = through(lambda t, c, b, p: sd._STDecode.apply(t, c, b, p,
                                                                cfg))
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert stand_in_launch == [True, True] and sd.LAUNCHES == 2


def test_kernel_function_backward_is_the_plain_gradient(stand_in_launch):
    cfg = decoder.DecoderConfig(**CFG)
    weight = torch.from_numpy(np.random.RandomState(8).rand(
        4, 32, 32, 3).astype(np.float32))
    grads = []
    for fn in (lambda *a: sd._STDecode.apply(*a, cfg),
               lambda t, c, b, p: sd.st_decode_plain(
                   decoder.DecoderAssets(t, c, b), p, cfg)):
        leaves = [x.clone().requires_grad_() for x in _function_inputs()]
        grads.append(torch.autograd.grad((fn(*leaves) * weight).sum(),
                                         leaves))
    for g_k, g_p in zip(*grads):
        assert torch.equal(g_k, g_p)


def test_refine_through_the_kernel_function(stand_in_launch, monkeypatch):
    """The refinement rendering through the kernel's Function (as on a CUDA
    tensor) equals the plain refinement, with one launch per Gauss-Newton
    iteration."""
    arrays, frames, pos0, _ = _problem(seed=9)
    cfg = decoder.DecoderConfig(**CFG)
    assets = [torch.from_numpy(a) for a in arrays]
    via_kernel = refine_positions(
        lambda p: sd._STDecode.apply(*assets, p, cfg),
        torch.from_numpy(frames), torch.from_numpy(pos0), iters=3)
    plain = refine_positions(_port_render(arrays), torch.from_numpy(frames),
                             torch.from_numpy(pos0), iters=3)
    assert torch.equal(via_kernel, plain)
    assert sd.LAUNCHES == 3 and all(stand_in_launch)
