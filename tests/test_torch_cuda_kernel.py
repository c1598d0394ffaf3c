"""The CUDA ST-decoder kernel against its plain PyTorch version on a card.

These tests need an NVIDIA GPU with nvcc (the kernel is built at first
use) and skip without one. Tolerances: forward atol 2e-5 (f32, TF32 off,
sums in another order); gradients rtol 1e-4 / atol 1e-5 (the backward is
the plain version's autograd on both sides). On the card, chip_smoke.py
runs the same checks at the main path's shapes.
"""
import pytest
import torch

from paig_reproduction_tpu_torch.models import decoder as tdec
from paig_reproduction_tpu_torch.ops.cuda import st_decoder as tkernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paig_reproduction_tpu_torch.utils.misc import use_full_f32
    use_full_f32()
    return torch.device("cuda")


def _inputs(img, tmpl, n_objs, ch, n, seed, device):
    g = torch.Generator().manual_seed(seed)
    assets = tdec.DecoderAssets(
        torch.randn(n_objs, tmpl, tmpl, generator=g),
        torch.randn(n_objs, tmpl, tmpl, ch, generator=g),
        torch.rand(img, img, ch, generator=g))
    pos = torch.rand(n, 2 * n_objs, generator=g) * 1.5 * img - 0.25 * img
    cfg = tdec.DecoderConfig((img, img), tmpl, n_objs, ch, 1.0)
    return (tdec.DecoderAssets(*(x.to(device) for x in assets)),
            pos.to(device), cfg)


@pytest.mark.parametrize("img,tmpl,n_objs,ch,n", [
    (32, 16, 2, 3, 1000), (32, 16, 2, 1, 10), (36, 18, 3, 3, 7),
    (64, 32, 2, 1, 5), (64, 32, 2, 3, 3),
    # The persistent grid's edges: one frame, an N the grid does not
    # divide, several frames a block (the seq-30 test graph's 26 x 100).
    (32, 16, 2, 3, 1), (32, 16, 2, 3, 1001), (32, 16, 2, 3, 2600),
    # Odd widths: rows of 31x3 floats, stored straight from registers.
    (31, 15, 2, 3, 4)])
def test_kernel_matches_plain(cuda, img, tmpl, n_objs, ch, n):
    assets, pos, cfg = _inputs(img, tmpl, n_objs, ch, n, seed=n, device=cuda)
    before = tkernel.LAUNCHES
    out = tkernel.st_decode_fused(assets, pos, cfg)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES == before + 1
    ref = tkernel.st_decode_plain(assets, pos, cfg)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)


def test_kernel_large_logits_finite(cuda):
    assets, pos, cfg = _inputs(32, 16, 2, 3, 8, seed=1, device=cuda)
    assets = assets._replace(template=torch.full_like(assets.template, 90.0))
    assert bool(torch.isfinite(tkernel.launch(assets, pos, cfg)).all())


def test_kernel_grads_match_plain(cuda):
    assets, pos, cfg = _inputs(32, 16, 2, 3, 40, seed=2, device=cuda)
    weight = torch.rand((40, 32, 32, 3), device=cuda)
    grads = []
    for fn in (tkernel.st_decode_fused, tkernel.st_decode_plain):
        leaves = [x.clone().requires_grad_(True) for x in (*assets, pos)]
        out = fn(tdec.DecoderAssets(*leaves[:3]), leaves[3], cfg)
        grads.append(torch.autograd.grad((out * weight).sum(), leaves))
    for g_k, g_p in zip(*grads):
        torch.testing.assert_close(g_k, g_p, rtol=1e-4, atol=1e-5)


def test_kernel_rejects_bad_inputs(cuda):
    assets, pos, cfg = _inputs(32, 16, 2, 3, 4, seed=3, device=cuda)
    with pytest.raises(TypeError):
        tkernel.launch(assets, pos.double(), cfg)
    with pytest.raises(ValueError):
        tkernel.launch(assets, pos.t().contiguous().t(), cfg)
    with pytest.raises(ValueError):
        tkernel.launch(assets, pos[:, :2].contiguous(), cfg)


def test_kernel_takes_shapes_in_any_order(cuda):
    """Setting the kernel up for a shape that needs less shared memory must
    not lower the limit a shape set up earlier needs."""
    for img in (40, 24, 40):
        assets, pos, cfg = _inputs(img, img // 2, 2, 3, 6, seed=img,
                                   device=cuda)
        torch.testing.assert_close(tkernel.launch(assets, pos, cfg),
                                   tkernel.st_decode_plain(assets, pos, cfg),
                                   rtol=0, atol=2e-5)


def test_kernel_rejects_shapes_above_the_shared_memory_budget(cuda):
    assets, pos, cfg = _inputs(128, 64, 4, 3, 2, seed=7, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tkernel.launch(assets, pos, cfg)


def test_physics_net_kernel_backend_matches_plain(cuda):
    from paig_reproduction_tpu_torch.models import PhysicsNet
    kw = dict(task="spring_color", cell_type="spring_ode_cell", seq_len=12,
              input_steps=4, pred_steps=6, autoencoder_loss=3.0, color=True,
              input_size=32 * 32)
    x = torch.rand((2, 12, 3, 32, 32),
                   generator=torch.Generator().manual_seed(0)).to(cuda)
    outs = []
    for backend in ("xla", "auto"):
        model = PhysicsNet(decoder_backend=backend,
                           generator=torch.Generator().manual_seed(0),
                           **kw).to(cuda)
        with torch.no_grad():
            outs.append(model(x)[0])
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=2e-5)
