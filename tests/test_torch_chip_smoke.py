"""chip_smoke.py checked on the CPU: the bound it reports, the shapes it
runs on the card, and the kernel launches it expects of a CLI run, counted
here as calls of the kernel's wrapper. The phases themselves need a
card."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from paig_reproduction_tpu_torch.models import decoder as tdec  # noqa: E402
from paig_reproduction_tpu_torch.ops.cuda import st_decoder as tkernel  # noqa: E402,E501


def test_st_decode_bound_of_the_main_path():
    # 12.29 MB of output and 36 KB of inputs at 3.35 TB/s; 98 MFLOP at
    # 67 TFLOP/s take less.
    ms, by = chip_smoke.st_decode_bound(1000, 32, 16, 2, 3)
    assert by == "bytes"
    bytes_moved = 4 * (1000 * 4 + 2 * 16 * 16 * 4 + 32 * 32 * 3
                       + 1000 * 32 * 32 * 3)
    assert ms == pytest.approx(bytes_moved / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(3.679e-3, abs=1e-6)


@pytest.mark.parametrize("n,img,tmpl,n_objs,ch", chip_smoke.ST_DECODE_SHAPES)
def test_every_smoke_shape_fits_the_kernel(n, img, tmpl, n_objs, ch):
    tkernel.check_limits(tdec.DecoderConfig((img, img), tmpl, n_objs, ch))


def test_expected_launches_count_a_cli_run(tmp_path, monkeypatch):
    """A tiny CLI run (8 train, 4 valid and 4 test sequences at seq 12, 4
    at seq 30; B=4, 2 epochs) calls the kernel's wrapper as often as
    chip_smoke.expected_launches says the card's run launches it."""
    import logging

    import numpy as np

    from paig_reproduction_tpu_torch import cli

    data = os.path.join(os.path.dirname(chip_smoke.__file__), "data",
                        "datasets", "spring_color")
    for name in ("color_spring_vx8_vy8_sl12_r2_k4_e6.npz",
                 "color_spring_vx8_vy8_sl30_r2_k4_e6.npz"):
        with np.load(os.path.join(data, name)) as d:
            (tmp_path / "spring_color").mkdir(exist_ok=True)
            np.savez(tmp_path / "spring_color" / name,
                     train_x=d["train_x"][:8], valid_x=d["valid_x"][:4],
                     test_x=d["test_x"][:4])
    fused = tkernel.st_decode_fused
    calls = []
    monkeypatch.setattr(tkernel, "st_decode_fused",
                        lambda *a: calls.append(1) or fused(*a))
    monkeypatch.setenv("PAIG_VIZ_EXAMPLES", "1")
    logger = logging.getLogger("paig")
    handlers = list(logger.handlers)
    try:
        trainer, _ = cli.main([
            "--task=spring_color", "--color", "--autoencoder_loss=3.0",
            "--batch_size=4", "--epochs=2", f"--data_dir={tmp_path}",
            f"--save_dir={tmp_path / 'run'}", "--device=cpu"])
    finally:
        for h in set(logger.handlers) - set(handlers):
            logger.removeHandler(h)
            h.close()
    assert len(calls) == chip_smoke.expected_launches(
        trainer.step, 4, 4, 4, batch_size=4, epochs=2) == 28
