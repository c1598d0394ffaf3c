"""chip_smoke.py's kernel phase, checked on the CPU: the bound it reports
and the shapes it runs on the card. The phase itself needs a card."""
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
