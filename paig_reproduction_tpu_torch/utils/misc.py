"""Logging, source-snapshot and numerics utilities.

``log_metrics`` writes the same ``<prefix> k=v k=v ...`` lines as
``paig_reproduction_tpu/utils/misc.py`` so log.txt tooling reads both, and
``zipdir`` writes the same code.zip members.
"""
from __future__ import annotations

import pathlib
import zipfile

import torch


def log_metrics(logger, prefix, metrics):
    """Emit one ``<prefix> k=v k=v ...`` info line, keys sorted."""
    body = " ".join(f"{k}={metrics[k]}" for k in sorted(metrics))
    logger.info(f"{prefix} {body}")


def zipdir(path, save_dir):
    """Snapshot every ``*.py`` under ``path`` into ``save_dir/code.zip``,
    archived relative to ``path``'s parent (``pathlib`` does not resolve
    ``..``, so a ``path`` ending in ``..`` gives members named
    ``../<file>``, as the JAX package's do)."""
    root = pathlib.Path(path)
    out = pathlib.Path(save_dir) / "code.zip"
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
        for src in sorted(root.rglob("*.py")):
            zf.write(src, src.relative_to(root.parent))


def use_full_f32():
    """Run float32 matmuls and convolutions on the card in full float32.

    cuDNN convolutions default to TF32, which keeps about three decimal
    digits; the JAX package computes in full f32 (``precision="highest"``
    in the decoder), and parity with it needs the same here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs (--compute_dtype=bfloat16) accumulate in f32 as the JAX
    # package's do, not in bf16 split-K partial sums.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
