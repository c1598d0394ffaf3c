"""MNIST digits and CIFAR backgrounds for the mnist_spring_color generator.

Counterpart of ``paig_reproduction_tpu/data/assets.py``, with no network,
no TensorFlow, no scikit-learn and no matplotlib. Assets resolve in order:

1. A local keras-layout cache (``~/.keras/datasets/mnist.npz``,
   ``cifar-10-batches-py``) or the paths in ``$PAIG_MNIST_NPZ`` /
   ``$PAIG_CIFAR_NPZ``.
2. Digits: ``mnist_digits.npy`` beside this module, the two 22x22 digits
   the JAX package draws from scikit-learn's bundled handwriting
   (``_sklearn_digits(2)``: the 8x8 samples of labels 5 and 0, MNIST's first
   train labels, upsampled and contrast-restored), written once from that
   function and held to it by ``tests/test_torch_generators.py``.
   Backgrounds: 64 deterministic smooth random fields
   (``_noise_backgrounds``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

DIGITS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "mnist_digits.npy")


def _keras_cache(name):
    return os.path.join(os.path.expanduser("~"), ".keras", "datasets", name)


def _bilinear_up(img: np.ndarray, out_hw) -> np.ndarray:
    """Minimal bilinear resize (align_corners=True) for 2D arrays."""
    h, w = img.shape
    oh, ow = out_hw
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 2)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 2)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = img[y0][:, x0]
    b = img[y0][:, x0 + 1]
    c = img[y0 + 1][:, x0]
    d = img[y0 + 1][:, x0 + 1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def load_mnist_digits(n: int = 2) -> np.ndarray:
    """Returns [n, 22, 22] float32 arrays in [0, 1]: the first n MNIST train
    digits center-cropped 3 px per side, from a local cache; without one,
    the tracked digits (at most two)."""
    path = os.environ.get("PAIG_MNIST_NPZ", _keras_cache("mnist.npz"))
    if os.path.exists(path):
        with np.load(path) as d:
            x = d["x_train"][:n, 3:-3, 3:-3] / 255.0
        return x.astype(np.float32)
    digits = np.load(DIGITS_FILE)
    if n > digits.shape[0]:
        raise ValueError(f"{DIGITS_FILE} holds {digits.shape[0]} digits; "
                         f"{n} asked for (set $PAIG_MNIST_NPZ)")
    return digits[:n]


def load_cifar_images() -> np.ndarray:
    """Returns [N, 32, 32, 3] uint8 CIFAR-10 train images from a local
    cache, or 64 smooth random-field backgrounds as the fallback."""
    npz = os.environ.get("PAIG_CIFAR_NPZ", "")
    if npz and os.path.exists(npz):
        with np.load(npz) as d:
            return d[d.files[0]]
    batch1 = os.path.join(_keras_cache("cifar-10-batches-py"), "data_batch_1")
    if os.path.exists(batch1):
        with open(batch1, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        return d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return _noise_backgrounds()


def _noise_backgrounds(n: int = 64) -> np.ndarray:
    """Smooth low-frequency RGB fields in a muted mid-intensity band
    (deterministic, from their own RandomState(0)), so the task's saturated
    object colours stay separable from the background."""
    rs = np.random.RandomState(0)
    out = np.empty((n, 32, 32, 3), np.float32)
    for i in range(n):
        base = rs.rand(4, 4)                     # shared luma structure
        for c in range(3):
            field = _bilinear_up(0.7 * base + 0.3 * rs.rand(4, 4),
                                 (32, 32))
            out[i, :, :, c] = field
    out = 0.15 + 0.5 * out                       # values in [0.15, 0.65]
    return (out * 255).astype(np.uint8)
