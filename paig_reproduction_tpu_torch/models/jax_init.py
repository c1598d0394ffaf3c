"""The JAX package's initial weights, drawn in numpy.

``model.init(jax.random.PRNGKey(seed), x)`` of the JAX package's PhysicsNet
gives every parameter from its own key: flax folds into the root key the
SHA-1 of the parameter's module path and of its creation count in that
module (``flax.core.scope._fold_in_static``), and the initializer draws
from that key with JAX's counter-based Threefry-2x32 generator
(``jax_threefry_partitionable``, JAX's default). ``initial_state(model,
key)`` repeats those draws for the port's ``model`` and returns its
``state_dict`` in the port's layout (``convert.py``'s mapping, inverted),
so that ``--seed`` gives the port the JAX package's initial weights, and a
discovery arm (``arm_key``) the JAX arm's.

The uniform draws (every ``TorchConv`` and ``TorchDense`` kernel and bias:
U(+-1/sqrt(fan_in))) are the JAX package's bit for bit. The LSTM cell's
kernels (flax's truncated-normal and orthogonal initializers) go through
``erf_inv`` and a QR factorization, which numpy computes in another order
than XLA: they agree to float32 rounding. The cell's physical parameters,
``frame_offset`` and the LSTM's biases start at zero, as in the JAX
package.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# The module names flax gives the port's modules (convert.py's _RENAMES,
# inverted by class).
_UNET_NAMES = {"ShallowUNet": "ShallowUNet_0", "UNet": "UNet_0"}
_LSTM_GATES = ("i", "f", "g", "o")


def _threefry2x32(k1, k2, x1, x2):
    """JAX's Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2), all uint32 (wrapping arithmetic)."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` of a non-negative seed, with JAX's 64-bit
    mode off (the JAX package's): the seed's low 32 bits."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    y0, y1 = _threefry2x32(key[0], key[1], [0], [int(data) & 0xFFFFFFFF])
    return np.array([y0[0], y1[0]], np.uint32)


def arm_key(seed: int, arm: int) -> np.ndarray:
    """The weights' key of discovery arm ``arm``, as the JAX package's
    recipes draw it: the seed's key for arm 0, else folded with ``arm``."""
    key = prng_key(seed)
    return key if arm == 0 else fold_in(key, arm)


def param_key(root: np.ndarray, path, count: int) -> np.ndarray:
    """The key flax gives the ``count``-th parameter (from 1) created in the
    module at ``path`` (module names from the root)."""
    m = hashlib.sha1()
    for x in tuple(path) + (count,):
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits``' 32-bit words of ``shape`` (the partitionable
    Threefry: each element hashes its row-major index)."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    b1, b2 = _threefry2x32(key[0], key[1], (idx >> np.uint64(32)).astype(
        np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, minval, maxval) -> np.ndarray:
    """``jax.random.uniform`` in float32. XLA fuses its scale and shift into
    one multiply-add, rounded once: the float64 product of two float32
    values is exact, and so is its sum with the float32 shift here, so one
    rounding to float32 gives the fused result."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


# Single-precision inverse error function (M. Giles), the polynomial XLA
# evaluates: coefficients for w < 5 and for w >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(small, np.float32(_ERFINV_SMALL[0]),
                 np.float32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = np.where(small, np.float32(a), np.float32(b)) + p * w
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(
        np.float32)


def truncated_normal(key, lower, upper, shape) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32."""
    sqrt2 = np.float32(math.sqrt(2))
    a = np.float32(math.erf(np.float32(lower) / sqrt2))
    b = np.float32(math.erf(np.float32(upper) / sqrt2))
    out = sqrt2 * erf_inv(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(np.float32(lower), np.float32(np.inf)),
                   np.nextafter(np.float32(upper), np.float32(-np.inf)))


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal`` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(math.sqrt(2)) * erf_inv(uniform(key, shape, lo, 1.0))


def lecun_normal(key, shape) -> np.ndarray:
    """flax's default kernel initializer for a (fan_in, out) kernel."""
    stddev = np.sqrt(np.float32(1.0 / shape[0])) / np.float32(
        0.87962566103423978)
    return truncated_normal(key, -2, 2, shape) * stddev


def orthogonal(key, shape) -> np.ndarray:
    """``jax.nn.initializers.orthogonal()`` of an (n, n) kernel."""
    n_rows, n_cols = shape
    z = normal(key, (max(n_rows, n_cols), min(n_rows, n_cols)))
    q, r = np.linalg.qr(z)
    q = (q * np.sign(np.diagonal(r))[None, :]).astype(np.float32)
    return q.T if n_rows < n_cols else q


def _uniform_param(root, path, count, flax_shape, fan_in):
    bound = 1.0 / np.sqrt(fan_in)
    return uniform(param_key(root, path, count), flax_shape, -bound, bound)


def _module_path(model, names):
    """The flax module path of the port's module at ``names`` (its dotted
    name's parts)."""
    path, i = [], 0
    while i < len(names):
        name = names[i]
        if name == "unet":
            sub = model.get_submodule(".".join(names[:i + 1]))
            path.append(_UNET_NAMES[type(sub).__name__])
        elif name == "convs":
            i += 1
            path += [f"TorchConv_{names[i]}", "Conv_0"]
        elif name == "dense":
            i += 1
            path.append(f"TorchDense_{names[i]}")
        else:
            path.append(name)
        i += 1
    return path


def initial_state(model: torch.nn.Module,
                  key: np.ndarray) -> Dict[str, torch.Tensor]:
    """The parameters the JAX package's ``model.init(key, x)`` gives the
    same configuration, by the port's parameter names and layouts."""
    out = {}
    for name, param in model.named_parameters():
        *names, leaf = name.split(".")
        shape = tuple(param.shape)
        path = _module_path(model, names)
        if not names:
            value = np.zeros(shape, np.float32)
        elif leaf in ("weight_ih", "weight_hh", "bias_hh"):
            value = _lstm_leaf(key, path, leaf, shape)
        elif leaf == "weight" and len(shape) == 4:    # conv (O, I, kh, kw)
            o, i, kh, kw = shape
            value = _uniform_param(key, path, 1, (kh, kw, i, o),
                                   kh * kw * i).transpose(3, 2, 0, 1)
        elif leaf == "weight" and len(shape) == 2:    # dense (out, in)
            value = _uniform_param(key, path, 1, shape[::-1], shape[1]).T
        elif leaf == "bias":
            weight = dict(model.named_parameters())[
                ".".join(names + ["weight"])]
            fan_in = math.prod(weight.shape[1:])
            value = _uniform_param(key, path, 2, shape, fan_in)
        else:
            raise ValueError(f"no JAX initializer for parameter {name}")
        out[name] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return out


def _lstm_leaf(key, path, leaf, shape):
    """torch LSTMCell's fused ``weight_ih`` / ``weight_hh`` / ``bias_hh``
    from flax OptimizedLSTMCell's per-gate ``ii..io`` (lecun-normal
    kernels) and ``hi..ho`` (orthogonal kernels, zero biases)."""
    hidden = shape[0] // 4
    if leaf == "bias_hh":
        return np.zeros(shape, np.float32)
    side = "i" if leaf == "weight_ih" else "h"
    init = lecun_normal if side == "i" else orthogonal
    gates = [init(param_key(key, path + [side + g], 1), (shape[1], hidden))
             for g in _LSTM_GATES]
    return np.concatenate(gates, axis=-1).T


def load_initial_state(model: torch.nn.Module, key: np.ndarray):
    """Overwrite ``model``'s parameters, in place, with ``initial_state``."""
    state = initial_state(model, key)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(state[name])
    return model
