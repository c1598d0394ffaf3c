"""ctypes bindings of the native C++ data loader (``csrc/paig_data.cpp``).

Counterpart of ``paig_reproduction_tpu/data/native.py``, over the port's own
copy of the same source, so ``NativeBatcher`` gives the JAX package's
batches at the same seed. A background C++ thread assembles shuffled,
normalized float32 batches with double buffering, overlapping host batch
preparation with the card's step. The library is built with ``g++`` into
``_build/`` at first use (``ops/cuda/build.py``, ``load_host``).

Where the JAX package logs and falls back to the Python iterator when the
library cannot be built, the port raises: the user asked for the loader by
flag (``--native_loader``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from paig_reproduction_tpu_torch.ops.cuda import build


@functools.cache
def _lib():
    lib = build.load_host("paig_data")
    lib.pd_create.restype = ctypes.c_void_p
    lib.pd_create.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int]
    lib.pd_next.restype = ctypes.c_int64
    lib.pd_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pd_epochs.restype = ctypes.c_int64
    lib.pd_epochs.argtypes = [ctypes.c_void_p]
    lib.pd_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeBatcher:
    """Prefetching batch source over a uint8 dataset [N, ...], with the JAX
    ``NativeBatcher``'s API: ``next_batch_x()`` -> float32 [batch, ...] in
    [0, 1], and ``epochs_completed``. Batches are written into one of two
    float32 host tensors, pinned with ``pin`` (for the card);
    ``next_batch_into`` copies rows of the next one to a device tensor
    with ``non_blocking=True``, and a host tensor is written again only
    after its copy has ended."""

    def __init__(self, data_u8: np.ndarray, batch_size: int, seed: int = 0,
                 normalize: bool = True, pin: bool = False):
        if data_u8.dtype != np.uint8:
            raise ValueError("NativeBatcher expects uint8 data")
        if not 0 < batch_size <= data_u8.shape[0]:
            raise ValueError(f"batch of {batch_size} from a split of "
                             f"{data_u8.shape[0]} sequences")
        lib = _lib()
        self._data = np.ascontiguousarray(data_u8)   # kept alive
        self.batch_size = int(batch_size)
        self.example_shape = self._data.shape[1:]
        eb = int(np.prod(self.example_shape))
        self._handle = lib.pd_create(self._data.ctypes.data,
                                     self._data.shape[0], eb,
                                     self.batch_size, seed,
                                     1 if normalize else 0)
        if not self._handle:
            raise RuntimeError("pd_create failed")
        self._lib = lib
        shape = (self.batch_size,) + self.example_shape
        self._out = [torch.empty(shape, dtype=torch.float32,
                                 pin_memory=pin) for _ in range(2)]
        self._copied = [None, None]
        self._i = 0
        self.epochs_completed = 0

    def _next(self) -> torch.Tensor:
        i = self._i
        self._i ^= 1
        if self._copied[i] is not None:
            self._copied[i].synchronize()
            self._copied[i] = None
        out = self._out[i]
        ep = self._lib.pd_next(self._handle, out.data_ptr())
        if ep < 0:
            raise RuntimeError("native loader shut down")
        # pd_next returns the batch's own epoch count (the loader's counter
        # may already include the prefetched next batch).
        self.epochs_completed = int(ep)
        return out

    def next_batch_x(self) -> np.ndarray:
        """The next batch as a host array (valid until the call after
        next)."""
        return self._next().numpy()

    def next_batch_into(self, dst: torch.Tensor, rows=slice(None)):
        """Copy ``rows`` of the next batch into ``dst`` (on the current
        stream; asynchronous from pinned memory)."""
        out = self._next()
        dst.copy_(out[rows], non_blocking=True)
        if dst.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._copied[self._i ^ 1] = event

    def close(self):
        if getattr(self, "_handle", None):
            for event in self._copied:
                if event is not None:
                    event.synchronize()
            self._lib.pd_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
