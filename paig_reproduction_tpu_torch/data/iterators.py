"""In-memory npz dataset iterators.

The port's own copy of ``paig_reproduction_tpu/data/iterators.py``:
epoch-shuffled sequential batching over ``train_x/valid_x/test_x`` arrays of
shape ``[N, T, H, W, C]`` uint8, normalized to float32/255 and transposed to
channels-first ``[N, T, C, H, W]`` when ``conv=True``. The ``datapoints``
truncation of the train split is applied, and ``sample_random_batch`` uses
the start index it draws.

``to_device`` and ``gather_batch`` keep a split on the device as uint8 and
gather and normalize batches there, so only index vectors cross from the
host each step.
"""
from __future__ import annotations

import numpy as np
import torch


class DataIterator:
    """Epoch-shuffled sequential batch iterator (reference iterators.py:4-47).

    Epoch-counting semantics match the reference exactly: the epoch
    counter increments when the *next* batch would run past the end, i.e.
    after the batch that consumed the tail.
    """

    def __init__(self, X, Y=None, seed=None):
        self.X = X
        self.Y = Y
        self.num_examples = self.X.shape[0]
        self.epochs_completed = 0
        self.indices = np.arange(self.num_examples)
        self._rng = np.random.RandomState(seed) if seed is not None else \
            np.random
        self.reset_iteration()

    def reset_iteration(self):
        self._rng.shuffle(self.indices)
        self.start_idx = 0

    def get_epoch(self):
        return self.epochs_completed

    def reset_epoch(self):
        self.reset_iteration()
        self.epochs_completed = 0

    def next_index_batch(self, batch_size):
        """Indices of the next batch, advancing the epoch state exactly as
        ``next_batch`` does. Used by the device-resident input path, where
        only the (tiny) index vector crosses to the device."""
        # .copy(): the slice is a view into self.indices, which
        # reset_iteration() reshuffles in place below.
        idx = self.indices[self.start_idx:self.start_idx
                           + batch_size].copy()
        self.start_idx += batch_size
        if self.start_idx + batch_size > self.num_examples:
            self.reset_iteration()
            self.epochs_completed += 1
        return idx

    def next_index_batches(self, batch_size, max_k):
        """Up to ``max_k`` consecutive index batches [k, batch_size],
        stopping early at an epoch boundary so per-epoch eval/save
        semantics are preserved."""
        out = []
        for _ in range(max_k):
            out.append(self.next_index_batch(batch_size))
            if self.start_idx == 0:       # epoch just rolled over
                break
        return np.stack(out)

    def next_batch(self, batch_size):
        idx = self.next_index_batch(batch_size)
        batch_x = self.X[idx]
        batch_y = self.Y[idx] if self.Y is not None else None
        return batch_x, batch_y

    def sample_random_batch(self, batch_size):
        start_idx = np.random.randint(0, self.num_examples - batch_size)
        batch_x = self.X[start_idx:start_idx + batch_size]
        batch_y = (self.Y[start_idx:start_idx + batch_size]
                   if self.Y is not None else None)
        return batch_x, batch_y


def _prep_split(arr: np.ndarray, conv: bool) -> np.ndarray:
    """uint8 [N, T, H, W, C] -> float32/255, channels-first when conv."""
    x = arr.astype(np.float32) / 255.0
    if conv:
        x = np.transpose(x, (0, 1, 4, 2, 3))          # [N, T, C, H, W]
    else:
        x = x.reshape(x.shape[0], x.shape[1], -1)
    return np.ascontiguousarray(x)


def get_iterators(file, conv=False, datapoints=0):
    """Load a dataset npz and return (train_it, valid_it, test_it)
    (reference iterators.py:50-69, with the datapoints bug fixed).

    The train iterator additionally carries ``raw_uint8`` — the original
    uint8 frames in the model layout — enabling the device-resident input
    path (the whole split lives in device memory as uint8; batches are
    gathered and normalized on device, so only index vectors cross the
    host->device boundary each step).
    """
    data = np.load(file)
    train = data["train_x"]
    if datapoints > 0:
        train = train[:datapoints]

    def make(split):
        it = DataIterator(X=_prep_split(split, conv))
        if conv and split.ndim == 5:
            it.raw_uint8 = np.ascontiguousarray(
                np.transpose(split, (0, 1, 4, 2, 3)))
        return it

    return make(train), make(data["valid_x"]), make(data["test_x"])


def to_device(raw_uint8: np.ndarray, device) -> torch.Tensor:
    """A uint8 split [N, T, C, H, W] as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(raw_uint8)).to(device)


def gather_batch(data_u8: torch.Tensor, idx) -> torch.Tensor:
    """float32 batch data_u8[idx] / 255, gathered on data_u8's device.
    ``idx`` is host indices, or an int64 tensor on that device (a captured
    step's static index buffer: nothing crosses from the host)."""
    if not torch.is_tensor(idx):
        idx = torch.as_tensor(np.ascontiguousarray(idx, np.int64),
                              device=data_u8.device)
    return data_u8[idx].to(torch.float32) / 255.0
