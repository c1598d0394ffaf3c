"""A train or eval step captured once as a CUDA graph and replayed.

The step's inputs are static device tensors that the caller fills before
each replay (an index row, the learning rate and the aux scale, or a host
batch), and its outputs are written into static tensors that the caller
reads after it. Capture records the step's launches without running them,
so the caller warms the step up first with one real step (lazy state such
as the optimizer's moments and the decoder kernel's launch setup is made
there), and a replay runs every recorded launch.

The ST decoder's wrapper counts its launches in Python
(``ops/cuda/st_decoder.py``'s ``LAUNCHES``), which a replay does not call:
a capture keeps the launches it recorded and leaves the count as it was,
and each replay adds them, so a count over graphed steps is the count the
same steps would give eagerly.
"""
from __future__ import annotations

import torch

from paig_reproduction_tpu_torch.ops.cuda import st_decoder


class CapturedStep:
    """``fn`` captured into a CUDA graph on the current device;
    ``replay()`` runs it. ``signature`` is what the caller keyed the
    capture on (the storages the graph reads and writes). ``_record`` and
    ``_replay`` are the graph's own operations."""

    def __init__(self, fn, signature=None):
        self.signature = signature
        before = st_decoder.LAUNCHES
        self._record(fn)
        # Decoder launches a replay runs.
        self.launches = st_decoder.LAUNCHES - before
        st_decoder.LAUNCHES = before
        self.replays = 0

    def _record(self, fn):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            fn()

    def _replay(self):
        self.graph.replay()

    def replay(self):
        self._replay()
        st_decoder.LAUNCHES += self.launches
        self.replays += 1

    @staticmethod
    def warm_up(fn, device):
        """One real call of ``fn`` on a side stream, as a capture of it
        wants: what the step makes at its first call is made outside the
        capture."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
