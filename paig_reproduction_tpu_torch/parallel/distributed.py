"""Multi-process runtime: one process per card.

Counterpart of ``paig_reproduction_tpu/parallel/distributed.py``, with the
same environment contract: ``PAIG_COORDINATOR`` (host:port),
``PAIG_NUM_PROCESSES`` and ``PAIG_PROCESS_ID``, all three or none.
``init_distributed`` joins ``torch.distributed``'s default process group
over ``tcp://$PAIG_COORDINATOR``: ``nccl`` for a process that trains on a
CUDA card, ``gloo`` on the CPU.

Where the JAX package runs one process per host over every chip of that
host, the port runs one process per card, as ``torch.distributed`` does: a
host with four cards runs four processes, and process i takes
``cuda:{i % torch.cuda.device_count()}``. The parallel layout over those
processes is ``parallel/mesh.py``'s.

Every process holds the whole dataset and the same shuffled index matrix
(the CLI seeds numpy's global generator from ``--seed`` on every process)
and computes its own rows of each global batch (``process_local_rows``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda",
                     backend: Optional[str] = None) -> int:
    """Join the multi-process group. No-op when neither the arguments nor
    the environment ask for it. ``backend`` defaults to ``nccl`` for a CUDA
    ``device`` and ``gloo`` for the CPU. Returns this process's index (0
    when single-process)."""
    coordinator = coordinator or os.environ.get("PAIG_COORDINATOR")
    if num_processes is None and "PAIG_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PAIG_NUM_PROCESSES"])
    if process_id is None and "PAIG_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PAIG_PROCESS_ID"])

    if coordinator is None and num_processes is None and process_id is None:
        return 0
    missing = [name for name, v in (("PAIG_COORDINATOR", coordinator),
                                    ("PAIG_NUM_PROCESSES", num_processes),
                                    ("PAIG_PROCESS_ID", process_id))
               if v is None]
    if missing:
        raise ValueError(
            "partial multi-process config: set all of PAIG_COORDINATOR, "
            "PAIG_NUM_PROCESSES and PAIG_PROCESS_ID (or none of them); "
            f"missing {missing}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if cuda else "gloo"),
            init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id)
    return process_id


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device) -> torch.device:
    """The card this process uses for a ``cuda`` device (the one
    ``init_distributed`` set), else ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def process_local_rows(n_rows: int) -> slice:
    """The half-open row range of a global batch this process owns under
    batch sharding (row-major process order).

    Contract: every process must hold an IDENTICALLY-ORDERED host batch
    (same dataset file, same shuffling RNG state) -- each process slices
    its own rows out of the logically-global array. The CLI guarantees
    this by seeding the global numpy RNG from --seed on every process;
    any other multi-process entry point must do the same."""
    pc, pi = process_count(), process_index()
    assert n_rows % pc == 0, (n_rows, pc)
    per = n_rows // pc
    return slice(pi * per, (pi + 1) * per)
