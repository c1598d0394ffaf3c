"""The ('data', 'model') layout of the processes: data and tensor
parallelism.

Counterpart of ``paig_reproduction_tpu/parallel/mesh.py``. The world of
processes (one a card, ``parallel/distributed.py``) is a row-major
``n_data x n_model`` grid: process r is data rank ``r // n_model`` and model
rank ``r % n_model``. A model group (``n_model`` consecutive processes)
holds one copy of the model, its split kernels spread over it; a data group
(the processes of one model rank) holds the copies that data parallelism
averages.

* DP: each data rank computes its rows of the global batch. Gradients are
  averaged with one flattened ``all_reduce``; losses are batch means and the
  model has no batch statistics, so the average is the global batch's
  gradient.
* TP splits exactly the kernels that the JAX package's ``_spec_for``
  shards, on the same conditions: a 2-D Dense kernel under
  ``var_net_content``/``var_net_background``/``var_net_template`` on its
  output dim, and one under ``encoder`` (a path segment:
  ``velocity_encoder`` is not caught) on its input dim, each where
  ``n_model`` divides that dim. An input-dim split computes each rank's
  partial product and sums it with an ``all_reduce``; an output-dim split
  gathers the pieces with an ``all_gather``. Both are
  ``torch.distributed.nn.functional`` collectives, whose backward sums the
  gradients of every rank of the model group: upstream of a collective
  every gradient comes out ``n_model`` times too large, so every gradient
  is divided by ``n_model`` after the reduction. The optimizer state of a
  split kernel is made from its slice, so it is split with it.

Each rank seeds its backward with ``1 / n_data`` (``loss_seed``) and the
reduction sums over the data ranks: a rank's loss is the mean over its own
rows, so every cotangent is then the one the global batch's mean gives,
also where the backward clips cotangents (``ops/cells.py``,
``clip_cotangent``) and a mean over a rank's rows would clip at another
scale. Downstream of the TP collectives the cotangents are the global
batch's too.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from paig_reproduction_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
)

# The JAX package's sharded parameter paths (mesh.py, _spec_for).
_TP_SHARD_LAST = ("var_net_content", "var_net_background", "var_net_template")
_TP_SHARD_FIRST = ("encoder",)


class Mesh:
    """``n_data x n_model`` processes; this process's ranks and groups
    (``None`` where a group is this process alone)."""

    def __init__(self, n_data: int = 1, n_model: int = 1, rank: int = 0,
                 data_group=None, model_group=None, world_group=None):
        self.shape = {"data": n_data, "model": n_model}
        self.rank = rank
        self.data_rank = rank // n_model
        self.model_rank = rank % n_model
        self.data_group = data_group
        self.model_group = model_group
        self.world_group = world_group

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def distributed(self) -> bool:
        """Whether this process is in a process group (of one or more)."""
        return self.world_group is not None

    def rows(self, n_rows: int) -> slice:
        """This data rank's rows of a global batch of ``n_rows``; all of
        them where ``n_data`` does not divide it (every rank then computes
        the whole batch, as the JAX trainer replicates an odd batch)."""
        n_data = self.shape["data"]
        if n_rows % n_data:
            return slice(0, n_rows)
        per = n_rows // n_data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    @property
    def loss_seed(self) -> float:
        return 1.0 / self.shape["data"]


def make_mesh(n_model: int = 1) -> Mesh:
    """The mesh over every process of the group (``init_distributed``),
    with ``n_model`` processes a model group; without a group, this process
    alone."""
    world = process_count()
    if n_model < 1 or world % n_model:
        raise ValueError(f"--n_model_shards={n_model} does not divide the "
                         f"{world} processes")
    n_data = world // n_model
    if not dist.is_initialized():
        return Mesh()
    rank = process_index()
    data_group = model_group = None
    # Every process creates every group, in the same order.
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == rank // n_model:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == rank % n_model:
            data_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group,
                dist.group.WORLD)


def split_dim(name: str, shape, n_model: int) -> Optional[int]:
    """The dim of the port's parameter ``name`` (a ``[out, in]`` Linear
    weight; flax's kernel is ``[in, out]``) that TP splits, or None:
    ``_spec_for`` of the JAX package on the same parameter."""
    names = name.split(".")
    if n_model > 1 and len(shape) == 2 and names[-1] == "weight":
        k_in, k_out = shape[1], shape[0]
        if any(k in names for k in _TP_SHARD_LAST) and k_out % n_model == 0:
            return 0
        if any(k in names for k in _TP_SHARD_FIRST) and k_in % n_model == 0:
            return 1
    return None


def split_dims(model: torch.nn.Module, n_model: int) -> dict:
    """{parameter name: split dim} of an unsplit model."""
    return {n: d for n, p in model.named_parameters()
            if (d := split_dim(n, p.shape, n_model)) is not None}


def piece(full: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of ``full`` along ``dim``."""
    per = full.shape[dim] // mesh.shape["model"]
    return full.narrow(dim, mesh.model_rank * per, per).clone()


def gather(local: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model rank's slice along ``dim``."""
    parts = [torch.empty_like(local) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, local.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=dim)


def _input_split_forward(mesh, layer, x):
    """y = x @ W.T + b with W split on its input dim: this rank's partial
    product over its input columns, summed over the model group."""
    from torch.distributed.nn.functional import all_reduce
    per = layer.weight.shape[1]
    x = x.narrow(-1, mesh.model_rank * per, per)
    dt = layer.compute_dtype or x.dtype
    y = all_reduce(F.linear(x.to(dt), layer.weight.to(dt)),
                   group=mesh.model_group)
    return y + layer.bias.to(dt)


def _output_split_forward(mesh, layer, x):
    """y = x @ W.T + b with W split on its output dim: every rank's output
    columns, gathered over the model group."""
    from torch.distributed.nn.functional import all_gather
    dt = layer.compute_dtype or x.dtype
    part = F.linear(x.to(dt), layer.weight.to(dt))
    parts = all_gather(part.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=-1) + layer.bias.to(dt)


def shard_model(model: torch.nn.Module, mesh: Mesh) -> dict:
    """Split ``model``'s TP kernels in place: each keeps its slice as its
    parameter and computes through the model group. Returns {parameter
    name: split dim}."""
    dims = split_dims(model, mesh.shape["model"])
    modules = dict(model.named_modules())
    for name, dim in dims.items():
        layer = modules[name.rsplit(".", 1)[0]]
        layer.weight = torch.nn.Parameter(piece(layer.weight.data, dim, mesh))
        layer.tp_forward = functools.partial(
            _output_split_forward if dim == 0 else _input_split_forward,
            mesh)
    return dims


def average_gradients(replicated, split, mesh: Mesh):
    """DP (and TP) gradient reduction after a backward seeded with
    ``mesh.loss_seed``: a replicated parameter's gradient summed over the
    world, a split one's over its data group, both divided by ``n_model``.
    One flattened ``all_reduce`` each."""
    from torch._utils import (
        _flatten_dense_tensors,
        _unflatten_dense_tensors,
    )
    n_model = mesh.shape["model"]
    for params, group in ((replicated, mesh.world_group),
                          (split, mesh.data_group)):
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            continue
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        if n_model > 1:
            flat.div_(n_model)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)


def mean_over_data(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the data ranks of a value every model rank holds
    alike (sum over the world / the world's size)."""
    t = t.clone()
    dist.all_reduce(t, group=mesh.world_group)
    return t.div_(mesh.size)
