"""The ``model`` axis's collectives as autograd functions, and the layers'
use of them.

Port of what XLA's SPMD partitioner inserts around the kernels that
``dmfusion/parallel/partition.py`` shards (``dmfusion/models/common.py``'s
convs and denses, ``dmfusion/models/attention.py``'s heads).  The model
peers of a data index run the same rows; a sharded layer computes its
shard of the output features, and everything else (norms, activations,
the loss) runs on every peer on the whole features.  Four functions:

  * :func:`copy_to_model`: identity forward; the backward sums the peers'
    gradients (each peer's holds its own output features' share);
  * :func:`gather_from_model`: every peer's shard concatenated along a
    dimension; the backward takes this peer's slice (the peers compute the
    same work downstream, so each holds the whole gradient: a
    reduce-scatter would hand the slice ``model`` times its gradient);
  * :func:`reduce_from_model`: the peers' partial sums added; the backward
    passes the gradient on (a row-parallel product);
  * :func:`use`: a module's parameter as it computes with it: gathered on
    use where the placement shards a leaf that is not a matmul or conv
    kernel's output features (``pos``, the dense family's every leaf).

A sharded layer (:class:`Shard` on ``module.tp``, set by
``parallel/partition.py::shard_model``) runs one of four modes:
``column`` (copy, the product with its rows of the output features,
gather, then the whole bias, added once after the gather so that every
peer's bias gradient is the whole one), ``heads`` (attention's
query/key/value: its heads' features and bias, no gather), ``row``
(attention's output: the product of its heads' features, reduce, then the
whole bias) and ``gather`` (every sharded parameter gathered on use).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist

from dmfusion_torch.parallel.mesh import all_gather_rows


@dataclass(frozen=True)
class ModelAxis:
    """This rank's model peers: their group, its place and their count."""

    group: Any
    index: int
    size: int


@dataclass(frozen=True)
class Shard:
    """How a module computes with its sharded parameters: ``mode``
    (``column``, ``heads``, ``row`` or ``gather``) and each sharded
    parameter's dimension (``dims``: name -> torch dimension)."""

    axis: ModelAxis
    mode: str
    dims: dict[str, int]


def shard_dims(model: torch.nn.Module) -> dict[str, tuple[ModelAxis, int]]:
    """``model``'s sharded parameters: qualified name -> (model axis, torch
    dimension); empty for a model that is not sharded."""
    out = {}
    for mname, m in model.named_modules():
        tp = m.__dict__.get("tp")
        if tp is not None:
            for pname, dim in tp.dims.items():
                out[f"{mname}.{pname}" if mname else pname] = (tp.axis, dim)
    return out


def shard_state(model: torch.nn.Module, state: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
    """This rank's shards of a whole ``state_dict`` of ``model`` (the
    replicated entries as they are)."""
    dims = shard_dims(model)
    return {k: (slice_dim(v, *dims[k]).contiguous() if k in dims else v)
            for k, v in state.items()}


@contextmanager
def unsharded(model: torch.nn.Module) -> Iterator[None]:
    """Every sharded parameter of ``model`` at its whole shape (its values
    undefined) inside the block, then this rank's slice of what the block
    wrote: a seeded initialization draws the whole tensors, as one process
    does, and each rank keeps its shard of them.  The parameters stay the
    same objects; a no-op for a model that is not sharded."""
    params = dict(model.named_parameters())
    held = []
    for name, (axis, dim) in shard_dims(model).items():
        p = params[name]
        shape = list(p.shape)
        shape[dim] *= axis.size
        held.append((p, axis, dim, p.ndim == 4 and p.is_contiguous(
            memory_format=torch.channels_last)))
        p.data = p.data.new_empty(shape)
    try:
        yield
    finally:
        for p, axis, dim, cl in held:
            p.data = slice_dim(p.data, axis, dim).clone(
                memory_format=torch.channels_last if cl
                else torch.contiguous_format)


def gather_dim(t: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """Every peer's ``t`` concatenated along ``dim``, in peer order."""
    moved = t.movedim(dim, 0)
    return all_gather_rows(moved, axis.size, axis.group).movedim(0, dim)


def slice_dim(t: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """This peer's slice of a whole ``t`` along ``dim``."""
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return gather_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return slice_dim(g, ctx.axis, ctx.dim).contiguous(), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _Copy.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: ModelAxis,
                      dim: int) -> torch.Tensor:
    return _Gather.apply(x, axis, dim)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _Reduce.apply(x, axis)


def use(module: torch.nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name`` as the module computes with it: the
    whole parameter, gathered from the peers when it is sharded."""
    p = getattr(module, name)
    tp = getattr(module, "tp", None)
    if tp is None or name not in tp.dims:
        return p
    return gather_from_model(p, tp.axis, tp.dims[name])


def sharded_product(module: torch.nn.Module, x: torch.Tensor,
                    op: Callable[..., torch.Tensor],
                    feature_dim: int) -> torch.Tensor:
    """A conv or dense layer's output ``op(x, weight, bias)`` in the
    module's mode (module docstring: ``column``, ``heads`` or ``row``);
    ``feature_dim`` is the output's feature dimension.  Unsharded, and in
    the ``heads`` mode (its own heads' weight and bias), it is ``op``
    itself.  A bias added after a
    collective is added in the output's dtype, as autocast's fused bias
    is."""
    tp = getattr(module, "tp", None)
    if tp is None or tp.mode == "heads":
        return op(x, module.weight, module.bias)
    if tp.mode == "column":
        y = op(copy_to_model(x, tp.axis), module.weight, None)
        y = gather_from_model(y, tp.axis, feature_dim)
    elif tp.mode == "row":
        y = reduce_from_model(op(x, module.weight, None), tp.axis)
    else:
        raise ValueError(f"unknown shard mode {tp.mode!r}")
    return y + _along(module.bias.to(y.dtype), y.ndim, feature_dim)


def _along(b: torch.Tensor, ndim: int, dim: int) -> torch.Tensor:
    """A (features,) vector shaped to broadcast along ``dim`` of ``ndim``
    dimensions."""
    dim %= ndim
    return b.reshape(b.shape[0], *([1] * (ndim - dim - 1)))
