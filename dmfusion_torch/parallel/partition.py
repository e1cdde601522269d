"""The ``model`` axis's placement: which parameters shard, and how.

Port of ``dmfusion/parallel/partition.py``.  The rule (:func:`leaf_spec`,
dmfusion's ``_leaf_spec`` as it stands) is decided on each leaf's flax
path and shape, so it is applied to the flax names and shapes that
``models/convert.py`` maps (:func:`flax_specs`), and each sharded flax
axis is then the torch dimension the converter lays it on
(:func:`placement`):

  * attention ``query``/``key``/``value`` kernels ``(in, heads,
    head_dim)`` shard over heads when the axis divides the head count, and
    their ``(heads, head_dim)`` biases with them; otherwise they, and
    their biases, are replicated;
  * the attention ``out`` kernel ``(heads, head_dim, out)`` shards its
    heads when they divide, else it is replicated;
  * any other leaf of two or more dims whose minor-most dim divides the
    axis is column-sharded (a conv's or dense's output features, the
    transformers' ``pos``, ``modality`` and ``cls``);
  * everything else (biases, norm scales, scalars) is replicated.

Under the config's vit (3 heads) and ``model: 2`` the attention is
replicated while its MLP, ``pos``, ``modality`` and ``cls`` still shard;
an odd class count leaves the head's last kernel replicated.

Adam's moments are shaped like their parameters, so an optimizer built on
the sharded parameters (:func:`shard_model` first, then
``train/optim.py::make_optimizer``, which fills zero moments at creation)
holds only the shards.  Checkpoints hold the whole model: :func:`full_state`
and :func:`full_opt_state` gather the shards over the model group before
a save, ``parallel/tensor.py::shard_state`` and :func:`shard_opt_state`
take a rank's slices of a loaded file.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from dmfusion_torch.models.common import Linear, SameConv2d
from dmfusion_torch.models.convert import (HEADS_IN, HEADS_OUT, PARAM,
                                           _walk, flax_leaves)
from dmfusion_torch.parallel.mesh import Mesh, unported
from dmfusion_torch.parallel.tensor import (ModelAxis, Shard, gather_dim,
                                            shard_dims, slice_dim)

#: flax MultiHeadDotProductAttention submodule names whose DenseGeneral
#: kernels are (in_features, heads, head_dim): shard the heads axis.
_ATTN_QKV = ("query", "key", "value")


def leaf_spec(names: tuple[str, ...] | list[str], shape: tuple[int, ...],
              model: int) -> tuple:
    """One leaf's placement, from its path's names and its shape: a tuple
    with ``"model"`` at the sharded axis and None elsewhere, or ``()``
    replicated (dmfusion's ``PartitionSpec``)."""
    nd = len(shape)
    if model <= 1:
        return ()
    if any(n in _ATTN_QKV for n in names):
        if nd == 3 and shape[1] % model == 0:
            return (None, "model", None)
        if nd == 2 and shape[0] % model == 0:
            return ("model", None)
        return ()
    if "out" in names and nd == 3:
        if shape[0] % model == 0:
            return ("model", None, None)
        return ()
    if nd >= 2 and shape[-1] % model == 0:
        return (*([None] * (nd - 1)), "model")
    return ()


def flax_specs(model: nn.Module, size: int) -> dict[tuple[str, ...], tuple]:
    """The placement of every leaf of ``model``'s flax tree on a model axis
    of ``size``: flax path -> :func:`leaf_spec`.  Every model of the zoo
    has one (its converter's tree), whether or not the port shards it."""
    return {path: leaf_spec(path, shape, size)
            for path, shape, _, _ in flax_leaves(model)}


def placement(model: nn.Module, size: int) -> dict[str, int | None]:
    """Each torch parameter's sharded dimension on a model axis of
    ``size``, or None where it is replicated.  Raises, naming ROADMAP A14
    item 7, where a sharded flax leaf has no one torch dimension (an LSTM
    cell's stacked gates, a head_dim axis)."""
    out: dict[str, int | None] = {}
    for path, shape, tname, axes in flax_leaves(model):
        spec = leaf_spec(path, shape, size)
        dim = spec.index("model") if spec else None
        if dim is not None and (tname is None or axes[dim] is None):
            raise unported(f"sharding {'/'.join(path)} on the model axis",
                           "model")
        if tname is not None:
            out[tname] = None if dim is None else axes[dim]
    return out


def shard_model(model: nn.Module, mesh: Mesh | None) -> dict[str, int]:
    """Replace each parameter that :func:`placement` shards by this rank's
    shard of it (the same name, the shard's shape) and set each owning
    module's mode (``parallel/tensor.py``): a model with
    ``tp_gather_on_use`` (the dense family) gathers every sharded leaf on
    use; otherwise a conv or dense layer of ``models/common.py`` is
    column-parallel, an attention's query/key/value are its heads' and its
    out row-parallel, and a raw parameter is gathered on use.  Any other
    sharded layer raises, naming ROADMAP A14 item 7.  Returns the sharded
    parameters' dimensions; a no-op without a model axis.  Shard before
    building the optimizer (its moments take the shards' shapes)."""
    if mesh is None or mesh.model == 1:
        return {}
    axis = ModelAxis(mesh.model_group, mesh.model_index, mesh.model)
    dims = {k: d for k, d in placement(model, mesh.model).items()
            if d is not None}
    kinds = {tname: (kind, owner, pname)
             for _, tname, kind, _, owner, pname in _walk(model)}
    owners: dict[nn.Module, dict[str, int]] = {}
    modes: dict[nn.Module, str] = {}
    gather_all = getattr(model, "tp_gather_on_use", False)
    for tname, dim in dims.items():
        kind, owner, pname = kinds[tname]
        owners.setdefault(owner, {})[pname] = dim
        modes[owner] = "gather" if gather_all else _mode(kind, owner, tname)
    for owner, pdims in owners.items():
        mode = modes[owner]
        if mode in ("column", "row") and set(pdims) != {"weight"}:
            raise unported(f"{type(owner).__name__} with {sorted(pdims)} "
                           "sharded", "model")
        for pname, dim in pdims.items():
            p = getattr(owner, pname)
            cl = p.ndim == 4 and p.is_contiguous(
                memory_format=torch.channels_last)
            shard = slice_dim(p.detach(), axis, dim).clone(
                memory_format=torch.channels_last if cl
                else torch.contiguous_format)
            setattr(owner, pname, nn.Parameter(shard,
                                               requires_grad=p.requires_grad))
        owner.tp = Shard(axis, mode, pdims)
    return dims


def _mode(kind: str, owner: nn.Module, tname: str) -> str:
    """The mode of the module that owns the sharded parameter ``tname``."""
    if kind == HEADS_IN:
        return "heads"
    if kind == HEADS_OUT:
        return "row"
    if kind == PARAM:
        return "gather"
    if isinstance(owner, (SameConv2d, Linear)):
        return "column"
    raise unported(f"{tname} ({type(owner).__name__}) sharded on the model "
                   "axis", "model")


@torch.no_grad()
def full_state(model: nn.Module,
               state: Mapping[str, torch.Tensor] | None = None
               ) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a sharded ``model`` (or of ``state``, a
    state of its shards' shapes), gathered over the model group: a
    collective that every peer calls in the same order.  Replicated
    entries are ``state``'s own tensors; a model that is not sharded gives
    ``state`` (or its ``state_dict()``) as it is."""
    state = model.state_dict() if state is None else state
    dims = shard_dims(model)
    return {k: (gather_dim(v.detach(), *dims[k]) if k in dims else v)
            for k, v in state.items()}


def _moment_dims(model: nn.Module, optimizer: torch.optim.Optimizer
                 ) -> dict[int, tuple[ModelAxis, int]]:
    """The optimizer state's parameter index -> its shard's (axis, dim)."""
    dims = shard_dims(model)
    names = {id(p): n for n, p in model.named_parameters()}
    order = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: dims[names[id(p)]] for i, p in enumerate(order)
            if names.get(id(p)) in dims}


def _map_moments(sd: dict[str, Any], dims: Mapping[int, tuple], fn
                 ) -> dict[str, Any]:
    state = {i: {k: (fn(v, *dims[i]) if i in dims and torch.is_tensor(v)
                     and v.ndim > 0 else v) for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {**sd, "state": state}


@torch.no_grad()
def full_opt_state(model: nn.Module, optimizer: torch.optim.Optimizer
                   ) -> dict[str, Any]:
    """``optimizer.state_dict()`` with every sharded parameter's moments
    gathered over the model group (a collective, as :func:`full_state`)."""
    return _map_moments(optimizer.state_dict(),
                        _moment_dims(model, optimizer),
                        lambda v, axis, dim: gather_dim(v.detach(), axis, dim))


def shard_opt_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                    sd: Mapping[str, Any]) -> dict[str, Any]:
    """This rank's slices of a whole optimizer ``state_dict``."""
    return _map_moments(dict(sd), _moment_dims(model, optimizer),
                        lambda v, axis, dim: slice_dim(v, axis,
                                                       dim).contiguous())
