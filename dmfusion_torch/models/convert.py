"""Parameters between the flax tree of ``dmfusion`` and the torch modules.

The flax tree (``flax.serialization.to_state_dict`` of the params, numpy
leaves) names modules by class and call order, e.g.
``ResBlock_2/ConvBlock_0/Conv_0/kernel``, or by an explicit name
(``trunk1/LocalConvBlock_0/WSConv_0/gain``).  The tables below map each
flax name to the torch attribute that holds the same layer, and say what
it is: a module of a scope with its own table, a leaf module (its params
are ``kernel``, ``bias``, ``scale``, ``gain``), or a raw parameter (the
dense heads' ``head1_kernel``, a residual ``alpha``), copied as it is.
Layouts differ for leaf modules: conv kernels are HWIO in flax and OIHW
in torch, dense kernels ``(in, out)`` against ``(out, in)``, and
GroupNorm's and LayerNorm's ``scale`` is torch's ``weight``.  An
attention layer's ``query``/``key``/``value`` kernels are ``DenseGeneral``
``(in, heads, head_dim)`` with ``(heads, head_dim)`` biases, and its
``out`` kernel is ``(heads, head_dim, dim)``: torch ``nn.Linear`` layers
over the flattened head axes, heads major (leaf kinds ``HEADS_IN`` and
``HEADS_OUT``; the head count is the attention module's ``heads``).
ct_lstm's ``OptimizedLSTMCell_0`` holds one kernel per gate and side
(``ii`` ... ``io``, ``(in, h)``, no bias; ``hi`` ... ``ho``, ``(h, h)``
with a bias): the port's LSTM stacks them, gates i, f, g, o, into one
input weight ``(4, h, in)``, one hidden weight ``(4, h, h)`` (each gate
in ``nn.Linear`` layout) and one bias ``(4, h)`` (kind ``LSTM_CELL``), so
that flax's hidden axis is torch dimension 1 of all three.  Conversion
in either direction raises on anything left unmatched, so a tree of
another model or width never loads in part.  The
root scope is the model class's ``flax_root``: ``Net`` for gmfnet,
``DenseNet`` for dense_fusion, ``ConvNet`` for gmfnet_conv (whose tree
names every layer explicitly), and ``TriNet``, ``DQTL``, ``ResNet18``,
``CrossNet``, ``ViT``, ``Swin``, ``SwinDual``, ``CTLSTM``, ``Generator``
and ``Discriminator`` for the tri_net, dqtl, resnet18, cross_net, vit,
swin_transformer, swin_T_dual, ct_lstm, generator and discriminator
trees, and ``MSNet`` for an MS-only classifier built of the shared blocks
(a stem ``ConvBlock_0``, ``ResBlock_i``, ``MLPHead_0``), each rooted at
flax's ``Net`` (tri_net's ``ResBlock_2`` is its
MSPAN branch, gmfnet's the trunk's first block: one name, two layers).

The optimizer state goes across the same way (:func:`opt_state_from_optax`,
:func:`opt_state_to_optax`): an optax Adam, SGD or RMSprop state, as
``flax.serialization.to_state_dict`` lays it out (``{"0": {"count", "mu",
"nu"}, "1": {...}}``, numpy leaves), holds one param-shaped tree per
moment, mapped leaf by leaf with the same transposes, and the update
count.  One optimizer over a tree of models (the GAN's one Adam over both
generators, ``{"gP", "gM"}``, and one over both discriminators) takes a
mapping of modules in place of the model, and its moments are trees keyed
the same way.

A model sharded over the mesh's ``model`` axis
(``parallel/partition.py::shard_model``) converts from and to the whole
flax tree: a whole tree loads as this rank's shards, and
:func:`params_to_flax` (with it :func:`opt_state_to_optax`) gathers the
shards from the rank's model peers first, a collective that every peer
calls in the same order.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from dmfusion_torch.parallel.tensor import (gather_dim, shard_dims,
                                            shard_state, slice_dim)

LEAF = "leaf"    # a module whose params are kernel/bias/scale/gain leaves
PARAM = "param"  # a raw parameter, same array in both frameworks
HEADS_IN = "heads_in"    # DenseGeneral dim -> (heads, head_dim)
HEADS_OUT = "heads_out"  # DenseGeneral (heads, head_dim) -> dim
LSTM_CELL = "lstm_cell"  # OptimizedLSTMCell's 8 gate kernels -> 3 tensors
_LEAVES = (LEAF, HEADS_IN, HEADS_OUT)
# OptimizedLSTMCell's gate order, as the port's LSTM stacks its gates.
_GATES = "ifgo"


def _conv_block(n: int, path: str) -> dict[str, tuple[str, str]]:
    return {f"ConvBlock_{i}": (f"{path}.{i}", "ConvBlock") for i in range(n)}


# The transformer scopes list blocks up to this depth, and the Swin
# encoder stages up to this count; a deeper model's extra blocks or stages
# are refused as unmatched.
_DEPTHS = 32
_STAGES = 8

# Per scope: flax child name -> (torch attribute path, child scope or kind).
_CHILDREN: dict[str, dict[str, tuple[str, str]]] = {
    "Net": {"ConvBlock_0": ("ms_stem", "ConvBlock"),
            "ResBlock_0": ("ms_res", "ResBlock"),
            "PanSpaceToDepth_0": ("pan", "PanSpaceToDepth"),
            "PanPyramid_0": ("pan", "PanPyramid"),
            "ResBlock_1": ("pan_res", "ResBlock"),
            "fusion_gate": ("fusion_gate", LEAF),
            "ResBlock_2": ("trunk.0", "ResBlock"),
            "ResBlock_3": ("trunk.1", "ResBlock"),
            "ResBlock_4": ("trunk.2", "ResBlock"),
            "MLPHead_0": ("head", "MLPHead")},
    "ConvBlock": {"Conv_0": ("conv", LEAF), "GroupNorm_0": ("norm", LEAF)},
    "ResBlock": {"ConvBlock_0": ("block", "ConvBlock"),
                 "Conv_0": ("conv", LEAF), "GroupNorm_0": ("norm", LEAF),
                 "Conv_1": ("shortcut", LEAF)},
    "PanSpaceToDepth": _conv_block(2, "blocks"),
    "PanPyramid": _conv_block(2, "blocks"),
    "MLPHead": {"Dense_0": ("hidden", LEAF), "Dense_1": ("out", LEAF)},
    "DenseNet": {
        **{n: (n, "LocalConvBlock") for n in ("ms_stem", "pan_stem",
                                              "refine")},
        **{n: (n, "LocalResBlock") for n in ("ms_block", "pan_block",
                                             "trunk1", "trunk2")},
        "fusion_gate": ("fusion_gate", LEAF),
        **{n: (n, PARAM) for n in ("head1_kernel", "head1_bias",
                                   "head2_kernel", "head2_bias")}},
    "ConvNet": {
        **{n: (n, LEAF) for n in (
            "ms_stem", "ms_c1", "ms_c2", "ms_sc", "pan_stem1", "pan_stem2",
            "pan_c1", "pan_c2", "fusion_gate", "t1_c1", "t1_c2", "t1_sc",
            "t2_c1", "t2_c2", "t3_c1", "t3_c2", "t3_sc", "head1", "head2")},
        **{n: (n, PARAM) for n in ("alpha_ms", "alpha_pan", "alpha1",
                                   "alpha2", "alpha3")}},
    "TriNet": {"ConvBlock_0": ("ms_stem", "ConvBlock"),
               "ResBlock_0": ("ms_res", "ResBlock"),
               "PanPyramid_0": ("pan", "PanPyramid"),
               "ResBlock_1": ("pan_res", "ResBlock"),
               "PanPyramid_1": ("mspan", "PanPyramid"),
               "ResBlock_2": ("mspan_res", "ResBlock"),
               "stream_gate": ("stream_gate", LEAF),
               "ResBlock_3": ("trunk.0", "ResBlock"),
               "ResBlock_4": ("trunk.1", "ResBlock"),
               "MLPHead_0": ("head", "MLPHead")},
    "DQTL": {"ConvBlock_0": ("stem", "ConvBlock"),
             **{f"ResBlock_{i}": (f"blocks.{i}", "ResBlock")
                for i in range(3)},
             "MLPHead_0": ("head", "MLPHead")},
    "Generator": {"ConvBlock_0": ("enc1", "ConvBlock"),
                  "ConvBlock_1": ("enc2", "ConvBlock"),
                  "ResBlock_0": ("res.0", "ResBlock"),
                  "ResBlock_1": ("res.1", "ResBlock"),
                  "ConvBlock_2": ("dec", "ConvBlock"),
                  "Conv_0": ("out", LEAF)},
    "Discriminator": {**_conv_block(3, "blocks"), "Conv_0": ("out", LEAF)},
    # An MS-only classifier of the shared blocks (a model of the single
    # arity): a stem, residual blocks, a head.
    "MSNet": {"ConvBlock_0": ("stem", "ConvBlock"),
              **{f"ResBlock_{i}": (f"blocks.{i}", "ResBlock")
                 for i in range(8)},
              "MLPHead_0": ("head", "MLPHead")},
    "ResNet18": {"ms_branch": ("ms_branch", "Branch"),
                 "pan_branch": ("pan_branch", "Branch"),
                 "MLPHead_0": ("head", "MLPHead")},
    "Branch": {"ConvBlock_0": ("stem", "ConvBlock"),
               **{f"ResBlock_{i}": (f"blocks.{i}", "ResBlock")
                  for i in range(8)}},
    "CrossNet": {
        "ms_embed": ("ms_embed", LEAF), "pan_embed": ("pan_embed", LEAF),
        "PanPyramid_0": ("pan", "PanPyramid"),
        "pos_ms": ("pos_ms", PARAM), "pos_pan": ("pos_pan", PARAM),
        **{f"{n}_{i}": (f"{n}.{i}", "CrossAttnBlock")
           for n in ("ms_from_pan", "pan_from_ms") for i in range(_DEPTHS)},
        **{f"{n}_{i}": (f"{n}.{i}", "SelfAttnBlock")
           for n in ("ms_self", "pan_self") for i in range(_DEPTHS)},
        "MLPHead_0": ("head", "MLPHead")},
    "ViT": {"ms_embed": ("ms_embed", LEAF), "pan_embed": ("pan_embed", LEAF),
            "PanPyramid_0": ("pan", "PanPyramid"),
            **{n: (n, PARAM) for n in ("pos", "modality", "cls")},
            **{f"block_{i}": (f"blocks.{i}", "SelfAttnBlock")
               for i in range(_DEPTHS)},
            "LayerNorm_0": ("norm", LEAF),
            "MLPHead_0": ("head", "MLPHeadOut")},
    "Swin": {"PanPyramid_0": ("pan", "PanPyramid"),
             "encoder": ("encoder", "SwinEncoder"),
             "MLPHead_0": ("head", "MLPHead")},
    "SwinDual": {"PanPyramid_0": ("pan", "PanPyramid"),
                 "ms_encoder": ("ms_encoder", "SwinEncoder"),
                 "pan_encoder": ("pan_encoder", "SwinEncoder"),
                 "gate": ("gate", LEAF),
                 "MLPHead_0": ("head", "MLPHead")},
    "SwinEncoder": {
        "embed": ("embed", LEAF), "pos": ("pos", PARAM),
        **{f"stage{s}_block{i}": (f"stages.{s}.{i}", "SwinBlock")
           for s in range(_STAGES) for i in range(_DEPTHS)},
        **{f"merge{s}": (f"merges.{s}", "PatchMerge")
           for s in range(_STAGES)},
        "LayerNorm_0": ("norm", LEAF)},
    "SwinBlock": {"LayerNorm_0": ("norm1", LEAF),
                  "WindowAttention_0": ("attn", "WindowAttention"),
                  "LayerNorm_1": ("norm2", LEAF),
                  "Dense_0": ("fc1", LEAF), "Dense_1": ("fc2", LEAF)},
    "WindowAttention": {"qkv": ("qkv", LEAF), "proj": ("proj", LEAF),
                        "rel_bias": ("rel_bias", PARAM)},
    "PatchMerge": {"LayerNorm_0": ("norm", LEAF),
                   "Dense_0": ("reduce", LEAF)},
    "CTLSTM": {**{f"pan_level{i}": (f"pan_levels.{i}", "LevelEmbed")
                  for i in range(3)},
               "ms_level": ("ms_level", "LevelEmbed"),
               "OptimizedLSTMCell_0": ("lstm", LSTM_CELL),
               "MLPHead_0": ("head", "MLPHead")},
    "LevelEmbed": _conv_block(2, "blocks"),
    # flax's MLPHead without a hidden layer names its one Dense "Dense_0".
    "MLPHeadOut": {"Dense_0": ("out", LEAF)},
    "SelfAttnBlock": {"LayerNorm_0": ("ln_0", LEAF),
                      "MultiHeadDotProductAttention_0": (
                          "attn", "MultiHeadAttention"),
                      "LayerNorm_1": ("ln_1", LEAF),
                      "Dense_0": ("fc_0", LEAF), "Dense_1": ("fc_1", LEAF)},
    "CrossAttnBlock": {"LayerNorm_0": ("ln_0", LEAF),
                       "LayerNorm_1": ("ln_1", LEAF),
                       "MultiHeadDotProductAttention_0": (
                           "attn", "MultiHeadAttention"),
                       "LayerNorm_2": ("ln_2", LEAF),
                       "Dense_0": ("fc_0", LEAF), "Dense_1": ("fc_1", LEAF)},
    "MultiHeadAttention": {"query": ("query", HEADS_IN),
                           "key": ("key", HEADS_IN),
                           "value": ("value", HEADS_IN),
                           "out": ("out", HEADS_OUT)},
    "LocalConvBlock": {"WSConv_0": ("conv", LEAF)},
    "LocalResBlock": {"LocalConvBlock_0": ("block", "LocalConvBlock"),
                      "WSConv_0": ("conv", LEAF),
                      "WSConv_1": ("shortcut", LEAF),
                      "alpha": ("alpha", PARAM)},
}

# A scope whose torch modules are of another class than its name.
_SCOPE_CLASS = {"MLPHeadOut": "MLPHead"}


def _f32(arr: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def _leaf_to_torch(name: str, arr: np.ndarray, where: str, kind: str = LEAF
                   ) -> tuple[str, torch.Tensor]:
    t = _f32(arr)
    if kind == HEADS_IN and name == "kernel":   # (in, heads, hd)
        return "weight", t.reshape(t.shape[0], -1).t().contiguous()
    if kind == HEADS_IN and name == "bias":     # (heads, hd)
        return "bias", t.reshape(-1)
    if kind == HEADS_OUT and name == "kernel":  # (heads, hd, out)
        return "weight", t.reshape(-1, t.shape[-1]).t().contiguous()
    if name == "kernel" and t.ndim == 4:
        return "weight", t.permute(3, 2, 0, 1).contiguous()
    if name == "kernel" and t.ndim == 2:
        return "weight", t.t().contiguous()
    if name == "scale":
        return "weight", t
    if name in ("bias", "gain"):
        return name, t
    raise ValueError(f"flax leaf {where}/{name} has no torch counterpart")


def _lstm_to_torch(cell: Mapping[str, Any], where: str
                   ) -> dict[str, torch.Tensor]:
    """OptimizedLSTMCell's ``i{g}`` kernels ``(in, h)`` and ``h{g}``
    kernels ``(h, h)`` and biases, gates i, f, g, o, -> the port's LSTM's
    ``input_weight`` ``(4, h, in)``, ``hidden_weight`` ``(4, h, h)`` and
    ``hidden_bias`` ``(4, h)``."""
    want = {f"i{g}": {"kernel"} for g in _GATES}
    want.update({f"h{g}": {"kernel", "bias"} for g in _GATES})
    got = {k: set(v) for k, v in cell.items()}
    if got != want:
        raise ValueError(f"flax entry {where} is not an OptimizedLSTMCell: "
                         f"{sorted(got)}")

    def stack(prefix, leaf):
        return torch.stack([_f32(cell[f"{prefix}{g}"][leaf]).t()
                            for g in _GATES]).contiguous()

    return {"input_weight": stack("i", "kernel"),
            "hidden_weight": stack("h", "kernel"),
            "hidden_bias": stack("h", "bias")}


def _lstm_to_flax(weights: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of :func:`_lstm_to_torch`."""
    def split(name):
        a = weights[name].detach().to("cpu", torch.float32).numpy()
        return [g.T for g in a]

    tree: dict[str, Any] = {}
    for prefix, name in (("i", "input_weight"), ("h", "hidden_weight")):
        for g, k in zip(_GATES, split(name)):
            tree[f"{prefix}{g}"] = {"kernel": np.ascontiguousarray(k)}
    for g, b in zip(_GATES, split("hidden_bias")):
        tree[f"h{g}"]["bias"] = np.ascontiguousarray(b)
    return tree


def params_from_flax(tree: Mapping[str, Any], root: str = "Net"
                     ) -> dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> torch ``state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], scope: str, fpath: str, tpath: str):
        table = _CHILDREN[scope]
        for key, value in node.items():
            where = f"{fpath}/{key}" if fpath else key
            if key not in table:
                raise ValueError(f"flax entry {where} is left unused: no "
                                 f"torch counterpart in {scope}")
            attr, kind = table[key]
            tname = f"{tpath}.{attr}" if tpath else attr
            if kind == PARAM:
                out[tname] = _f32(value)
            elif kind == LSTM_CELL:
                out.update({f"{tname}.{k}": v for k, v in
                            _lstm_to_torch(value, where).items()})
            elif kind in _LEAVES:
                for leaf, arr in value.items():
                    pname, tensor = _leaf_to_torch(leaf, arr, where, kind)
                    out[f"{tname}.{pname}"] = tensor
            else:
                walk(value, kind, where, tname)

    walk(tree, root, "", "")
    return out


def load_flax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load a flax tree into ``model`` (this rank's shards of a sharded
    model); raises on any flax leaf left unused and on any torch parameter
    left unset."""
    state = shard_state(model, params_from_flax(
        tree, getattr(model, "flax_root", "Net")))
    want = model.state_dict()
    unused = sorted(set(state) - set(want))
    unset = sorted(set(want) - set(state))
    if unused:
        raise ValueError(f"flax leaves left unused: {unused}")
    if unset:
        raise ValueError(f"torch parameters left unset: {unset}")
    model.load_state_dict(state, strict=True)
    return model


def _leaf_to_flax(module: nn.Module, name: str, p: torch.Tensor,
                  kind: str = LEAF, heads: int = 0) -> tuple[str, np.ndarray]:
    a = p.detach().to("cpu", torch.float32).numpy()
    if kind == HEADS_IN and name == "weight":   # (heads*hd, in)
        return "kernel", np.ascontiguousarray(a.T).reshape(
            a.shape[1], heads, -1)
    if kind == HEADS_IN and name == "bias":
        return "bias", a.reshape(heads, -1)
    if kind == HEADS_OUT and name == "weight":  # (out, heads*hd)
        return "kernel", np.ascontiguousarray(a.T).reshape(
            heads, -1, a.shape[0])
    if name in ("bias", "gain"):
        return name, a
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
        return "scale", a
    if name == "weight" and a.ndim == 4:
        return "kernel", np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if name == "weight" and a.ndim == 2:
        return "kernel", np.ascontiguousarray(a.T)
    raise ValueError(f"{type(module).__name__}.{name} has no flax counterpart")


def _walk(model: nn.Module):
    """Every torch parameter of ``model`` in the flax tree's order: ``(flax
    path of the leaf's module or raw parameter, torch name, kind, scope
    module, owner module, parameter name)``; an LSTM cell comes once, its
    parameter name None."""
    def walk(module: nn.Module, scope: str, fpath: tuple, prefix: str):
        for fname, (attr, kind) in _CHILDREN[scope].items():
            tname = f"{prefix}.{attr}" if prefix else attr
            here = (*fpath, fname)
            if kind == PARAM:
                yield here, tname, kind, module, module, attr
                continue
            try:
                child = module.get_submodule(attr)
            except AttributeError:  # an absent optional layer (shortcut)
                continue
            if kind == LSTM_CELL:
                yield here, tname, kind, module, child, None
            elif kind not in _LEAVES:
                # The class check picks gmfnet's PAN variant.
                if type(child).__name__ == _SCOPE_CLASS.get(kind, kind):
                    yield from walk(child, kind, here, tname)
            else:
                for pname, _ in child.named_parameters(recurse=False):
                    yield here, f"{tname}.{pname}", kind, module, child, pname

    yield from walk(model, getattr(model, "flax_root", "Net"), (), "")


def _node(tree: dict, path: tuple) -> dict:
    for key in path:
        tree = tree.setdefault(key, {})
    return tree


def params_to_flax(model: nn.Module,
                   values: Mapping[str, torch.Tensor] | None = None
                   ) -> dict[str, Any]:
    """Torch model -> flax param tree (nested dicts of numpy arrays).

    With ``values`` (parameter name -> tensor of its shape, e.g. an Adam
    moment), those tensors are laid out in the tree instead of the
    parameters.  A sharded model's shards (and values) are gathered from
    its model peers: the tree is the whole model's."""
    tree: dict[str, Any] = {}
    seen = 0
    dims = shard_dims(model)

    def value(name: str, p: torch.Tensor) -> torch.Tensor:
        t = (p if values is None else values[name]).detach()
        return gather_dim(t, *dims[name]) if name in dims else t

    for fpath, tname, kind, scope, owner, pname in _walk(model):
        if kind == PARAM:
            _node(tree, fpath[:-1])[fpath[-1]] = value(
                tname, getattr(owner, pname)).to("cpu", torch.float32).numpy()
            seen += 1
        elif kind == LSTM_CELL:
            params = dict(owner.named_parameters(recurse=False))
            _node(tree, fpath[:-1])[fpath[-1]] = _lstm_to_flax({
                n: value(f"{tname}.{n}", p) for n, p in params.items()})
            seen += len(params)
        else:
            leaf, arr = _leaf_to_flax(owner, pname,
                                      value(tname, getattr(owner, pname)),
                                      kind, getattr(scope, "heads", 0))
            _node(tree, fpath)[leaf] = arr
            seen += 1
    total = len(model.state_dict())
    if seen != total:
        raise ValueError(f"{total - seen} torch parameters have no flax name")
    return tree


def flax_leaves(model: nn.Module):
    """Every flax leaf of ``model``'s tree, in its order: ``(flax path,
    flax shape, torch name, torch dimension of each flax axis)``.  An LSTM
    cell's gate leaves name the stacked tensor that holds them (four
    leaves a tensor).  The shapes are the parameters' own (a model's
    before it is sharded)."""
    for fpath, tname, kind, scope, owner, pname in _walk(model):
        if kind == PARAM:
            p = getattr(owner, pname)
            yield fpath, tuple(p.shape), tname, tuple(range(p.ndim))
        elif kind == LSTM_CELL:
            for sub, leaves in _lstm_to_flax({
                    n: p.detach() for n, p in
                    owner.named_parameters(recurse=False)}).items():
                for leaf, arr in leaves.items():
                    # kernel (in, h) -> (gate, h, in); bias (h,) -> (gate, h)
                    name = ("hidden_bias" if leaf == "bias" else
                            "input_weight" if sub[0] == "i" else
                            "hidden_weight")
                    yield ((*fpath, sub, leaf), arr.shape, f"{tname}.{name}",
                           (2, 1) if leaf == "kernel" else (1,))
        else:
            p = getattr(owner, pname)
            leaf, arr = _leaf_to_flax(owner, pname, p.detach(), kind,
                                      getattr(scope, "heads", 0))
            yield ((*fpath, leaf), arr.shape, tname,
                   _AXES.get((kind, leaf, p.ndim), tuple(range(p.ndim))))


# The torch dimension of each flax axis of a leaf, by (kind, flax leaf,
# torch ndim): HWIO against OIHW, (in, out) against (out, in), the heads
# axes flattened heads-major (a head_dim axis has none of its own).
_AXES = {(LEAF, "kernel", 4): (2, 3, 1, 0), (LEAF, "kernel", 2): (1, 0),
         (HEADS_IN, "kernel", 2): (1, 0, None),
         (HEADS_IN, "bias", 1): (0, None),
         (HEADS_OUT, "kernel", 2): (1, None, 0)}


# Per optimizer: the optax moment trees and the torch state key of each,
# and the number of optax sub-states (the schedule's count is in "1").
_OPT_LAYOUT = {
    "Adam": ((("mu", "exp_avg"), ("nu", "exp_avg_sq")), 2),
    "SGD": ((("trace", "momentum_buffer"),), 2),
    "RMSprop": ((("nu", "nu"),), 3),
}


def _opt_layout(optimizer: torch.optim.Optimizer):
    name = type(optimizer).__name__
    if name not in _OPT_LAYOUT:
        raise ValueError(f"no optax counterpart for {name}")
    return name, *_OPT_LAYOUT[name]


def _named(model: nn.Module | Mapping[str, nn.Module]
           ) -> dict[str, tuple[str | None, str]]:
    """Each parameter's (model key, name): the key is None for one model,
    or the tree's key for a tree of models (the GAN's ``{"gP", "gM"}``)."""
    if isinstance(model, nn.Module):
        return {p: (None, n) for n, p in model.named_parameters()}
    return {p: (k, n) for k, m in model.items()
            for n, p in m.named_parameters()}


def opt_state_to_optax(model: nn.Module | Mapping[str, nn.Module],
                       optimizer: torch.optim.Optimizer) -> dict[str, Any]:
    """The port's optimizer state -> optax's, as ``to_state_dict`` lays it
    out: ``{"0": {moments (and Adam's count)}, "1": {"count"} when a
    schedule is on else {}, ...}``, numpy leaves.  ``model`` is the module
    the optimizer updates, or a mapping of modules for one optimizer over
    a tree of models (each moment is then a tree keyed the same way)."""
    name, moments, n_sub = _opt_layout(optimizer)
    names = _named(model)
    count = np.asarray(optimizer.param_groups[0]["count"], np.int32)
    first: dict[str, Any] = {"count": count} if name == "Adam" else {}
    for okey, tkey in moments:
        values: dict[str | None, dict[str, torch.Tensor]] = {}
        for g in optimizer.param_groups:
            for p in g["params"]:
                key, pname = names[p]
                values.setdefault(key, {})[pname] = optimizer.state[p][tkey]
        if isinstance(model, nn.Module):
            first[okey] = params_to_flax(model, values[None])
        else:
            first[okey] = {k: params_to_flax(m, values[k])
                           for k, m in model.items()}
    out: dict[str, Any] = {str(i): {} for i in range(n_sub)}
    out["0"] = first
    if getattr(optimizer, "schedule", None) is not None:
        out["1"] = {"count": count}
    return out


def opt_state_from_optax(state: Mapping[str, Any],
                         model: nn.Module | Mapping[str, nn.Module],
                         optimizer: torch.optim.Optimizer,
                         count: int | None = None) -> torch.optim.Optimizer:
    """Load an optax state (the layout of :func:`opt_state_to_optax`) into
    ``optimizer``, whose parameters are ``model``'s (one module, or a
    mapping of modules whose keys the state's moment trees must match
    exactly).  The update count comes from the state; SGD and RMSprop keep
    none without a schedule, and then ``count`` (default 0) is used."""
    name, moments, _ = _opt_layout(optimizer)
    first = state["0"]
    counts = [int(np.asarray(s["count"])) for s in state.values()
              if isinstance(s, Mapping) and "count" in s]
    n = counts[0] if counts else int(count or 0)
    models = {None: model} if isinstance(model, nn.Module) else dict(model)
    trees: dict[str, dict[tuple[str | None, str], np.ndarray]] = {}
    for okey, tkey in moments:
        if okey not in first:
            raise ValueError(f"optax state has no {okey!r}: not a {name} "
                             f"state")
        per_model = {None: first[okey]} if None in models else first[okey]
        if set(per_model) != set(models):
            raise ValueError(f"optax {okey} tree holds {sorted(per_model)}, "
                             f"the optimizer's models are {sorted(models)}")
        trees[tkey] = {(k, pname): arr for k, m in models.items()
                       for pname, arr in params_from_flax(
                           per_model[k], getattr(m, "flax_root", "Net")
                       ).items()}
    names = _named(model)
    for tkey, tree in trees.items():
        if set(tree) != set(names.values()):
            raise ValueError(f"optax {tkey} tree does not cover the model's "
                             f"parameters")
    dims = {k: shard_dims(m) for k, m in models.items()}
    for group in optimizer.param_groups:
        group["count"] = n
    for p, key in names.items():
        dim = dims[key[0]].get(key[1])
        st = {tkey: torch.empty_like(p).copy_(
                  tree[key] if dim is None else slice_dim(tree[key], *dim))
              for tkey, tree in trees.items()}
        if name == "Adam":
            st["step"] = torch.tensor(float(n))
        optimizer.state[p] = st
    return optimizer
