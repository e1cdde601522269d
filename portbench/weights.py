"""Seeded weights, made on the run's device in one draw.

The recipe: one ``torch.randn`` of every parameter's elements at once
from a generator on the device, cut in the order of the reference's
``param_spec``, then scaled by kind:

* ``kernel`` (out, in, ...): ``N(0, 1) / sqrt(in * kh * kw)`` (LeCun);
* ``kernel_in_out`` (in, out): ``N(0, 1) / sqrt(in)``;
* ``scale`` (norm scales, WSConv gains): ``1 + 0.1 N(0, 1)``;
* ``bias``: ``0.1 N(0, 1)``;
* ``alpha`` (a residual branch's scalar): ``0.2 (1 + 0.1 N(0, 1))``.

Biases and scales are drawn, not zero and one as a fresh model has them,
so that every parameter takes part in the sums the check compares.

Then :func:`centre` shifts the classifier's output bias so that every
class's mean logit over a seeded sample of the scene's anchors is zero.
A classifier with random weights gives nearly the same features to every
anchor, so without it one class wins everywhere by a wide margin and no
rounding could change a served label; centred, the label follows the
input, as a trained classifier's does, and near ties occur as in real
maps.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import strict_float32
from portbench.seeds import derive

#: Anchors of the sample :func:`centre` averages the logits over.
CENTRE_ANCHORS = 2048


def make(spec: list, seed: int, device: torch.device) -> dict:
    """``{name: float32 tensor}`` for ``spec``'s ``(name, shape, kind)``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        z = flat[at:at + n].reshape(shape)
        at += n
        if kind == "kernel":
            v = z / math.sqrt(math.prod(shape[1:]))
        elif kind == "kernel_in_out":
            v = z / math.sqrt(shape[0])
        elif kind == "scale":
            v = 1.0 + 0.1 * z
        elif kind == "bias":
            v = 0.1 * z
        elif kind == "alpha":
            v = 0.2 * (1.0 + 0.1 * z)
        else:
            raise ValueError(f"{name}: unknown parameter kind {kind!r}")
        out[name] = v.contiguous()
    return out


def centre(params: dict, ref, scene, seed: int) -> None:
    """Shift ``params[ref.OUT_BIAS]`` by minus the mean reference logits of
    a seeded sample of ``scene``'s anchors (in place)."""
    dev = scene.ms.device
    gen = torch.Generator(device=dev).manual_seed(derive(seed, "centre"))
    ids = torch.randint(0, scene.height * scene.width, (CENTRE_ANCHORS,),
                        generator=gen, device=dev)
    with torch.no_grad(), strict_float32():
        mean = ref.anchor_logits(params, scene.ms.float(), scene.pan.float(),
                                 ids, scene.width, scene.patch).mean(0)
    params[ref.OUT_BIAS] = params[ref.OUT_BIAS] - mean
