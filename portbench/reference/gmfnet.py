"""Plain reference of gmfnet, the gated multimodal fusion classifier.

Frozen copy of the mathematics of ``dmfusion/models/gmfnet.py`` as the
port runs it, in float32 with no kernels: an MS window (B, ps, ps, C) and
its PAN window (B, 4ps, 4ps, 1) give (B, classes) logits.

* MS branch: ConvBlock(C -> w/2), ResBlock(w/2 -> w).
* PAN branch (``gmfnet_pan: s2d``): 4x space-to-depth to (B, 16, ps, ps),
  ConvBlock(16 -> w/2), ConvBlock(w/2 -> w), ResBlock(w -> w).
* Gate: ``z = sigmoid(conv1x1([h_ms, h_pan]))``, ``z h_ms + (1 - z) h_pan``.
* Trunk: ResBlock(w -> 2w, stride 2), ResBlock(2w -> 2w),
  ResBlock(2w -> 4w, stride 2); head: global mean, dense 4w -> 2w, act,
  dense 2w -> classes.
* ConvBlock is conv, GroupNorm, act; ResBlock is ``act(GN(conv(ConvBlock(x)))
  + shortcut(x))`` with a 1x1 conv shortcut where the width or the stride
  changes.  Convolutions pad as XLA's ``SAME``; GroupNorm takes 8 groups
  (every width here is a multiple of 8) and eps 1e-6; the activation is
  ReLU.

Parameters are a dict of tensors under the port's parameter names;
:func:`param_spec` lists them with their shapes and kinds, which is what
the harness draws seeded weights from.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from portbench.reference.common import (Round, conv_same, exact, group_norm,
                                        linear, masked_cross_entropy)

GROUPS = 8
#: The classifier's output bias (see ``portbench/weights.py::centre``).
OUT_BIAS = "head.out.bias"


def _conv_spec(name: str, cin: int, cout: int, k: int) -> list:
    return [(f"{name}.weight", (cout, cin, k, k), "kernel"),
            (f"{name}.bias", (cout,), "bias")]


def _norm_spec(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "scale"), (f"{name}.bias", (c,), "bias")]


def _block_spec(name: str, cin: int, cout: int) -> list:
    return _conv_spec(f"{name}.conv", cin, cout, 3) + _norm_spec(
        f"{name}.norm", cout)


def _res_spec(name: str, cin: int, cout: int, stride: int) -> list:
    spec = (_block_spec(f"{name}.block", cin, cout)
            + _conv_spec(f"{name}.conv", cout, cout, 3)
            + _norm_spec(f"{name}.norm", cout))
    if cin != cout or stride != 1:
        spec += _conv_spec(f"{name}.shortcut", cin, cout, 1)
    return spec


def param_spec(config: Mapping[str, Any]) -> list:
    """``[(name, shape, kind)]`` of every parameter of the configuration
    (its ``model_width``, ``scene_size``'s channels, ``classes``),
    ``kind`` one of kernel, bias, scale."""
    w = int(config["model_width"])
    ms_channels = int(config["scene_size"][2])
    classes = int(config["classes"])
    return (_block_spec("ms_stem", ms_channels, w // 2)
            + _res_spec("ms_res", w // 2, w, 1)
            + _block_spec("pan.blocks.0", 16, w // 2)
            + _block_spec("pan.blocks.1", w // 2, w)
            + _res_spec("pan_res", w, w, 1)
            + _conv_spec("fusion_gate", 2 * w, w, 1)
            + _res_spec("trunk.0", w, 2 * w, 2)
            + _res_spec("trunk.1", 2 * w, 2 * w, 1)
            + _res_spec("trunk.2", 2 * w, 4 * w, 2)
            + [("head.hidden.weight", (2 * w, 4 * w), "kernel"),
               ("head.hidden.bias", (2 * w,), "bias"),
               ("head.out.weight", (classes, 2 * w), "kernel"),
               ("head.out.bias", (classes,), "bias")])


def _block(p, name, x, stride, q):
    y = conv_same(x, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"],
                  stride, q)
    return F.relu(group_norm(y, GROUPS, p[f"{name}.norm.weight"],
                             p[f"{name}.norm.bias"]))


def _res(p, name, x, stride, q):
    y = _block(p, f"{name}.block", x, stride, q)
    y = conv_same(y, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], 1, q)
    y = group_norm(y, GROUPS, p[f"{name}.norm.weight"], p[f"{name}.norm.bias"])
    if f"{name}.shortcut.weight" in p:
        x = conv_same(x, p[f"{name}.shortcut.weight"],
                      p[f"{name}.shortcut.bias"], stride, q)
    return F.relu(y + x)


def logits(p: Mapping[str, torch.Tensor], ms: torch.Tensor,
           pan: torch.Tensor, q: Round = exact) -> torch.Tensor:
    """(B, ps, ps, C) MS and (B, 4ps, 4ps, 1) PAN windows -> (B, classes)
    float32 logits."""
    b = ms.shape[0]
    x_ms = ms.float().permute(0, 3, 1, 2)
    pan = pan.float().reshape(b, pan.shape[1], pan.shape[2], 1)
    x_pan = _s2d4_batch(pan).permute(0, 3, 1, 2)
    h_ms = _res(p, "ms_res", _block(p, "ms_stem", x_ms, 1, q), 1, q)
    h_pan = _block(p, "pan.blocks.1", _block(p, "pan.blocks.0", x_pan, 1, q),
                   1, q)
    h_pan = _res(p, "pan_res", h_pan, 1, q)
    z = torch.sigmoid(conv_same(torch.cat([h_ms, h_pan], 1),
                                p["fusion_gate.weight"], p["fusion_gate.bias"],
                                1, q))
    t = z * h_ms + (1.0 - z) * h_pan
    t = _res(p, "trunk.0", t, 2, q)
    t = _res(p, "trunk.1", t, 1, q)
    t = _res(p, "trunk.2", t, 2, q)
    h = F.relu(linear(t.mean(dim=(2, 3)), p["head.hidden.weight"],
                      p["head.hidden.bias"], q))
    return linear(h, p["head.out.weight"], p["head.out.bias"], q)


def _s2d4_batch(pan: torch.Tensor) -> torch.Tensor:
    """(B, 4h, 4w, 1) -> (B, h, w, 16), channels ``[row-phase,
    col-phase]``."""
    b, h4, w4, c = pan.shape
    x = pan.reshape(b, h4 // 4, 4, w4 // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h4 // 4, w4 // 4, 16 * c)


def windows(ms_scene: torch.Tensor, pan_scene: torch.Tensor,
            ids: torch.Tensor, width: int, patch: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain gather of the windows at flat anchor ids (``x = id //
    width``, ``y = id % width``): the MS window at (x, y), the PAN window
    at (4x, 4y), both from the padded scenes, by advanced indexing."""
    ids = ids.long()
    x, y = ids // width, ids % width
    r = torch.arange(patch, device=ids.device)
    ms = ms_scene[(x[:, None] + r)[:, :, None], (y[:, None] + r)[:, None, :]]
    r4 = torch.arange(4 * patch, device=ids.device)
    pan = pan_scene[(4 * x[:, None] + r4)[:, :, None],
                    (4 * y[:, None] + r4)[:, None, :]]
    return ms, pan[..., None]


def anchor_logits(p: Mapping[str, torch.Tensor], ms_scene: torch.Tensor,
                  pan_scene: torch.Tensor, ids: torch.Tensor, width: int,
                  patch: int, q: Round = exact) -> torch.Tensor:
    """(n, classes) logits of the anchors ``ids`` of a padded scene."""
    return logits(p, *windows(ms_scene, pan_scene, ids, width, patch), q)


def train_loss(p: Mapping[str, torch.Tensor], ms_scene: torch.Tensor,
               pan_scene: torch.Tensor, patch: int, ids: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor,
               q: Round = exact) -> torch.Tensor:
    """The masked mean cross-entropy of one batch of anchors of a padded
    scene: the plain gather's windows, their logits, the mean over the
    rows whose mask is 1."""
    width = ms_scene.shape[1] - patch + 1
    return masked_cross_entropy(
        anchor_logits(p, ms_scene, pan_scene, ids, width, patch, q), labels,
        mask)
