"""Plain reference of dense_fusion, the whole-scene dense classifier.

Frozen copy of the mathematics of ``dmfusion/models/dense_fusion.py`` as
the port runs it, in float32 with no kernels, no summed-area tables and
no phase packing of the pooled map:

* The padded MS scene (Hm, Wm, C) is zero-padded to even size and packed
  2x2 space-to-depth (channels ``[row-phase, col-phase, C]``); the PAN
  scene is cropped to (4Hm, 4Wm), zero-padded to the 8x grid and packed
  8x8: both land on the (Hm/2, Wm/2) trunk grid.
* WSConv: the kernel standardized per output channel, ``(k - mean) /
  sqrt(var * fan_in + 1e-8) * gain * act_gain`` (population variance),
  a ``SAME`` convolution at stride 1, plus the bias.  LocalConvBlock is
  ``relu(WSConv(x))`` with act_gain sqrt 2; LocalResBlock is ``relu(sc +
  alpha * WSConv(LocalConvBlock(x)))`` with a 1x1 WSConv shortcut where
  the width changes.
* Branches: MS stem w, block 2w; PAN stem w, block 2w; the gate ``z =
  sigmoid(conv1x1([h_ms, h_pan]) + b)`` fuses them as ``z h_ms + (1 - z)
  h_pan``; trunk blocks 4w, 4w, then a LocalConvBlock 4w; unpacked 2x2
  to the (Hm, Wm, w) full-resolution features.
* Pooling: the mean of the features over the ``ps x ps`` window of each
  anchor (x, y), summed directly (``avg_pool2d`` for the whole map, a
  window gather for a batch of anchors).
* Head, per anchor: ``relu(f K1 + b1) K2 + b2``.

Parameters are a dict of tensors under the port's parameter names
(:func:`param_spec`); the head's kernels are (in, out).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from portbench.reference.common import (Round, depth_to_space, exact,
                                        masked_cross_entropy, space_to_depth)

ACT_GAIN = math.sqrt(2.0)
#: The classifier's output bias (see ``portbench/weights.py::centre``).
OUT_BIAS = "head2_bias"


def _ws_spec(name: str, cin: int, cout: int, k: int) -> list:
    return [(f"{name}.weight", (cout, cin, k, k), "kernel"),
            (f"{name}.gain", (cout,), "scale"),
            (f"{name}.bias", (cout,), "bias")]


def _res_spec(name: str, cin: int, cout: int) -> list:
    spec = ([(f"{name}.alpha", (), "alpha")]
            + _ws_spec(f"{name}.block.conv", cin, cout, 3)
            + _ws_spec(f"{name}.conv", cout, cout, 3))
    if cin != cout:
        spec += _ws_spec(f"{name}.shortcut", cin, cout, 1)
    return spec


def param_spec(config: Mapping[str, Any]) -> list:
    """``[(name, shape, kind)]`` of every parameter of the configuration
    (its ``model_width``, ``scene_size``'s channels, ``classes``),
    ``kind`` one of kernel, kernel_in_out, bias, scale, alpha."""
    w = int(config["model_width"])
    ms_channels = int(config["scene_size"][2])
    classes = int(config["classes"])
    return ([("head1_kernel", (w, w), "kernel_in_out"),
             ("head1_bias", (w,), "bias"),
             ("head2_kernel", (w, classes), "kernel_in_out"),
             ("head2_bias", (classes,), "bias")]
            + _ws_spec("ms_stem.conv", 4 * ms_channels, w, 3)
            + _res_spec("ms_block", w, 2 * w)
            + _ws_spec("pan_stem.conv", 64, w, 3)
            + _res_spec("pan_block", w, 2 * w)
            + [("fusion_gate.weight", (2 * w, 4 * w, 1, 1), "kernel"),
               ("fusion_gate.bias", (2 * w,), "bias")]
            + _res_spec("trunk1", 2 * w, 4 * w)
            + _res_spec("trunk2", 4 * w, 4 * w)
            + _ws_spec("refine.conv", 4 * w, 4 * w, 3))


def _ws(p, name, x, act_gain, q):
    k = p[f"{name}.weight"]
    mean = k.mean(dim=(1, 2, 3), keepdim=True)
    var = ((k - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    fan_in = k[0].numel()
    kn = (k - mean) / torch.sqrt(var * fan_in + 1e-8)
    kn = kn * (p[f"{name}.gain"] * act_gain)[:, None, None, None]
    y = F.conv2d(q(x), q(kn), padding=k.shape[-1] // 2)
    return y + p[f"{name}.bias"][None, :, None, None]


def _lcb(p, name, x, q):
    return F.relu(_ws(p, f"{name}.conv", x, ACT_GAIN, q))


def _lres(p, name, x, q):
    y = _ws(p, f"{name}.conv", _lcb(p, f"{name}.block", x, q), 1.0, q)
    if f"{name}.shortcut.weight" in p:
        x = _ws(p, f"{name}.shortcut", x, 1.0, q)
    return F.relu(x + p[f"{name}.alpha"] * y)


def features(p: Mapping[str, torch.Tensor], ms: torch.Tensor,
             pan: torch.Tensor, q: Round = exact) -> torch.Tensor:
    """Padded scene MS (Hm, Wm, C) and PAN (>= 4Hm, >= 4Wm) -> the (Hm,
    Wm, w) float32 full-resolution features."""
    hm, wm = ms.shape[0], ms.shape[1]
    hm2, wm2 = -(-hm // 2), -(-wm // 2)
    ms = F.pad(ms.float(), (0, 0, 0, 2 * wm2 - wm, 0, 2 * hm2 - hm))
    pan = pan.float().reshape(pan.shape[0], pan.shape[1])[:4 * hm, :4 * wm]
    pan = F.pad(pan, (0, 8 * wm2 - pan.shape[1], 0, 8 * hm2 - pan.shape[0]))
    x_ms = space_to_depth(ms, 2).permute(2, 0, 1)[None]
    x_pan = space_to_depth(pan[..., None], 8).permute(2, 0, 1)[None]
    h_ms = _lres(p, "ms_block", _lcb(p, "ms_stem", x_ms, q), q)
    h_pan = _lres(p, "pan_block", _lcb(p, "pan_stem", x_pan, q), q)
    g = F.conv2d(q(torch.cat([h_ms, h_pan], 1)), q(p["fusion_gate.weight"]))
    z = torch.sigmoid(g + p["fusion_gate.bias"][None, :, None, None])
    t = z * h_ms + (1.0 - z) * h_pan
    t = _lcb(p, "refine", _lres(p, "trunk2", _lres(p, "trunk1", t, q), q), q)
    return depth_to_space(t[0].permute(1, 2, 0), 2)[:hm, :wm]


def head(p: Mapping[str, torch.Tensor], pooled: torch.Tensor,
         q: Round = exact) -> torch.Tensor:
    """(..., w) pooled features -> (..., classes) logits."""
    h = F.relu(q(pooled) @ q(p["head1_kernel"]) + p["head1_bias"])
    return q(h) @ q(p["head2_kernel"]) + p["head2_bias"]


def logits_map(p: Mapping[str, torch.Tensor], ms: torch.Tensor,
               pan: torch.Tensor, patch: int, q: Round = exact
               ) -> torch.Tensor:
    """(H, W, classes) logits of every anchor of the scene (H = Hm - ps +
    1, W = Wm - ps + 1)."""
    f = features(p, ms, pan, q).permute(2, 0, 1)[None]
    pooled = F.avg_pool2d(f, patch, stride=1)[0].permute(1, 2, 0)
    del f
    return head(p, pooled, q)


def anchor_pooled(feats: torch.Tensor, ids: torch.Tensor, width: int,
                  patch: int) -> torch.Tensor:
    """(B, w) window means of the full-resolution features at flat anchor
    ids (``x = id // width``, ``y = id % width``)."""
    ids = ids.long()
    x, y = ids // width, ids % width
    r = torch.arange(patch, device=ids.device)
    win = feats[(x[:, None] + r)[:, :, None], (y[:, None] + r)[:, None, :]]
    return win.sum(dim=(1, 2)) / float(patch * patch)


def train_loss(p: Mapping[str, torch.Tensor], ms: torch.Tensor,
               pan: torch.Tensor, patch: int, ids: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor,
               q: Round = exact) -> torch.Tensor:
    """The masked mean cross-entropy of one batch of anchors."""
    width = ms.shape[1] - patch + 1
    pooled = anchor_pooled(features(p, ms, pan, q), ids, width, patch)
    return masked_cross_entropy(head(p, pooled, q), labels, mask)


def anchor_logits(p: Mapping[str, torch.Tensor], ms: torch.Tensor,
                  pan: torch.Tensor, ids: torch.Tensor, width: int,
                  patch: int, q: Round = exact) -> torch.Tensor:
    """(n, classes) logits of the anchors ``ids`` of a padded scene."""
    return head(p, anchor_pooled(features(p, ms, pan, q), ids, width, patch),
                q)
