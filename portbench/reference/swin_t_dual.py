"""Plain reference of swin_t_dual: two Swin encoders, one on the MS window
and one on the conv-pooled PAN window, fused by a sigmoid gate.

The encoders are written from the Swin Transformer's equations (Liu et
al. 2021, arXiv:2103.14030, and its code's ``SwinTransformerBlock``,
``WindowAttention``, ``PatchMerging``), in float32 with no kernels: an MS
window (B, ps, ps, C) and its PAN window (B, 4ps, 4ps, 1) give (B,
classes) logits.

* PAN: two ``SAME`` 3x3 stride-2 convolutions (1 -> d/2 -> d, ``d`` the
  embed dim), each followed by GroupNorm (the largest divisor of the width
  that is at most 8 groups, eps 1e-6) and the activation: (B, ps, ps, d).
* Encoder, on a (B, ps, ps, Cin) grid: a dense embedding to ``d`` plus a
  learned position table; stages of blocks, then a 2x2 patch merge (LN,
  dense to twice the width) between stages; a last LayerNorm and the mean
  over the grid.  A block is ``x + W-MSA(LN(x))`` then ``x + MLP(LN(x))``
  with a 4x MLP.  W-MSA splits the grid into ``ws x ws`` windows (``ws =
  min(window, h, w)``), and in each window and head computes ``softmax(q
  k^T / sqrt(hd) + B [+ M]) v``: ``B`` the learned relative-position bias
  table ((2 ws - 1)^2, heads) read through the relative index, ``M`` the
  -100 mask between tokens of different regions of the cyclically
  shifted grid; every second block shifts by ``floor(window / 2)`` before
  the windows and back after.
* Fusion: ``g = sigmoid(dense([f_ms, f_pan]))``, ``g f_ms + (1 - g)
  f_pan``; head: dense to ``d``, the activation, dense to the classes.
* The activation is GELU, Swin's own (a configuration of this reference
  states ``activate: Gelu``).

Departures from Liu et al., each as dmfusion (and so the port) computes:

* the shift is ``floor(window / 2) mod ws``: on a grid no larger than the
  window (Swin-T's last stage, 7 x 7 at window 7) a block still shifts,
  by 3, under the mask, where Swin-T takes the shift to 0;
* a learned absolute position table is added after the embedding (Swin-T
  has ``ape`` False) and no LayerNorm follows the embedding;
* LayerNorm eps is 1e-6 (Swin's 1e-5); GELU is its tanh form;
* the patch merge orders its channels by the offsets (0,0), (0,1), (1,0),
  (1,1) (row offset major) and its reduction has a bias;
* the patch embedding is a dense layer over each pixel of the window (the
  window is the token grid), and the two-encoder gated fusion with its
  head is dmfusion's own.

Parameters are a dict of tensors under the port's parameter names
(:func:`param_spec`); ``q`` rounds both operands of every convolution and
matrix product, the attention's QK and PV products included.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

from portbench.reference.common import (Round, conv_same, exact, group_norm,
                                        linear)
from portbench.reference.gmfnet import windows

LN_EPS = 1e-6
MASK = -100.0
#: The classifier's output bias (see ``portbench/weights.py::centre``).
OUT_BIAS = "head.out.bias"
#: Anchors computed at once: the float32 activations of one chunk of
#: Swin-T at patch 56 take about 25 MB an anchor at their widest.
CHUNK = 256


def _widths(config: Mapping[str, Any]) -> dict:
    tr = config["trans"]
    return {"dim": int(tr["embed_dim"]), "window": int(tr["window_size"]),
            "depths": [int(d) for d in tr["depths"]],
            "heads": [int(h) for h in tr["num_heads"]],
            "grid": int(config["patch_size"]),
            "ms_channels": int(config["scene_size"][2]),
            "classes": int(config["classes"])}


def _stages(grid: int, dim: int, window: int, depths, heads) -> list:
    """Per stage: (grid, width, heads, window, [shift of each block]),
    and whether a merge follows it."""
    out, g = [], grid
    for s, (depth, nh) in enumerate(zip(depths, heads)):
        ws = min(window, g)
        shifts = [((i % 2) * (window // 2)) % ws for i in range(depth)]
        merge = s + 1 < len(depths) and g >= 2
        out.append((g, dim, nh, ws, shifts, merge))
        if merge:
            dim, g = 2 * dim, g // 2
    return out


def _dense(name: str, cin: int, cout: int) -> list:
    return [(f"{name}.weight", (cout, cin), "kernel"),
            (f"{name}.bias", (cout,), "bias")]


def _norm(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "scale"), (f"{name}.bias", (c,), "bias")]


def _encoder_spec(name: str, cin: int, w: dict) -> list:
    spec = _dense(f"{name}.embed", cin, w["dim"]) + [
        (f"{name}.pos", (1, w["grid"], w["grid"], w["dim"]), "bias")]
    stages = _stages(w["grid"], w["dim"], w["window"], w["depths"],
                     w["heads"])
    for s, (_, c, nh, ws, shifts, merge) in enumerate(stages):
        for i in range(len(shifts)):
            b = f"{name}.stages.{s}.{i}"
            spec += (_norm(f"{b}.norm1", c) + _dense(f"{b}.attn.qkv", c, 3 * c)
                     + _dense(f"{b}.attn.proj", c, c)
                     + [(f"{b}.attn.rel_bias", ((2 * ws - 1) ** 2, nh),
                         "bias")]
                     + _norm(f"{b}.norm2", c) + _dense(f"{b}.fc1", c, 4 * c)
                     + _dense(f"{b}.fc2", 4 * c, c))
        if merge:
            spec += (_norm(f"{name}.merges.{s}.norm", 4 * c)
                     + _dense(f"{name}.merges.{s}.reduce", 4 * c, 2 * c))
    return spec + _norm(f"{name}.norm", _out_dim(w))


def _out_dim(w: dict) -> int:
    return _stages(w["grid"], w["dim"], w["window"], w["depths"],
                   w["heads"])[-1][1]


def _groups(c: int) -> int:
    g = min(8, c)
    while c % g:
        g -= 1
    return g


def param_spec(config: Mapping[str, Any]) -> list:
    """``[(name, shape, kind)]`` of every parameter of the configuration
    (its ``trans`` widths, ``patch_size``, the scene's channels and
    ``classes``), ``kind`` one of kernel, bias, scale."""
    w = _widths(config)
    if w["window"] > w["grid"]:
        raise ValueError(f"window {w['window']} is wider than the "
                         f"{w['grid']}-token grid: the reference reads the "
                         f"window back from stage 0's bias table")
    d, out = w["dim"], _out_dim(w)
    spec = []
    for i, (cin, cout) in enumerate(((1, d // 2), (d // 2, d))):
        spec += [(f"pan.blocks.{i}.conv.weight", (cout, cin, 3, 3), "kernel"),
                 (f"pan.blocks.{i}.conv.bias", (cout,), "bias")]
        spec += _norm(f"pan.blocks.{i}.norm", cout)
    return (spec + _encoder_spec("ms_encoder", w["ms_channels"], w)
            + _encoder_spec("pan_encoder", d, w)
            + _dense("gate", 2 * out, out)
            + _dense("head.hidden", out, d) + _dense("head.out", d,
                                                     w["classes"]))


def attention_calls(config: Mapping[str, Any]) -> list:
    """The window-attention calls of one forward, in order: ``(windows,
    heads, tokens, head_dim, masked)`` for one anchor, ``windows`` the
    windows of its grid and ``masked`` whether the call adds a shift
    mask (of one (tokens, tokens) slab a window)."""
    w = _widths(config)
    calls = []
    for _ in ("ms_encoder", "pan_encoder"):
        for g, c, nh, ws, shifts, _ in _stages(
                w["grid"], w["dim"], w["window"], w["depths"], w["heads"]):
            calls += [((g // ws) ** 2, nh, ws * ws, c // nh, bool(s))
                      for s in shifts]
    return calls


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(x, p, name):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + LN_EPS) * p[f"{name}.weight"]
            + p[f"{name}.bias"])


def relative_index(ws: int, device) -> torch.Tensor:
    """(ws*ws, ws*ws) indices into the (2ws-1)^2 bias table."""
    r = torch.arange(ws, device=device)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)
    return rel[0] * (2 * ws - 1) + rel[1]


def shift_mask(g: int, ws: int, shift: int, device) -> torch.Tensor:
    """(nW, ws*ws, ws*ws): -100 between tokens of different regions of
    the shifted grid, 0 within one."""
    img = torch.zeros((g, g), device=device)
    region = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = region
            region += 1
    img = partition(img[None, :, :, None], ws)[..., 0]        # (nW, N)
    diff = img[:, :, None] != img[:, None, :]
    return torch.where(diff, MASK, 0.0)


def partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def unpartition(x: torch.Tensor, ws: int, b: int, h: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // ws, h // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, h, c)


def attention(p, name, x, heads, ws, shift, q):
    """Window attention of a (B, g, g, C) grid, shifted by ``shift``."""
    b, g, _, c = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    wins = partition(x, ws)                                  # (B nW, N, C)
    n, hd = ws * ws, c // heads
    qkv = linear(wins, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"], q)
    qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qk = q(qkv[0]) @ q(qkv[1]).transpose(-1, -2) / math.sqrt(hd)
    bias = p[f"{name}.rel_bias"][relative_index(ws, x.device)]
    a = qk + bias.permute(2, 0, 1)[None]                     # (B nW, h, N, N)
    if shift:
        mask = shift_mask(g, ws, shift, x.device)
        a = (a.reshape(b, -1, heads, n, n) + mask[None, :, None]
             ).reshape(-1, heads, n, n)
    out = q(torch.softmax(a, dim=-1)) @ q(qkv[2])
    out = linear(out.transpose(1, 2).reshape(-1, n, c),
                 p[f"{name}.proj.weight"], p[f"{name}.proj.bias"], q)
    out = unpartition(out, ws, b, g)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out


def merge(p, name, x, q):
    """2x2 neighbours to 4C channels, offsets (0,0), (0,1), (1,0), (1,1)."""
    b, g, _, c = x.shape
    x = x.reshape(b, g // 2, 2, g // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    x = layer_norm(x.reshape(b, g // 2, g // 2, 4 * c), p, f"{name}.norm")
    return linear(x, p[f"{name}.reduce.weight"], p[f"{name}.reduce.bias"], q)


def encoder(p, name, x, w, q):
    """(B, g, g, Cin) grid -> (B, out) pooled features."""
    x = linear(x, p[f"{name}.embed.weight"], p[f"{name}.embed.bias"], q)
    x = x + p[f"{name}.pos"]
    stages = _stages(w["grid"], w["dim"], w["window"], w["depths"],
                     w["heads"])
    for s, (_, _, nh, ws, shifts, do_merge) in enumerate(stages):
        for i, shift in enumerate(shifts):
            b = f"{name}.stages.{s}.{i}"
            x = x + attention(p, f"{b}.attn", layer_norm(x, p, f"{b}.norm1"),
                              nh, ws, shift, q)
            h = gelu(linear(layer_norm(x, p, f"{b}.norm2"),
                            p[f"{b}.fc1.weight"], p[f"{b}.fc1.bias"], q))
            x = x + linear(h, p[f"{b}.fc2.weight"], p[f"{b}.fc2.bias"], q)
        if do_merge:
            x = merge(p, f"{name}.merges.{s}", x, q)
    return layer_norm(x, p, f"{name}.norm").mean(dim=(1, 2))


def _widths_of(p: Mapping[str, torch.Tensor]) -> dict:
    """The widths, read back from the parameters' shapes."""
    depths, heads, s = [], [], 0
    while f"ms_encoder.stages.{s}.0.attn.rel_bias" in p:
        depths.append(sum(1 for k in p if k.startswith(
            f"ms_encoder.stages.{s}.") and k.endswith(".attn.rel_bias")))
        heads.append(int(p[f"ms_encoder.stages.{s}.0.attn.rel_bias"].shape[1]))
        s += 1
    pos = p["ms_encoder.pos"]
    rows = int(p["ms_encoder.stages.0.0.attn.rel_bias"].shape[0])
    # Stage 0's table is ((2 ws - 1)^2, heads): the window, which
    # param_spec holds to no more than the grid.
    return {"dim": int(pos.shape[3]), "depths": depths, "heads": heads,
            "grid": int(pos.shape[1]), "window": (math.isqrt(rows) + 1) // 2}


def logits(p: Mapping[str, torch.Tensor], ms: torch.Tensor,
           pan: torch.Tensor, q: Round = exact) -> torch.Tensor:
    """(B, ps, ps, C) MS and (B, 4ps, 4ps, 1) PAN windows -> (B, classes)
    float32 logits, computed :data:`CHUNK` anchors at a time."""
    return torch.cat([_logits(p, ms[lo:lo + CHUNK], pan[lo:lo + CHUNK], q)
                      for lo in range(0, ms.shape[0], CHUNK)])


def _logits(p, ms, pan, q):
    w = _widths_of(p)
    b = ms.shape[0]
    x = pan.float().reshape(b, pan.shape[1], pan.shape[2], 1)
    x = x.permute(0, 3, 1, 2)
    for i in range(2):
        blk = f"pan.blocks.{i}"
        x = conv_same(x, p[f"{blk}.conv.weight"], p[f"{blk}.conv.bias"], 2, q)
        x = gelu(group_norm(x, _groups(x.shape[1]), p[f"{blk}.norm.weight"],
                            p[f"{blk}.norm.bias"]))
    f_ms = encoder(p, "ms_encoder", ms.float(), w, q)
    f_pan = encoder(p, "pan_encoder", x.permute(0, 2, 3, 1), w, q)
    g = torch.sigmoid(linear(torch.cat([f_ms, f_pan], -1), p["gate.weight"],
                             p["gate.bias"], q))
    h = gelu(linear(g * f_ms + (1.0 - g) * f_pan, p["head.hidden.weight"],
                    p["head.hidden.bias"], q))
    return linear(h, p["head.out.weight"], p["head.out.bias"], q)


def anchor_logits(p: Mapping[str, torch.Tensor], ms_scene: torch.Tensor,
                  pan_scene: torch.Tensor, ids: torch.Tensor, width: int,
                  patch: int, q: Round = exact) -> torch.Tensor:
    """(n, classes) logits of the anchors ``ids`` of a padded scene."""
    return logits(p, *windows(ms_scene, pan_scene, ids, width, patch), q)
