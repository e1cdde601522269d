"""gmfnet_conv — the shift-and-stitch-servable variant of gmfnet.

Port of ``dmfusion/models/gmfnet_conv.py``.  gmfnet's topology (dual
branch, sigmoid-gated fusion, two stride-2 trunk resblocks, pooled MLP
head) with the two semantics that make a window forward shift-variant
replaced: every conv is VALID over a window gathered with its own margin
(``patch_size`` 47 = a core of 16 + 31 margin rows), and normalization is
scaled weight standardization (:class:`WSConv`), never activation
statistics.  Window features are then literal crops of scene features.

Two routes, one set of weights:
  * the window route, ``model(ms, pan)`` on NHWC windows ((B, ps, ps, C)
    and (B, 4ps, 4ps, 1), as the port's gmfnet takes them), returns
    (B, classes) f32 logits; training and per-anchor eval run it;
  * the scene route, :meth:`Net.logits_map` and :meth:`Net.class_map` on
    the padded scene, runs every stride-2 conv at stride 1 and splits its
    output into a batch of phase maps (2 stages x 2 dims: 16 maps), pools
    each with a g x g box sum in the window route's summation order,
    applies the head per position and interleaves the 16 maps back.  Its
    entry for anchor (x, y) is that anchor's window-route logits.

On the mesh's model axis the WSConvs and the gate gather their sharded
weights on use, and the heads are column-parallel (``models/common.py``'s
``Linear``).  Convolutions run NCHW on channels-last memory.  Numerics
follow flax: the compute dtype is set by explicit casts, not autocast
(``head2`` computes in f32 under bf16 compute); the pooled sums are f32,
rows (dim 2) then columns (dim 3), each from low to high with the first
term cast to f32.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dmfusion_torch.models.common import (Linear, activation_fn, dtypes,
                                          tree_shape)
from dmfusion_torch.models.dense_fusion import (_SQRT2, GateConv, WSConv,
                                                space_to_depth)
from dmfusion_torch.models.registry import register
from dmfusion_torch.parallel.tensor import sharded_product

ARITY = "dual"
#: train/steps.py renders this model's maps with ConvMapPrograms.
MAP_PROGRAMS = "convmap"

#: Extra zero rows and columns the scene route appends at the scene's
#: bottom and right so every phase map can be sliced to one extent; the
#: entries computed from them lie beyond every anchor's reads.
EDGE_SLACK = 8


def pool_grid(patch: int) -> int:
    """The pooled grid g of a ``patch``-row window: the VALID chain
    patch -> -8 (branches) -> /2-2 (trunk1) -> -4 (trunk2) -> /2-2
    (trunk3) must land on an integer >= 1."""
    if patch % 4 != 3 or patch < 35:
        raise ValueError(
            f"gmfnet_conv needs patch_size ≡ 3 (mod 4) and >= 35 so its "
            f"VALID conv chain lands on an integer pooled grid "
            f"(core-16 default: 47); got {patch}")
    return (patch - 31) // 4


def _s2d4_batched(pan: torch.Tensor) -> torch.Tensor:
    """(B, 4S, 4S, C) -> (B, S, S, 16C), NHWC, phase-major channels
    (row-phase, col-phase, C): the order of :func:`space_to_depth`, so both
    routes feed ``pan_stem1`` the same layout."""
    b, h4, w4, c = pan.shape
    x = pan.reshape(b, h4 // 4, 4, w4 // 4, 4, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h4 // 4, w4 // 4, 16 * c)


def _split2(x: torch.Tensor, n_r: int, n_c: int) -> torch.Tensor:
    """Phase-split an NCHW map into its four stride-2 grids:
    (B, C, H, W) -> (4B, C, n_r, n_c) with
    out[4b + 2r + c, :, u, v] = x[b, :, r + 2u, c + 2v]; one copy, in
    channels-last memory."""
    b, ch, h, w = x.shape
    if h < 2 * n_r or w < 2 * n_c:
        raise ValueError(f"phase split needs ({2 * n_r}, {2 * n_c}) "
                         f"rows/cols, have ({h}, {w})")
    x = x.permute(0, 2, 3, 1)[:, :2 * n_r, :2 * n_c]
    x = x.reshape(b, n_r, 2, n_c, 2, ch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(4 * b, n_r, n_c, ch).permute(0, 3, 1, 2)


def _box_sum(x: torch.Tensor, g: int, dim: int) -> torch.Tensor:
    """Sum of ``g`` consecutive entries along ``dim`` in f32, from low to
    high: the one association both routes share."""
    n = x.shape[dim] - g + 1
    acc = x.narrow(dim, 0, n).float()
    for i in range(1, g):
        acc = acc + x.narrow(dim, i, n)
    return acc


class _HeadLinear(Linear):
    """``Linear`` in the compute dtype ``dtype``: the product rounded to
    it, then the bias added in it (flax's ``Dense`` under ``dtype``)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__(in_features, features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype

        def op(x, w, b):
            y = F.linear(x, w.to(dt))
            return y if b is None else y + b.to(dt)
        return sharded_product(self, x.to(dt), op, -1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (1, C, H, W), channels-last memory."""
    return x.permute(2, 0, 1)[None]


@register("gmfnet_conv")
class Net(nn.Module):
    """``model(ms, pan)``: window logits; ``logits_map`` and ``class_map``:
    the scene route over a padded scene (MS (H+ps-1, W+ps-1, C), PAN 2-D or
    (.., .., 1) at 4x)."""

    flax_root = "ConvNet"

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The width, from the flax tree's first MS conv."""
        return {"model_width": tree_shape(tree, "ms_c1", "kernel")[-1]}

    def __init__(self, cfg: Mapping[str, Any], width: int = 64):
        super().__init__()
        self.act = activation_fn(cfg)
        dt, _ = dtypes(cfg)
        self.compute_dtype = dt
        w = int(cfg.get("model_width", width))
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        ncls = int(cfg["Categories_Number"])

        def ws(cin, cout, k, gain):
            return WSConv(cin, cout, k, gain, dt, padding="VALID")

        # MS branch: conv + resblock (3 convs, -6 extent).
        self.ms_stem = ws(ms_channels, w // 2, 3, _SQRT2)
        self.ms_c1 = ws(w // 2, w, 3, _SQRT2)
        self.ms_c2 = ws(w, w, 3, 1.0)
        self.ms_sc = ws(w // 2, w, 1, 1.0)
        # PAN branch: s2d(4) + 2 convs + resblock (4 convs, -8 extent).
        self.pan_stem1 = ws(16, w // 2, 3, _SQRT2)
        self.pan_stem2 = ws(w // 2, w, 3, _SQRT2)
        self.pan_c1 = ws(w, w, 3, _SQRT2)
        self.pan_c2 = ws(w, w, 3, 1.0)
        self.fusion_gate = GateConv(2 * w, w, dt)
        # Trunk: stride-2 resblock -> resblock -> stride-2 resblock.
        self.t1_c1 = ws(w, 2 * w, 3, _SQRT2)
        self.t1_c2 = ws(2 * w, 2 * w, 3, 1.0)
        self.t1_sc = ws(w, 2 * w, 1, 1.0)
        self.t2_c1 = ws(2 * w, 2 * w, 3, _SQRT2)
        self.t2_c2 = ws(2 * w, 2 * w, 3, 1.0)
        self.t3_c1 = ws(2 * w, 4 * w, 3, _SQRT2)
        self.t3_c2 = ws(4 * w, 4 * w, 3, 1.0)
        self.t3_sc = ws(2 * w, 4 * w, 1, 1.0)
        for name in ("alpha_ms", "alpha_pan", "alpha1", "alpha2", "alpha3"):
            setattr(self, name, nn.Parameter(torch.tensor(0.2)))
        self.head1 = _HeadLinear(4 * w, 2 * w, dt)
        self.head2 = Linear(2 * w, ncls)

    def flax_init(self, generator: torch.Generator) -> None:
        """The residual scales start at 0.2 (the convs and heads initialize
        themselves)."""
        for name in ("alpha_ms", "alpha_pan", "alpha1", "alpha2", "alpha3"):
            getattr(self, name).fill_(0.2)

    # -- shared stride-1 pieces (identical in both routes) -----------------
    def _resblock(self, c1, c2, sc_conv, alpha, x):
        y = c2(self.act(c1(x)))
        sc = x[:, :, 2:-2, 2:-2]
        if sc_conv is not None:
            sc = sc_conv(sc)
        return self.act(sc + alpha.to(y.dtype) * y)

    def _fuse(self, ms: torch.Tensor, pan16: torch.Tensor) -> torch.Tensor:
        """(B, C, S, S) + (B, 16, S, S) -> (B, w, S-8, S-8)."""
        act = self.act
        h_ms = self._resblock(self.ms_c1, self.ms_c2, self.ms_sc,
                              self.alpha_ms, act(self.ms_stem(ms)))
        h_ms = h_ms[:, :, 1:-1, 1:-1]
        h_pan = act(self.pan_stem2(act(self.pan_stem1(pan16))))
        h_pan = self._resblock(self.pan_c1, self.pan_c2, None,
                               self.alpha_pan, h_pan)
        z = torch.sigmoid(self.fusion_gate(torch.cat([h_ms, h_pan], dim=1)))
        return z * h_ms + (1.0 - z) * h_pan

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 4w) -> (..., ncls) f32: head1 in the compute dtype (the
        bias added after the matmul's rounding), head2 in f32."""
        return self.head2(self.act(self.head1(x)).float())

    @staticmethod
    def _pool(t: torch.Tensor, g: int) -> torch.Tensor:
        """g x g box sums of an NCHW map, rows first, over g², in f32."""
        return _box_sum(_box_sum(t, g, 2), g, 3) / float(g * g)

    # -- window route (training / per-anchor eval) -------------------------
    def _resblock_s2(self, c1, c2, sc_conv, alpha, x):
        """VALID stride-2 resblock: main = s2 conv + s1 conv; the shortcut
        samples the main path's input positions (in[3 + 2k])."""
        y = c2(self.act(c1(x, stride=2)))
        sc = x[:, :, 3::2, 3::2][:, :, :y.shape[2], :y.shape[3]]
        if sc_conv is not None:
            sc = sc_conv(sc)
        return self.act(sc + alpha.to(y.dtype) * y)

    def forward(self, ms: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
        """(B, S, S, C) MS + (B, 4S, 4S, 1) PAN windows, NHWC -> (B, ncls)
        f32 logits."""
        dt = self.compute_dtype
        g = pool_grid(ms.shape[1])
        pan16 = _s2d4_batched(pan.to(dt)).permute(0, 3, 1, 2)
        f = self._fuse(ms.to(dt).permute(0, 3, 1, 2), pan16)
        t = self._resblock_s2(self.t1_c1, self.t1_c2, self.t1_sc,
                              self.alpha1, f)
        t = self._resblock(self.t2_c1, self.t2_c2, None, self.alpha2, t)
        t = self._resblock_s2(self.t3_c1, self.t3_c2, self.t3_sc,
                              self.alpha3, t)
        if t.shape[2:] != (g, g):
            raise ValueError(f"trunk output {tuple(t.shape[2:])}, expected "
                             f"({g}, {g})")
        pooled = self._pool(t, g).reshape(t.shape[0], -1).to(dt)
        return self._head(pooled)

    # -- scene route (shift-and-stitch full-scene maps) --------------------
    def _phase_logits(self, scene_ms: torch.Tensor, scene_pan: torch.Tensor,
                      patch: int):
        """The 16 per-phase quarter-resolution logit maps, (16, nq_r, nq_c,
        ncls) with phase (r, c, r2, c2) at batch 8r + 4c + 2r2 + c2, and
        the anchor-grid geometry.  Entry (u, v) of phase map (r, c, r2, c2)
        holds the window-route logits of anchor (4u + 2r2 + r,
        4v + 2c2 + c)."""
        dt = self.compute_dtype
        act = self.act
        g = pool_grid(patch)
        hm, wm = scene_ms.shape[0], scene_ms.shape[1]
        h, wcols = hm - patch + 1, wm - patch + 1
        ms = F.pad(scene_ms, (0, 0, 0, EDGE_SLACK, 0, EDGE_SLACK))
        pan2d = scene_pan if scene_pan.ndim == 2 else scene_pan[..., 0]
        pan2d = F.pad(pan2d[:4 * hm, :4 * wm],
                      (0, 4 * EDGE_SLACK, 0, 4 * EDGE_SLACK))
        # Space-to-depth before the cast to the compute dtype.
        pan16 = _nchw(space_to_depth(pan2d[..., None], 4).to(dt))
        f = self._fuse(_nchw(ms.to(dt)), pan16)

        # Per-phase extents, top-down from the anchor grid.
        nq_r, nq_c = (h - 1) // 4 + 1, (wcols - 1) // 4 + 1
        n1_r = 2 * (nq_r + g + 1) + 2 + 6
        n1_c = 2 * (nq_c + g + 1) + 2 + 6

        # trunk1 at stride 1, its output phase-split into a batch of 4.
        y = self.t1_c2(_split2(act(self.t1_c1(f)), n1_r, n1_c))
        sc = self.t1_sc(_split2(f[:, :, 3:, 3:], n1_r - 2, n1_c - 2))
        t1 = act(sc + self.alpha1.to(y.dtype) * y)
        t2 = self._resblock(self.t2_c1, self.t2_c2, None, self.alpha2, t1)
        del f, y, sc, t1

        # trunk3 at stride 1, each phase map split again: a batch of 16.
        y3 = self.t3_c2(_split2(act(self.t3_c1(t2)), nq_r + g + 1,
                                nq_c + g + 1))
        sc3 = self.t3_sc(_split2(t2[:, :, 3:, 3:], nq_r + g - 1,
                                 nq_c + g - 1))
        del t2
        t3 = act(sc3 + self.alpha3.to(y3.dtype) * y3)
        del y3, sc3

        pooled = self._pool(t3, g)[:, :, :nq_r, :nq_c]
        del t3
        maps = self._head(pooled.to(dt).permute(0, 2, 3, 1))
        return maps, (h, wcols, nq_r, nq_c)

    @staticmethod
    def _stitch(maps: torch.Tensor, geom) -> torch.Tensor:
        """(16, nq_r, nq_c, C) phase maps -> (h, w, C): anchor
        (4u + 2r2 + r, 4v + 2c2 + c) reads phase (r, c, r2, c2) at (u, v)."""
        h, wcols, nq_r, nq_c = geom
        c = maps.shape[-1]
        x = maps.reshape(2, 2, 2, 2, nq_r, nq_c, c)  # (r, c, r2, c2, u, v)
        x = x.permute(4, 2, 0, 5, 3, 1, 6)           # (u, r2, r, v, c2, c)
        return x.reshape(4 * nq_r, 4 * nq_c, c)[:h, :wcols]

    def logits_map(self, scene_ms: torch.Tensor, scene_pan: torch.Tensor,
                   patch: int) -> torch.Tensor:
        """(H, W, ncls) f32 logits of every anchor in one convolutional
        pass."""
        maps, geom = self._phase_logits(scene_ms, scene_pan, patch)
        return self._stitch(maps, geom)

    def class_map(self, scene_ms: torch.Tensor, scene_pan: torch.Tensor,
                  patch: int) -> torch.Tensor:
        """(H, W) int32 argmax map; the argmax runs on the quarter-res phase
        maps, so the full-res logits map is never built."""
        maps, geom = self._phase_logits(scene_ms, scene_pan, patch)
        am = maps.argmax(-1).to(torch.int32)[..., None]
        return self._stitch(am, geom)[..., 0]
