"""dense_fusion — whole-scene dense per-pixel fusion classifier.

Port of ``dmfusion/models/dense_fusion.py``.  One dense feature map is
computed over the whole padded scene on a half-resolution, 4x-channel
trunk (both modalities space-to-depth packed onto the trunk grid), mean-
pooled over every ``ps x ps`` anchor window, and classified by a two-layer
head applied per phase block: every pixel's logits in one pass.

Public functions keep the JAX package's layouts: scenes and feature maps
are ``(H, W, C)``, the s2d-2 channel order is phase-major
``[row-phase, col-phase, C]``.  Inside, convolutions run NCHW on
channels-last memory.  Numerics follow flax:
  * :class:`WSConv` standardizes its kernel in f32 with the population
    variance, ``rsqrt(var * fan_in + 1e-8)``, scaled by ``gain * act_gain``
    (``act_gain`` is sqrt(2) only in :class:`LocalConvBlock`); the
    convolution's output is in the compute dtype and its bias is added in
    the compute dtype;
  * the first head matmul has compute-dtype operands and result, the
    second compute-dtype operands and an f32 result, with the f32 bias
    added after, so the logits are never rounded to bf16.

Pooling (even patches) goes through :func:`phase_pooled_s2d`: the CUDA
kernel for a CUDA tensor, its plain version on the CPU.  The JAX knob
``precision.pallas_pool`` chooses between two TPU lowerings and is not
read here.  Odd patches take the full-resolution summed-area table
(:func:`window_mean`) on both devices, as in JAX.

Training pools differently: it needs only the train anchors' rows and a
gradient, and the pool kernel has neither a backward nor a row gather.
Each step builds the f32 phase summed-area table (:func:`phase_sat`) of
the whole scene and gathers 16 of its rows per anchor
(:func:`phase_corner_sums`; odd patches: 4 rows of the full-resolution
table of :func:`sat_window_sums`).  ``train.dense_remat`` (anything but
'off') recomputes each conv block in the backward instead of storing its
activations (``torch.utils.checkpoint``), as flax's ``nn.remat`` does.

Under the mesh's ``model`` axis the placement (``parallel/partition.py``)
shards the kernels at rest, with their Adam moments, and the model
gathers every sharded leaf on use (``parallel/tensor.py::use``): dmfusion's
bands take the parameters replicated into ``shard_map``
(``dmfusion/train/steps.py:726-727``), so the model peers of a band
compute the same band.  The gathers sit inside each checkpointed block, so
the backward's recompute gathers again.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dmfusion_torch.models.common import activation_fn, dtypes, tree_shape
from dmfusion_torch.models.registry import register
from dmfusion_torch.ops.pool import phase_pool
from dmfusion_torch.parallel.tensor import use
from dmfusion_torch.utils.misc import parse_switch

ARITY = "dense"

_SQRT2 = 1.4142135623730951

# Receptive radius of features() in full-resolution rows (8 half-res cells
# of 3x3 convs, rounded up to even so band starts stay on the s2d-2 grid).
RECEPTIVE_RADIUS = 18


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(H, W, C) -> (H/f, W/f, f*f*C); channels ``[row-phase, col-phase,
    C]``.  H and W must be multiples of ``f``."""
    h, w, c = x.shape
    x = x.reshape(h // f, f, w // f, f * c).permute(0, 2, 1, 3)
    return x.reshape(h // f, w // f, f * f * c)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    h, w, c = x.shape
    c0 = c // (f * f)
    x = x.reshape(h, w, f, f * c0).permute(0, 2, 1, 3)
    return x.reshape(h * f, w * f, c0)


def window_mean(feats: torch.Tensor, patch: int) -> torch.Tensor:
    """(H', W', D) -> (H'-patch+1, W'-patch+1, D): the mean over every
    ``patch x patch`` window from an f32 summed-area table."""
    s = F.pad(feats.float(), (0, 0, 1, 0, 1, 0))
    s = s.cumsum(0).cumsum(1)
    p = patch
    win = s[p:, p:] - s[:-p, p:] - s[p:, :-p] + s[:-p, :-p]
    return (win / float(p * p)).to(feats.dtype)


def phase_sat(feats_s2d: torch.Tensor, extra: int = 0) -> torch.Tensor:
    """Zero-padded 2-D summed-area table of the s2d-2 features in f32:
    (H2+1+extra, W2+1+extra, 4C); ``extra`` zero rows and columns go
    after the last ones.

    Two ``torch.cumsum`` passes.  dmfusion's ``chunked_cumsum`` computes
    the same sums as triangular matmuls on the TPU's matrix unit, with
    another f32 association; the port keeps the plain cumsum unless a
    card measurement calls for a kernel."""
    s = F.pad(feats_s2d, (0, 0, 1, extra, 1, extra))
    return s.float().cumsum(0).cumsum(1)


def phase_corner_sums(flat_sat: torch.Tensor, w1: int, patch: int,
                      x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, C) f32 ``patch x patch`` full-resolution window sums at anchors
    (x, y), from a phase SAT flattened to (rows * w1, 4C).

    For input phase (c, d) the window [x, x+patch) x [y, y+patch) is a
    half-resolution rectangle of ``patch/2`` rows from ``x//2 + (x%2 &
    ~c)`` (columns likewise): 4 SAT corners per phase, 16 rows per
    anchor, each read at its phase block's C channels only (one gather,
    so the backward scatters into one SAT-sized gradient).  The
    arithmetic and its order are dmfusion's: ``A - B - C + D`` per phase,
    then the phases added in order (0, 0), (0, 1), (1, 0), (1, 1)."""
    ph = patch // 2
    c = flat_sat.shape[-1] // 4
    blocks = flat_sat.reshape(-1, c)          # row r, phase k -> 4 r + k
    x, y = x.long(), y.long()
    i, a = x // 2, x % 2
    j, b = y // 2, y % 2
    idx = []
    for cc in (0, 1):
        rs = i + (a & (1 - cc))
        for d in (0, 1):
            cs = j + (b & (1 - d))
            k = cc * 2 + d
            idx += [((rs + ph) * w1 + cs + ph) * 4 + k,
                    (rs * w1 + cs + ph) * 4 + k,
                    ((rs + ph) * w1 + cs) * 4 + k,
                    (rs * w1 + cs) * 4 + k]
    rows = blocks[torch.stack(idx)].reshape(4, 4, x.shape[0], c)
    total = None
    for k in range(4):
        r = rows[k]
        rect = r[0] - r[1] - r[2] + r[3]
        total = rect if total is None else total + rect
    return total


def sat_window_sums(feats: torch.Tensor, patch: int
                    ) -> tuple[torch.Tensor, int]:
    """Flattened f32 full-resolution SAT and its row stride ``w1``:
    win(x, y) = flat[(x+ps)*w1 + y+ps] - flat[x*w1 + y+ps]
              - flat[(x+ps)*w1 + y] + flat[x*w1 + y]."""
    s = F.pad(feats.float(), (0, 0, 1, 0, 1, 0))
    s = s.cumsum(0).cumsum(1)
    return s.reshape(-1, s.shape[-1]), s.shape[1]


def phase_pooled_s2d(feats_s2d: torch.Tensor, patch: int, out_rows: int,
                     out_cols: int) -> torch.Tensor:
    """(H2, W2, 4C) s2d-2 features -> the (ceil(out_rows/2),
    ceil(out_cols/2), 4C) s2d-2 packing of the full-resolution window-mean
    map (:func:`dmfusion_torch.ops.pool.phase_pool`: the kernel on the
    card, the plain version on the CPU).  ``patch`` must be even."""
    if patch % 2:
        raise ValueError(f"phase pooling needs an even patch, got {patch}")
    return phase_pool(feats_s2d, patch, -(-out_rows // 2), -(-out_cols // 2))


def phase_window_mean(feats_s2d: torch.Tensor, patch: int, out_rows: int,
                      out_cols: int) -> torch.Tensor:
    """:func:`phase_pooled_s2d` unpacked to (out_rows, out_cols, C)."""
    st = phase_pooled_s2d(feats_s2d, patch, out_rows, out_cols)
    return depth_to_space(st, 2)[:out_rows, :out_cols]


class WSConv(nn.Module):
    """Conv with scaled weight standardization (norm-free); ``padding``
    "SAME" (at stride 1) or "VALID".  ``weight`` is OIHW,
    ``gain`` and ``bias`` per output channel, all f32.  The stride is a
    call argument: the parameters do not depend on it, which lets a
    shift-and-stitch scene route run a stride-2 conv at stride 1 with the
    same weights (``models/gmfnet_conv.py``)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 act_gain: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"WSConv padding {padding!r}: use SAME or VALID")
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel,
                                               kernel))
        self.gain = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.act_gain = act_gain
        self.dtype = dtype
        self.padding = padding

    def flax_init(self, generator: torch.Generator) -> None:
        """he_normal kernel (variance 2/fan_in), unit gain, zero bias."""
        fan_in = self.weight[0].numel()
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator)
                          * math.sqrt(2.0 / fan_in))
        self.gain.fill_(1.0)
        self.bias.zero_()

    def standardized(self) -> torch.Tensor:
        w = use(self, "weight")
        mu = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
        fan_in = w[0].numel()
        wn = (w - mu) * torch.rsqrt(var * fan_in + 1e-8)
        return wn * (self.gain * self.act_gain)[:, None, None, None]

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        k = self.weight.shape[-1]  # a shard keeps the kernel's size
        if self.padding == "SAME" and stride != 1:
            # flax pads the odd pixel after; no caller needs that yet.
            raise ValueError("WSConv: SAME padding runs at stride 1 only")
        y = F.conv2d(x.to(self.dtype), self.standardized().to(self.dtype),
                     stride=stride,
                     padding=k // 2 if self.padding == "SAME" else 0)
        return y + self.bias.to(self.dtype)[:, None, None]


class GateConv(nn.Conv2d):
    """flax ``nn.Conv`` 1x1 with bias in the compute dtype: the conv's
    output is rounded before the bias add."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, features, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), use(self, "weight").to(self.dtype))
        return y + self.bias.to(self.dtype)[:, None, None]


class LocalConvBlock(nn.Module):
    """WSConv (act_gain sqrt 2) -> activation."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 act=F.relu, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = WSConv(in_features, features, kernel, _SQRT2, dtype)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(x))


class LocalResBlock(nn.Module):
    """``act(sc + alpha * y)``: y = WSConv(LocalConvBlock(x)), the shortcut
    a 1x1 WSConv where the width changes, alpha a learnable scalar (0.2)."""

    def __init__(self, in_features: int, features: int, act=F.relu,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.block = LocalConvBlock(in_features, features, 3, act, dtype)
        self.conv = WSConv(features, features, 3, 1.0, dtype)
        self.shortcut = (WSConv(in_features, features, 1, 1.0, dtype)
                         if in_features != features else None)
        self.alpha = nn.Parameter(torch.tensor(0.2))
        self.act = act

    def flax_init(self, generator: torch.Generator) -> None:
        self.alpha.fill_(0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(self.block(x))
        sc = x if self.shortcut is None else self.shortcut(x)
        return self.act(sc + self.alpha.to(y.dtype) * y)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (1, C, H, W), channels-last memory."""
    return x.permute(2, 0, 1)[None]


@register("dense_fusion")
class Net(nn.Module):
    """The dense model; ``model(ms, pan, patch)`` is the (H, W, ncls) f32
    logits map of a padded scene (MS (H+ps-1, W+ps-1, C), PAN 2-D or
    (.., .., 1) at 4x).

    ``remat`` (from ``train.dense_remat``: on unless 'off') checkpoints
    each conv block while grad is enabled; the fusion gate stays
    unwrapped, as in dmfusion.  A plain attribute, so a copy can be
    probed with it off."""

    flax_root = "DenseNet"
    #: Under the model axis every sharded leaf is gathered on use.
    tp_gather_on_use = True

    @classmethod
    def widths_from_tree(cls, tree: Mapping[str, Any]) -> dict[str, Any]:
        """The width, from the flax tree's MS stem."""
        return {"model_width": tree_shape(tree, "ms_stem", "WSConv_0",
                                          "kernel")[-1]}

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__()
        act = activation_fn(cfg)
        dt, _ = dtypes(cfg)
        w = int(cfg.get("model_width", 32))
        ms_channels = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
        ncls = int(cfg["Categories_Number"])
        self.compute_dtype = dt
        self.act = act
        self.remat = parse_switch(
            cfg.get("train", {}).get("dense_remat", "on"),
            "train.dense_remat") != "off"
        self.ms_stem = LocalConvBlock(4 * ms_channels, w, 3, act, dt)
        self.ms_block = LocalResBlock(w, 2 * w, act, dt)
        self.pan_stem = LocalConvBlock(64, w, 3, act, dt)
        self.pan_block = LocalResBlock(w, 2 * w, act, dt)
        self.fusion_gate = GateConv(4 * w, 2 * w, dt)
        self.trunk1 = LocalResBlock(2 * w, 4 * w, act, dt)
        self.trunk2 = LocalResBlock(4 * w, 4 * w, act, dt)
        self.refine = LocalConvBlock(4 * w, 4 * w, 3, act, dt)
        # Raw head params in flax's (in, out) layout.
        self.head1_kernel = nn.Parameter(torch.empty(w, w))
        self.head1_bias = nn.Parameter(torch.zeros(w))
        self.head2_kernel = nn.Parameter(torch.empty(w, ncls))
        self.head2_bias = nn.Parameter(torch.zeros(ncls))

    def flax_init(self, generator: torch.Generator) -> None:
        """lecun_normal head kernels (variance 1/fan_in), zero biases."""
        for k, b in ((self.head1_kernel, self.head1_bias),
                     (self.head2_kernel, self.head2_bias)):
            k.copy_(torch.randn(k.shape, generator=generator)
                    / math.sqrt(k.shape[0]))
            b.zero_()

    def features_s2d(self, scene_ms: torch.Tensor,
                     scene_pan: torch.Tensor) -> torch.Tensor:
        """(H', W', C) + (4H'', 4W''[, 1]) -> (ceil(H'/2), ceil(W'/2), 4w)
        s2d-2 packed dense features.  MS is zero-padded to even size at
        the bottom/right; PAN is cropped to 4H' x 4W', zero-padded to the
        8x grid and packed with space-to-depth 8; both are packed in the
        scene dtype, then cast."""
        dt = self.compute_dtype
        pan2d = scene_pan if scene_pan.ndim == 2 else scene_pan[..., 0]
        hm, wm = scene_ms.shape[0], scene_ms.shape[1]
        hm2, wm2 = -(-hm // 2), -(-wm // 2)
        ms = F.pad(scene_ms, (0, 0, 0, 2 * wm2 - wm, 0, 2 * hm2 - hm))
        pan = pan2d[:4 * hm, :4 * wm]
        pan = F.pad(pan, (0, 8 * wm2 - pan.shape[1], 0, 8 * hm2 - pan.shape[0]))
        ms16 = _nchw(space_to_depth(ms, 2).to(dt))
        pan64 = _nchw(space_to_depth(pan[..., None], 8).to(dt))
        blk = self._block
        h_ms = blk(self.ms_block, blk(self.ms_stem, ms16))
        h_pan = blk(self.pan_block, blk(self.pan_stem, pan64))
        z = torch.sigmoid(self.fusion_gate(torch.cat([h_ms, h_pan], dim=1)))
        fused = z * h_ms + (1.0 - z) * h_pan
        t = blk(self.refine, blk(self.trunk2, blk(self.trunk1, fused)))
        return t[0].permute(1, 2, 0)

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False)
        return block(x)

    def features(self, scene_ms: torch.Tensor,
                 scene_pan: torch.Tensor) -> torch.Tensor:
        """Dense (H', W', w) full-resolution features."""
        f = self.features_s2d(scene_ms, scene_pan)
        return depth_to_space(f, 2)[:scene_ms.shape[0], :scene_ms.shape[1]]

    def pooled(self, scene_ms: torch.Tensor, scene_pan: torch.Tensor,
               patch: int) -> torch.Tensor:
        """(H, W, w): entry (x, y) is the mean of the features over the
        window of anchor (x, y)."""
        hm, wm = scene_ms.shape[0], scene_ms.shape[1]
        if patch % 2:
            return window_mean(self.features(scene_ms, scene_pan), patch)
        return phase_window_mean(self.features_s2d(scene_ms, scene_pan),
                                 patch, hm - patch + 1, wm - patch + 1)

    def head(self, pooled_feats: torch.Tensor) -> torch.Tensor:
        """(..., w) pooled features -> (..., ncls) f32 logits."""
        dt = self.compute_dtype
        x = (pooled_feats.to(dt) @ use(self, "head1_kernel").to(dt)
             + self.head1_bias.to(dt))
        x = self.act(x)
        # Compute-dtype operands, f32 products and sums, f32 bias after.
        return (x.float() @ use(self, "head2_kernel").to(dt).float()
                + self.head2_bias.float())

    def logits_s2d(self, scene_ms: torch.Tensor, scene_pan: torch.Tensor,
                   patch: int) -> torch.Tensor:
        """Even patch: (ni, nj, 4*ncls) f32 logits, phase-major blocks.
        The head applies to each phase block of the pooled map, which is
        what JAX's block-diagonal kron(I4, K) matmuls compute."""
        hm, wm = scene_ms.shape[0], scene_ms.shape[1]
        st = phase_pooled_s2d(self.features_s2d(scene_ms, scene_pan), patch,
                              hm - patch + 1, wm - patch + 1)
        ni, nj, c4 = st.shape
        logits = self.head(st.reshape(ni, nj, 4, c4 // 4))
        return logits.reshape(ni, nj, -1)

    def forward(self, scene_ms: torch.Tensor, scene_pan: torch.Tensor,
                patch: int) -> torch.Tensor:
        """(H, W, ncls) f32 logits map."""
        if patch % 2:
            return self.head(self.pooled(scene_ms, scene_pan, patch))
        out_r = scene_ms.shape[0] - patch + 1
        out_c = scene_ms.shape[1] - patch + 1
        logits = self.logits_s2d(scene_ms, scene_pan, patch)
        return depth_to_space(logits, 2)[:out_r, :out_c]

    def class_map(self, scene_ms: torch.Tensor, scene_pan: torch.Tensor,
                  patch: int) -> torch.Tensor:
        """(H, W) int32 argmax class map; for an even patch the argmax runs
        per phase block before the unpacking."""
        if patch % 2:
            return self(scene_ms, scene_pan, patch).argmax(-1).to(torch.int32)
        out_r = scene_ms.shape[0] - patch + 1
        out_c = scene_ms.shape[1] - patch + 1
        logits = self.logits_s2d(scene_ms, scene_pan, patch)
        ni, nj, c = logits.shape
        am = logits.reshape(ni, nj, 4, c // 4).argmax(-1).to(torch.int32)
        return depth_to_space(am, 2)[:out_r, :out_c, 0]
