"""Seeded synthetic scenes, made on the run's device.

A frozen copy, in torch, of the recipe of
``dmfusion_torch/data/scene.py::synthetic_scene`` (itself the JAX
package's): smooth class fields on a coarse grid give every pixel a class
(1 .. classes-1), 30 % of the pixels are unlabeled (0), the MS pixel is
its class's base colour plus ``0.25 N(0, 1)`` noise, and the PAN pixel is
the MS luminance, upsampled 4x, plus ``0.25 N(0, 1)``.  Then each image
is min-max normalized over the whole image and reflect-padded at the
bottom and right (``patch - 1`` for MS, ``4 patch - 1`` for PAN), as the
port's ``prep_scene`` does, and stored in the scene dtype.  The draws come
from a torch generator on the device, so the values differ from the
port's numpy draws of the same seed; the distribution is the same.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from portbench.seeds import derive


@dataclasses.dataclass
class Scene:
    ms: torch.Tensor      # (H + ps - 1, W + ps - 1, C), scene dtype
    pan: torch.Tensor     # (4H + 4ps - 1, 4W + 4ps - 1), scene dtype
    label: torch.Tensor   # (H, W) uint8 on the device
    height: int
    width: int
    patch: int

    @property
    def streams(self) -> tuple[torch.Tensor, ...]:
        """The padded images a window gather reads, in the reference's
        order."""
        return (self.ms, self.pan)


def _normalize_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    x = (x - x.min()) / (x.max() - x.min())
    chw = x[None] if x.ndim == 2 else x.permute(2, 0, 1)
    out = F.pad(chw[None], (0, pad, 0, pad), mode="reflect")[0]
    return out[0] if x.ndim == 2 else out.permute(1, 2, 0).contiguous()


def make(size, classes: int, patch: int, dtype: torch.dtype, seed: int,
         tag: str, device: torch.device) -> Scene:
    """The scene of stream ``tag`` of ``seed``."""
    h, w, c = (int(v) for v in size)
    gen = torch.Generator(device=device).manual_seed(derive(seed, tag))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    gh, gw = max(h // 32, 8), max(w // 32, 8)
    fields = randn(classes - 1, gh, gw)
    up = fields.repeat_interleave(-(-h // gh), 1).repeat_interleave(
        -(-w // gw), 2)[:, :h, :w]
    cls = up.argmax(0) + 1
    del up
    unlabeled = torch.rand((h, w), generator=gen, device=device) < 0.3
    label = torch.where(unlabeled, 0, cls).to(torch.uint8)
    ms = randn(classes, c)[cls] + 0.25 * randn(h, w, c)
    lum = ms.mean(-1)
    pan = lum.repeat_interleave(4, 0).repeat_interleave(4, 1)
    pan += 0.25 * randn(4 * h, 4 * w)
    ms_p = _normalize_pad(ms, patch - 1).to(dtype)
    del ms
    pan_p = _normalize_pad(pan, 4 * patch - 1).to(dtype)
    return Scene(ms=ms_p, pan=pan_p, label=label, height=h, width=w,
                 patch=patch)
