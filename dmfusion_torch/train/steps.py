"""Dense whole-scene programs: the inference half of ``DensePrograms``.

Port of ``dmfusion/train/steps.py`` (``resolve_dense_streams``,
``resolve_dense_streams_infer``, ``DensePrograms._band_plan``,
``_band_slices``, ``_assemble_bands``, ``_streamed``,
``class_map_streamed`` and ``predict_map``).  The class map of a padded
scene is one dense pass, or ``n`` sequential row bands: each band is a
slice of the scene that lies fully inside it (bands near the bottom are
clamped upward), starts on an even row so the s2d-2 phase grid stays
global, and carries a halo of ``RECEPTIVE_RADIUS`` rows, so its owned
output rows match the whole pass.  JAX's ``lax.scan`` over the bands is
a Python loop here.  Training, the remat and band probes and the mesh
routes are not ported yet.
"""

from __future__ import annotations

import torch

from dmfusion_torch.models.dense_fusion import RECEPTIVE_RADIUS


def resolve_dense_streams(value, ms_rows: int, ms_cols: int) -> int:
    """The ``dense_streams`` knob as a band count (0 = the whole-scene
    pass): 'auto'/'on' keep scenes up to 8M px whole and give larger ones
    one band per 6.5M px; 'off'/0/1 force the whole pass; an integer
    forces a count."""
    v = str(value).strip().lower() if value is not None else "auto"
    if v in ("auto", "", "on", "true", "yes"):
        cells = int(ms_rows) * int(ms_cols)
        if cells <= 8_000_000:
            return 0
        return -(-cells // 6_500_000)
    if v in ("off", "false", "no"):
        return 0
    try:
        n = int(v)
    except ValueError:
        raise ValueError(
            f"dense_streams: unrecognized value {value!r} (use "
            "off/auto/on or an integer band count)") from None
    return n if n > 1 else 0


def resolve_dense_streams_infer(value, n_train: int) -> int:
    """The ``dense_streams_infer`` knob given the resolved training band
    count ``n_train``: 'auto' follows it, 'off' forces the whole pass, an
    integer forces a count."""
    if not n_train:
        return 0
    v = str(value if value is not None else "auto").strip().lower()
    if v in ("auto", "", "train", "same"):
        return n_train
    if v in ("off", "false", "no"):
        return 0
    try:
        n = int(v)
    except ValueError:
        raise ValueError(
            f"dense_streams_infer: unrecognized value {v!r} (use "
            "auto/off or an integer band count)") from None
    return n if n > 1 else 0


class DensePrograms:
    """Whole-scene class maps of a dense model (``ARITY = 'dense'``) over
    padded scene tensors ``ms`` (H+ps-1, W+ps-1, C) and ``pan``.  The band
    count comes from the caller: an artifact stamps it at export
    (``dense_bands``, resolved there from the two knobs above)."""

    def __init__(self, model: torch.nn.Module, patch: int):
        self.model = model
        self.patch = int(patch)

    def band_plan(self, ms_rows: int, parts: int):
        """``(h, parts, band, halo, need)`` for ``parts`` bands, or None
        when the scene is too small to band.  ``need`` (scene rows per
        band) is congruent to ``ms_rows`` mod 2, so a bottom-clamped band
        starts on an even row and still ends at the scene's last row."""
        ps = self.patch
        h = ms_rows - ps + 1
        if parts < 2:
            return None
        band = -(-h // parts)
        halo = RECEPTIVE_RADIUS
        base = band + ps - 1 + 2 * halo + 1
        need = base + ((ms_rows - base) % 2)
        if need > ms_rows or band > h:
            return None
        return h, parts, band, halo, need

    @staticmethod
    def band_slices(plan, i: int, ms_rows: int) -> tuple[int, int, int]:
        """Band ``i``'s (first owned output row, first scene row, offset of
        the owned rows in the band's output)."""
        h, _, band, halo, need = plan
        out_start = min(i * band, h - band)
        s0 = min(max(out_start - halo, 0), ms_rows - need)
        s0 = (s0 // 2) * 2
        return out_start, s0, out_start - s0

    @staticmethod
    def assemble_bands(pieces: list[torch.Tensor], plan) -> torch.Tensor:
        """Per-band owned rows -> (h, ...); band i holds rows
        [min(i*band, h-band), +band), and a later band supersedes the
        overlap of an earlier one."""
        h, parts, band, _, _ = plan
        kept, prev_end = [], 0
        for i in range(parts):
            s = min(i * band, h - band)
            e = s + band
            if e > prev_end:
                kept.append(pieces[i][prev_end - s:])
                prev_end = e
        return torch.cat(kept, dim=0)

    def _streamed(self, ms: torch.Tensor, pan: torch.Tensor, n_bands: int,
                  band_fn):
        """``band_fn(band_ms, band_pan)`` over the bands, owned rows
        assembled; None when the scene is too small to band."""
        plan = self.band_plan(ms.shape[0], n_bands)
        if plan is None:
            return None
        need, band = plan[4], plan[2]
        pieces = []
        for i in range(n_bands):
            _, s0, offset = self.band_slices(plan, i, ms.shape[0])
            out = band_fn(ms[s0:s0 + need], pan[4 * s0:4 * (s0 + need)])
            pieces.append(out[offset:offset + band])
        return self.assemble_bands(pieces, plan)

    @torch.inference_mode()
    def class_map_streamed(self, ms: torch.Tensor, pan: torch.Tensor,
                           n_bands: int) -> torch.Tensor:
        """(H, W) int32 class map from ``n_bands`` sequential row bands (the
        whole pass when the scene is too small to band)."""
        out = self._streamed(
            ms, pan, n_bands,
            lambda bm, bp: self.model.class_map(bm, bp, self.patch))
        if out is None:
            return self.model.class_map(ms, pan, self.patch)
        return out

    @torch.inference_mode()
    def predict_map(self, ms: torch.Tensor, pan: torch.Tensor,
                    n_bands: int) -> torch.Tensor:
        """(H, W) int32 class map of the whole scene in one dense pass
        (``n_bands`` 0) or in ``n_bands`` row bands."""
        if n_bands:
            return self.class_map_streamed(ms, pan, n_bands)
        return self.model.class_map(ms, pan, self.patch)
