"""Programs over a model: the dual-stream training/eval/predict programs
of the patch classifiers (``DualPrograms``) and the inference half of the
dense family's (``DensePrograms``).

Port of ``dmfusion/train/steps.py``.  ``DualPrograms`` holds the
``nn.Module`` and its ``torch.optim`` optimizer and updates them in place;
where JAX runs an epoch as one ``lax.scan``, an epoch here is an eager
loop over the (steps, B) id batches: gather the windows, forward, masked
cross-entropy, backward, step.  Each step's loss stays on the device and
the epoch's losses come back stacked, so the caller fetches once per
epoch.  On the card every window gather goes through the CUDA kernel
(``ops/gather.py::gather_dual_fast``, both streams), for batches of any
size; on the CPU it is the plain gather.

``DensePrograms`` renders the class map of a padded scene in one dense
pass, or ``n`` sequential row bands: each band is a slice of the scene
that lies fully inside it (bands near the bottom are clamped upward),
starts on an even row so the s2d-2 phase grid stays global, and carries
a halo of ``RECEPTIVE_RADIUS`` rows, so its owned output rows match the
whole pass.  JAX's ``lax.scan`` over the bands is a Python loop here.
Dense training, the remat and band probes, the mesh routes and the
tri/quad/h5/conv-map program families are not ported yet.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from dmfusion_torch.data.patches import gather_dual
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.dense_fusion import RECEPTIVE_RADIUS
from dmfusion_torch.ops.gather import gather_dual_fast
from dmfusion_torch.ops.metrics import confusion_matrix
from dmfusion_torch.train.losses import cross_entropy
from dmfusion_torch.train.optim import reset_state


def check_eval_scan_anchors(cfg: Mapping[str, Any]) -> None:
    """Raise on a bad ``eval_scan_anchors`` value: 'auto'/0/unset, 'off' or
    an anchor count.  dmfusion bounds each eval device call by it; the
    eager loop here launches one batch at a time, so it bounds nothing
    more."""
    v = str(cfg.get("eval_scan_anchors", "auto")).strip().lower()
    if v in ("auto", "", "0", "none", "off", "false", "no"):
        return
    try:
        int(v)
    except ValueError:
        raise ValueError(
            f"eval_scan_anchors: unrecognized value {v!r} (use "
            "auto/off or an anchor count)") from None


class DualPrograms:
    """Train, eval and predict programs of a dual-stream (ms, pan)
    classifier over a device-resident scene.

    ``scene_args`` is ``(ms, pan)``: the padded scene tensors; ``ids``,
    ``labels`` and ``mask`` are (steps, B) tensors on the same device, the
    mask zero on the padding of the last partial batch.
    ``plain_gather=True`` gathers with the plain version even on the card
    (for checks that hold the kernel against it).
    """

    #: Per-anchor programs cannot render a whole-scene map.
    supports_map = False

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer | None,
                 cfg: Mapping[str, Any], width: int, patch: int, *,
                 plain_gather: bool = False):
        check_eval_scan_anchors(cfg)
        self.model = model
        self.optimizer = optimizer
        self.width = int(width)
        self.patch = int(patch)
        self.num_classes = int(cfg["Categories_Number"])
        self.plain_gather = plain_gather
        self.device = next(model.parameters()).device
        #: The card's eval/predict batches are rounded up to 4096 anchors.
        self.on_card = self.device.type == "cuda"

    def init(self, generator: torch.Generator) -> None:
        """Seeded parameters (flax's default initializers' distributions)
        and a zeroed optimizer state."""
        init_params(self.model, generator)
        if self.optimizer is not None:
            reset_state(self.optimizer)

    def _gather(self, scene_args: tuple, ids_b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        gather = gather_dual if self.plain_gather else gather_dual_fast
        ms_b, pan_b = gather(scene_args[0], scene_args[1], ids_b, self.width,
                             self.patch)
        # bf16 scenes widen exactly to the model's f32 inputs.
        return ms_b.float(), pan_b.float()

    # -- one optimizer step ------------------------------------------------
    def train_step(self, ms_b: torch.Tensor, pan_b: torch.Tensor,
                   labels_b: torch.Tensor,
                   mask_b: torch.Tensor | None = None) -> torch.Tensor:
        """One update on gathered windows; returns the loss, detached, on
        the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy(self.model(ms_b, pan_b), labels_b, mask_b)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    # -- whole epochs ------------------------------------------------------
    def train_epoch(self, scene_args: tuple, ids: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One update per batch; returns the (steps,) losses on the device."""
        self.model.train()
        losses = [self.train_step(*self._gather(scene_args, ids[i]),
                                  labels[i], mask[i])
                  for i in range(ids.shape[0])]
        return torch.stack(losses)

    @torch.inference_mode()
    def eval_epoch(self, scene_args: tuple, ids: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Masked eval: (sample-weighted loss sum ``(per * mask).sum()``,
        ``[pred][target]`` confusion with the padding masked out)."""
        self.model.eval()
        loss_sum = torch.zeros((), dtype=torch.float32, device=ids.device)
        conf = torch.zeros((self.num_classes, self.num_classes),
                           dtype=torch.float32, device=ids.device)
        for i in range(ids.shape[0]):
            logits = self.model(*self._gather(scene_args, ids[i]))
            per = torch.nn.functional.cross_entropy(
                logits.float(), labels[i].long(), reduction="none")
            loss_sum += (per * mask[i].float()).sum()
            conf += confusion_matrix(logits.argmax(dim=-1), labels[i],
                                     self.num_classes, mask[i])
        return loss_sum, conf

    @torch.inference_mode()
    def predict(self, scene_args: tuple, ids: torch.Tensor) -> torch.Tensor:
        """(steps, B) anchor ids -> (steps, B) int32 argmax class ids."""
        self.model.eval()
        return torch.stack([
            self.model(*self._gather(scene_args, ids[i])).argmax(dim=-1)
            .to(torch.int32) for i in range(ids.shape[0])])

    def test_confusion(self, scene_args: tuple, ids: torch.Tensor,
                       labels: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
        """Confusion matrix of the test phase (loss discarded)."""
        return self.eval_epoch(scene_args, ids, labels, mask)[1]


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
