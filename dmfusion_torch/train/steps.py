"""Programs over a model: the dual-stream training/eval/predict programs
of the patch classifiers (``DualPrograms``, ``ConvMapPrograms``) and the
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

``DensePrograms`` trains, evaluates and maps the dense family over the
whole padded scene, in one dense pass or ``n`` sequential row bands: each
band is a slice of the scene that lies fully inside it (bands near the
bottom are clamped upward), starts on an even row so the s2d-2 phase grid
stays global, and carries a halo of ``RECEPTIVE_RADIUS`` rows, so its
owned output rows match the whole pass.  JAX's ``lax.scan`` over the
bands, and over the batches, is a Python loop here.

``ConvMapPrograms`` is ``DualPrograms`` with the shift-and-stitch map
route of gmfnet_conv for test and color.  ``TriPrograms`` is
``DualPrograms`` over three streams (MS, PAN and the IHS-fused MSPAN at
PAN geometry), gathered by ``ops/gather.py::gather_tri_fast`` on the card;
``QuadPrograms`` over the two-stage solver's four MS-geometry streams,
gathered by ``gather_quad_fast``, with the quadruplet KL loss and the
fused MS-plus-PAN prediction.  ``SinglePrograms`` feeds the MS window
alone, gathered by ``gather_one_fast`` (the kernel on every batch on the
card); ``H5DualPrograms`` indexes rows of the ``use_h5`` cache's
pre-gathered windows, with no gather at all.

Under a mesh (``parallel/mesh.py``) ``DualPrograms``, ``TriPrograms``,
``SinglePrograms`` and ``QuadPrograms`` run the ``data`` axis: every rank
holds the global (steps, B) batches, gathers its contiguous shard of each
batch with the family's kernel wrapper on ``mesh.shard(ids)``
(``gather_dual_fast``, as ``ops/gather.py::gather_dual_sharded`` does;
``gather_tri_fast``; ``gather_one_fast``; ``gather_quad_fast``: the kernel
on every batch on the card), and sums
what the ranks computed: a step's gradients (the cross-entropy divides by
the whole batch's real rows), an eval's loss sum and confusion, a
prediction's class ids in rank order.  ``qua_loss`` is not a sum over
rows (its KLs are batch means): under a mesh every rank computes it on the
whole batch's logits, rebuilt from the ranks' shards with only its own
rows live (``Mesh.batch_rows``), so the summed gradients are the whole
batch's and the loss is the whole batch's on every rank.
``ConvMapPrograms`` under a mesh is ``DualPrograms``' per-anchor route
throughout: its test and color do not render the map (dmfusion's banded
map under a mesh is not built either).

``DensePrograms`` under a mesh splits the scene's rows, not the batch
(dmfusion's shard_map programs): rank ``i`` owns band ``i`` of
``band_plan(ms_rows, mesh.data)`` (the halo'd, clamped bands of the
streamed pass) and holds the whole batch.  A step builds the features and
the phase SAT of the rank's band alone, takes the window sums of the
anchors it owns (the rest zeroed) and sums them over the ranks with its
own live (``Mesh.sum_live``), so each rank's backward reaches its band
alone and the features' gradients, summed, are the whole batch's; the head
and the loss run on the summed sums, the whole batch's on every rank, and
are not summed again.  Eval, predict and the maps render the
rank's band through the model (its pool is the pool kernel on the card)
and score the anchors it owns, or gather every rank's owned rows of the
int32 class map.  A scene too small to band runs whole on every rank, and
then nothing is summed over the ranks.

On the mesh's ``model`` axis (``parallel/partition.py``) the model peers of
a data index hold the same rows, and the data axis above runs between the
ranks of one model index (the mesh's data group): the shard is
``mesh.shard`` at the data index, the band ``band_plan(ms_rows,
mesh.data)``'s at the data index, and only the data group sums.  The model
computes with its shards (``parallel/tensor.py``), each rank's gradients,
a shard's or a replicated parameter's, are already its own, and
:func:`take_rank0_params` broadcasts rank 0's whole parameters before each
rank keeps its shards of them.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dmfusion_torch.data.patches import (gather_dual, gather_one,
                                         gather_quad, gather_tri)
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.dense_fusion import (RECEPTIVE_RADIUS,
                                                phase_corner_sums, phase_sat,
                                                sat_window_sums)
from dmfusion_torch.ops.gather import (gather_dual_fast, gather_one_fast,
                                       gather_quad_fast, gather_tri_fast)
from dmfusion_torch.ops.metrics import confusion_matrix
from dmfusion_torch.parallel.mesh import Mesh
from dmfusion_torch.parallel.partition import full_state
from dmfusion_torch.parallel.tensor import shard_state
from dmfusion_torch.train.losses import cross_entropy, qua_loss
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


def assemble_bands(pieces: list[torch.Tensor], h: int,
                   band: int) -> torch.Tensor:
    """Per-band owned rows -> (h, ...); band i holds rows
    [min(i*band, h-band), +band), and a later band supersedes the overlap
    of an earlier one."""
    kept, prev_end = [], 0
    for i, piece in enumerate(pieces):
        s = min(i * band, h - band)
        e = s + band
        if e > prev_end:
            kept.append(piece[prev_end - s:])
            prev_end = e
    return torch.cat(kept, dim=0)


@torch.no_grad()
def take_rank0_params(model: torch.nn.Module, mesh: Mesh | None) -> None:
    """Under a mesh, overwrite ``model``'s parameters with rank 0's, as DDP
    starts.  On the model axis rank 0 holds a shard: every rank gathers its
    whole parameters over its model group, rank 0's whole parameters are
    broadcast, and every rank keeps its shard of them (broadcasting rank
    0's shard itself would overwrite every model index's shard with model
    index 0's)."""
    if mesh is None:
        return
    if mesh.model == 1:
        mesh.broadcast_all_(model.parameters())
        return
    whole = full_state(model, dict(model.named_parameters()))
    mesh.broadcast_all_(whole.values())
    params = dict(model.named_parameters())
    for name, t in shard_state(model, whole).items():
        if t is not params[name]:
            params[name].copy_(t)


def sum_grads(params, mesh: Mesh) -> None:
    """Sum the gradients of ``params`` over the data axis, in one flat
    collective (a parameter without a gradient counts as zeros).  On the
    model axis every gradient, a shard's or a replicated parameter's, is
    already this rank's own: the model peers' are not added."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    mesh.sum_all_(grads)


def conf_from_map(pred_map: torch.Tensor, ids: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """``[pred][target]`` confusion of the (steps, B) anchors ``ids``, read
    from a class map (padding masked out)."""
    pred = pred_map.reshape(-1)[ids.reshape(-1)]
    return confusion_matrix(pred, labels.reshape(-1), num_classes,
                            mask.reshape(-1))


class DualPrograms:
    """Train, eval and predict programs of a dual-stream (ms, pan)
    classifier over a device-resident scene.

    ``scene_args`` is ``(ms, pan)``: the padded scene tensors; ``ids``,
    ``labels`` and ``mask`` are (steps, B) tensors on the same device, the
    mask zero on the padding of the last partial batch.
    ``plain_gather=True`` gathers with the plain version even on the card
    (for checks that hold the kernel against it; not with a mesh).  With a
    ``mesh`` the
    programs run this rank's shard of every batch (module docstring) and
    start from rank 0's parameters, as DDP does.
    """

    #: Per-anchor programs cannot render a whole-scene map.
    supports_map = False
    #: The (plain, kernel) window gathers over ``scene_args``.
    gathers = (gather_dual, gather_dual_fast)
    #: Under a mesh a rank's train loss is its share of the batch's, summed
    #: over the ranks (False: every rank's loss is already the batch's).
    loss_shares = True

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer | None,
                 cfg: Mapping[str, Any], width: int, patch: int, *,
                 plain_gather: bool = False, mesh: Mesh | None = None):
        if mesh is not None and plain_gather:
            raise ValueError("plain_gather holds the kernel against its plain "
                             "version in one process; a mesh gathers the "
                             "rank's shard with the kernel, as "
                             "gather_dual_sharded does")
        check_eval_scan_anchors(cfg)
        self.cfg = dict(cfg)
        self.model = model
        self.optimizer = optimizer
        self.width = int(width)
        self.patch = int(patch)
        self.num_classes = int(cfg["Categories_Number"])
        self.plain_gather = plain_gather
        self.mesh = mesh
        self.device = next(model.parameters()).device
        #: The card's eval/predict batches are rounded up to 4096 anchors.
        self.on_card = self.device.type == "cuda"
        take_rank0_params(self.model, mesh)

    def init(self, generator: torch.Generator) -> None:
        """Seeded parameters (flax's default initializers' distributions)
        and a zeroed optimizer state."""
        init_params(self.model, generator)
        take_rank0_params(self.model, self.mesh)
        if self.optimizer is not None:
            reset_state(self.optimizer)

    def _gather(self, scene_args: tuple, ids_b: torch.Tensor
                ) -> tuple[torch.Tensor, ...]:
        """The model's inputs at ``ids_b``: every anchor, or under a mesh
        this rank's shard (``mesh.shard``)."""
        if self.mesh is None:
            gather = self.gathers[0 if self.plain_gather else 1]
            windows = gather(*scene_args, ids_b, self.width, self.patch)
        else:
            windows = self.gathers[1](*scene_args, self.mesh.shard(ids_b),
                                      self.width, self.patch)
        # bf16 scenes widen exactly to the model's f32 inputs.
        return tuple(w.float() for w in windows)

    def _shard(self, labels_b: torch.Tensor, mask_b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """A batch's labels and mask, or under a mesh this rank's shard of
        them (the padding past the batch masked out)."""
        if self.mesh is None:
            return labels_b, mask_b
        return self.mesh.shard(labels_b, 0), self.mesh.shard(mask_b, 0)

    def loss(self, logits: torch.Tensor, labels_b: torch.Tensor,
             mask_b: torch.Tensor | None,
             count: torch.Tensor | None = None) -> torch.Tensor:
        """The train step's loss: the masked cross-entropy (over ``count``
        real rows when given)."""
        return cross_entropy(logits, labels_b, mask_b, count)

    # -- one optimizer step ------------------------------------------------
    def train_step(self, inputs: Sequence[torch.Tensor],
                   labels_b: torch.Tensor,
                   mask_b: torch.Tensor | None = None,
                   count: torch.Tensor | None = None) -> torch.Tensor:
        """One update on gathered windows (``inputs``: the model's
        arguments, e.g. ``(ms_b, pan_b)``); returns the loss, detached, on
        the device.  Under a mesh the inputs, labels and mask are this
        rank's shard, ``count`` the whole batch's real rows, and the
        ranks' gradients are summed before the update: the returned loss
        is this rank's share of the batch's."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(self.model(*inputs), labels_b, mask_b, count)
        loss.backward()
        if self.mesh is not None:
            sum_grads(self.model.parameters(), self.mesh)
        self.optimizer.step()
        return loss.detach()

    # -- whole epochs ------------------------------------------------------
    def train_epoch(self, scene_args: tuple, ids: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One update per batch; returns the (steps,) losses on the device
        (under a mesh the whole batches', on every rank)."""
        self.model.train()
        losses = []
        for i in range(ids.shape[0]):
            inputs = self._gather(scene_args, ids[i])
            if self.mesh is None:
                losses.append(self.train_step(inputs, labels[i], mask[i]))
            else:
                losses.append(self.train_step(
                    inputs, *self._shard(labels[i], mask[i]),
                    count=mask[i].float().sum()))
        losses = torch.stack(losses)
        if self.mesh is None or not self.loss_shares:
            return losses
        return self.mesh.sum_(losses)

    @torch.inference_mode()
    def eval_epoch(self, scene_args: tuple, ids: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Masked eval: (sample-weighted loss sum ``(per * mask).sum()``,
        ``[pred][target]`` confusion with the padding masked out); under a
        mesh each rank's shards, summed over the ranks."""
        self.model.eval()
        loss_sum = torch.zeros((), dtype=torch.float32, device=ids.device)
        conf = torch.zeros((self.num_classes, self.num_classes),
                           dtype=torch.float32, device=ids.device)
        for i in range(ids.shape[0]):
            logits = self.model(*self._gather(scene_args, ids[i]))
            labels_i, mask_i = self._shard(labels[i], mask[i])
            per = torch.nn.functional.cross_entropy(
                logits.float(), labels_i.long(), reduction="none")
            loss_sum += (per * mask_i.float()).sum()
            conf += confusion_matrix(logits.argmax(dim=-1), labels_i,
                                     self.num_classes, mask_i)
        if self.mesh is not None:
            self.mesh.sum_(loss_sum)
            self.mesh.sum_(conf)
        return loss_sum, conf

    @staticmethod
    def decide(logits: torch.Tensor) -> torch.Tensor:
        """A batch's logits -> its int32 class ids: the argmax."""
        return logits.argmax(dim=-1).to(torch.int32)

    @torch.inference_mode()
    def predict(self, scene_args: tuple, ids: torch.Tensor) -> torch.Tensor:
        """(steps, B) anchor ids -> (steps, B) int32 class ids
        (``decide``); under a mesh every rank's shards, gathered in rank
        order once, on every rank."""
        self.model.eval()
        preds = torch.stack([
            self.decide(self.model(*self._gather(scene_args, ids[i])))
            for i in range(ids.shape[0])])
        if self.mesh is None:
            return preds
        steps, per = preds.shape
        every = self.mesh.rows(preds).view(self.mesh.data, steps, per)
        return every.transpose(0, 1).reshape(steps, -1)[:, :ids.shape[1]]

    def test_confusion(self, scene_args: tuple, ids: torch.Tensor,
                       labels: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
        """Confusion matrix of the test phase (loss discarded)."""
        return self.eval_epoch(scene_args, ids, labels, mask)[1]


class TriPrograms(DualPrograms):
    """Three-stream programs: ``scene_args`` is ``(ms, pan, mspan)``, the
    IHS-fused MSPAN padded like PAN (reference dataset_tri,
    train/dataset.py:248-282); every gather on the card launches the
    window kernel three times (MS, PAN, MSPAN), under a mesh on the rank's
    shard.  Every rank builds the same MSPAN bit for bit (its unpooling
    offsets come from a CPU generator seeded by ``seed``, and the rest is
    elementwise work and fixed-order reductions), so nothing is
    broadcast."""

    gathers = (gather_tri, gather_tri_fast)


class H5DualPrograms(DualPrograms):
    """The ``use_h5`` cache's input path (dmfusion's ``H5DualPrograms``,
    the reference's ``dataset_h5``): ``scene_args`` are the pre-gathered
    windows of the repeat's patch cache, (N, ps, ps, C) MS and (N, 4ps,
    4ps, 1) PAN (``utils/h5cache.py``), and batch ids are row indices into
    them.  An epoch indexes rows: no window gather, no kernel launch.  The
    cache holds exactly what the plain gather gives, which the kernel
    equals, so the epoch is the on-the-fly epoch's.  Single-process: the
    solver trains a mesh from scene gathers, as dmfusion does."""

    def _gather(self, scene_args: tuple, ids_b: torch.Tensor
                ) -> tuple[torch.Tensor, ...]:
        rows = ids_b.long()
        return tuple(a[rows].float() for a in scene_args)


class SinglePrograms(DualPrograms):
    """Single-modality programs (dmfusion's ``SinglePrograms``, the
    reference's ``dataset_one``): ``scene_args`` is ``(ms,)`` and the model
    sees the MS window alone.  Every batch on the card, the train batches
    of 256 included, goes through ``gather_one_fast`` (one window-kernel
    launch), as the other families' do; dmfusion's ``_use_fast`` rule kept
    small batches on the XLA gather, which the card's kernel beats at
    every size.  Under a mesh each rank gathers its own shard."""

    gathers = (lambda ms, ids, w, ps: (gather_one(ms, ids, w, ps),),
               lambda ms, ids, w, ps: (gather_one_fast(ms, ids, w, ps),))


class QuadPrograms(DualPrograms):
    """Four-stream programs of the two-stage (DQTL) classifier:
    ``scene_args`` is ``(ms, pan_ms, ms_gan, pan_gan)``, four MS-geometry
    scenes; a batch's four windows go to the model concatenated along the
    batch axis, one ``(4B, ps, ps, C)`` input (reference
    tostagesolver.py:271), and every gather on the card launches the
    window kernel four times.  The loss is the masked quadruplet KL
    (``losses.py::qua_loss``) on the f32 logits; the prediction sums the
    MS and PAN streams' logits before the softmax and argmax
    (tostagesolver.py:337).

    Under a mesh a rank runs the model on its shard's four streams, and the
    loss is dmfusion's ``qua_loss`` of the whole batch on every rank
    (module docstring): the train loss is not summed over the ranks."""

    gathers = (gather_quad, gather_quad_fast)
    loss_shares = False

    def _gather(self, scene_args: tuple, ids_b: torch.Tensor
                ) -> tuple[torch.Tensor]:
        return (torch.cat(super()._gather(scene_args, ids_b)),)

    def _shard(self, labels_b: torch.Tensor, mask_b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole batch's labels and mask, on every rank: the loss sees
        the whole batch (``loss``)."""
        return labels_b, mask_b

    def _whole_logits(self, logits: torch.Tensor, b: int) -> torch.Tensor:
        """A rank's ``(4 per, C)`` shard logits -> the whole batch's
        ``(4 b, C)``, stream by stream (MS, PAN, GM, GP), each stream's
        rows in rank order and trimmed to ``b``; only this rank's rows
        carry a gradient (``Mesh.batch_rows``)."""
        per = logits.shape[0] // 4
        rows = self.mesh.batch_rows(logits.view(4, per, -1).transpose(0, 1),
                                    b)
        return rows.transpose(0, 1).reshape(4 * b, -1)

    def loss(self, logits: torch.Tensor, labels_b: torch.Tensor,
             mask_b: torch.Tensor | None,
             count: torch.Tensor | None = None) -> torch.Tensor:
        """The masked qua_loss of the batch (``labels_b``, ``mask_b``: the
        whole batch's; ``count`` is unused: the mask counts its rows).
        Under a mesh ``logits`` are the rank's shard's, and the loss runs on
        the whole batch's rebuilt from every rank's."""
        b = labels_b.shape[0]
        if self.mesh is not None:
            logits = self._whole_logits(logits, b)
        return qua_loss(logits, b, labels_b, self.cfg, mask_b)

    @torch.inference_mode()
    def eval_epoch(self, scene_args: tuple, ids: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (loss sum, (5, C, C) confusions): the loss sum adds each
        batch's masked ``qua_loss`` times its real anchors; confusion [0]
        scores the fused prediction (the MS plus PAN logits' argmax),
        [1..4] each stream on its own, the padding masked out.  Under a
        mesh the loss sum is the whole batches' on every rank (``loss``),
        and the confusions are each rank's shards', summed over the
        ranks."""
        self.model.eval()
        c = self.num_classes
        loss_sum = torch.zeros((), dtype=torch.float32, device=ids.device)
        confs = torch.zeros((5, c, c), dtype=torch.float32, device=ids.device)
        for i in range(ids.shape[0]):
            logits = self.model(*self._gather(scene_args, ids[i]))
            m = mask[i].float()
            loss_sum += self.loss(logits, labels[i], m) * m.sum()
            labels_i, m_i = super()._shard(labels[i], m)  # the rank's rows
            parts = logits.split(logits.shape[0] // 4)
            preds = [(parts[0] + parts[1]).argmax(dim=-1)]
            preds += [p.argmax(dim=-1) for p in parts]
            for k, p in enumerate(preds):
                confs[k] += confusion_matrix(p, labels_i, c, m_i)
        if self.mesh is not None:
            self.mesh.sum_(confs)
        return loss_sum, confs

    @staticmethod
    def decide(logits: torch.Tensor) -> torch.Tensor:
        return fused_predict(logits)

    def test_confusion(self, scene_args: tuple, ids: torch.Tensor,
                       labels: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
        """The fused prediction's confusion."""
        return self.eval_epoch(scene_args, ids, labels, mask)[1][0]


def fused_predict(logits: torch.Tensor) -> torch.Tensor:
    """(4B, C) quad logits -> (B,) int32: the argmax of the softmax of the
    MS and PAN streams' summed logits."""
    b = logits.shape[0] // 4
    fused = torch.softmax(logits[:b] + logits[b:2 * b], dim=-1)
    return fused.argmax(dim=-1).to(torch.int32)


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


def resolve_dense_epoch(value, streams: int) -> str:
    """``train.dense_epoch`` as 'minibatch' or 'full' given the resolved
    training band count: 'auto' is 'full' exactly when the run streams
    (a streamed minibatch step replays every band for ~B anchors)."""
    mode = str(value if value is not None else "auto").strip().lower()
    if mode == "auto":
        return "full" if streams else "minibatch"
    if mode not in ("minibatch", "full"):
        raise ValueError(
            f"train.dense_epoch: unknown mode {value!r} "
            "(use 'auto', 'minibatch' or 'full')")
    return mode


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
    """Train, eval and map programs of a dense model (``ARITY = 'dense'``)
    over padded scene tensors ``ms`` (H+ps-1, W+ps-1, C) and ``pan``; an
    anchor id is ``x * W + y``, with W read from the scene's shape.

    ``DensePrograms(model, patch)`` serves maps only: an artifact stamps
    its band count at export (``dense_bands``).  The solver adds the
    ``optimizer`` and the run's ``cfg``, which give the band counts
    (``dense_streams``, ``dense_streams_infer``) and the epoch mode
    (``train.dense_epoch``, 'minibatch' unless 'full').

    Training pools from summed-area tables, never through the pool
    kernel: each step runs the dense features of the whole scene (or of
    each band in turn), builds the f32 phase SAT and gathers the batch's
    window sums from it (``_band_corner_fns``).  Eval, test and color
    render the logits or class map, whose pooling is the pool kernel on
    the card.  dmfusion's ``_compact_compute_scenes`` (a TPU layout
    device: cast the whole scene before slicing bands) has no
    counterpart: bands slice the scene as it is, and the model casts after
    its space-to-depth packing, which the cast commutes with exactly.

    With a ``mesh`` every rank computes its own band of
    ``band_plan(ms_rows, mesh.data)`` (module docstring): no program
    streams (``dense_streams`` counts as 0), and the programs start from
    rank 0's parameters.
    """

    supports_map = True

    def __init__(self, model: torch.nn.Module, patch: int, *,
                 optimizer: torch.optim.Optimizer | None = None,
                 cfg: Mapping[str, Any] | None = None,
                 mesh: Mesh | None = None):
        self.model = model
        self.mesh = mesh
        self.patch = int(patch)
        self.optimizer = optimizer
        self.cfg = dict(cfg or {})
        # The solver resolves 'auto' from the scene first; programs built
        # directly train by minibatch.
        self.dense_epoch_mode = resolve_dense_epoch(
            self.cfg.get("train", {}).get("dense_epoch", "auto"), 0)
        self.device = (next(model.parameters()).device if model is not None
                       else torch.device("cpu"))
        #: The card's eval/predict batches are rounded up to 4096 anchors.
        self.on_card = self.device.type == "cuda"
        take_rank0_params(model, mesh)

    @property
    def num_classes(self) -> int:
        return int(self.model.head2_bias.shape[0])

    def init(self, generator: torch.Generator) -> None:
        """Seeded parameters and a zeroed optimizer state."""
        init_params(self.model, generator)
        take_rank0_params(self.model, self.mesh)
        if self.optimizer is not None:
            reset_state(self.optimizer)

    # -- band geometry -----------------------------------------------------
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

    def _band(self, ms: torch.Tensor, pan: torch.Tensor, plan, i: int):
        """Band ``i``'s (first scene row, MS slab, PAN slab)."""
        need = plan[4]
        _, s0, _ = self.band_slices(plan, i, ms.shape[0])
        return s0, ms[s0:s0 + need], pan[4 * s0:4 * (s0 + need)]

    def _owns(self, plan, i: int, x: torch.Tensor) -> torch.Tensor:
        """Anchors whose row lies in band ``i``'s owned output rows."""
        h, _, band, _, _ = plan
        return (x >= i * band) & (x < min((i + 1) * band, h))

    def _band_piece(self, ms: torch.Tensor, pan: torch.Tensor, plan, i: int,
                    band_fn) -> torch.Tensor:
        """``band_fn(band_ms, band_pan)`` over band ``i``: its owned rows."""
        _, _, offset = self.band_slices(plan, i, ms.shape[0])
        return band_fn(*self._band(ms, pan, plan, i)[1:])[
            offset:offset + plan[2]]

    def mesh_plan(self, ms_rows: int):
        """The plan of the mesh's bands, one a rank; None without a mesh or
        when the scene is too small to band (every rank then runs the whole
        scene)."""
        if self.mesh is None:
            return None
        return self.band_plan(ms_rows, self.mesh.data)

    def mesh_band(self, ms_rows: int) -> dict | None:
        """This rank's band under a mesh (``mesh_plan``), for its report."""
        plan = self.mesh_plan(ms_rows)
        if plan is None:
            return None
        out_start, s0, _ = self.band_slices(plan, self.mesh.data_index,
                                            ms_rows)
        return {"out_start": out_start, "s0": s0, "need": plan[4],
                "band": plan[2]}

    def _stream_bands(self, ms_rows: int, ms_cols: int) -> int:
        """The training band count (0: the whole-scene pass; always under
        a mesh, whose bands run on the ranks)."""
        if self.mesh is not None:
            return 0
        return resolve_dense_streams(self.cfg.get("dense_streams", "auto"),
                                     ms_rows, ms_cols)

    def _stream_bands_infer(self, ms_rows: int, ms_cols: int) -> int:
        """The band count of maps, eval and predict: ``dense_streams_infer``
        (the solver writes its band probe's answer there) over the
        training count."""
        return resolve_dense_streams_infer(
            self.cfg.get("dense_streams_infer", "auto"),
            self._stream_bands(ms_rows, ms_cols))

    def _eval_stream_plan(self, ms: torch.Tensor):
        n = self._stream_bands_infer(ms.shape[0], ms.shape[1])
        return self.band_plan(ms.shape[0], n) if n else None

    # -- anchor pooling (training) -----------------------------------------
    def _band_corner_fns(self):
        """``build(ms, pan) -> (flat SAT, w1, compute dtype)`` over one
        scene slab, and ``corners(state, lx, y) -> (B, C)`` f32 window sums
        of the anchors at slab rows ``lx`` and columns ``y``: 16 phase-SAT
        rows an anchor for an even patch, 4 full-resolution SAT rows
        otherwise.  Streamed eval builds once per band and gathers many
        batches from it."""
        ps, model = self.patch, self.model
        if ps % 2 == 0:
            def build(band_ms, band_pan):
                f = model.features_s2d(band_ms, band_pan)
                s = phase_sat(f)
                return s.reshape(-1, s.shape[-1]), s.shape[1], f.dtype

            def corners(state, lx, y):
                return phase_corner_sums(state[0], state[1], ps, lx, y)
        else:
            def build(band_ms, band_pan):
                feats = model.features(band_ms, band_pan)
                flat, w1 = sat_window_sums(feats, ps)
                return flat, w1, feats.dtype

            def corners(state, lx, y):
                flat, w1, _ = state
                lx, y = lx.long(), y.long()
                r = flat[torch.stack([(lx + ps) * w1 + y + ps,
                                      lx * w1 + y + ps, (lx + ps) * w1 + y,
                                      lx * w1 + y])]
                return r[0] - r[1] - r[2] + r[3]
        return build, corners

    def _anchor_pooled_fn(self, ms_rows: int, ms_cols: int):
        """``pooled(ms, pan, ids_b) -> (B, w)`` window means in the compute
        dtype (rounded there, as dmfusion rounds them before the head).

        Whole scene: checkpointed end to end unless the model's remat is
        off (then the backward keeps the features and the SAT).  With
        ``dense_streams`` resolving to n > 1 bands on a scene that bands:
        :meth:`_anchor_pooled_streamed`; under a mesh whose scene bands:
        :meth:`_anchor_pooled_sharded`."""
        ps = self.patch
        width = ms_cols - ps + 1
        build, corners = self._band_corner_fns()
        plan = self.mesh_plan(ms_rows)
        if plan is not None:
            return self._anchor_pooled_sharded(build, corners, plan, width)
        n = self._stream_bands(ms_rows, ms_cols)
        splan = self.band_plan(ms_rows, n) if n else None
        if splan is not None:
            return self._anchor_pooled_streamed(build, corners, splan, width)

        def pooled(ms, pan, ids_b):
            state = build(ms, pan)
            win = corners(state, ids_b // width, ids_b % width)
            return (win / float(ps * ps)).to(state[2])

        if not self.model.remat:
            return pooled
        return lambda ms, pan, ids_b: checkpoint(pooled, ms, pan, ids_b,
                                                 use_reentrant=False)

    def _anchor_pooled_streamed(self, build, corners, splan, width: int):
        """Anchor pooling band by band: each band computes its slab's
        features and SAT and adds the window sums of the anchors it owns
        (the others are zeroed; every anchor has exactly one owner) into
        an f32 sum.  Each band is checkpointed whatever the remat setting,
        so the backward holds one band's intermediates at a time."""
        ps = self.patch
        dt = self.model.compute_dtype

        def band_win(band_ms, band_pan, lx, y, own):
            win = corners(build(band_ms, band_pan), lx, y)
            return torch.where(own[:, None], win, 0.0).float()

        def pooled(ms, pan, ids_b):
            x, y = ids_b // width, ids_b % width
            acc = None
            for i in range(splan[1]):
                s0, band_ms, band_pan = self._band(ms, pan, splan, i)
                lx = (x - s0).clamp(0, splan[4] - ps)
                win = checkpoint(band_win, band_ms, band_pan, lx, y,
                                 self._owns(splan, i, x), use_reentrant=False)
                acc = win if acc is None else acc + win
            return (acc / float(ps * ps)).to(dt)

        return pooled

    def _anchor_pooled_sharded(self, build, corners, plan, width: int):
        """Anchor pooling under a mesh (dmfusion's shard_map branch): this
        rank computes the features and SAT of its band alone and takes the
        window sums of the anchors it owns (the others zeroed); the sums
        are added over the ranks with its own live (``Mesh.sum_live``).
        The band is checkpointed end to end unless the model's remat is
        off, as dmfusion checkpoints its shard_map; the sum stays outside,
        so the backward does not repeat the collective."""
        ps, i = self.patch, self.mesh.data_index
        dt = self.model.compute_dtype

        def band_win(ms, pan, ids_b):
            x, y = ids_b // width, ids_b % width
            s0, band_ms, band_pan = self._band(ms, pan, plan, i)
            lx = (x - s0).clamp(0, plan[4] - ps)
            win = corners(build(band_ms, band_pan), lx, y)
            return torch.where(self._owns(plan, i, x)[:, None], win, 0.0)

        def pooled(ms, pan, ids_b):
            if self.model.remat:
                win = checkpoint(band_win, ms, pan, ids_b,
                                 use_reentrant=False)
            else:
                win = band_win(ms, pan, ids_b)
            return (self.mesh.sum_live(win) / float(ps * ps)).to(dt)

        return pooled

    def _loss(self, pooled, scene_args: tuple, ids_b: torch.Tensor,
              labels_b: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
        feats = pooled(scene_args[0], scene_args[1], ids_b)
        return cross_entropy(self.model.head(feats), labels_b, mask_b)

    def _step(self, pooled, scene_args: tuple, ids_b, labels_b,
              mask_b) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(pooled, scene_args, ids_b, labels_b, mask_b)
        loss.backward()
        if self.mesh_plan(scene_args[0].shape[0]) is not None:
            # Each rank holds its band's share of the features' gradients;
            # the head runs on the summed window sums, so its gradient is
            # already the whole batch's on every rank.
            sum_grads((p for n, p in self.model.named_parameters()
                       if not n.startswith("head")), self.mesh)
        self.optimizer.step()
        return loss.detach()

    # -- whole epochs ------------------------------------------------------
    def train_epoch(self, scene_args: tuple, ids: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The epoch of ``train.dense_epoch``: minibatch, one update per
        (steps, B) batch, each recomputing the dense pass; returns the
        (steps,) losses on the device (under a mesh the whole batches', on
        every rank).  'full': :meth:`train_epoch_full`."""
        if self.dense_epoch_mode == "full":
            return self.train_epoch_full(scene_args, ids, labels, mask)
        self.model.train()
        pooled = self._anchor_pooled_fn(*scene_args[0].shape[:2])
        return torch.stack([self._step(pooled, scene_args, ids[i], labels[i],
                                       mask[i])
                            for i in range(ids.shape[0])])

    def train_epoch_full(self, scene_args: tuple, ids: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
        """One dense pass scoring every train anchor and one update; the
        (1,) loss."""
        self.model.train()
        pooled = self._anchor_pooled_fn(*scene_args[0].shape[:2])
        return self._step(pooled, scene_args, ids.reshape(-1),
                          labels.reshape(-1), mask.reshape(-1))[None]

    def _band_anchor_scan(self, ms: torch.Tensor, pan: torch.Tensor, splan,
                          ids: torch.Tensor):
        """Streamed per-anchor logits: for each band, its features and SAT
        once, then ``(b, logits, own)`` for every batch ``b`` that owns an
        anchor in it (the others are skipped: ownership is read on the
        host once per band)."""
        ps = self.patch
        width = ms.shape[1] - ps + 1
        build, corners = self._band_corner_fns()
        x, y = ids // width, ids % width
        for i in range(splan[1]):
            own = self._owns(splan, i, x)
            live = [b for b, v in enumerate(own.any(dim=1).tolist()) if v]
            if not live:
                continue
            s0, band_ms, band_pan = self._band(ms, pan, splan, i)
            state = build(band_ms, band_pan)
            for b in live:
                lx = (x[b] - s0).clamp(0, splan[4] - ps)
                win = corners(state, lx, y[b])
                feats = (win / float(ps * ps)).to(state[2])
                yield b, self.model.head(feats), own[b]

    def _rank_band_logits(self, ms: torch.Tensor, pan: torch.Tensor, plan,
                          ids: torch.Tensor):
        """Under a mesh: this rank's band's logits map (the model's
        forward), then ``(b, logits, own)`` for every batch ``b``, each
        anchor read from the band's owned rows (clamped where the rank does
        not own it: ``own`` masks those)."""
        i, band = self.mesh.data_index, plan[2]
        logits = self._band_piece(
            ms, pan, plan, i, lambda bm, bp: self.model(bm, bp, self.patch))
        flat = logits.reshape(-1, logits.shape[-1])
        width = logits.shape[1]
        out_start, _, _ = self.band_slices(plan, i, ms.shape[0])
        x, y = ids // width, ids % width
        own = self._owns(plan, i, x)
        local = (x - out_start).clamp(0, band - 1) * width + y
        for b in range(ids.shape[0]):
            yield b, flat[local[b]], own[b]

    @torch.inference_mode()
    def eval_epoch(self, scene_args: tuple, ids: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Masked eval: (sample-weighted loss sum, ``[pred][target]``
        confusion).  One logits map of the scene, every batch indexed from
        it; streamed, each anchor scored by its owning band; under a mesh,
        each rank scores the anchors it owns from its band's logits map
        and the sums are added over the ranks."""
        self.model.eval()
        ms, pan = scene_args[0], scene_args[1]
        ncls = self.num_classes
        loss_sum = torch.zeros((), dtype=torch.float32, device=ids.device)
        conf = torch.zeros((ncls, ncls), dtype=torch.float32,
                           device=ids.device)
        mplan = self.mesh_plan(ms.shape[0])
        splan = self._eval_stream_plan(ms)
        if mplan is not None:
            batches = self._rank_band_logits(ms, pan, mplan, ids)
        elif splan is None:
            flat = self.model(ms, pan, self.patch).reshape(-1, ncls)
            batches = ((b, flat[ids[b]], None) for b in range(ids.shape[0]))
        else:
            batches = self._band_anchor_scan(ms, pan, splan, ids)
        for b, logits, own in batches:
            m = mask[b] if own is None else mask[b] * own.to(mask.dtype)
            per = F.cross_entropy(logits.float(), labels[b].long(),
                                  reduction="none")
            loss_sum += (per * m).sum()
            conf += confusion_matrix(logits.argmax(dim=-1), labels[b], ncls,
                                     m)
        if mplan is not None:
            self.mesh.sum_(loss_sum)
            self.mesh.sum_(conf)
        return loss_sum, conf

    @torch.inference_mode()
    def predict(self, scene_args: tuple, ids: torch.Tensor) -> torch.Tensor:
        """(steps, B) anchor ids -> (steps, B) int32 class ids: indexed
        from the class map (:meth:`predict_map`), or streamed, each from
        its owning band."""
        self.model.eval()
        ms, pan = scene_args[0], scene_args[1]
        splan = self._eval_stream_plan(ms)
        if splan is None:
            return self.predict_map(ms, pan).reshape(-1)[ids]
        out = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
        for b, logits, own in self._band_anchor_scan(ms, pan, splan, ids):
            out[b] = torch.where(own, logits.argmax(dim=-1).to(torch.int32),
                                 out[b])
        return out

    def _streamed(self, ms: torch.Tensor, pan: torch.Tensor, n_bands: int,
                  band_fn):
        """``band_fn(band_ms, band_pan)`` over the bands, owned rows
        assembled; None when the scene is too small to band."""
        plan = self.band_plan(ms.shape[0], n_bands)
        if plan is None:
            return None
        pieces = [self._band_piece(ms, pan, plan, i, band_fn)
                  for i in range(n_bands)]
        return assemble_bands(pieces, plan[0], plan[2])

    def _mesh_map(self, ms: torch.Tensor, pan: torch.Tensor, plan,
                  band_fn) -> torch.Tensor:
        """``band_fn(band_ms, band_pan)`` over this rank's band; every
        rank's owned rows gathered (``Mesh.rows``) and assembled, on every
        rank."""
        piece = self._band_piece(ms, pan, plan, self.mesh.data_index,
                                 band_fn)
        pieces = self.mesh.rows(piece).split(plan[2])
        return assemble_bands(list(pieces), plan[0], plan[2])

    @torch.inference_mode()
    def logits_map(self, ms: torch.Tensor, pan: torch.Tensor
                   ) -> torch.Tensor:
        """(H, W, ncls) f32 logits map in one pass; under a mesh every
        rank's band, gathered and assembled on every rank (dmfusion's
        ``logits_map_sharded``).  The programs score and map without it:
        it holds the bands against the whole pass."""
        self.model.eval()
        plan = self.mesh_plan(ms.shape[0])
        if plan is None:
            return self.model(ms, pan, self.patch)
        return self._mesh_map(ms, pan, plan,
                              lambda bm, bp: self.model(bm, bp, self.patch))

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
                    n_bands: int | None = None) -> torch.Tensor:
        """(H, W) int32 class map of the whole scene in one dense pass
        (``n_bands`` 0) or in ``n_bands`` row bands; None: the run's
        inference band count.  Under a mesh whose scene bands, every
        rank's band, gathered and assembled on every rank."""
        plan = self.mesh_plan(ms.shape[0])
        if plan is not None:
            self.model.eval()
            return self._mesh_map(
                ms, pan, plan,
                lambda bm, bp: self.model.class_map(bm, bp, self.patch))
        if n_bands is None:
            n_bands = self._stream_bands_infer(ms.shape[0], ms.shape[1])
        if n_bands:
            return self.class_map_streamed(ms, pan, n_bands)
        return self.model.class_map(ms, pan, self.patch)

    def test_confusion(self, scene_args: tuple, ids: torch.Tensor,
                       labels: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
        """Test-phase confusion: streamed, from one class map of the scene
        (the map's argmax; no loss); otherwise :meth:`eval_epoch`'s."""
        if self._eval_stream_plan(scene_args[0]) is None:
            return self.eval_epoch(scene_args, ids, labels, mask)[1]
        pred_map = self.predict_map(scene_args[0], scene_args[1])
        return conf_from_map(pred_map, ids, labels, mask, self.num_classes)


def resolve_conv_streams(value, ms_rows: int, ms_cols: int, patch: int,
                         width: int = 64) -> int:
    """The ``conv_streams`` knob as a band count for the shift-and-stitch
    map route (0 = the whole-scene pass): 'auto' keeps scenes of up to
    6.5M anchor cells whole and gives larger ones one band per 4M anchor
    cells at width 64 (scaled by width); 'off'/0 force the whole pass; an
    integer forces a count."""
    v = str(value).strip().lower() if value is not None else "auto"
    if v in ("off", "0", "false", "no", "none"):
        return 0
    cells = (ms_rows - patch + 1) * (ms_cols - patch + 1)
    if v in ("auto", ""):
        per_band = int(4_000_000 * 64 / max(width, 1))
        return 0 if cells <= 6_500_000 else -(-cells // per_band)
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"conv_streams: unrecognized value {value!r} "
                         "(use auto/off or a band count)") from None


class ConvMapPrograms(DualPrograms):
    """:class:`DualPrograms` plus the shift-and-stitch map route of a model
    that declares ``MAP_PROGRAMS = "convmap"`` (gmfnet_conv).

    Train and val are the inherited per-anchor programs (the window gather
    on every batch).  Test and color render the model's convolutional
    ``class_map``, whose entries are the window route's argmaxes in f32:
    one map of the scene, or ``conv_streams`` sequential row bands.  Under
    a mesh test and color stay per anchor too (``supports_map`` is False),
    as in dmfusion, whose banded map under a mesh is not built.  A band is a
    slab of the scene that starts on the stride-4 phase grid (so it
    computes the same global phases) and lies inside the scene (the
    bottom band is clamped upward); its owned rows equal the whole map's,
    since WSConv features do not depend on the input and every pooled sum
    lies inside one band.  dmfusion's cast of the whole scene before
    slicing is not needed: the model pads and packs before it casts, which
    commutes exactly."""

    @property
    def supports_map(self) -> bool:
        """One rank renders the map; under a mesh the ranks' shards go per
        anchor."""
        return self.mesh is None

    # -- band geometry -----------------------------------------------------
    def band_plan(self, ms_rows: int, n: int):
        """``(h, n, band, need)`` for ``n`` row bands, or None when the
        scene is too small to band.  ``need`` (scene rows per band) carries
        the patch-1 window rows plus 7 slack rows (up to 3 for moving the
        start onto the stride-4 grid) and is congruent to ``ms_rows`` mod
        4, so a bottom-clamped band still starts on the grid and ends at
        the scene's last row."""
        ps = self.patch
        h = ms_rows - ps + 1
        if n < 2:
            return None
        band = -(-h // n)
        need = band + ps + 7
        need += (ms_rows - need) % 4
        if need > ms_rows or band > h:
            return None
        return h, n, band, need

    @staticmethod
    def band_slices(plan, i: int, ms_rows: int) -> tuple[int, int]:
        """Band ``i``'s (first scene row, offset of its owned rows in the
        band's map)."""
        h, _, band, need = plan
        out_start = min(i * band, h - band)
        s0 = min(max(out_start, 0), ms_rows - need) // 4 * 4
        return s0, out_start - s0

    @torch.inference_mode()
    def class_map_streamed(self, ms: torch.Tensor, pan: torch.Tensor,
                           n_bands: int) -> torch.Tensor:
        """(H, W) int32 class map from ``n_bands`` sequential row bands (the
        whole pass when the scene is too small to band)."""
        plan = self.band_plan(ms.shape[0], n_bands)
        if plan is None:
            return self._whole_class_map(ms, pan)
        self.model.eval()
        need, band = plan[3], plan[2]
        pieces = []
        for i in range(n_bands):
            s0, offset = self.band_slices(plan, i, ms.shape[0])
            out = self.model.class_map(ms[s0:s0 + need],
                                       pan[4 * s0:4 * (s0 + need)],
                                       self.patch)
            pieces.append(out[offset:offset + band])
        return assemble_bands(pieces, plan[0], band)

    @torch.inference_mode()
    def _whole_class_map(self, ms: torch.Tensor,
                         pan: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        return self.model.class_map(ms, pan, self.patch)

    def conv_streams(self, ms_rows: int, ms_cols: int) -> int:
        """The run's band count (``conv_streams``; 0: one pass)."""
        return resolve_conv_streams(
            self.cfg.get("conv_streams", "auto"), ms_rows, ms_cols,
            self.patch, int(self.cfg.get("model_width", 64)))

    def predict_map(self, ms: torch.Tensor, pan: torch.Tensor,
                    n_bands: int | None = None) -> torch.Tensor:
        """(H, W) int32 class map of the whole scene in one pass
        (``n_bands`` 0) or in ``n_bands`` row bands; None: the run's
        ``conv_streams``.  One rank's route: it refuses a mesh."""
        if self.mesh is not None:
            raise ValueError(
                "ConvMapPrograms.predict_map renders the map on one rank; "
                "under a mesh gmfnet_conv tests and colors per anchor "
                "(supports_map is False)")
        if n_bands is None:
            n_bands = self.conv_streams(ms.shape[0], ms.shape[1])
        if n_bands:
            return self.class_map_streamed(ms, pan, n_bands)
        return self._whole_class_map(ms, pan)

    def test_confusion(self, scene_args: tuple, ids: torch.Tensor,
                       labels: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
        """Test-phase confusion from one class map of the scene: exact in
        f32, where the map's entries are the window route's argmaxes; in
        bf16 the two routes sum in another order, so near-tie argmaxes may
        part.  Under a mesh: the per-anchor confusion of
        :class:`DualPrograms`."""
        if self.mesh is not None:
            return super().test_confusion(scene_args, ids, labels, mask)
        pred_map = self.predict_map(scene_args[0], scene_args[1])
        return conf_from_map(pred_map, ids, labels, mask, self.num_classes)
