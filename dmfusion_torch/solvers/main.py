"""Solver: the train, test and color phases of a classifier.

Port of ``dmfusion/solvers/main.py`` for models of arity ``dual`` (gmfnet,
gmfnet_conv, resnet18, cross_net, vit, swin_transformer, swin_T_dual,
ct_lstm), ``tri`` (tri_net), ``dense`` (dense_fusion) and ``single`` (a
registered model whose module declares ``ARITY = "single"``: the MS window
alone, through ``SinglePrograms``; no model of the zoo has it).
Semantics kept:
  * the model comes from the registry by ``model_name``, seeded with
    ``seed + repeat``; the optimizer counts ``ceil(len(train) / batchsize)``
    updates an epoch for its schedule; a loss other than ``Criterion``
    raises;
  * each epoch trains over freshly shuffled batches (built while the last
    epoch's work drains), fetches the mean loss once, evaluates the val
    batches (built once), keeps the best parameters by val loss (a real
    copy) and saves them, saves the current parameters, optimizer state
    and epoch, and records ``Epoch``, ``Loss``, ``ValLoss``, ``ValOA`` and
    ``EpochTime``; ``train.early_stop`` stops at the first val regression;
  * ``train.resume`` restarts from ``curweights`` at ``epoch + 1`` with
    the records trimmed;
  * test -> ``[pred][target]`` confusion -> OA/AA/kappa and the workbook;
    a test- or color-only run without weights raises
    ``FileNotFoundError``;
  * color() writes ``{time}_pic_1.png`` (labeled pixels) and
    ``{time}_pic_2.png`` (all pixels), with the port's own PNG writer;
  * with ``use_h5`` a dual-arity run trains from the repeat's patch cache
    (``H5DualPrograms``: rows of the pre-gathered windows, shuffled by the
    repeat's generator as dmfusion shuffles them), in one process.

Eval and predict batches are rounded up to 4096 anchors on the card (the
counterpart of dmfusion's fast-gather rule) and to 64 on the CPU; masks
keep every confusion exact either way.

The dense arity (dense_fusion) resolves its knobs from the scene before it
builds its programs, as dmfusion does: ``dense_streams`` (the training
band count), ``train.dense_epoch`` ('auto' is 'full' when streaming; a
full epoch is one update, so the schedule counts one step an epoch and the
train batches are built once), ``train.dense_remat`` and
``dense_streams_infer`` (by the two memory probes below).  Its test and
color phases render the class map: one map gives both PNGs.  So do
gmfnet_conv's (``ConvMapPrograms``, the shift-and-stitch route), which
trains and validates per anchor like gmfnet.  The tri arity adds a third
scene, MSPAN: the seeded IHS pansharpen of the raw scene (seed ``seed``,
``data/scene.py::mspan_scene``), built once on the device, normalized and
padded like PAN, and gathered with MS and PAN by ``TriPrograms``.  The
quad arity (dqtl) trains under ``solvers/twostage.py``, and so do the image
arity's generator and discriminator, as its stage 1: this solver refuses
them with a ``ValueError``, as dmfusion's does.  ``proof`` (the
contourlet diagnostics) renders the lowband and the four directional
subbands of ``proof.samples`` labeled anchors' MS and PAN windows;
``visualize`` draws the t-SNE scatter of ``visualize.samples`` test
anchors' logits (``report/viz.py::embedding_scatter``, the t-SNE on the
run's device).

Under a mesh (``torchrun``, ``mesh.distributed``; ``solvers/base.py``)
the dual, tri and dense arities train, validate, test and color on every
rank through the programs' mesh route (``DualPrograms``, ``TriPrograms``,
``DensePrograms``' row bands; gmfnet_conv per anchor throughout, its
``supports_map`` false): the val loss and every confusion and class map
are the whole batch's on every rank, so every rank keeps the same best
parameters.  The dense knobs resolve as dmfusion resolves them under a
mesh: ``dense_streams`` 0, ``train.dense_epoch`` 'auto' is 'minibatch',
``train.dense_remat`` 'auto' is 'on' without a probe, and no band probe.
Rank 0 alone writes; a checkpoint that a phase reads back
(``train.resume``, a test- or color-only run) is read by rank 0 and
broadcast.  ``visualize`` trims its anchors to a multiple of the ranks,
every rank computes its shard's logits, and rank 0 embeds them all;
``use_h5`` warns and trains from scene gathers, as dmfusion's
multi-process run does.  Models with BatchNorm raise
``NotImplementedError`` naming their ROADMAP A14 item.

With ``mesh.model > 1`` (the mesh's ``model`` axis,
``parallel/partition.py``) the dual arity's gmfnet and vit and the dense
family train, validate, test and color as above, each rank holding its
shards of the seeded whole parameters (sharded after ``init_params``,
before the optimizer, whose moments take the shards' shapes).  Every save
gathers the whole parameters and moments over the model group first and a
load takes the rank's shards of the file, so a checkpoint holds the whole
model in one process's layout.  Every other family raises
``NotImplementedError`` naming ROADMAP A14 item 7, and so does the
two-stage solver.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Mapping

import numpy as np
import torch

from dmfusion_torch.data.patches import batched_ids_np, gather_dual
from dmfusion_torch.data.scene import mspan_scene
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.registry import (build_model, model_arity,
                                            model_map_programs)
from dmfusion_torch.ops.contourlet import contourlet_decompose
from dmfusion_torch.ops.metrics import aa_oa, render_class_map
from dmfusion_torch.parallel import check_model, unported
from dmfusion_torch.parallel.partition import (full_opt_state, full_state,
                                               shard_model, shard_opt_state)
from dmfusion_torch.parallel.tensor import shard_state
from dmfusion_torch.report.png import write_png
from dmfusion_torch.report.viz import channel_grid, embedding_scatter
from dmfusion_torch.solvers.base import BaseSolver
from dmfusion_torch.train.checkpoint import (AsyncCheckpointWriter, exists,
                                             load_checkpoint, save_checkpoint,
                                             snapshot)
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import (ConvMapPrograms, DensePrograms,
                                        DualPrograms, H5DualPrograms,
                                        QuadPrograms, SinglePrograms,
                                        TriPrograms, resolve_dense_epoch,
                                        resolve_dense_streams)
from dmfusion_torch.utils.misc import parse_switch

# The (arity, model) pairs that run on the mesh's model axis: the dual
# arity's gmfnet and vit, the dense family (dmfusion's TP tests pin these
# three).  The rest raises, naming ROADMAP A14 item 7.
_MODEL_AXIS = {("dual", "gmfnet"), ("dual", "vit"),
               ("dual", "vision_transformer"), ("dense", "dense_fusion")}

# The per-anchor programs of an arity other than dual (whose map-route
# models take ConvMapPrograms).
_PROGRAMS = {"tri": TriPrograms, "single": SinglePrograms}

# The dense memory probes' decisions, per process.  dmfusion also keeps
# them on disk, because each of its probes is an XLA compile that costs
# minutes on a remote TPU; here a probe is one pass on the card, so the
# disk cache is not ported.
_PROBE_CACHE: dict[tuple, Any] = {}
# A probed program fits when its peak is under this share of the budget.
_PROBE_MARGIN = 0.92


def _probe_budget(cfg: Mapping[str, Any], device: torch.device) -> float:
    """``train.dense_hbm_budget`` when set, else the card's total memory."""
    budget = float(cfg["train"].get("dense_hbm_budget") or 0)
    return budget or float(torch.cuda.mem_get_info(device)[1])


def _peak_bytes(device: torch.device, fn: Callable[[], Any]) -> int | None:
    """The card's peak allocated bytes while ``fn()`` runs (what was
    allocated before counts too: scene, weights, optimizer state), or None
    when it runs out of memory."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    try:
        fn()
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        torch.cuda.empty_cache()


def dense_remat_probe(cfg: Mapping[str, Any], scene, model: torch.nn.Module,
                      n_train: int = 0) -> dict:
    """``train.dense_remat`` 'auto': {'decision': 'off' or 'on',
    'peak_bytes', 'budget_bytes'}.

    On the card: one forward and backward, no update, of the epoch
    program the run will execute (one batch of ``batchsize`` anchors; all
    ``n_train`` train anchors under ``train.dense_epoch: full``) at the
    scene's real shapes, on a copy of ``model`` with remat off.  'off'
    (keep the activations: faster) when its peak stays under 0.92 x the
    budget, 'on' when it does not or runs out of memory.  A failure of
    any other kind raises: dmfusion's fallback to a byte estimate covers
    its remote compiles failing, which has no counterpart here.  On the
    CPU: that byte estimate (``cells * 4w * 2 * 16`` under 9e9 bytes).
    """
    w = int(cfg.get("model_width", 32))
    ms, pan = scene.ms, scene.pan
    if ms.device.type != "cuda":
        cells = -(-ms.shape[0] // 2) * -(-ms.shape[1] // 2)
        est = cells * 4 * w * 2 * 16
        return {"decision": "off" if est < 9e9 else "on",
                "peak_bytes": None, "estimate_bytes": est}
    budget = _probe_budget(cfg, ms.device)
    mode = str(cfg["train"].get("dense_epoch", "minibatch")).strip().lower()
    b = int(cfg["batchsize"])
    steps = max(1, -(-int(n_train) // b)) if (mode == "full" and n_train) \
        else 1
    key = (tuple(ms.shape), tuple(pan.shape), w, int(cfg["patch_size"]), b,
           mode, steps, str(cfg["precision"]["compute_dtype"]), budget)
    if key not in _PROBE_CACHE:
        probe = copy.deepcopy(model)
        probe.remat = False
        prog = DensePrograms(probe, int(cfg["patch_size"]), cfg=cfg)
        pooled = prog._anchor_pooled_fn(ms.shape[0], ms.shape[1])
        n = steps * b
        ids = (torch.arange(n, device=ms.device) % scene.num_pixels).int()
        labels = torch.zeros(n, dtype=torch.int64, device=ms.device)
        mask = torch.ones(n, dtype=torch.float32, device=ms.device)
        peak = _peak_bytes(ms.device, lambda: prog._loss(
            pooled, (ms, pan), ids, labels, mask).backward())
        del probe, prog, pooled
        torch.cuda.empty_cache()
        fits = peak is not None and peak < _PROBE_MARGIN * budget
        _PROBE_CACHE[key] = {"decision": "off" if fits else "on",
                             "peak_bytes": peak, "budget_bytes": budget}
    return dict(_PROBE_CACHE[key])


def dense_infer_band_probe(cfg: Mapping[str, Any], scene,
                           model: torch.nn.Module, n_train: int) -> int:
    """``dense_streams_infer`` 'auto' for a streamed run: the fewest bands
    whose class map renders on the card under 0.92 x the budget, tried
    fewest first among dmfusion's candidates (2-16 bands, fewer than the
    training count, under dmfusion's pixels-per-band limit, and a scene
    that bands); else ``n_train``.  On the CPU: ``n_train``."""
    ms, pan = scene.ms, scene.pan
    if ms.device.type != "cuda":
        return n_train
    budget = _probe_budget(cfg, ms.device)
    w = int(cfg.get("model_width", 32))
    ps = int(cfg["patch_size"])
    key = ("infer_bands", tuple(ms.shape), tuple(pan.shape), w, ps,
           str(cfg["precision"]["compute_dtype"]), budget)
    if key not in _PROBE_CACHE:
        prog = DensePrograms(model, ps, cfg=cfg)
        cells = int(ms.shape[0]) * int(ms.shape[1])
        limit_px = 18_500_000 * (32 / max(w, 1))
        decision = n_train
        for n in (2, 3, 4, 6, 8, 12, 16):
            if (n >= n_train or cells / n > limit_px
                    or prog.band_plan(int(ms.shape[0]), n) is None):
                continue
            peak = _peak_bytes(ms.device, lambda n=n: prog.class_map_streamed(
                ms, pan, n))
            if peak is not None and peak < _PROBE_MARGIN * budget:
                decision = n
                break
        _PROBE_CACHE[key] = decision
    return _PROBE_CACHE[key]


class Solver(BaseSolver):
    #: Trim the shuffled train ids to whole batches (the two-stage solver).
    TRIM_TRAIN = False

    def __init__(self, cfg: Mapping[str, Any]):
        super().__init__(cfg)
        self.model: torch.nn.Module | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.programs: DualPrograms | DensePrograms | None = None
        self.remat_probe: dict | None = None
        self.best_params: dict[str, torch.Tensor] | None = None
        self.scene_args: tuple | None = None
        self.color_time = 0.0
        #: The last ``visualize`` scatter's t-SNE run (rank 0).
        self.tsne = None

    # -- model lifecycle ---------------------------------------------------
    def init_model(self) -> None:
        cfg = self.cfg
        arity = model_arity(cfg["model_name"])
        if arity == "image":
            raise ValueError(
                f"unsupported model arity {arity!r} for the main solver: "
                f"{cfg['model_name']!r} trains as stage 1 of the two-stage "
                "solver (--solver twostage --set model_name=dqtl "
                "dqtl.pre_trained=0)")
        if arity == "quad":
            raise NotImplementedError(
                f"model {cfg['model_name']!r} has arity 'quad': its training "
                "trains under the two-stage solver: pass --solver twostage "
                "(ROADMAP A11)")
        if arity not in ("dual", "tri", "dense", "single"):
            raise ValueError(f"unsupported model arity {arity!r} for the "
                             "main solver")
        if (self.mesh is not None and self.mesh.model > 1
                and (arity, str(cfg["model_name"]).lower())
                not in _MODEL_AXIS):
            raise unported(f"model {cfg['model_name']!r} (arity {arity!r}) "
                           f"on mesh.model {self.mesh.model}", "model")
        loss_name = cfg["schedule"]["loss"]
        if loss_name != "Criterion":
            raise ValueError(
                f"schedule.loss {loss_name!r} is not usable with the main "
                "solver (integer-label classification); use 'Criterion' "
                "(qua_loss is selected automatically by task 'dqtl')")
        if self.scene_args is None:
            self.scene_args = self._make_scene_args(arity)
        streams = 0
        if arity == "dense":
            if self.mesh is None:  # a mesh's bands run on its ranks
                streams = resolve_dense_streams(
                    cfg.get("dense_streams", "auto"), *self.scene.ms.shape[:2])
            mode = resolve_dense_epoch(cfg["train"].get("dense_epoch", "auto"),
                                       streams)
            if streams and mode == "minibatch" and not cfg.get("nohup"):
                print("[dmfusion] WARNING: dense_streams is active with "
                      "train.dense_epoch: minibatch — every step replays "
                      "all band passes for one minibatch (hundreds of "
                      "full-scene passes per epoch). train.dense_epoch: "
                      "full is the intended mode at this scale.")
            train = dict(cfg["train"], dense_epoch=mode)
            if self.mesh is not None and parse_switch(
                    train.get("dense_remat", "auto"),
                    "train.dense_remat") == "auto":
                # As dmfusion: a mesh's bands exist where memory is tight,
                # so they remat, with no probe.
                train["dense_remat"] = "on"
            cfg = dict(cfg, train=train)
        model = build_model(cfg)
        if self.mesh is not None:
            check_model(model)
        if self.device.type == "cuda":
            model = model.to(self.device, memory_format=torch.channels_last)
        init_params(model, torch.Generator().manual_seed(
            int(cfg["seed"]) + int(self.time)))
        # The model axis: every rank keeps its shards of the seeded whole
        # parameters, before the optimizer fills its moments.
        shard_model(model, self.mesh)
        self.model = model
        n_train = len(self.split.train) if self.split else 0
        if arity == "dense":
            cfg = self._resolve_dense_memory(cfg, streams, n_train)
        # A full-batch dense epoch is one update: the schedule counts one
        # step an epoch.
        full = arity == "dense" and cfg["train"]["dense_epoch"] == "full"
        steps_per_epoch = 1 if full else max(
            1, -(-max(1, n_train) // cfg["batchsize"]))
        self.optimizer = make_optimizer(cfg, model.parameters(),
                                        steps_per_epoch)
        if arity == "dense":
            self.programs = DensePrograms(model, self.scene.patch,
                                          optimizer=self.optimizer, cfg=cfg,
                                          mesh=self.mesh)
        else:
            # A model with a convolutional map route (gmfnet_conv) trains
            # per anchor and maps test and color in one pass.
            if arity in _PROGRAMS:
                cls = _PROGRAMS[arity]
            elif model_map_programs(cfg["model_name"]) == "convmap":
                cls = ConvMapPrograms
            else:
                cls = DualPrograms
            self.programs = cls(model, self.optimizer, cfg, self.scene.width,
                                self.scene.patch, mesh=self.mesh)

    def _make_scene_args(self, arity: str) -> tuple:
        """The scenes the arity's programs gather from: ``(ms,)`` (single),
        ``(ms, pan)`` (dual, dense), ``(ms, pan, mspan)`` (tri)."""
        if arity == "single":
            return (self.scene.ms,)
        args = (self.scene.ms, self.scene.pan)
        if arity == "tri":
            args += (mspan_scene(self.scene, self.cfg["seed"]),)
        return args

    def _resolve_dense_memory(self, cfg: dict, streams: int,
                              n_train: int) -> dict:
        """``train.dense_remat`` and, when streaming, ``dense_streams_infer``:
        explicit values pass through, 'auto' asks the probes (on the
        seeded model).  Sets the model's remat; returns the run's cfg."""
        remat = parse_switch(cfg["train"].get("dense_remat", "auto"),
                             "train.dense_remat")
        if remat == "auto":
            self.remat_probe = dense_remat_probe(cfg, self.scene, self.model,
                                                 n_train)
            remat = self.remat_probe["decision"]
            if not cfg.get("nohup"):
                print(f"[dmfusion] train.dense_remat auto -> {remat} "
                      f"({self.remat_probe})")
        self.model.remat = remat != "off"
        cfg = dict(cfg, train=dict(cfg["train"], dense_remat=remat))
        if streams:
            v = str(cfg.get("dense_streams_infer", "auto")).strip().lower()
            if v in ("auto", ""):
                v = str(dense_infer_band_probe(cfg, self.scene, self.model,
                                               streams))
            elif v in ("train", "same"):
                v = str(streams)
            cfg["dense_streams_infer"] = v
        return cfg

    def _ckpt_meta(self) -> dict:
        """Model-identity stamp written into every checkpoint and checked on
        load."""
        return {"model": str(self.cfg["model_name"]),
                "width": int(self.cfg.get("model_width", 0) or 0)}

    def _ckpt_lenient(self) -> bool:
        return bool(self.cfg["train"].get("pretrained_lenient"))

    # -- phases ------------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        t0 = self.now()
        self.profile_start("train")
        if not cfg["train"]["pretrained"] or self.programs is None:
            self.init_model()
        best_loss = float("inf")
        self.epoch = 0
        if cfg["train"].get("resume") and self._on_main(
                lambda: exists(self.cur_weights_path())):
            template = self._whole_tree()
            ckpt = self._on_main(lambda: load_checkpoint(
                self.cur_weights_path(), template,
                expect=self._ckpt_meta(), lenient=self._ckpt_lenient()))
            self.model.load_state_dict(shard_state(self.model,
                                                   ckpt["params"]))
            self.optimizer.load_state_dict(shard_opt_state(
                self.model, self.optimizer, ckpt["opt_state"]))
            self.epoch = int(ckpt["epoch"]) + 1
            self.load_records()
            if not cfg.get("nohup") and self.is_main:
                print(f"[repeat {self.time}] resumed at epoch {self.epoch}")
        h5 = self._maybe_h5_training()
        saver = self._make_saver()
        try:
            self._train_loop(cfg, saver, h5, best_loss)
        finally:
            if saver is not None:
                saver.close()
        self.profile_stop()
        self.train_time = self.now() - t0
        self.epoch = 0
        self.save_records()

    # -- the use_h5 cache's input path -------------------------------------
    def _maybe_h5_training(self):
        """With ``use_h5`` and this repeat's patch cache on disk (written by
        ``dataloader``), train from the cached windows instead of the
        scene (dmfusion's ``dataset_h5`` path): ``(H5DualPrograms over this
        model and optimizer, (ms, pan) on the device, the rows' labels)``,
        or None.  Dual-arity programs only (the cache format is dual), and
        one process: under a ``torch.distributed`` world larger than 1 it
        warns and the run trains from scene gathers, as dmfusion's
        multi-process run does."""
        cfg = self.cfg
        if not cfg.get("use_h5") or type(self.programs) is not DualPrograms:
            return None
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            import warnings
            warnings.warn("use_h5 training input is single-process; the "
                          "multi-process run falls back to scene gathers")
            return None
        path = os.path.join(cfg["RESULT_output"],
                            f"{self.time}_train_patches.h5")
        if not os.path.exists(path):
            return None
        from dmfusion_torch.utils.h5cache import read_h5
        cache = read_h5(path)
        prog = H5DualPrograms(self.model, self.optimizer, cfg,
                              self.scene.width, self.scene.patch)
        args = tuple(torch.from_numpy(cache[k]).to(self.device)
                     for k in ("ms", "pan"))
        return prog, args, cache["label"].astype(np.int32)

    def _h5_row_batches(self, n_rows: int, labels_np: np.ndarray,
                        batch: int):
        """An epoch's shuffled row batches into the patch cache: (ids,
        labels, mask) on the device, from this repeat's generator, as
        dmfusion draws them."""
        perm = self._epoch_rng.permutation(n_rows).astype(np.int32)
        chunks, mask, _ = batched_ids_np(perm, batch)
        labels = labels_np[chunks.reshape(-1)].reshape(chunks.shape)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (chunks, labels, mask.astype(np.float32)))

    def _on_main(self, fn: Callable[[], Any]) -> Any:
        """``fn()``, or under a mesh rank 0's ``fn()`` on every rank
        (``Mesh.from_rank0``)."""
        return fn() if self.mesh is None else self.mesh.from_rank0(fn)

    def _make_saver(self) -> AsyncCheckpointWriter | None:
        """Per-epoch checkpoint writer: a worker thread by default
        (``train.async_save``), synchronous under 'off'."""
        if parse_switch(self.cfg["train"].get("async_save", "auto"),
                        "train.async_save") == "off":
            return None
        return AsyncCheckpointWriter()

    def _whole_tree(self, epoch: int = 0) -> dict:
        """``{"params", "opt_state", "epoch"}`` of the whole model: on the
        model axis the shards and their moments gathered over the model
        group (a collective: every rank calls it), the live tensors
        otherwise.  A checkpoint's layout, and its load's template."""
        return {"params": full_state(self.model),
                "opt_state": full_opt_state(self.model, self.optimizer),
                "epoch": epoch}

    def _save_best(self, saver) -> None:
        best = full_state(self.model, self.best_params)  # every rank
        if not self.is_main:
            return
        if saver is not None:
            saver.save(self.best_weights_path(), best,
                       copy=False, meta=self._ckpt_meta())
        else:
            save_checkpoint(self.best_weights_path(), best,
                            meta=self._ckpt_meta())

    def _save_current(self, saver) -> None:
        tree = self._whole_tree(self.epoch)  # every rank
        if not self.is_main:
            return
        if saver is not None:
            # copy=True: the next epoch's steps update these tensors in place.
            saver.save(self.cur_weights_path(), tree, copy=True,
                       meta=self._ckpt_meta())
        else:
            save_checkpoint(self.cur_weights_path(), tree,
                            meta=self._ckpt_meta())

    def _train_loop(self, cfg, saver, h5, best_loss: float) -> None:
        best_epoch = 0
        save_best = cfg["train"]["save_best"]
        val_batches = None  # the same every epoch: built once
        # A full-batch dense epoch sums over every train anchor once: the
        # batches are built once, and the shuffle generator advances only
        # for them, as in dmfusion.
        reuse_train = getattr(self.programs, "dense_epoch_mode",
                              "minibatch") == "full"
        if h5 is not None:
            prog, prog_args, h5_labels = h5

            def build_train():
                return self._h5_row_batches(len(h5_labels), h5_labels,
                                            cfg["batchsize"])
        else:
            prog, prog_args = self.programs, self.scene_args

            def build_train():
                ids, labels, mask, _ = self.batches(
                    self.split.train, cfg["batchsize"], shuffle=True,
                    trim=self.TRIM_TRAIN)
                return ids, labels, mask.float()

        nxt = build_train()
        while self.epoch < self.EPOCH:
            ep_t0 = self.now()
            ids, labels, mask = nxt
            losses = prog.train_epoch(prog_args, ids, labels, mask)
            # The card may still be running the epoch: build the next
            # epoch's batches first (the same draws as at the top of the
            # next iteration), then fetch the mean loss once.
            if not reuse_train and self.epoch + 1 < self.EPOCH:
                nxt = build_train()
            train_loss = float(losses.mean())
            val_loss = None
            val_oa = None
            stop_early = False
            if save_best:
                if val_batches is None:
                    vids, vlabels, vmask, _ = self.batches(
                        self.split.valid, cfg["color_batchsize"],
                        round_to=self._eval_round_to())
                    val_batches = (vids, vlabels, vmask.float())
                loss_sum, conf = self.programs.eval_epoch(self.scene_args,
                                                          *val_batches)
                if conf.ndim == 3:  # quad: [0] scores the fused prediction
                    conf = conf[0]
                val_loss = float(loss_sum)
                val_oa = float(aa_oa(conf.cpu().numpy())[1])
                if val_loss < best_loss:
                    best_loss = val_loss
                    best_epoch = self.epoch
                    self.best_params = snapshot(self.model.state_dict())
                    self._save_best(saver)
                elif cfg["train"].get("early_stop"):
                    stop_early = True
            self._save_current(saver)
            self.records["Epoch"].append(self.epoch)
            self.records["Loss"].append(train_loss)
            self.records["ValLoss"].append(val_loss)
            self.records.setdefault("ValOA", []).append(val_oa)
            self.records.setdefault("EpochTime", []).append(
                round(self.now() - ep_t0, 4))
            self.save_records()
            if stop_early:
                if not cfg.get("nohup") and self.is_main:
                    print(f"[repeat {self.time}] early stop at epoch "
                          f"{self.epoch}: val {val_loss:.4f} > best "
                          f"{best_loss:.4f} (ep {best_epoch})")
                break
            if not cfg.get("nohup") and self.is_main:
                msg = (f"[repeat {self.time}] epoch {self.epoch} "
                       f"loss {train_loss:.4f}")
                if val_loss is not None:
                    msg += (f" val {val_loss:.4f} OA {val_oa:.4f} "
                            f"(best ep {best_epoch})")
                print(msg)
            self.epoch += 1

    def _load_eval_params(self) -> dict[str, torch.Tensor]:
        """The parameters test and color use: the best ones (in memory, or
        from ``{time}_weights.pt``), or the current ones without
        ``save_best``; on the model axis this rank's shards of them."""
        cfg = self.cfg
        if self.programs is None:
            self.init_model()
        if cfg["train"]["save_best"]:
            if self.best_params is not None:
                return self.best_params
            path = self.best_weights_path()
        else:
            path = self.cur_weights_path()
        template = self._whole_tree()
        return shard_state(self.model, self._on_main(
            lambda: self._read_eval_params(path, template)))

    def _read_eval_params(self, path: str, template: dict
                          ) -> dict[str, torch.Tensor]:
        """The whole parameters in ``path`` (``template``: a whole tree of
        :meth:`_whole_tree`)."""
        cfg = self.cfg
        if not exists(path):
            raise FileNotFoundError(
                f"eval weights not found at {path} (train.index="
                f"{cfg['train']['index']}, train.pretrained="
                f"{cfg['train']['pretrained']}, save_best="
                f"{cfg['train']['save_best']}).  A test/color-only run "
                "needs a prior training run in the SAME result slot — "
                "set train.resume: 1 to reuse the newest unfinished "
                "slot, or train first.")
        if cfg["train"]["save_best"]:
            return load_checkpoint(path, template["params"],
                                   expect=self._ckpt_meta(),
                                   lenient=self._ckpt_lenient())
        ckpt = load_checkpoint(path, template, expect=self._ckpt_meta(),
                               lenient=self._ckpt_lenient())
        return ckpt["params"]

    def _use_eval_params(self) -> None:
        params = self._load_eval_params()  # builds the model when needed
        self.model.load_state_dict(params)

    def _eval_round_to(self) -> int:
        """Eval/predict batch rounding: 4096 anchors on the card, 64 on the
        CPU."""
        return 4096 if self.programs.on_card else 64

    def test(self) -> None:
        cfg = self.cfg
        t0 = self.now()
        self._use_eval_params()
        ids, labels, mask, _ = self.batches(self.split.test,
                                            cfg["test_batchsize"],
                                            round_to=self._eval_round_to())
        conf = self.programs.test_confusion(self.scene_args, ids, labels,
                                            mask.float())
        self.test_matrix = conf.cpu().numpy()
        self.test_time = self.now() - t0
        self.indicator()

    def _predict_ids(self, ids: np.ndarray, batch: int) -> np.ndarray:
        chunks, _, _, n = self.batches(ids, batch,
                                       round_to=self._eval_round_to())
        preds = self.programs.predict(self.scene_args, chunks)
        return preds.cpu().numpy().reshape(-1)[:n]

    def color(self) -> None:
        """Full-scene class maps: map 1 over the labeled pixels, map 2 over
        every pixel (each as configured by ``color.supervised`` and
        ``color.unsupervised``)."""
        cfg = self.cfg
        t0 = self.now()
        self._use_eval_params()
        h, w = self.scene.height, self.scene.width
        label_np1 = np.zeros((h, w), np.int32)
        label_np2 = np.zeros((h, w), np.int32)
        if self.programs.supports_map:
            # One class map of the scene fills both PNGs.
            pred = self.programs.predict_map(*self.scene_args).cpu().numpy()

            def predict(ids):
                return pred[self.scene.ids_to_xy(ids)]
        else:
            def predict(ids):
                return self._predict_ids(ids, cfg["color_batchsize"])
        if cfg["color"]["supervised"]:
            ids = self.split.labeled
            preds = predict(ids)
            x, y = self.scene.ids_to_xy(ids)
            label_np1[x, y] = preds
            label_np2[x, y] = preds
        if cfg["color"]["unsupervised"]:
            ids = self.split.unlabeled
            preds = predict(ids)
            x, y = self.scene.ids_to_xy(ids)
            label_np2[x, y] = preds
        self.color_maps = (label_np1, label_np2)
        if self.is_main:
            palette = torch.tensor(
                cfg["DATA_DICT"][cfg["data_city"]]["color"],
                dtype=torch.uint8)
            os.makedirs(cfg["RESULT_output"], exist_ok=True)
            for tag, lab in (("1", label_np1), ("2", label_np2)):
                img = render_class_map(torch.from_numpy(lab), palette).numpy()
                write_png(os.path.join(cfg["RESULT_output"],
                                       f"{self.time}_pic_{tag}.png"), img)
        self.color_time = self.now() - t0

    def proof(self) -> None:
        """Contourlet band diagnostics (the reference's ``proof()`` /
        ``visualize_channels``, solver/mainsolver.py:245-431): decompose the
        MS and PAN windows of the first ``proof.samples`` labeled anchors
        into the lowband and 4 directional subbands (the transform ct_lstm
        consumes) and write the first window's channels as grids:
        ``{time}_ct_{ms,pan}_{low,dfb}.png`` (at most 16 subband
        channels).  Under a mesh rank 0 renders them alone."""
        if not self.is_main:
            return
        cfg = self.cfg
        n = int(cfg.get("proof", {}).get("samples", 4))
        ids = (self.split.labeled if self.split is not None
               else self.labeled_ids)[:n]
        ids = torch.from_numpy(np.asarray(ids, np.int32)).to(self.device)
        windows = gather_dual(self.scene.ms, self.scene.pan, ids,
                              self.scene.width, self.scene.patch)
        out_dir = cfg["RESULT_output"]
        os.makedirs(out_dir, exist_ok=True)
        for tag, batch in zip(("ms", "pan"), windows):
            low, sub = contourlet_decompose(batch.permute(0, 3, 1, 2))
            for band, x, most in (("low", low, low.shape[1]),
                                  ("dfb", sub, 16)):
                channel_grid(x.permute(0, 2, 3, 1).cpu().numpy(),
                             os.path.join(out_dir,
                                          f"{self.time}_ct_{tag}_{band}.png"),
                             num_channels=min(most, x.shape[1]))

    def visualize(self) -> None:
        """t-SNE scatter of test-split logits coloured by target class
        (dmfusion's ``visualize``, the reference's test-loop diagnostic):
        ``visualize.samples`` test anchors, drawn from
        ``default_rng(seed)`` and sorted, through the eval weights, embedded
        on the run's device (``report/viz.py::embedding_scatter``) and
        written as ``{time}_tsne_test.png``.  Under a mesh every rank
        computes the logits and rank 0 embeds and writes them."""
        cfg = self.cfg
        self._use_eval_params()
        ids = np.asarray(self.split.test, np.int32)
        n = int(cfg.get("visualize", {}).get("samples", 2000))
        if ids.shape[0] > n:
            rng = np.random.default_rng(int(cfg["seed"]))
            ids = np.sort(rng.choice(ids, n, replace=False))
        ids = self._trim_to_mesh(ids)
        labels = self.scene.label.reshape(-1)[ids].astype(np.int32)
        self._scatter(self._anchor_logits(ids), labels, "test")

    def _scatter(self, logits: torch.Tensor, labels: np.ndarray,
                 tag: str) -> None:
        """Rank 0: the t-SNE scatter of ``logits`` as
        ``{time}_tsne_{tag}.png``; its run is kept in ``tsne``."""
        if not self.is_main:
            return
        cfg = self.cfg
        os.makedirs(cfg["RESULT_output"], exist_ok=True)
        path = os.path.join(cfg["RESULT_output"],
                            f"{self.time}_tsne_{tag}.png")
        self.tsne = embedding_scatter(logits, labels, path,
                                      seed=int(cfg["seed"]))

    def _trim_to_mesh(self, ids: np.ndarray) -> np.ndarray:
        """A diagnostic id set trimmed to a multiple of the mesh's ``data``
        size, as dmfusion trims it: its sharded gathers split the batch
        evenly."""
        mesh = getattr(self.programs, "mesh", None)
        if mesh is None:
            return ids
        r = int(mesh.data)
        return ids[:max((ids.shape[0] // r) * r, 0)]

    @torch.inference_mode()
    def _anchor_logits(self, ids: np.ndarray) -> torch.Tensor:
        """(B, C) float32 logits of a small diagnostic id set, on the
        device: the window gather and the forward for the per-anchor
        programs (quad: (4B, C), the four streams' rows stream by stream),
        the anchor-pooled window sums and the head for the dense family (no
        whole-scene map).  Under a mesh every rank's shard, gathered in
        rank order on every rank."""
        prog = self.programs
        prog.model.eval()
        ids_t = torch.from_numpy(np.asarray(ids, np.int32)).to(self.device)
        if isinstance(prog, DensePrograms):
            ms, pan = self.scene_args
            pooled = prog._anchor_pooled_fn(ms.shape[0], ms.shape[1])
            return prog.model.head(pooled(ms, pan, ids_t)).float()
        logits = prog.model(*prog._gather(self.scene_args, ids_t)).float()
        if prog.mesh is None:
            return logits
        streams = 4 if isinstance(prog, QuadPrograms) else 1
        per = logits.shape[0] // streams
        every = prog.mesh.rows(logits.view(streams, per, -1).transpose(0, 1)
                               .contiguous())
        return every[:len(ids)].transpose(0, 1).reshape(
            streams * len(ids), -1)
