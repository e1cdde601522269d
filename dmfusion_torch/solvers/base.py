"""BaseSolver: scene residency, splits, batches, the repeat loop, records.

Port of ``dmfusion/solvers/base.py``.  The scene lives on the run's device
(``resolve_device``: ``cuda:0`` unless ``device: cpu``; under a mesh the
rank's card, ``Mesh.device``).  Splits and
shuffles are numpy draws from ``default_rng(seed + repeat)``, made in the
same order as dmfusion's, so both packages give identical train, test and
valid ids and identical per-epoch batches.  Batches are (steps, B) id,
label and mask tensors, moved to the device once per call.

Under ``torchrun`` with ``mesh.distributed`` (the process group already
up: the CLI starts it) the solver holds the
:class:`~dmfusion_torch.parallel.Mesh` of its ``data`` and ``model``
axes, built from the config as dmfusion's ``get_mesh`` builds its mesh.  Every rank draws the same
splits and batches, as every dmfusion process does; the programs shard
them.  Only rank 0 (``is_main``) writes: the run slot, checkpoints,
records, the matrix, the workbook, PNGs, profiles and the ``use_h5``
patch cache: with ``use_h5`` each repeat's ``dataloader`` writes its train
windows as ``{time}_train_patches.h5`` (``utils/h5cache.py``; ``h5py`` is
needed, and the machine with the card has none, so there it raises
``ImportError``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

import numpy as np
import torch

from dmfusion_torch.config import prepare_run, resolve_device
from dmfusion_torch.data.patches import batched_ids_np
from dmfusion_torch.data.scene import (Scene, load_scene, split_labels,
                                       split_labels_masked)
from dmfusion_torch.ops.metrics import aa_oa
from dmfusion_torch.parallel import get_mesh
from dmfusion_torch.report.excel import expo_result


class Split:
    """Per-repeat index sets (flat row-major pixel ids)."""

    def __init__(self, train: np.ndarray, test: np.ndarray,
                 valid: np.ndarray, labeled: np.ndarray,
                 unlabeled: np.ndarray):
        self.train = train
        self.test = test
        self.valid = valid
        self.labeled = labeled
        self.unlabeled = unlabeled


class BaseSolver:
    def __init__(self, cfg: Mapping[str, Any]):
        cfg = dict(cfg)
        self.mesh = get_mesh(cfg)
        self.is_main = self.mesh is None or self.mesh.is_main
        if "RESULT_output" not in cfg:
            # Ranks probing the result tree at once could pick two slots.
            cfg = (prepare_run(cfg) if self.mesh is None
                   else self.mesh.from_rank0(lambda: prepare_run(cfg)))
        self.cfg = cfg
        self.TIME = cfg["time"]
        self.time = cfg["index"]
        self.EPOCH = cfg["epoch"]
        self.epoch = 0
        self.num_classes = cfg["Categories_Number"]
        self.device = (resolve_device(cfg) if self.mesh is None
                       else self.mesh.device)

        self.scene: Scene = load_scene(cfg, self.device)
        self.labels_flat = self.scene.label.reshape(-1).astype(np.int32)
        self.labeled_ids, self.unlabeled_ids = split_labels(self.scene.label)
        if not cfg.get("nohup") and self.is_main:
            from dmfusion_torch.utils import data_show
            data_show(self.scene.label)

        self.masked_split = None
        if cfg.get("data_new"):
            train_mask = np.load(os.path.join(cfg["data_address"], "train.npy"))
            test_mask = np.load(os.path.join(cfg["data_address"], "test.npy"))
            self.masked_split = split_labels_masked(train_mask, test_mask)

        self.split: Split | None = None
        self.records: dict[str, list] = {"Epoch": [], "Loss": [],
                                         "ValLoss": []}
        self.train_time = 0.0
        self.test_time = 0.0
        self.test_matrix: np.ndarray | None = None

    # -- splits ------------------------------------------------------------
    def dataloader(self) -> None:
        """Re-split for the current repeat: labeled pixels -> train/test/
        valid by train_rate/verify_rate, in the [train, test, valid] order
        over one permutation (or the explicit masks under ``data_new``)."""
        cfg = self.cfg
        self.records = {"Epoch": [], "Loss": [], "ValLoss": []}
        rng = np.random.default_rng(int(cfg["seed"]) + int(self.time))
        if self.masked_split is not None:
            _, train_ids, test_pool = self.masked_split
            perm = rng.permutation(test_pool)
            valid_size = int(cfg["verify_rate"] * len(test_pool))
            test_ids = perm[: len(test_pool) - valid_size]
            valid_ids = perm[len(test_pool) - valid_size:]
            train_ids = rng.permutation(train_ids)
        else:
            n = len(self.labeled_ids)
            perm = rng.permutation(self.labeled_ids)
            train_size = int(cfg["train_rate"] * n)
            valid_size = int(cfg["verify_rate"] * n)
            train_ids = perm[:train_size]
            test_ids = perm[train_size: n - valid_size]
            valid_ids = perm[n - valid_size:]
        self.split = Split(train_ids.astype(np.int32),
                           test_ids.astype(np.int32),
                           valid_ids.astype(np.int32),
                           self.labeled_ids, self.unlabeled_ids)
        self._epoch_rng = rng
        if cfg.get("use_h5") and self.scene.ms is not None and self.is_main:
            # The repeat's train windows as an HDF5 cache (dmfusion's
            # use_h5), once a slot; the two-stage solver has freed the
            # dual scene, and the cache is dual-only.
            path = os.path.join(cfg["RESULT_output"],
                                f"{self.time}_train_patches.h5")
            if not os.path.exists(path):
                from dmfusion_torch.utils.h5cache import save_patches
                os.makedirs(cfg["RESULT_output"], exist_ok=True)
                save_patches(path, self.scene, self.split.train)

    def batches(self, ids: np.ndarray, batch: int, shuffle: bool = False,
                trim: bool = False, round_to: int = 1):
        """-> (ids (steps, B), labels (steps, B), mask (steps, B) bool, n),
        the tensors on the run's device.

        ``round_to`` rounds the batch size up (eval/predict only: the mask
        keeps metrics exact); ``shuffle`` permutes with this repeat's
        generator, so every epoch draws the next permutation.
        """
        if round_to > 1:
            batch = -(-batch // round_to) * round_to
        ids = np.asarray(ids)
        if shuffle:
            ids = self._epoch_rng.permutation(ids)
        if trim and len(ids) >= batch:
            ids = ids[: (len(ids) // batch) * batch]
        chunks_np, mask_np, n = batched_ids_np(ids, batch)
        labels_np = self.labels_flat[chunks_np.reshape(-1)].reshape(
            chunks_np.shape)
        return (torch.from_numpy(chunks_np).to(self.device),
                torch.from_numpy(labels_np).to(self.device),
                torch.from_numpy(mask_np).to(self.device), n)

    # -- reporting ---------------------------------------------------------
    def indicator(self) -> None:
        """Save the confusion matrix and write OA/AA/kappa and per-class
        accuracy into the run workbook (rank 0 writes)."""
        cfg = self.cfg
        self.last_result = result = aa_oa(self.test_matrix)
        if not self.is_main:
            return
        if cfg["test"].get("save_matrix"):
            os.makedirs(cfg["RESULT_output"], exist_ok=True)
            np.save(os.path.join(cfg["RESULT_output"],
                                 f"{self.time}_matrix.npy"), self.test_matrix)
        expo_result(result, cfg, [self.train_time, self.test_time], self.time)

    # -- paths -------------------------------------------------------------
    def best_weights_path(self) -> str:
        return os.path.join(self.cfg["RESULT_output"], f"{self.time}_weights.pt")

    def cur_weights_path(self) -> str:
        return os.path.join(self.cfg["RESULT_output"],
                            f"{self.time}_curweights.pt")

    # -- overridables ------------------------------------------------------
    def train(self):
        raise NotImplementedError

    def test(self):
        raise NotImplementedError

    def color(self):
        raise NotImplementedError

    def proof(self):
        raise NotImplementedError

    def visualize(self):
        raise NotImplementedError

    def run(self):
        """Repeat loop: split, then train, test and color as configured."""
        while self.time < self.TIME:
            self.dataloader()
            if self.cfg["train"]["index"]:
                self.train()
            if self.cfg["test"]["index"]:
                self.test()
            if self.cfg["color"]["index"]:
                self.color()
            if self.cfg.get("proof", {}).get("index"):
                self.proof()
            if self.cfg.get("visualize", {}).get("index"):
                self.visualize()
            self.time += 1

    def save_records(self) -> None:
        """Write this repeat's per-epoch records as JSON next to the
        checkpoints (rank 0)."""
        if not self.is_main:
            return
        os.makedirs(self.cfg["RESULT_output"], exist_ok=True)
        path = os.path.join(self.cfg["RESULT_output"],
                            f"{self.time}_records.json")
        with open(path, "w") as f:
            json.dump(self.records, f)

    def load_records(self) -> None:
        """On resume, reload an earlier process's records, trimmed to the
        epochs below the resume point."""
        path = os.path.join(self.cfg["RESULT_output"],
                            f"{self.time}_records.json")
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                loaded = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(loaded, dict) or not isinstance(
                loaded.get("Epoch"), list):
            return
        keep = [i for i, e in enumerate(loaded["Epoch"])
                if isinstance(e, int) and e < self.epoch]
        self.records = {
            k: [v[i] for i in keep if i < len(v)]
            for k, v in loaded.items() if isinstance(v, list)}
        for k in ("Epoch", "Loss", "ValLoss"):
            self.records.setdefault(k, [])

    # -- profiling ---------------------------------------------------------
    def profile_start(self, tag: str) -> None:
        """Begin a ``torch.profiler`` trace when ``profile.enabled`` is set;
        :meth:`profile_stop` writes it as a Chrome trace under
        ``profile.dir`` (rank 0 only, under a mesh)."""
        prof = self.cfg.get("profile", {})
        if prof.get("enabled") and self.is_main:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._trace_path = os.path.join(prof.get("dir", "profile/"),
                                            f"{tag}_{self.time}",
                                            "trace.json")
            self._profiler = profile(activities=acts)
            self._profiler.start()

    def profile_stop(self) -> None:
        prof = getattr(self, "_profiler", None)
        if prof is not None:
            prof.stop()
            os.makedirs(os.path.dirname(self._trace_path), exist_ok=True)
            prof.export_chrome_trace(self._trace_path)
            self._profiler = None

    @staticmethod
    def now() -> float:
        return time.time()
