"""TwoStageSolver: stage 2 of the two-stage (DQTL) workflow.

Port of ``dmfusion/solvers/twostage.py``'s stage 2 (reference
solver/tostagesolver.py).  Stage 1 trains a GAN quartet and writes two
scenes of the MS geometry, ``msgan.npy`` (its fake PAN) and ``pangan.npy``
(its fake MS), under ``expo_result/dqtl.WEIGHTS``.  Stage 2 builds four
aligned MS-geometry streams from the raw scene and those arrays (MS,
``pan2ms(PAN)``, msgan, pangan; each normalized, padded and float32 on the
run's device) and trains the shared ``dqtl`` classifier on them with the
quadruplet KL loss (``QuadPrograms``); test scores the fused prediction
and each stream on its own (the workbook's ``streams`` sheet); color
predicts by the fused rule.

``dqtl.pre_trained`` loads the cached arrays and skips stage 1
(tostagesolver.py:242-246).  Stage 1 itself is not ported yet: without
``pre_trained`` the run raises ``NotImplementedError`` naming ROADMAP A11.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dmfusion_torch.data.scene import load_gan_scenes, quad_streams
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.registry import build_model
from dmfusion_torch.ops.metrics import per_stream_results
from dmfusion_torch.report.excel import expo_stream_results
from dmfusion_torch.solvers.main import Solver
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import QuadPrograms


class TwoStageSolver(Solver):
    TRIM_TRAIN = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.ms_gan: np.ndarray | None = None
        self.pan_gan: np.ndarray | None = None
        self.stream_matrices: np.ndarray | None = None
        self._stage2_ready = False

    def _weights_dir(self) -> str:
        d = os.path.join(self.cfg["expo_result"], self.cfg["dqtl"]["WEIGHTS"])
        os.makedirs(d, exist_ok=True)
        return d

    # -- stage 2 -----------------------------------------------------------
    def train_stage2_setup(self) -> None:
        """Load the GAN scenes, build the four streams on the device, and
        free the dual scene's tensors (every stream is MS-geometry)."""
        cfg = self.cfg
        s = self.scene
        size = (s.height, s.width, int(s.raw_ms.shape[-1]))
        if cfg["dqtl"].get("pre_trained"):
            self.ms_gan, self.pan_gan = load_gan_scenes(self._weights_dir(),
                                                        size)
        elif self.ms_gan is None:
            raise NotImplementedError(
                "dqtl.pre_trained: 0 trains the GAN quartet of stage 1, "
                "which is not ported to dmfusion_torch yet (ROADMAP A11, "
                "stage 1); set dqtl.pre_trained=1 with msgan.npy and "
                f"pangan.npy in {self._weights_dir()}")
        self.scene_args = quad_streams(s, self.ms_gan, self.pan_gan,
                                       self.device)
        # Keep MS only for the proof phase (dual contourlet diagnostics).
        if not cfg.get("proof", {}).get("index"):
            s.ms = None
        s.pan = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._stage2_ready = True

    def init_model(self) -> None:
        cfg = self.cfg
        if not self._stage2_ready:
            self.train_stage2_setup()
        model = build_model(cfg)
        if self.device.type == "cuda":
            model = model.to(self.device, memory_format=torch.channels_last)
        init_params(model, torch.Generator().manual_seed(
            int(cfg["seed"]) + int(self.time)))
        self.model = model
        n_train = len(self.split.train) if self.split else 1
        steps_per_epoch = max(1, -(-max(1, n_train) // cfg["batchsize"]))
        self.optimizer = make_optimizer(cfg, model.parameters(),
                                        steps_per_epoch)
        # qua_loss whatever schedule.loss says (reference tostagesolver.py).
        self.programs = QuadPrograms(model, self.optimizer, cfg,
                                     self.scene.width, self.scene.patch)

    # -- phases ------------------------------------------------------------
    def test(self) -> None:
        cfg = self.cfg
        t0 = self.now()
        self._use_eval_params()
        ids, labels, mask, _ = self.batches(self.split.test,
                                            cfg["test_batchsize"],
                                            round_to=self._eval_round_to())
        _, confs = self.programs.eval_epoch(self.scene_args, ids, labels,
                                            mask.float())
        confs = confs.cpu().numpy()
        self.test_matrix = confs[0]         # the fused prediction
        self.stream_matrices = confs[1:]    # MS, PAN, GM, GP on their own
        self.test_time = self.now() - t0
        self.indicator()

    def indicator(self) -> None:
        """The fused block, then the per-stream OA/AA/kappa ``streams``
        sheet."""
        super().indicator()
        if self.stream_matrices is not None:
            self.stream_results = per_stream_results(
                list(self.stream_matrices))
            expo_stream_results(self.stream_results, self.cfg, self.time)

    def run(self) -> None:
        """Stage-2 setup once, then the repeat loop."""
        self.train_stage2_setup()
        super().run()
