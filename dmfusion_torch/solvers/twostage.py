"""TwoStageSolver: the two-stage (DQTL) workflow.

Port of ``dmfusion/solvers/twostage.py`` (reference
solver/tostagesolver.py).

Stage 1 tiles the scene (MS, and PAN brought to the MS geometry by
``pan2ms`` with the ``pan.npy`` cache; each min-max normalized, then cut
into ``dqtl.pic_size`` tiles with a reflect-101 pad), trains the
noise-conditioned GAN quartet on them (``train/gan.py::GanPrograms``),
saves the four nets under ``dqtl.save_model``, and reassembles the last
epoch's fakes into two scenes of the MS geometry, ``msgan.npy`` and
``pangan.npy``, under ``expo_result/dqtl.WEIGHTS``, with their renders and
the sample grids.  The reference's naming is kept: ``ms_gan`` assembles
gen_P's outputs (the fake PAN) and ``pan_gan`` gen_M's (the fake MS).

Stage 2 builds four aligned MS-geometry streams from the raw scene and
those arrays (MS, ``pan2ms(PAN)``, msgan, pangan; each normalized, padded
and float32 on the run's device) and trains the shared ``dqtl`` classifier
on them with the quadruplet KL loss (``QuadPrograms``); test scores the
fused prediction and each stream on its own (the workbook's ``streams``
sheet); color predicts by the fused rule.

``dqtl.pre_trained`` loads the cached arrays and skips stage 1
(tostagesolver.py:242-246).  The cached artifacts are shared by the runs
of one ``expo_result``, so each is checked: a ``pan.npy`` of another
shape is recomputed, msgan/pangan of another shape are refused, and a GAN
checkpoint's stamp must match the run's (``_gan_meta``).

Under a mesh (``torchrun``, ``mesh.distributed``) both stages run on every
rank, as dmfusion's do on its mesh: stage 1 rounds ``dqtl.batch_size`` up
to a multiple of the data axis's ranks
(``dmfusion/solvers/twostage.py:138-142``) and
trains ``GanPrograms`` on each rank's shard of every tile batch; every
rank rebuilds msgan and pangan from the gathered fakes, since stage 2
needs them; stage 2 trains ``QuadPrograms`` on each rank's shard.  Rank 0
alone touches the weights dir: the ``pan.npy`` cache, the GAN checkpoints
(read and broadcast under ``dqtl.load_model``), msgan/pangan, their
renders and sample grids; and, as in the main solver, the result tree, the
workbook and its ``streams`` sheet.  On a ``data x model`` mesh
(``mesh.model > 1``) the parameters of both stages stay replicated, as
dmfusion's two-stage solver keeps them (it never calls ``shard_params``):
the batches shard over the data index, every gradient sum, mean and row
gather runs on the rank's data group, and the model peers of a data index
compute the same steps and take the first peer's gradients
(``Mesh.sync_peers_``), so they hold the same parameters after each.
``visualize`` scatters the four streams' logits of ``visualize.samples //
4`` train anchors (``{time}_tsne_streams.png``); ``proof`` keeps its
refusal.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dmfusion_torch.data.scene import (load_gan_scenes, minmax_normalize,
                                       quad_streams)
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.registry import build_model
from dmfusion_torch.ops.ihs import pan2ms
from dmfusion_torch.ops.image import (render_tensor, scene_to_tiles,
                                      tiles_to_scene)
from dmfusion_torch.ops.metrics import per_stream_results
from dmfusion_torch.parallel import check_model
from dmfusion_torch.report.excel import expo_stream_results
from dmfusion_torch.report.png import write_png
from dmfusion_torch.report.viz import save_image_grid
from dmfusion_torch.solvers.main import Solver
from dmfusion_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dmfusion_torch.train.gan import GanPrograms, NoiseFn
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import QuadPrograms

# The GAN quartet: each net's key, and its file name's key under ``dqtl``.
GAN_NETS = {"gP": "check_gH", "gM": "check_gZ", "dP": "check_dH",
            "dM": "check_dZ"}


class TwoStageSolver(Solver):
    TRIM_TRAIN = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.ms_gan: np.ndarray | None = None
        self.pan_gan: np.ndarray | None = None
        self.stream_matrices: np.ndarray | None = None
        self.gan_programs: GanPrograms | None = None
        #: Stage 1's noise draw; None draws from a generator seeded with
        #: ``seed + 1`` on the run's device (the tests inject JAX's draws).
        self.gan_noise: NoiseFn | None = None
        #: Stage 1's per-epoch losses, its batch and its times (s).
        self.stage1_log: dict[str, list | float] = {}
        self._stage2_ready = False

    # -- artifact paths ----------------------------------------------------
    def _weights_dir(self) -> str:
        d = os.path.join(self.cfg["expo_result"], self.cfg["dqtl"]["WEIGHTS"])
        if self.is_main:
            os.makedirs(d, exist_ok=True)
        return d

    def _gan_ckpt(self, which: str) -> str:
        return os.path.join(self._weights_dir(),
                            self.cfg["dqtl"][GAN_NETS[which]])

    def _gan_meta(self, which: str) -> dict:
        """The identity stamp of a GAN quartet file (the weights dir is
        shared across runs, the same staleness class as msgan.npy)."""
        d = self.cfg["dqtl"]
        name = d["decoder_name"] if which in ("gP", "gM") \
            else d["encoder_name"]
        return {"model": str(name),
                "width": int(self.cfg.get("gan_width", 32)), "role": which}

    # -- stage 1 -----------------------------------------------------------
    def _stage1_tiles(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        """Scene -> normalized ``pic_size`` tiles of both modalities
        (reference ``data_process_dqtl_stage1``): (ms tiles, pan tiles,
        rows, cols), float32 host arrays."""
        cfg = self.cfg
        s = self.scene
        pic = int(cfg["dqtl"]["pic_size"])
        size = (s.height, s.width, int(s.raw_ms.shape[-1]))
        pan_npy = os.path.join(cfg["data_address"] or self._weights_dir(),
                               "pan.npy")

        def cached() -> np.ndarray:
            pms = None
            if os.path.exists(pan_npy):
                pms = np.load(pan_npy)
                if pms.shape != size:
                    # A cache of another city or geometry: the weights dir
                    # is not keyed by city.
                    print(f"[stage1] ignoring stale pan.npy cache "
                          f"{pms.shape} != {size}")
                    pms = None
            if pms is None:
                pan = torch.from_numpy(np.asarray(s.raw_pan, np.float32))
                pms = pan2ms(pan.to(self.device), size).cpu().numpy()
                np.save(pan_npy, pms)
            return pms

        pms = self._on_main(cached)

        def norm(x: np.ndarray) -> np.ndarray:
            return minmax_normalize(torch.from_numpy(
                np.asarray(x, np.float32))).numpy()

        ms_tiles, rows, cols = scene_to_tiles(norm(s.raw_ms), pic)
        pan_tiles, _, _ = scene_to_tiles(norm(pms), pic)
        return ms_tiles, pan_tiles, rows, cols

    def init_stage1_model(self) -> None:
        """The GAN quartet on the run's device, seeded from ``seed`` (gP,
        gM, dP, dM in that order); with ``dqtl.load_model`` each net whose
        file exists loads it, its stamp checked."""
        cfg = self.cfg
        d = cfg["dqtl"]
        nets = {}
        for which in GAN_NETS:
            net = build_model(cfg, self._gan_meta(which)["model"])
            if self.device.type == "cuda":
                net = net.to(self.device, memory_format=torch.channels_last)
            nets[which] = net
        self.gan_programs = GanPrograms(nets["gP"], nets["gM"], nets["dP"],
                                        nets["dM"], cfg, noise=self.gan_noise,
                                        mesh=self.mesh)
        self.gan_programs.init(torch.Generator().manual_seed(int(cfg["seed"])))
        if d.get("load_model"):
            for which, net in nets.items():
                path = self._gan_ckpt(which)

                def read(path=path, which=which, net=net):
                    if not os.path.exists(path):
                        return None
                    return load_checkpoint(
                        path, net.state_dict(), expect=self._gan_meta(which),
                        lenient=self._ckpt_lenient())
                state = self._on_main(read)
                if state is not None:
                    net.load_state_dict(state)

    def train_stage1(self) -> None:
        """Train the GAN quartet for ``dqtl.epochs`` on the scene's tiles,
        save it under ``dqtl.save_model``, and write msgan.npy and
        pangan.npy (and their renders) from the last epoch's fakes.  Under
        a mesh the batch is ``dqtl.batch_size`` rounded up to a multiple of
        the ranks."""
        cfg = self.cfg
        d = cfg["dqtl"]
        log = self.stage1_log = {"epoch_s": [], "d_loss": [], "g_loss": []}
        t_start = t0 = self.now()
        ms_tiles, pan_tiles, rows, cols = self._stage1_tiles()
        bs = int(d["batch_size"])
        if self.mesh is not None:
            bs = -(-bs // self.mesh.data) * self.mesh.data
        log["batch"] = bs
        n = ms_tiles.shape[0]
        steps = -(-n // bs)
        # Pad the tile list by wrapping so that every batch is full; the
        # reassembly below keeps the first n.
        idx = np.arange(steps * bs) % n

        def batches(tiles: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(tiles[idx]).to(self.device).reshape(
                steps, bs, *tiles.shape[1:])

        m_b, p_b = batches(ms_tiles), batches(pan_tiles)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log["tiles_s"] = self.now() - t0
        self.init_stage1_model()
        last = None
        n_epochs = int(d["epochs"])
        for epoch in range(n_epochs):
            t0 = self.now()
            # Fakes only where something reads them: the last epoch's all
            # (the scenes), a sample epoch's first batch (the grids).
            sample = epoch == 0 or epoch % 20 == 19
            collect = ("all" if epoch == n_epochs - 1
                       else "first" if sample else "none")
            out = self.gan_programs.train_epoch(m_b, p_b, collect)
            d_loss, g_loss = (out[k].cpu().tolist()
                              for k in ("d_loss", "g_loss"))
            log["epoch_s"].append(self.now() - t0)
            log["d_loss"].append(d_loss)
            log["g_loss"].append(g_loss)
            if collect == "all":
                last = out
            if sample and self.is_main:
                self._save_gan_samples(epoch, out, m_b, p_b)
            if not cfg.get("nohup") and self.is_main:
                print(f"[stage1] epoch {epoch} d_loss {d_loss[-1]:.4f} "
                      f"g_loss {g_loss[-1]:.4f}")
        t0 = self.now()
        if d.get("save_model") and self.is_main:
            for which, net in self.gan_programs.nets.items():
                save_checkpoint(self._gan_ckpt(which), net.state_dict(),
                                meta=self._gan_meta(which))
        # The last epoch's fakes as scenes.  The reference's naming:
        # ms_gan <- fake_pan, pan_gan <- fake_ms.
        size = (self.scene.height, self.scene.width)
        fp, fm = (last[k].reshape(steps * bs, *ms_tiles.shape[1:])[:n]
                  .cpu().numpy() for k in ("fake_pan", "fake_ms"))
        self.ms_gan = tiles_to_scene(fp, rows, cols, size)
        self.pan_gan = tiles_to_scene(fm, rows, cols, size)
        if self.is_main:
            wdir = self._weights_dir()
            np.save(os.path.join(wdir, "msgan.npy"), self.ms_gan)
            np.save(os.path.join(wdir, "pangan.npy"), self.pan_gan)
            # Whole-scene renders of the fakes (reference
            # tostagesolver.py:228-231).
            for name, arr in (("fake_ms.png", self.ms_gan),
                              ("fake_pan.png", self.pan_gan)):
                write_png(os.path.join(wdir, name),
                          render_tensor(arr.transpose(2, 0, 1)))
        log["scenes_s"] = self.now() - t0
        log["stage1_s"] = self.now() - t_start

    def _save_gan_samples(self, epoch: int, out: dict, m_b: torch.Tensor,
                          p_b: torch.Tensor) -> None:
        """Sample-tile grids: the fakes, and on epoch 0 the real tiles they
        imitate."""
        t0 = self.now()
        sample_dir = os.path.join(self._weights_dir(), "saved_images")
        os.makedirs(sample_dir, exist_ok=True)

        def norm(x: torch.Tensor) -> np.ndarray:
            if x.ndim == 5:       # stacked (steps, B, ...) -> first batch
                x = x[0]
            x = x[:8].cpu().numpy()
            lo, hi = x.min(), x.max()
            return (x - lo) / (hi - lo + 1e-12)

        grids = {f"f_p_{epoch}.png": out["fake_pan"],
                 f"f_m_{epoch}.png": out["fake_ms"]}
        if epoch == 0:
            grids.update({"p.png": p_b, "m.png": m_b})
        for name, x in grids.items():
            save_image_grid(norm(x), os.path.join(sample_dir, name))
        self.stage1_log["samples_s"] = (self.stage1_log.get("samples_s", 0.0)
                                        + self.now() - t0)

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
            self.train_stage1()
        self.scene_args = quad_streams(s, self.ms_gan, self.pan_gan,
                                       self.device)
        s.ms = s.pan = None
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
        if self.mesh is not None:
            check_model(model)
        init_params(model, torch.Generator().manual_seed(
            int(cfg["seed"]) + int(self.time)))
        self.model = model
        n_train = len(self.split.train) if self.split else 1
        steps_per_epoch = max(1, -(-max(1, n_train) // cfg["batchsize"]))
        self.optimizer = make_optimizer(cfg, model.parameters(),
                                        steps_per_epoch)
        # qua_loss whatever schedule.loss says (reference tostagesolver.py).
        self.programs = QuadPrograms(model, self.optimizer, cfg,
                                     self.scene.width, self.scene.patch,
                                     mesh=self.mesh)

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
            if self.is_main:
                expo_stream_results(self.stream_results, self.cfg, self.time)

    def visualize(self) -> None:
        """The four streams' scatter (dmfusion's ``visualize``, the
        reference's ``visualize_extract``): ``visualize.samples // 4``
        train anchors, drawn from ``default_rng(seed)`` and sorted, through
        all four streams, their logits coloured by stream (M, PAN, GM, GP,
        the legend's swatches in that order): whether the quadruplet loss
        pulled the modalities together.  Written as
        ``{time}_tsne_streams.png`` by rank 0."""
        cfg = self.cfg
        self._use_eval_params()
        ids = np.asarray(self.split.train, np.int32)
        n = max(1, int(cfg.get("visualize", {}).get("samples", 2000)) // 4)
        if ids.shape[0] > n:
            rng = np.random.default_rng(int(cfg["seed"]))
            ids = np.sort(rng.choice(ids, n, replace=False))
        ids = self._trim_to_mesh(ids)
        self._scatter(self._anchor_logits(ids),
                      np.repeat(np.arange(4), ids.shape[0]), "streams")

    def proof(self) -> None:
        """Not a phase of this solver: stage 2 frees the dual scene, as
        dmfusion's does (whose inherited ``proof`` then fails on the freed
        PAN)."""
        raise NotImplementedError(
            "proof: the two-stage solver frees the MS and PAN scenes for "
            "stage 2 and renders no contourlet bands; run proof with the "
            "main solver")

    def run(self) -> None:
        """Stage-2 setup once, then the repeat loop."""
        self.train_stage2_setup()
        super().run()
