"""Scene IO, normalization, padding and label bookkeeping.

Port of ``dmfusion/data/scene.py``.  Reference semantics kept:
  * global min-max normalization (``to_tensor``, function/function.py:120-124),
  * reflect-101 padding of the *bottom/right only* by ``patch-1`` (MS) /
    ``4*patch-1`` (PAN) (``data_padding``, function/function.py:99-117);
    torch's ``F.pad(mode="reflect")`` is reflect-101, like ``jnp.pad``,
  * the labeled/unlabeled split and the explicit-mask 3-way split, in numpy.

The normalized, padded scene lives on the device as NHWC tensors, so
windows are gathered where the model runs (see patches.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from dmfusion_torch.config import resolve_device
from dmfusion_torch.ops.ihs import ihs_transform, pan2ms


def minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    """Global (whole-array) min-max to [0, 1] (reference ``to_tensor``)."""
    lo = x.min()
    hi = x.max()
    return (x - lo) / (hi - lo)


def pad_scene(x: torch.Tensor, patch: int) -> torch.Tensor:
    """Reflect-101 pad bottom/right by ``patch - 1`` on the two leading
    (spatial) dims of an (H, W) or (H, W, C) tensor."""
    # F.pad pads the trailing dims of a (C, H, W) view: W first, then H.
    chw = x.unsqueeze(0) if x.ndim == 2 else x.permute(2, 0, 1)
    out = F.pad(chw, (0, patch - 1, 0, patch - 1), mode="reflect")
    return out[0] if x.ndim == 2 else out.permute(1, 2, 0).contiguous()


def prep_scene(x: torch.Tensor, patch: int, dtype: torch.dtype) -> torch.Tensor:
    """normalize + reflect-pad + cast, on ``x``'s device."""
    return pad_scene(minmax_normalize(x), patch).to(dtype)


def mspan_scene(scene: Scene, seed: int) -> torch.Tensor:
    """The tri arity's third stream: the seeded IHS pansharpen of the raw
    scene at PAN geometry, normalized and padded like PAN, float32 (as
    dmfusion keeps it whatever ``precision.scene_dtype`` says), on the
    scene's device.  The (4H, 4W, C) unpooled intermediate is freed before
    this returns."""
    device = scene.pan.device
    mspan = ihs_transform(
        torch.from_numpy(np.asarray(scene.raw_ms, np.float32)).to(device),
        torch.from_numpy(np.asarray(scene.raw_pan, np.float32)).to(device),
        torch.Generator().manual_seed(int(seed)))
    out = prep_scene(mspan, 4 * scene.patch, torch.float32)
    del mspan
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


GAN_FILES = ("msgan.npy", "pangan.npy")


def load_gan_scenes(gan_dir: str, size: tuple[int, int, int]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The two-stage solver's stage-1 scenes, ``msgan.npy`` (the GAN's
    fake PAN) and ``pangan.npy`` (its fake MS), from ``gan_dir``; a missing
    file raises ``FileNotFoundError``, an array not of the scene's ``size``
    ``ValueError``."""
    arrays = []
    for name in GAN_FILES:
        path = os.path.join(gan_dir, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path}: stage-1 GAN artifact missing (produced by the "
                f"two-stage solver's stage 1)")
        arr = np.load(path)
        if tuple(arr.shape) != tuple(size):
            # The weights dir is shared across runs: refuse another city's
            # fakes rather than gather out-of-bounds windows from them.
            raise ValueError(
                f"dqtl.pre_trained: cached {name} has shape "
                f"{tuple(arr.shape)} but this scene needs {tuple(size)}; "
                f"re-run stage 1 (pre_trained: 0) or point dqtl.WEIGHTS at "
                f"the right artifacts")
        arrays.append(arr)
    return arrays[0], arrays[1]


def quad_streams(scene: Scene, ms_gan: np.ndarray, pan_gan: np.ndarray,
                 device: torch.device) -> tuple[torch.Tensor, ...]:
    """The dqtl arity's four MS-geometry streams (MS, ``pan2ms(PAN)``,
    msgan, pangan), built from the raw scene and the stage-1 scenes as the
    two-stage solver builds them: each normalized, padded like MS and
    float32 (whatever ``precision.scene_dtype`` says), on ``device``."""
    size = (scene.height, scene.width, int(scene.raw_ms.shape[-1]))

    def prep(arr) -> torch.Tensor:
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.asarray(arr, np.float32))
        return prep_scene(arr.to(device, torch.float32), scene.patch,
                          torch.float32)

    pan_ms = pan2ms(torch.from_numpy(np.asarray(scene.raw_pan, np.float32)
                                     ).to(device), size)
    return (prep(scene.raw_ms), prep(pan_ms), prep(ms_gan), prep(pan_gan))


def split_labels(label: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (labeled_ids, unlabeled_ids) as flat row-major pixel indices;
    ``t`` decodes as ``x = t // W, y = t % W``."""
    flat = np.asarray(label).reshape(-1)
    labeled = np.flatnonzero(flat != 0).astype(np.int32)
    unlabeled = np.flatnonzero(flat == 0).astype(np.int32)
    return labeled, unlabeled


def split_labels_masked(train_mask: np.ndarray, test_mask: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Explicit-mask split (reference ``split_data``): train wins over test,
    everything else is unassigned.  Returns (unassigned, train, test) ids."""
    tr = np.asarray(train_mask).reshape(-1) != 0
    te = np.asarray(test_mask).reshape(-1) != 0
    train_ids = np.flatnonzero(tr).astype(np.int32)
    test_ids = np.flatnonzero(~tr & te).astype(np.int32)
    rest = np.flatnonzero(~tr & ~te).astype(np.int32)
    return rest, train_ids, test_ids


@dataclasses.dataclass
class Scene:
    """A device-resident dual-modal scene.

    ms   : (H + ps - 1, W + ps - 1, C)   normalized, padded
    pan  : (4H + 4ps - 1, 4W + 4ps - 1)  normalized, padded
    label: (H, W) uint8 host array (0 = unlabeled/background)
    """

    ms: torch.Tensor
    pan: torch.Tensor
    label: np.ndarray
    height: int
    width: int
    patch: int
    raw_ms: np.ndarray | None = None
    raw_pan: np.ndarray | None = None

    @property
    def num_pixels(self) -> int:
        return self.height * self.width

    def ids_to_xy(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return ids // self.width, ids % self.width


def _read_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is not None:
            return img
    except ImportError:
        pass
    from PIL import Image
    return np.asarray(Image.open(path))


def _read_label(data_dir: str) -> np.ndarray:
    """label.npy, or materialize it from label.mat on first run (reference
    ``label_mat2np``: the hdf5 matrix is transposed and cached)."""
    npy = os.path.join(data_dir, "label.npy")
    if os.path.exists(npy):
        return np.load(npy, allow_pickle=True)
    mat = os.path.join(data_dir, "label.mat")
    try:
        import h5py
        with h5py.File(mat, "r") as f:
            label = np.array(f["label"], dtype=np.uint8).T
    except OSError:  # pre-7.3 .mat
        import scipy.io
        label = np.asarray(scipy.io.loadmat(mat)["label"], dtype=np.uint8)
    np.save(npy, label)
    return label


def _find(data_dir: str, stem: str) -> str:
    for ext in (".tif", ".tiff", ".npy", ".png"):
        p = os.path.join(data_dir, stem + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no {stem}.(tif|npy|png) under {data_dir}")


def scene_dtype(cfg: Mapping[str, Any]) -> torch.dtype:
    """Device scene storage dtype (``precision.scene_dtype``)."""
    name = str(cfg.get("precision", {}).get("scene_dtype", "float32"))
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _device_scene(ms: np.ndarray, pan: np.ndarray, label: np.ndarray,
                  cfg: Mapping[str, Any], device: torch.device) -> Scene:
    ps = cfg["patch_size"]
    sdt = scene_dtype(cfg)
    h, w = label.shape
    ms_n = prep_scene(torch.from_numpy(ms).to(device), ps, sdt)
    pan_n = prep_scene(torch.from_numpy(pan).to(device), 4 * ps, sdt)
    return Scene(ms=ms_n, pan=pan_n, label=label, height=h, width=w,
                 patch=ps, raw_ms=ms, raw_pan=pan)


def load_scene(cfg: Mapping[str, Any],
               device: torch.device | str | None = None) -> Scene:
    """Load (or synthesize) the configured city's scene, normalize + pad
    on ``device`` (default: ``resolve_device(cfg)``).  An empty or missing
    ``data_address`` gives the seeded synthetic scene of the configured
    geometry."""
    device = resolve_device(cfg) if device is None else torch.device(device)
    data_dir = cfg.get("data_address", "")
    if not (data_dir and os.path.isdir(data_dir)):
        return synthetic_scene(cfg, device=device)
    ms = _read_image(_find(data_dir, "ms4")).astype(np.float32)
    pan = _read_image(_find(data_dir, "pan")).astype(np.float32)
    return _device_scene(ms, pan, _read_label(data_dir), cfg, device)


def synthetic_scene(cfg: Mapping[str, Any], seed: int | None = None,
                    device: torch.device | str | None = None) -> Scene:
    """Seeded synthetic MS/PAN/label scene in the ``DATA_DICT`` geometry,
    on ``device`` (default: ``resolve_device(cfg)``).

    The same numpy draws, in the same order, as the JAX package's
    ``synthetic_scene``, so both packages build equal scenes from a seed.
    """
    city = cfg["data_city"]
    h, w, c = cfg["DATA_DICT"][city]["size"]
    ncls = len(cfg["DATA_DICT"][city]["color"])
    rng = np.random.default_rng(cfg["seed"] if seed is None else seed)

    gh, gw = max(h // 32, 8), max(w // 32, 8)
    fields = rng.standard_normal((ncls - 1, gh, gw)).astype(np.float32)
    reps = (-(-h // gh), -(-w // gw))
    up = np.repeat(np.repeat(fields, reps[0], axis=1), reps[1], axis=2)[:, :h, :w]
    label = (np.argmax(up, axis=0) + 1).astype(np.uint8)
    label[rng.random((h, w)) < 0.3] = 0

    base = rng.standard_normal((ncls, c)).astype(np.float32)
    ms = base[np.argmax(up, axis=0) + 1] + 0.25 * rng.standard_normal(
        (h, w, c)).astype(np.float32)
    lum = ms.mean(-1)
    pan = np.repeat(np.repeat(lum, 4, axis=0), 4, axis=1)
    pan = pan + 0.25 * rng.standard_normal(pan.shape).astype(np.float32)
    device = resolve_device(cfg) if device is None else torch.device(device)
    return _device_scene(ms, pan, label, cfg, device)
