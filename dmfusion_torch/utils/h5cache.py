"""The ``use_h5`` patch cache: HDF5 files of pre-gathered train windows.

Port of ``dmfusion/utils/h5cache.py``.  With ``use_h5`` the solver's
``dataloader`` writes the repeat's train windows (:func:`save_patches`)
and ``Solver.train`` trains from them by row (``train/steps.py::
H5DualPrograms``), as dmfusion does.  The file holds dmfusion's keys,
shapes and dtypes: ``ms`` (N, ps, ps, 4) and ``pan`` (N, 4ps, 4ps, 1) in
the scene's dtype, ``label`` (N,) uint8 and ``xy`` (N, 2) int32, so
either package reads the other's.  ``h5py`` is imported only to read or
write a file: :func:`gather_patches` gives the same arrays without it.
"""

from __future__ import annotations

import numpy as np
import torch

from dmfusion_torch.data.patches import gather_dual


def save_h5(filename: str, **arrays: np.ndarray) -> None:
    import h5py
    with h5py.File(filename, "w") as f:
        for key, value in arrays.items():
            f[key] = np.asarray(value)


def read_h5(filename: str) -> dict[str, np.ndarray]:
    import h5py
    out = {}
    with h5py.File(filename, "r") as f:
        for key in f.keys():
            out[key] = np.array(f[key])
    return out


def gather_patches(scene, ids: np.ndarray) -> dict[str, torch.Tensor]:
    """The cache's four arrays for anchor ``ids``, on the scene's device:
    the plain ``gather_dual`` windows ``ms`` and ``pan``, each anchor's
    ``label`` and its ``xy`` (row, column)."""
    ids = np.asarray(ids, np.int32)
    dev = scene.ms.device
    ms_p, pan_p = gather_dual(scene.ms, scene.pan,
                              torch.from_numpy(ids).to(dev), scene.width,
                              scene.patch)
    x, y = scene.ids_to_xy(ids)
    return {"ms": ms_p, "pan": pan_p,
            "label": torch.from_numpy(scene.label.reshape(-1)[ids]).to(dev),
            "xy": torch.from_numpy(np.stack([x, y], axis=1)).to(dev)}


def save_patches(filename: str, scene, ids: np.ndarray) -> None:
    """Write the cache of anchor ``ids`` (the reference's ``dataset_cut``
    and ``save_h5``)."""
    save_h5(filename, **{k: v.cpu().numpy()
                         for k, v in gather_patches(scene, ids).items()})
