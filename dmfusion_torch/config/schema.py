"""Config schema and defaults — a copy of ``dmfusion/config/schema.py``.

The schema is framework-neutral, so the port carries its own copy rather
than importing the JAX package (whose ``__init__`` imports jax).  The
values of :data:`DATA_DICT` and :data:`DEFAULTS` are identical to the JAX
package's, key for key, so one config renders to the same dict in both
packages (``tests/test_torch_config.py``).  Knobs that only the JAX
package reads (Pallas pool, ...) are kept so that configs stay
interchangeable; the port ignores them.  ``mesh`` is read by
:mod:`dmfusion_torch.parallel` (the ``data`` axis).  Of the dense knobs it reads
``dense_streams`` and ``dense_streams_infer`` (band counts), and
``train.dense_epoch``, ``train.dense_remat`` and
``train.dense_hbm_budget``; not ``dense_stream_unroll`` or
``precision.pallas_pool`` (TPU scheduling devices).  ``device`` is read
by :func:`dmfusion_torch.config.resolve_device`.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

# Per-city scene registry: geometry + class palette (palette length == number
# of classes incl. background).  Mirrors reference config.yml:75-108.
DATA_DICT: dict[str, dict[str, Any]] = {
    "image4": {
        "size": [800, 830, 4],
        "color": [[0, 0, 0], [255, 192, 203], [255, 165, 0], [0, 255, 255],
                  [255, 0, 0], [160, 80, 43], [123, 255, 0], [0, 0, 255]],
    },
    "image5": {
        "size": [4541, 4548, 4],
        "color": [[0, 0, 0], [0, 255, 255], [0, 0, 255], [0, 255, 127],
                  [237, 145, 33], [189, 252, 201], [255, 0, 0], [139, 58, 58],
                  [160, 32, 240], [221, 160, 221], [240, 230, 140],
                  [255, 0, 255], [255, 255, 0]],
    },
    "image6": {
        "size": [2001, 2101, 4],
        "color": [[0, 0, 0], [0, 255, 255], [0, 0, 255], [237, 145, 33],
                  [0, 255, 0], [160, 32, 240], [221, 160, 221],
                  [240, 230, 140], [255, 0, 0], [255, 255, 0],
                  [0, 255, 127], [255, 0, 255]],
    },
    "image7": {
        "size": [2000, 2500, 4],
        "color": [[0, 0, 0], [0, 255, 255], [0, 0, 255], [237, 145, 33],
                  [0, 255, 0], [240, 230, 140], [255, 0, 0], [160, 32, 240],
                  [255, 255, 0], [221, 160, 221], [0, 255, 127],
                  [255, 0, 255]],
    },
    "image8": {
        "size": [3408, 4000, 4],
        "color": [[0, 0, 0], [0, 255, 255], [0, 0, 255], [0, 255, 0],
                  [255, 0, 0], [221, 160, 221], [240, 230, 140],
                  [237, 145, 33], [0, 128, 0]],
    },
    "image9": {
        "size": [6905, 7300, 4],
        "color": [[0, 0, 0], [0, 255, 255], [0, 0, 255], [237, 145, 33],
                  [189, 252, 201], [230, 0, 0], [0, 255, 0], [160, 32, 240],
                  [221, 160, 221], [240, 230, 140], [255, 255, 0]],
    },
    "image10": {
        "size": [6905, 7300, 4],
        "color": [[0, 0, 0], [0, 255, 255], [0, 0, 255], [237, 145, 33],
                  [189, 252, 201], [230, 0, 0], [0, 255, 0], [160, 32, 240],
                  [221, 160, 221], [240, 230, 140], [255, 255, 0]],
    },
    # Small synthetic city for tests/benchmarks (not in the reference; it has
    # no test fixtures at all — SURVEY.md §4).
    "synth64": {
        "size": [64, 72, 4],
        "color": [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                  [255, 255, 0]],
    },
}

DQTL_DEFAULTS: dict[str, Any] = {
    # Stage-1 (GAN) schedule.
    "num_epochs": 10,       # used for artifact directory naming
    "epochs": 10,           # GAN epochs actually run
    "pic_size": 128,        # scene tile edge for stage 1
    "lr": 1e-4,
    "batch_size": 4,
    "num_workers": 0,
    # Loss selection and weights (reference tostagesolver.py:30-31,144-155).
    "loss1": "MSE",         # adversarial loss
    "loss2": "L1",          # cycle/identity/cross-reconstruction loss
    "l_cy": 10.0,
    "l_id": 0.5,
    "l_ad": 1.0,
    # Stage-2 quadruplet-KL loss hyperparams (train/loss_function.py:21-76).
    "tao": 0.1,
    "epsilon": 1e-8,
    "alpha": 0.1,
    "beta": 0.0,
    "gamma": 1.0,
    # Encoder/decoder model names for the GAN quartet.
    "encoder_name": "discriminator",
    "decoder_name": "generator",
    # Checkpoint artifact names (reference tostagesolver.py:216-224).
    "WEIGHTS": "dqtl_weights/",
    "check_gH": "gen_p.ckpt",
    "check_gZ": "gen_m.ckpt",
    "check_dH": "disc_p.ckpt",
    "check_dZ": "disc_m.ckpt",
    "load_model": 0,
    "save_model": 0,
    "pre_trained": 0,
}

DEFAULTS: dict[str, Any] = {
    "task": "classification",
    "remark": "none",
    "nohup": 0,
    "data_new": 0,
    "model_name": "gmfnet",
    "solver": "main",          # "main" | "twostage"
    "data_address": "",        # scene directory; empty => synthetic scene
    "delete": 1,
    "gpu_mode": False,         # kept for config-surface compat; unused
    "seed": 3407,              # reference seeds torch with 3407 (test.py:8)
    "expo_result": "Export_result/",
    "FILE_NUM": 0,
    "index": 0,
    "data_city": "image6",
    "gmfnet_pan": "s2d",       # gmfnet PAN branch: "s2d" | "pyramid"
    "use_h5": False,
    "patch_size": 16,
    "Categories_Number": 0,    # derived from palette length when 0
    "device": "tpu",           # "cpu" = CPU; any other value = cuda:0
    "threads": 0,
    "batchsize": 256,
    "test_batchsize": 300,
    "color_batchsize": 300,
    "train_rate": 0.02,
    "verify_rate": 0.02,
    "epoch": 50,
    "time": 5,
    "schedule": {
        "loss": "Criterion",
        "optimizer": "ADAM",
        "if_scheduler": 0,
        "scheduler": "ExponentialLR",
        "activate": "Relu",
        "lr": 1e-3,
        "base_lr": 5e-4,
        "momentum": 0.9,       # SGD (reference utils/utils.py:14)
        "alpha": 0.99,         # RMSprop (reference utils/utils.py:16)
    },
    "train": {"index": 1, "pretrained": 0, "save_best": True,
              "pretrained_lenient": 0,
              "early_stop": 0,
              "dense_remat": "auto",
              "dense_hbm_budget": 0,
              "dense_epoch": "auto",
              "async_save": "auto"},
    "test": {"index": 1, "save_matrix": 1},
    "color": {"index": 0, "supervised": 1, "unsupervised": 1},
    "proof": {"index": 0, "samples": 4},
    "visualize": {"index": 0, "samples": 2000},
    "trans": {
        "patch_size": 1,
        "window_size": 2,
        "embed_dim": 96,
        "depth": 2,
        "num_head": 3,
        "depths": [2, 4],
        "num_heads": [3, 3],
    },
    "dqtl": DQTL_DEFAULTS,
    "DATA_DICT": DATA_DICT,
    "mesh": {
        "data": -1,
        "model": 1,
        "distributed": 0,
    },
    "precision": {
        "compute_dtype": "bfloat16",   # forward compute (bf16 autocast)
        "param_dtype": "float32",      # parameters
        "scene_dtype": "float32",      # device-resident scene storage
        "pallas_pool": "auto",
    },
    "dense_streams": "auto",
    "dense_streams_infer": "auto",
    "dense_stream_unroll": 1,
    "conv_streams": "auto",
    "eval_scan_anchors": "auto",
    "profile": {"enabled": 0, "dir": "profile/"},
    "debug": {"nans": 0},
}

_NUMERIC_COERCIONS = (
    # (path, cast) — mirrors reference get_dump_config's ad-hoc coercions
    # (utils/config.py:82-87) but applied uniformly.
    (("schedule", "lr"), float),
    (("schedule", "base_lr"), float),
    (("Categories_Number",), int),
    (("dqtl", "lr"), float),
    (("dqtl", "tao"), float),
    (("dqtl", "epsilon"), float),
    (("train_rate",), float),
    (("verify_rate",), float),
    (("epoch",), int),
    (("time",), int),
    (("batchsize",), int),
    (("test_batchsize",), int),
    (("color_batchsize",), int),
    (("patch_size",), int),
    (("seed",), int),
)


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def validate(cfg: Mapping[str, Any]) -> dict[str, Any]:
    """Merge ``cfg`` over the defaults, coerce numerics, derive class count.

    Unlike the reference (which crashes with ``KeyError`` on its own shipped
    YAML), unknown keys are kept and missing ones are defaulted.
    """
    out = _deep_merge(DEFAULTS, cfg)
    for path, cast in _NUMERIC_COERCIONS:
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = cast(node[path[-1]])
    city = out["data_city"]
    if city not in out["DATA_DICT"]:
        raise ValueError(f"unknown data_city {city!r}; known: "
                         f"{sorted(out['DATA_DICT'])}")
    palette = out["DATA_DICT"][city]["color"]
    if not out["Categories_Number"]:
        out["Categories_Number"] = len(palette)
    if out["Categories_Number"] != len(palette):
        raise ValueError(
            f"Categories_Number={out['Categories_Number']} does not match "
            f"palette length {len(palette)} for {city}")
    if out["patch_size"] <= 0:
        raise ValueError("patch_size must be positive")
    if not 0.0 <= out["train_rate"] <= 1.0 or not 0.0 <= out["verify_rate"] <= 1.0:
        raise ValueError("train_rate/verify_rate must lie in [0, 1]")
    return out
