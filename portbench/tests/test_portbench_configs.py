"""A configuration file renders to the port's config and to its reference's
parameters: a file without ``trans`` exactly as before the block existed,
and a transformer's file with its own ``trans`` widths."""

import hashlib
import json
import math

import pytest
import torch

from portbench import system
from portbench.bench import Benchmark

#: Parameter count, element count and sha256 of the JSON of ``[[name,
#: shape, kind], ...]`` of each configuration's ``param_spec``, as the
#: reference listed them from ``model_width``, the scene's channels and
#: ``classes`` before a configuration could carry ``trans``.
SPEC = {
    "gmfnet-w64-p16": (
        64, 1644428,
        "4ba8a2c7ad7f12e4abc1498bf80ed52e062ca87ae97f2fb9ed83ee7cc8f9ebf6"),
    "dense_fusion-w32-p16": (
        52, 821616,
        "748f172a8b25c19a2c9990908649917de672dcada890f401863908ddf6db0a86"),
}

#: Swin-T (Liu et al. 2021, configs/swin/swin_tiny_patch4_window7_224.yaml)
#: as swin_t_dual at patch 56: a 224 x 224 PAN window, conv-pooled 4x to
#: Swin-T's 56 x 56 stage-1 token grid.
SWIN_T = {
    "name": "swin_t_dual-p56", "model_name": "swin_t_dual",
    "reference": "swin_t_dual", "model_width": 64, "patch_size": 56,
    "city": "image6", "scene_size": [2001, 2101, 4], "classes": 12,
    "scene_dtype": "float32", "compute_dtype": "bfloat16",
    "param_dtype": "float32", "activate": "Relu", "optimizer": "ADAM",
    "lr": 0.001, "batchsize": 256,
    "trans": {"window_size": 7, "embed_dim": 96, "depths": [2, 2, 6, 2],
              "num_heads": [3, 6, 12, 24]},
}


def _overrides_without_trans(config, device):
    """The port's overrides as a configuration file without ``trans``
    rendered them: a fixed list of keys."""
    return {
        "model_name": config["model_name"],
        "model_width": int(config["model_width"]),
        "gmfnet_pan": config.get("gmfnet_pan", "s2d"),
        "patch_size": int(config["patch_size"]),
        "data_city": config["city"],
        "batchsize": int(config["batchsize"]),
        "seed": 0,
        "nohup": True,
        "device": "cpu" if device.type == "cpu" else "cuda",
        "precision": {"compute_dtype": config["compute_dtype"],
                      "param_dtype": config["param_dtype"],
                      "scene_dtype": config["scene_dtype"]},
        "schedule": {"activate": config["activate"],
                     "optimizer": config["optimizer"],
                     "lr": float(config["lr"]), "if_scheduler": 0},
        "train": {"dense_remat": config.get("dense_remat", "auto")},
    }


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", sorted(SPEC))
def test_a_file_without_trans_renders_as_before(root, name, device):
    from dmfusion_torch.config import load_config

    config = Benchmark(root).config(name)
    assert "trans" not in config
    dev = torch.device(device)
    assert system.port_config(config, dev) == load_config(
        overrides=_overrides_without_trans(config, dev))
    spec = system.param_spec(config)
    blob = json.dumps([[n, list(s), k] for n, s, k in spec])
    assert (len(spec), sum(math.prod(s) for _, s, _ in spec),
            hashlib.sha256(blob.encode()).hexdigest()) == SPEC[name]


def test_swin_t_renders_with_its_own_trans():
    from dmfusion_torch.models import build_model

    cfg = system.port_config(SWIN_T, torch.device("cpu"))
    for key, value in SWIN_T["trans"].items():
        assert cfg["trans"][key] == value, key
    with torch.device("meta"):
        model = build_model(cfg)
    assert next(model.parameters()).device.type == "meta"
    for enc in (model.ms_encoder, model.pan_encoder):
        assert tuple(enc.pos.shape) == (1, 56, 56, 96)
        assert [len(s) for s in enc.stages] == [2, 2, 6, 2]
        assert [s[0].attn.heads for s in enc.stages] == [3, 6, 12, 24]
        assert [s[0].norm1.weight.shape[0] for s in enc.stages] == [
            96, 192, 384, 768]
        assert all(b.ws == 7 for s in enc.stages for b in s)
        # A shifted block's mask has one (49, 49) slab a window: the
        # stage's grid is 7 windows' sqrt across.
        grids = [7 * math.isqrt(s[1].mask.shape[0]) for s in enc.stages]
        assert grids == [56, 28, 14, 7]
        assert enc.out_dim == 768


def test_an_unknown_trans_key_is_refused():
    config = dict(SWIN_T, trans=dict(SWIN_T["trans"], window=7))
    with pytest.raises(ValueError, match="window"):
        system.port_config(config, torch.device("cpu"))
