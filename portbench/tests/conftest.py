"""Tests of the benchmark harness.  They run on the CPU at small sizes;
tests marked ``gpu`` need the card and skip without it (decided inside
the ``card`` fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def root():
    return ROOT


#: Small sizes of the three cells: the same files, with the scene cut to
#: the port's ``synth64`` city (5 classes), narrower models where the
#: check still tells the control from the program, and for maps more
#: scenes in the sample so that it holds as many pixels as one map of a
#: larger scene.
_SMALL = {"city": "synth64", "scene_size": [64, 72, 4], "classes": 5}
SMALL_OVER = {
    "gmfnet.serve-b4096": {"config": dict(_SMALL, model_width=16),
                           "traffic": {"anchors_per_request": 256}},
    "dense_fusion.map-image6": {"config": dict(_SMALL, model_width=32),
                                "traffic": {"scenes": 8},
                                "limits": {"sample": 8}},
    "dense_fusion.train-b256": {"config": dict(_SMALL, model_width=32,
                                               batchsize=64),
                                "traffic": {"train_anchors": 400}},
}


@pytest.fixture(scope="session")
def small_over():
    return SMALL_OVER
