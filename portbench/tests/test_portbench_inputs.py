"""Inputs come from ``--seed`` alone: the same seed gives the same scene,
weights, requests and epochs; another seed gives others."""

import numpy as np
import pytest
import torch

from portbench import scenes, seeds, system, weights
from portbench.bench import Benchmark

CPU = torch.device("cpu")


def test_derived_seeds_are_stable_and_distinct():
    big = 2**31 + 12345
    assert seeds.derive(big, "weights") == seeds.derive(big, "weights")
    assert seeds.derive(big, "weights") != seeds.derive(big, "traffic")
    assert seeds.derive(big, "weights") != seeds.derive(big + 1, "weights")
    assert 0 <= seeds.derive(-5, "x") < 2**63
    assert 0 <= seeds.derive(2**70, "x") < 2**63


def test_scene_is_seeded():
    a = scenes.make([40, 44, 4], 5, 8, torch.float32, 3, "scene0", CPU)
    b = scenes.make([40, 44, 4], 5, 8, torch.float32, 3, "scene0", CPU)
    c = scenes.make([40, 44, 4], 5, 8, torch.float32, 3, "scene1", CPU)
    assert torch.equal(a.ms, b.ms) and torch.equal(a.pan, b.pan)
    assert torch.equal(a.label, b.label)
    assert not torch.equal(a.ms, c.ms)
    assert a.ms.shape == (47, 51, 4) and a.pan.shape == (191, 207)
    assert float(a.ms.min()) == 0.0 and float(a.ms.max()) == 1.0
    labeled = (a.label > 0).float().mean()
    assert 0.6 < float(labeled) < 0.8
    assert int(a.label.max()) <= 4


def test_weights_follow_the_reference_spec(root):
    cfg = Benchmark(root).config("dense_fusion-w32-p16")
    spec = system.param_spec(cfg)
    w1 = weights.make(spec, 11, CPU)
    w2 = weights.make(spec, 11, CPU)
    w3 = weights.make(spec, 12, CPU)
    assert list(w1) == [n for n, _, _ in spec]
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["trunk1.conv.weight"], w3["trunk1.conv.weight"])
    assert all(tuple(w1[n].shape) == tuple(s) for n, s, _ in spec)


@pytest.mark.parametrize("draw", ["uniform", "raster"])
def test_serving_requests_are_seeded(draw):
    from types import SimpleNamespace

    from portbench.entries.predict_ids import Draws

    def requests(seed, n=2):
        run = SimpleNamespace(seed=seed, config={"scene_size": [64, 72, 4]},
                              traffic={"anchors_per_request": 256,
                                       "draw": draw})
        d = Draws(run, "traffic")
        return [d.next() for _ in range(n)]

    a, b, c = requests(9), requests(9), requests(10)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.int32 and a[0].max() < 64 * 72
    if draw == "raster":
        # Consecutive ids, request after request, wrapping at the end.
        ids = np.concatenate(requests(9, 20))
        assert np.array_equal(np.diff(ids) % (64 * 72), np.ones(ids.size - 1))


def test_epochs_are_seeded_and_cover_the_split(root, small_over):
    from types import SimpleNamespace

    from portbench.entries import train_epoch

    def epochs(seed):
        st = SimpleNamespace(
            n_train=70, batch=32,
            train_ids=np.arange(100, 170, dtype=np.int32),
            labels_flat=np.arange(200, dtype=np.int32) % 5,
            rng=seeds.numpy_rng(seed, "epochs"))
        return [train_epoch._epoch(st, CPU) for _ in range(2)]

    a, b, c = epochs(4), epochs(4), epochs(5)
    ids, labels, mask = a[0]
    assert ids.shape == (3, 32) and mask.sum() == 70
    assert sorted(ids.reshape(-1)[:70].tolist()) == list(range(100, 170))
    assert torch.equal(labels, ids.long() % 5)
    assert torch.equal(a[1][0], b[1][0]) and not torch.equal(a[0][0], a[1][0])
    assert not torch.equal(a[0][0], c[0][0])
