"""The plain references against the port on the CPU at a small size, in
float32: the same mathematics from the same weights and scenes."""

import statistics

import pytest
import torch

from portbench import scenes, system, weights
from portbench.bench import Benchmark
from portbench.reference import dense_fusion as ref_dense
from portbench.reference import gmfnet as ref_gmfnet
from portbench.reference.common import bf16, exact, fp8

CPU = torch.device("cpu")


def _setup(root, config_name, width, seed=0):
    cfg_file = Benchmark(root).config(config_name)
    cfg_file.update(city="synth64", scene_size=[64, 72, 4], classes=5,
                    model_width=width, compute_dtype="float32")
    cfg = system.port_config(cfg_file, CPU)
    scene = scenes.make(cfg_file["scene_size"], 5, 16, torch.float32, seed,
                        "scene0", CPU)
    params = weights.make(system.param_spec(cfg_file), seed, CPU)
    return cfg_file, cfg, scene, params


@pytest.mark.parametrize("seed", [0, 1])
def test_gmfnet_logits(root, seed):
    _, cfg, scene, params = _setup(root, "gmfnet-w64-p16", 16, seed)
    model = system.model_with(cfg, params, CPU).eval()
    ids = torch.randint(0, 64 * 72, (64,), generator=torch.Generator()
                        .manual_seed(seed))
    ms, pan = ref_gmfnet.windows(scene.ms, scene.pan, ids, 72, 16)
    from dmfusion_torch.data.patches import gather_dual
    p_ms, p_pan = gather_dual(scene.ms, scene.pan, ids.int(), 72, 16)
    assert torch.equal(p_ms, ms) and torch.equal(p_pan.reshape(pan.shape),
                                                 pan)
    with torch.no_grad():
        want = model(p_ms.float(), p_pan.float())
        got = ref_gmfnet.logits(params, ms, pan)
        low = ref_gmfnet.logits(params, ms, pan, fp8)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    assert (low - want).abs().max() > 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_logits_map(root, seed):
    _, cfg, scene, params = _setup(root, "dense_fusion-w32-p16", 8, seed)
    model = system.model_with(cfg, params, CPU).eval()
    with torch.no_grad():
        want = model(scene.ms, scene.pan, 16)
        got = ref_dense.logits_map(params, scene.ms, scene.pan, 16)
    assert got.shape == want.shape == (64, 72, 5)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


def test_dense_train_loss_and_gradient(root):
    from dmfusion_torch.train.steps import DensePrograms

    _, cfg, scene, params = _setup(root, "dense_fusion-w32-p16", 8)
    model = system.model_with(cfg, params, CPU)
    model.remat = False
    prog = DensePrograms(model, 16, cfg=cfg)
    ids = torch.arange(0, 64 * 72, 97, dtype=torch.int32)[:32]
    labels = (ids % 4 + 1).int()
    mask = torch.ones(32)
    mask[-3:] = 0
    pooled = prog._anchor_pooled_fn(*scene.ms.shape[:2])
    loss = prog._loss(pooled, (scene.ms, scene.pan), ids, labels, mask)
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ref = ref_dense.train_loss(p, scene.ms, scene.pan, 16, ids, labels, mask)
    grads = torch.autograd.grad(ref, list(p.values()))
    assert float(ref.detach()) == pytest.approx(float(loss.detach()),
                                                rel=1e-5)
    named = dict(model.named_parameters())
    for (k, _), g in zip(p.items(), grads):
        assert torch.allclose(named[k].grad, g, atol=1e-5, rtol=1e-3), k


def _leaf_gap(got, want):
    """Worst leaf's ``|got - want| / max(|want|, median leaf's |want|)``."""
    med = statistics.median(float(w.norm()) for w in want.values())
    return max(float((got[k] - w).norm()) / max(float(w.norm()), med)
               for k, w in want.items())


@pytest.mark.parametrize("seed", [0, 1])
def test_gmfnet_train_loss_and_gradient(root, seed):
    from dmfusion_torch.train.steps import DualPrograms

    _, cfg, scene, params = _setup(root, "gmfnet-w64-p16", 16, seed)
    model = system.model_with(cfg, params, CPU).train()
    prog = DualPrograms(model, None, cfg, 72, 16)
    ids = torch.arange(0, 64 * 72, 97, dtype=torch.int32)[:32]
    labels = (ids % 4 + 1).int()
    mask = torch.ones(32)
    mask[-3:] = 0
    inputs = prog._gather((scene.ms, scene.pan), ids)
    loss = prog.loss(model(*inputs), labels, mask)
    loss.backward()

    def ref_grads(q):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        ref = ref_gmfnet.train_loss(p, scene.ms, scene.pan, 16, ids, labels,
                                    mask, q)
        return ref, dict(zip(p, torch.autograd.grad(ref, list(p.values()))))

    ref, grads = ref_grads(exact)
    assert float(ref.detach()) == pytest.approx(float(loss.detach()),
                                                rel=1e-5)
    named = {k: v.grad for k, v in model.named_parameters()}
    # The MS branch's GroupNorms see near-flat 16 x 16 windows of one
    # channel a group, which amplify float32 rounding: both sides lie
    # about 1e-3 from a float64 computation there (1e-6 elsewhere), and
    # the reference in bfloat16 lies at about 0.15.
    assert _leaf_gap(named, grads) < 1e-2
    assert _leaf_gap(ref_grads(bf16)[1], grads) > 5e-2
