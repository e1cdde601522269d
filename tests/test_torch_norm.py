"""B5, the fused GroupNorm + residual + activation (``ops/norm.py``,
``csrc/group_norm_act.cu``), and its dispatch in ``models/common.py``.

This file imports neither JAX nor ``dmfusion``, so it also runs on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_norm.py -q

On the CPU: the plain version against the modules' arithmetic, the blocks'
two paths, the launch plan and the state-dict keys.  Tests marked ``gpu``
skip without a CUDA device: the kernel against the plain version at
gmfnet's shapes, the launch counts of a served and a trained gmfnet, and
the zoo's no-grad logits.

Under CUDA autocast ``group_norm`` runs in float32 and the port's
``GroupNorm`` casts its result back; CPU autocast runs ``group_norm`` in
bfloat16 itself.  The bfloat16 cases on the CPU imitate CUDA's float32
norm (as ``test_torch_models.py::test_norm_output_keeps_compute_dtype``
does), so that both paths hold the card's arithmetic.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dmfusion_torch.config import load_config
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import (ConvBlock, GroupNorm, ResBlock,
                                          activation_fn)
from dmfusion_torch.ops import norm

ACTS = sorted(norm.ACTIVATIONS)
# gmfnet-w64-p16's 13 norms: (C, H, W) and whether a residual is added
# (each ResBlock's second norm).
GMFNET_NORMS = ([((32, 16, 16), False)] * 2 + [((64, 16, 16), False)] * 3
                + [((128, 8, 8), False)] * 2 + [((256, 4, 4), False)]
                + [((64, 16, 16), True)] * 2 + [((128, 8, 8), True)] * 2
                + [((256, 4, 4), True)])


@pytest.fixture
def f32_group_norm(monkeypatch):
    """``F.group_norm`` in float32 whatever its input, as CUDA autocast
    runs it."""
    f32_norm = F.group_norm
    monkeypatch.setattr(F, "group_norm",
                        lambda x, *a, **k: f32_norm(x.float(), *a, **k))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _tensor(shape, dtype, channels_last, seed=0, device="cpu", scale=1.0):
    g = np.random.default_rng(seed)
    t = torch.from_numpy(
        (g.standard_normal(shape) * scale + 0.3).astype(np.float32))
    t = t.to(device, dtype)
    return t.contiguous(memory_format=torch.channels_last
                        if channels_last else torch.contiguous_format)


def _params(c, seed=1, device="cpu"):
    g = np.random.default_rng(seed)
    return (torch.from_numpy(1 + 0.5 * g.standard_normal(c).astype(
                np.float32)).to(device),
            torch.from_numpy(0.2 * g.standard_normal(c).astype(
                np.float32)).to(device))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ref_equals_module_arithmetic(f32_group_norm, dtype, channels_last,
                                      residual, act):
    x = _tensor((2, 16, 5, 6), dtype, channels_last)
    res = _tensor((2, 16, 5, 6), dtype, channels_last, seed=2) \
        if residual else None
    gn = GroupNorm(4, 16)
    w, b = _params(16)
    with torch.no_grad():
        gn.weight.copy_(w)
        gn.bias.copy_(b)
        y = gn(x)
        want = norm.ACTIVATIONS[act](y if res is None else y + res)
        got = norm.group_norm_act_ref(x, 4, gn.weight, gn.bias, act, res)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def _blocks(act):
    torch.manual_seed(0)
    return (ConvBlock(8, 16, 3, 1, act), ResBlock(8, 16, 2, act),
            ResBlock(16, 16, 1, act))


def _input(block, dtype):
    first = block.conv if isinstance(block, ConvBlock) else block.block.conv
    return _tensor((2, first.in_channels, 8, 8), dtype, True)


@pytest.mark.parametrize("activate", ["Relu", "Gelu", "LeakyRelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocks_same_output_both_paths(f32_group_norm, dtype, activate):
    act = activation_fn({"schedule": {"activate": activate}})
    for block in _blocks(act):
        x = _input(block, dtype)
        with torch.autocast("cpu", dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            graph = block(x)
            with torch.no_grad():
                fused = block(x)
        assert graph.requires_grad and not fused.requires_grad
        assert fused.dtype == graph.dtype == dtype
        assert torch.equal(fused, graph.detach())


def test_blocks_unknown_activation_and_residual_dtype(f32_group_norm):
    """An activation without a kernel code runs after the norm, and a
    residual of another dtype is added (promoting) after it."""
    act = lambda t: t * torch.sigmoid(t)  # noqa: E731
    block = ResBlock(16, 16, 1, act)
    x = _tensor((2, 16, 8, 8), torch.float32, True)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        graph = block(x)
        with torch.no_grad():
            fused = block(x)
    assert fused.dtype == graph.dtype == torch.float32
    assert torch.equal(fused, graph.detach())


def test_grad_path_never_calls_the_op(monkeypatch):
    calls = []
    real = norm.group_norm_act
    import dmfusion_torch.models.common as common
    monkeypatch.setattr(common, "group_norm_act",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    grads = {}
    for name in ("module", "parent"):
        for block in _blocks(F.relu):
            x = _input(block, torch.float32)
            if name == "parent":  # the forward before B5: modules only
                y = (block.act(block.norm(block.conv(x)))
                     if isinstance(block, ConvBlock) else block.act(
                         block.norm(block.conv(block.block(x)))
                         + (x if block.shortcut is None
                            else block.shortcut(x))))
            else:
                y = block(x)
            block.zero_grad()
            (y.float() ** 2).sum().backward()
            grads.setdefault(name, []).append(
                [p.grad.clone() for p in block.parameters()])
    assert not calls
    for a, b in zip(grads["module"], grads["parent"]):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    with torch.no_grad():
        block = _blocks(F.relu)[1]
        block(_input(block, torch.float32))
    assert len(calls) == 2


@pytest.mark.parametrize("shape,residual", GMFNET_NORMS)
def test_plan_shared_body_for_gmfnet(shape, residual):
    c, h, w = shape
    plan = norm.launch_plan(4096, c, h, w, 8, 2, True, residual)
    assert plan.body == "shared" and plan.grid == 4096
    assert plan.threads % 32 == 0 and plan.threads <= norm.BLOCK_THREADS
    vectors = c * h * w // 8
    assert plan.threads * norm.VECTORS_PER_THREAD >= vectors
    assert plan.threads % (c // 8) == 0  # a thread keeps its channels
    assert plan.smem == 16 * vectors * (1 + residual) + 4 * (
        plan.threads * 8 + 2 * 8)
    assert 2 * (plan.smem + 1024) <= 228 * 1024  # two blocks an SM


@pytest.mark.parametrize("case", [
    ((4, 64, 128, 128, 8, 2, True, True), "looped"),   # generator slab
    ((4096, 64, 16, 16, 8, 4, False, True), "shared"),
    ((7, 24, 5, 5, 3, 2, False, False), "looped"),     # 25 pixels: no vectors
    ((7, 24, 5, 5, 3, 2, True, False), "shared"),
    ((4096, 64, 16, 16, 8, 2, True, True, False), "looped"),  # unaligned
])
def test_plan_bodies(case):
    args, body = case
    plan = norm.launch_plan(*args)
    assert plan.body == body
    if body == "looped":
        assert plan.grid == args[0] * args[4] and plan.smem == 0


def test_plan_refuses_huge_slab():
    with pytest.raises(ValueError, match="no kernel plan"):
        norm.launch_plan(1, 2**16, 2**8, 2**8, 8, 2, True, False)


def test_wrappers_refuse_cpu_tensor_and_bad_arguments():
    x = _tensor((2, 16, 4, 4), torch.float32, False)
    w, b = _params(16)
    with pytest.raises(ValueError, match="CUDA"):
        norm.group_norm_act_cuda(x, 4, w, b, "relu")
    with pytest.raises(ValueError, match="groups"):
        norm.group_norm_act(x, 5, w, b, "relu")
    with pytest.raises(ValueError, match="activation"):
        norm.group_norm_act(x, 4, w, b, "swish")
    with pytest.raises(ValueError, match="strides"):
        norm.is_channels_last(x[:, :, :, :2])
    before = norm.group_norm_act_cuda.launches
    out = norm.group_norm_act(x, 4, w, b, "relu")
    assert norm.group_norm_act_cuda.launches == before
    assert torch.equal(out, norm.group_norm_act_ref(x, 4, w, b, "relu"))


@pytest.mark.parametrize("fault,ok", [(None, True), ("one_ulp", True),
                                      ("channel", False), ("residual", False)])
def test_ulp_report_tells_rounding_from_faults(fault, ok):
    x = _tensor((2, 16, 4, 4), torch.bfloat16, False, scale=2.0)
    res = _tensor((2, 16, 4, 4), torch.bfloat16, False, seed=2)
    w, b = _params(16)
    want = norm.group_norm_act_ref(x, 4, w, b, "relu", res)
    got = want.clone()
    if fault == "one_ulp":  # the largest element, one bf16 ulp up
        i = int(want.view(-1).float().abs().argmax())
        got.view(-1).view(torch.int16)[i] += 1
    elif fault == "channel":  # one channel's weight swapped for another's
        w2 = w.clone()
        w2[3] = w[5]
        got = norm.group_norm_act_ref(x, 4, w2, b, "relu", res)
    elif fault == "residual":  # the residual shifted by a pixel
        got = norm.group_norm_act_ref(x, 4, w, b, "relu",
                                      torch.roll(res, 1, dims=3))
    report = norm.ulp_report(got, want, x, 4, w, b)
    assert report["ok"] == ok
    assert (report["bit_equal_share"] == 1.0) == (fault is None)


# Norm module names (each with .weight and .bias) and state-dict sizes.
STATE = {
    "gmfnet": (64, ["ms_stem", "ms_res.block", "ms_res", "pan.blocks.0",
                    "pan.blocks.1", "pan_res.block", "pan_res",
                    "trunk.0.block", "trunk.0", "trunk.1.block", "trunk.1",
                    "trunk.2.block", "trunk.2"]),
    "tri_net": (72, ["ms_stem", "ms_res.block", "ms_res", "pan.blocks.0",
                     "pan.blocks.1", "pan_res.block", "pan_res",
                     "mspan.blocks.0", "mspan.blocks.1", "mspan_res.block",
                     "mspan_res", "trunk.0.block", "trunk.0",
                     "trunk.1.block", "trunk.1"]),
    "generator": (30, ["enc1", "enc2", "res.0.block", "res.0",
                       "res.1.block", "res.1", "dec"]),
}


@pytest.mark.parametrize("name", sorted(STATE))
def test_state_dict_keys_unchanged(name):
    size, norms = STATE[name]
    cfg = load_config(overrides={"data_city": "synth64", "patch_size": 8,
                                 "model_width": 8, "gan_width": 8,
                                 "model_name": name})
    keys = list(build_model(cfg).state_dict())
    assert len(keys) == size
    assert [k for k in keys if ".norm." in k] == [
        f"{m}.norm.{leaf}" for m in norms for leaf in ("weight", "bias")]


# On the card.


# gmfnet's 13 norms at a bucket of 4,096 anchors, bf16 channels-last: the
# ConvBlocks without a residual, each ResBlock's second norm with one; a
# contiguous f32 case and a generator slab (the looped body).  Held by
# ``norm.ulp_report``: within 2 bf16 ulps at the scale of the norm's own
# terms everywhere, and bf16 outputs bit-equal on at least 99 % of
# elements (99.9993 % and more measured on an H100: PERF.md's kernel
# table).  An f32 output is not held to a share: its last bits follow the
# statistics' order of sums.
CARD_CASES = [(4096, 32, 16, 16, torch.bfloat16, True, False),
              (4096, 64, 16, 16, torch.bfloat16, True, False),
              (4096, 64, 16, 16, torch.bfloat16, True, True),
              (4096, 128, 8, 8, torch.bfloat16, True, False),
              (4096, 128, 8, 8, torch.bfloat16, True, True),
              (4096, 256, 4, 4, torch.bfloat16, True, False),
              (4096, 256, 4, 4, torch.bfloat16, True, True),
              (4096, 64, 16, 16, torch.float32, False, True),
              (4, 64, 128, 128, torch.bfloat16, True, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_version(cuda, case):
    n, c, h, w, dtype, cl, residual = case
    x = _tensor((n, c, h, w), dtype, cl, device=cuda, scale=2.0)
    res = _tensor((n, c, h, w), dtype, cl, seed=3, device=cuda) \
        if residual else None
    wt, b = _params(c, device=cuda)
    with torch.inference_mode():
        got = norm.group_norm_act_cuda(x, 8, wt, b, "relu", res)
        want = norm.group_norm_act_ref(x, 8, wt, b, "relu", res)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.stride() == x.stride()
    report = norm.ulp_report(got, want, x, 8, wt, b)
    assert report["ok"], report
    if dtype == torch.bfloat16:
        assert report["bit_equal_share"] >= 0.99, report


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_kernel_activations(cuda, act):
    x = _tensor((64, 64, 16, 16), torch.bfloat16, True, device=cuda)
    res = _tensor((64, 64, 16, 16), torch.bfloat16, True, seed=3,
                  device=cuda)
    wt, b = _params(64, device=cuda)
    with torch.inference_mode():
        got = norm.group_norm_act_cuda(x, 8, wt, b, act, res)
        want = norm.group_norm_act_ref(x, 8, wt, b, act, res)
    report = norm.ulp_report(got, want, x, 8, wt, b)
    assert report["ok"] and report["bit_equal_share"] >= 0.99, report


@pytest.mark.gpu
def test_dispatch_takes_any_layout(cuda):
    """A channel-major x (a sharded conv's gathered output) and a residual
    in another format than x's: copied as ATen's group norm copies them,
    then one launch."""
    x = _tensor((4, 32, 8, 8), torch.bfloat16, False, device=cuda)
    x = x.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
    res = _tensor((4, 32, 8, 8), torch.bfloat16, True, seed=3, device=cuda)
    wt, b = _params(32, device=cuda)
    launches = norm.group_norm_act_cuda.launches
    with torch.inference_mode():
        got = norm.group_norm_act(x, 8, wt, b, "relu", res)
        want = norm.group_norm_act_ref(x, 8, wt, b, "relu", res)
    assert norm.group_norm_act_cuda.launches == launches + 1
    assert got.is_contiguous()
    report = norm.ulp_report(got, want, x, 8, wt, b)
    assert report["ok"] and report["bit_equal_share"] >= 0.99, report
    with pytest.raises(ValueError, match="strides"):
        norm.group_norm_act_cuda(x, 8, wt, b, "relu")


@pytest.mark.gpu
def test_kernel_refuses_bad_plan(cuda):
    x = _tensor((2, 64, 16, 16), torch.bfloat16, True, device=cuda)
    wt, b = _params(64, device=cuda)
    # 48 threads: not whole warps.
    bad = norm.NormPlan("shared", 48, 2, 16 * 2048 + 4 * (48 * 8 + 16))
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="launch failed"):
        norm.group_norm_act_cuda(x, 8, wt, b, "relu", plan=bad)


def _gmfnet(device, **over):
    cfg = load_config(overrides={"data_city": "image6", "patch_size": 16,
                                 "model_width": 64, **over})
    torch.manual_seed(0)
    return cfg, build_model(cfg).to(device, memory_format=torch.channels_last)


def _windows(cfg, b, device, seed=0):
    c = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
    ps = int(cfg["patch_size"])
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand((b, ps, ps, c), generator=g, device=device),
            torch.rand((b, 4 * ps, 4 * ps, 1), generator=g, device=device))


@pytest.mark.gpu
def test_gmfnet_serving_launches_and_training_bypasses(cuda):
    cfg, model = _gmfnet(cuda)
    ms, pan = _windows(cfg, 256, cuda)
    k = norm.group_norm_act_cuda
    launches, bypassed = k.launches, k.bypassed
    with torch.inference_mode():
        model.eval()(ms, pan)
    assert (k.launches - launches, k.bypassed - bypassed) == (13, 0)
    launches, bypassed = k.launches, k.bypassed
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    loss = model.train()(ms, pan).float().square().mean()
    loss.backward()
    opt.step()
    assert (k.launches - launches, k.bypassed - bypassed) == (0, 13)


@pytest.mark.gpu
def test_block_output_keeps_channels_last(cuda):
    cfg, model = _gmfnet(cuda)
    ms, pan = _windows(cfg, 64, cuda)
    outs = []
    hooks = [m.register_forward_hook(lambda _m, _i, o: outs.append(o))
             for m in model.modules() if isinstance(m, (ConvBlock, ResBlock))]
    with torch.inference_mode():
        model.eval()(ms, pan)
    for h in hooks:
        h.remove()
    assert len(outs) == 13  # 8 ConvBlocks and 5 ResBlocks
    assert all(o.is_contiguous(memory_format=torch.channels_last)
               for o in outs)
    assert {o.dtype for o in outs} == {torch.bfloat16}


ZOO = {"tri_net": {}, "dqtl": {}, "resnet18": {"model_width": 32},
       "ct_lstm": {}, "generator": {}, "discriminator": {}}


def _zoo_inputs(name, cfg, device):
    g = torch.Generator(device=device).manual_seed(0)
    ps = int(cfg["patch_size"])
    c = int(cfg["DATA_DICT"][cfg["data_city"]]["size"][2])
    if name in ("generator", "discriminator"):
        pic = 128
        return (torch.rand((4, pic, pic, c), generator=g, device=device),)
    if name == "dqtl":
        return (torch.rand((4 * 64, ps, ps, c), generator=g, device=device),)
    ms = torch.rand((64, ps, ps, c), generator=g, device=device)
    pan = torch.rand((64, 4 * ps, 4 * ps, 1), generator=g, device=device)
    if name == "tri_net":
        return ms, pan, torch.rand((64, 4 * ps, 4 * ps, 1), generator=g,
                                   device=device)
    return ms, pan


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_no_grad_logits_match_plain_path(cuda, name):
    cfg = load_config(overrides={"data_city": "image6", "patch_size": 16,
                                 "model_name": name, **ZOO[name]})
    torch.manual_seed(0)
    model = build_model(cfg).to(cuda, memory_format=torch.channels_last)
    model.eval()
    inputs = _zoo_inputs(name, cfg, cuda)
    launches = norm.group_norm_act_cuda.launches
    with torch.no_grad():
        fused = model(*inputs).float()
    assert norm.group_norm_act_cuda.launches > launches
    with torch.enable_grad():  # the modules' own path, torch's GroupNorm
        plain = model(*inputs).float().detach()
    assert torch.isfinite(fused).all()
    assert float((fused - plain).abs().max()) <= 1e-2
