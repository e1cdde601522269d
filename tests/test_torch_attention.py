"""B6, the fused window-attention core (``ops/attention.py``,
``csrc/window_attn.cu``), and its dispatch in ``models/swin.py``.

This file imports neither JAX nor ``dmfusion``, so it also runs on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_attention.py -q

On the CPU: ``WindowAttention`` on the grid (the plain version between
the projections) against the pre-B6 module path it folds (roll,
partition, the core, reverse, roll), bit for bit; a whole ``swin_t_dual``
forward against the pre-B6 block code, bit for bit; the checks and the
launch plan; the dispatcher operator.  Tests marked
``gpu`` skip without a CUDA device: the kernel against the plain version
at Swin-T's and the config's shapes, the launch counts of a served and a
trained ``swin_t_dual``, and the profiler's linkage of the kernel to the
``swin.attn`` span.
"""

import pytest
import torch

from dmfusion_torch.config import load_config
from dmfusion_torch.models import build_model
from dmfusion_torch.models import swin
from dmfusion_torch.ops import attention
from dmfusion_torch.parallel.tensor import use
from dmfusion_torch.tools import attn_probe
from dmfusion_torch.trace import span

# (grid, channels, heads, window): Swin-T's four stages (hd 32, 49
# tokens), ``config.yml``'s Swin (window 2, hd 32 and 64) and the
# benchmark's small swin cell (hd 8).
SHAPES = {"swin_t_s1": (56, 96, 3, 7), "swin_t_s2": (28, 192, 6, 7),
          "swin_t_s3": (14, 384, 12, 7), "swin_t_s4": (7, 768, 24, 7),
          "config_hd32": (8, 96, 3, 2), "config_hd64": (4, 192, 3, 2),
          "small_hd8": (8, 24, 3, 2)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _block_inputs(shape, dtype, shifted, batch=2, seed=0):
    """A ``WindowAttention`` at ``shape`` with a seeded bias table of unit
    spread, a grid input, the block's mask and shift."""
    grid, c, heads, ws = shape
    torch.manual_seed(seed)
    attn = swin.WindowAttention(c, heads, ws)
    with torch.no_grad():
        attn.rel_bias.normal_()
    attn = attn.to(dtype)
    y = torch.randn((batch, grid, grid, c)).to(dtype)
    shift = ws // 2 if shifted else 0
    mask = (torch.from_numpy(swin._shift_mask(grid, grid, ws, shift))
            if shift else None)
    return attn, y, mask, shift


def _old_attention_forward(self, wins, mask=None):
    """``WindowAttention.forward`` before B6, verbatim but for the relative
    index, then a buffer."""
    b_, n, dim = wins.shape
    hd = dim // self.heads
    qkv = self.qkv(wins)
    swin.WindowAttention.calls += 1
    swin.WindowAttention.masked += int(mask is not None)
    with span("swin.attn"):
        qkv = qkv.reshape(b_, n, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = q @ k.transpose(-1, -2)
        attn = attn / float(torch.tensor(float(hd),
                                         dtype=attn.dtype).sqrt())
        rel_index = torch.from_numpy(
            attention.relative_index(self.window).reshape(-1))
        bias = use(self, "rel_bias")[rel_index].reshape(n, n, self.heads)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, self.heads, n, n)
            attn = attn + mask.to(attn.dtype)[None, :, None]
            attn = attn.reshape(b_, self.heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b_, n, dim)
    return self.proj(out)


def _module_path(attn, y, mask, shift):
    """The pre-B6 module path: roll, partition, ``WindowAttention`` on
    windows, reverse, roll back."""
    b, h, w, _ = y.shape
    ws = attn.window
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    y = _old_attention_forward(attn, attention.window_partition(y, ws), mask)
    y = attention.window_reverse(y, ws, b, h, w)
    return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("name", list(SHAPES))
def test_ref_on_grid_equals_module_path(name, dtype, shifted):
    """The projections are per token, so they commute with the roll and
    the partition: ``WindowAttention`` on the grid, ``qkv`` and ``proj``
    around the plain core, gives the pre-B6 module path's output bit for
    bit."""
    attn, y, mask, shift = _block_inputs(SHAPES[name], DTYPES[dtype],
                                         shifted)
    with torch.no_grad():
        want = _module_path(attn, y, mask, shift)
        got = attn(y, mask, shift)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _old_block_forward(self, x):
    """``SwinBlock.forward`` before B6, verbatim."""
    b, h, w, _ = x.shape
    s = self.shift
    y = self.norm1(x)
    if s:
        y = torch.roll(y, (-s, -s), dims=(1, 2))
    y = self.attn(attention.window_partition(y, self.ws), self.mask)
    y = attention.window_reverse(y, self.ws, b, h, w)
    if s:
        y = torch.roll(y, (s, s), dims=(1, 2))
    x = x + y
    return x + self.fc2(self.act(self.fc1(self.norm2(x))))


def _swin_t_dual(compute, patch=4):
    cfg = load_config(overrides={
        "model_name": "swin_t_dual", "data_city": "image6",
        "patch_size": patch, "precision": {"compute_dtype": compute},
        "trans": {"window_size": 2, "embed_dim": 24, "depths": [2, 2],
                  "num_heads": [3, 6]}})
    torch.manual_seed(0)
    model = build_model(cfg).eval()
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, swin.WindowAttention):
                blk.rel_bias.normal_()
    return cfg, model


def _windows(patch, b=4, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand((b, patch, patch, 4), generator=g, device=device),
            torch.rand((b, 4 * patch, 4 * patch, 1), generator=g,
                       device=device))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_swin_t_dual_cpu_forward_unchanged(compute, monkeypatch):
    _, model = _swin_t_dual(compute)
    ms, pan = _windows(4, 2)
    calls = swin.WindowAttention.calls
    with torch.no_grad():
        got = model(ms, pan)
    assert swin.WindowAttention.calls - calls == 8
    monkeypatch.setattr(swin.WindowAttention, "forward",
                        _old_attention_forward)
    monkeypatch.setattr(swin.SwinBlock, "forward", _old_block_forward)
    with torch.no_grad():
        want = model(ms, pan)
    assert torch.equal(got, want)


def test_training_after_an_inference_forward():
    """The plain version's cached relative index, first made under
    inference mode, can still be saved for a later backward."""
    _, model = _swin_t_dual("float32")
    ms, pan = _windows(4, 2)
    attention._rel_index.cache_clear()
    with torch.inference_mode():
        want = model.eval()(ms, pan)
    got = model.train()(ms, pan)
    got.square().mean().backward()
    assert torch.equal(got.detach(), want)
    assert all(p.grad is not None for p in model.parameters()
               if p.requires_grad)


def _qkv(b, grid, c, dtype=torch.bfloat16):
    return torch.zeros((b, grid, grid, 3 * c), dtype=dtype)


@pytest.mark.parametrize("case,match", [
    (dict(qkv=_qkv(1, 8, 48, torch.float16)), "dtype"),
    (dict(qkv=_qkv(1, 8, 48).transpose(1, 2)), "contiguous"),
    (dict(qkv=_qkv(1, 9, 48), ws=9, table=torch.zeros(289, 3)),
     "at most 64"),
    (dict(qkv=_qkv(1, 8, 36)), "multiple of 8"),
    (dict(qkv=_qkv(1, 8, 216)), "multiple of 8 up to 64"),
    (dict(qkv=_qkv(1, 7, 48)), "multiple of the window"),
    (dict(qkv=torch.zeros((1, 8, 7, 144), dtype=torch.bfloat16)),
     "multiple of the window"),
    (dict(shift=1), "mask goes with a shift"),
    (dict(table=torch.zeros(9, 4)), "table must be"),
    (dict(qkv=_qkv(1, 8, 48)[..., :143]), r"\(B, H, W, 3C\)"),
], ids=["dtype", "contiguity", "tokens", "hd12", "hd72", "grid_h",
        "grid_w", "mask_shift", "table", "not_3c"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """The checks the operator's CUDA implementation runs before it
    launches, on any device."""
    args = {"qkv": _qkv(1, 8, 48), "table": torch.zeros(9, 3),
            "mask": None, "ws": 2, "shift": 0, "heads": 3, **case}
    with pytest.raises(ValueError, match=match):
        attention.check_inputs(**args)


def test_wrapper_needs_the_card_and_the_whole_mask():
    qkv, table = _qkv(1, 8, 48), torch.zeros(9, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.window_attn_cuda(qkv, table, None, 2, 0, 3)
    mask = torch.from_numpy(swin._shift_mask(8, 8, 2, 1))
    with pytest.raises(ValueError, match="mask must be"):
        attention.check_inputs(qkv, table, mask[:4], 2, 1, 3)


# Swin-T at 1,024 anchors: (grid, channels, heads) a stage, window 7.
SWIN_T = [(56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24)]


@pytest.mark.parametrize("stage", range(4))
def test_launch_plan_at_swin_t(stage):
    grid, c, heads = SWIN_T[stage]
    windows = 1024 * (grid // 7) ** 2
    # Two heads' q, k and v tiles of 64 rows of 40 bf16 elements, two bias
    # columns of 169, the tokens' pixels and coordinates; the mask's 49²
    # floats under a shift.
    base = 12 * 64 * 40 + 8 * 169 + 512
    for shift, smem in ((0, base), (3, base + 4 * 49 * 49)):
        plan = attention.launch_plan(1024, grid, grid, c, heads, 7, shift,
                                     bool(shift), 2)
        assert plan == attention.AttnPlan("mma", 32, 49, 4, 128, windows,
                                          smem)
        assert plan.as_ints() == (0, 32, 49, 4, 128, windows, smem)
    f32 = attention.launch_plan(1024, grid, grid, c, heads, 7, 3, True, 4)
    assert f32 == attention.AttnPlan(
        "simt", 32, 49, 4, 128, windows,
        4 * (3 * 49 * 33 + 49 * 50) + 4 * 169 + 4 * 49 * 49 + 512)


def test_launch_plan_small_windows_and_refusals():
    plan = attention.launch_plan(4096, 8, 8, 24, 3, 2, 1, True, 2)
    # hd 8 padded to the MMA's 16 (rows of 24 elements), 4 tokens in one
    # 16-row tile.
    assert plan == attention.AttnPlan("mma", 8, 4, 1, 128, 4096 * 16,
                                      12 * 16 * 24 + 8 * 9 + 4 * 16 + 512)
    with pytest.raises(ValueError, match="32-bit"):
        attention.launch_plan(2**20, 64, 64, 96, 3, 8, 0, False, 2)
    with pytest.raises(ValueError, match="shift"):
        attention.launch_plan(1, 8, 8, 24, 3, 2, 2, True, 2)


def test_operator_is_a_dispatcher_op():
    """B6 launches inside ``torch.ops.dmfusion_torch.window_attn``, an
    operator of the dispatcher with a CUDA kernel, which a profiler records
    as it records torch's own, and to which it links the kernels launched
    inside it (a bare ``ctypes`` launch would be linked to none); on the
    CPU the operator computes the plain version."""
    op = torch.ops.dmfusion_torch.window_attn.default
    assert str(op._schema) == (
        "dmfusion_torch::window_attn(Tensor qkv, Tensor table, Tensor? mask, "
        "int ws, int shift, int heads) -> Tensor")
    for key in ("CUDA", "CPU", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            "dmfusion_torch::window_attn", key), key
    attn, y, mask, shift = _block_inputs(SHAPES["small_hd8"], torch.float32,
                                         True)
    table = attn.rel_bias.detach()
    with torch.no_grad():
        qkv = attn.qkv(y)
        want = attention.window_attn_ref(qkv, table, mask, 2, shift, 3)
        got = torch.ops.dmfusion_torch.window_attn(qkv, table, mask, 2,
                                                   shift, 3)
        fake = torch.ops.dmfusion_torch.window_attn(
            qkv.to("meta"), table.to("meta"), mask.to("meta"), 2, shift, 3)
    assert torch.equal(got, want)
    assert fake.shape == want.shape and fake.dtype == want.dtype


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain_version(cuda, name, shifted):
    """bf16: the kernel's scores stay in f32 where the plain version rounds
    them to bf16, so against a float64 truth its mean error is at most the
    plain version's and its largest within twice the plain version's (both
    round p and the output to bf16); f32: within 1e-5 of the plain
    version."""
    attn, y, mask, shift = _block_inputs(SHAPES[name], torch.float32,
                                         shifted, batch=4)
    grid, c, heads, ws = SHAPES[name]
    table = attn.rel_bias.detach().to(cuda)
    mask = None if mask is None else mask.to(cuda)
    qkv32 = torch.randn((4, grid, grid, 3 * c), device=cuda)
    with torch.inference_mode():
        truth = attn_probe.truth(qkv32.to(torch.bfloat16), table, mask, ws,
                                 shift, heads)
        qkv16 = qkv32.to(torch.bfloat16)
        got16 = attention.window_attn_cuda(qkv16, table, mask, ws, shift,
                                           heads)
        ref16 = attention.window_attn_ref(qkv16, table, mask, ws, shift,
                                          heads)
        got32 = attention.window_attn_cuda(qkv32, table, mask, ws, shift,
                                           heads)
        ref32 = attention.window_attn_ref(qkv32, table, mask, ws, shift,
                                          heads)
    torch.cuda.synchronize()
    assert got16.dtype == torch.bfloat16 and got16.shape == ref16.shape
    err_k = (got16.double() - truth).abs()
    err_r = (ref16.double() - truth).abs()
    assert float(err_k.mean()) <= float(err_r.mean()), (err_k.mean(),
                                                        err_r.mean())
    assert float(err_k.max()) <= 2 * float(err_r.max()), (err_k.max(),
                                                          err_r.max())
    assert float((got32 - ref32).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_swin_t_dual_launches_and_training_bypasses(cuda):
    _, model = _swin_t_dual("bfloat16", patch=8)
    model = model.to(cuda)
    ms, pan = _windows(8, 64, cuda)
    k = attention.window_attn_cuda
    launches, bypassed = k.launches, k.bypassed
    masked = swin.WindowAttention.masked
    with torch.inference_mode():
        model.eval()(ms, pan)
    assert (k.launches - launches, k.bypassed - bypassed) == (8, 0)
    assert swin.WindowAttention.masked - masked == 4
    launches, bypassed = k.launches, k.bypassed
    loss = model.train()(ms, pan).float().square().mean()
    loss.backward()
    assert (k.launches - launches, k.bypassed - bypassed) == (0, 8)


@pytest.mark.gpu
def test_profiler_links_the_kernel_to_the_span(cuda):
    """The device time ``key_averages()`` gives the ``swin.attn`` spans of
    a forward is the kernel's own device time there."""
    from torch.profiler import ProfilerActivity, profile
    _, model = _swin_t_dual("bfloat16", patch=16)
    model = model.to(cuda).eval()
    ms, pan = _windows(16, 256, cuda)
    with torch.inference_mode():
        model(ms, pan)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(ms, pan)
            torch.cuda.synchronize()
    avg = prof.key_averages()
    span_us = sum(e.device_time_total for e in avg
                  if e.key == "swin.attn" and e.is_user_annotation
                  and e.device_type == torch.autograd.DeviceType.CPU)
    kernel_us = sum(e.self_device_time_total for e in avg
                    if "wattn_" in e.key)
    assert kernel_us > 0
    assert abs(span_us - kernel_us) <= 0.05 * kernel_us, (span_us, kernel_us)
