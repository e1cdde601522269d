"""swin_t_dual-p56 and its cell, swin_t_dual.serve-b1024: the file renders
Swin-T at its published widths, the plain reference meets the port on the
CPU in float32, the cell's check passes the program and fails the control
and the planted fault at a small size, the port's window-attention core
is a span and two counters, and the cell's two attention metrics read
them.

The small size is the port's ``synth64`` city at patch 8 with window 2,
embed 24 and four stages: grids 8-4-2-1, so that a shifted block runs on
a grid no larger than its window (the 2 x 2 third stage), the rule in
which the port departs from Swin-T."""

import math
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from portbench import attnbytes, calibrate, faults, harness, scenes, system
from portbench import weights
from portbench.bench import Benchmark
from portbench.reference import swin_t_dual as ref
from portbench.reference.common import fp8
from portbench.trace import WINDOW, Trace

CPU = torch.device("cpu")
CONFIG = "swin_t_dual-p56"
CELL = "swin_t_dual.serve-b1024"
SMALL_TRANS = {"window_size": 2, "embed_dim": 24, "depths": [2, 2, 2, 2],
               "num_heads": [3, 6, 12, 24]}
SMALL_OVER = {"config": {"city": "synth64", "scene_size": [64, 72, 4],
                         "classes": 5, "patch_size": 8,
                         "trans": SMALL_TRANS},
              "traffic": {"anchors_per_request": 64}}


@pytest.fixture(scope="module")
def bench(root):
    return Benchmark(root)


def _small(bench, seed, compute_dtype="float32"):
    """The configuration at the small size, the port's config, a scene and
    the seeded weights."""
    c = bench.config(CONFIG)
    c.update(SMALL_OVER["config"], compute_dtype=compute_dtype)
    cfg = system.port_config(c, CPU)
    scene = scenes.make(c["scene_size"], 5, 8, torch.float32, seed,
                        "scene0", CPU)
    return c, cfg, scene, weights.make(system.param_spec(c), seed, CPU)


def test_file_renders_swin_t_at_its_published_widths(bench):
    from dmfusion_torch.models import build_model

    c = bench.config(CONFIG)
    assert c["reduced"] == [] and c["model_name"] == "swin_t_dual"
    cfg = system.port_config(c, CPU)
    assert cfg["trans"] == {**cfg["trans"], "window_size": 7,
                            "embed_dim": 96, "depths": [2, 2, 6, 2],
                            "num_heads": [3, 6, 12, 24]}
    assert cfg["schedule"]["activate"] == "Gelu"
    with torch.device("meta"):
        model = build_model(cfg)
    assert next(model.parameters()).device.type == "meta"
    for enc in (model.ms_encoder, model.pan_encoder):
        assert tuple(enc.pos.shape) == (1, 56, 56, 96)
        assert [len(s) for s in enc.stages] == [2, 2, 6, 2]
        assert [s[0].attn.heads for s in enc.stages] == [3, 6, 12, 24]
        assert [s[0].norm1.weight.shape[0] for s in enc.stages] == [
            96, 192, 384, 768]
        assert [s[0].fc1.weight.shape[0] for s in enc.stages] == [
            384, 768, 1536, 3072]
        assert all(b.ws == 7 for s in enc.stages for b in s)
        # A shifted block's mask has one (49, 49) slab a window: the
        # stage's grid is 7 windows' sqrt across.
        grids = [7 * math.isqrt(s[1].mask.shape[0]) for s in enc.stages]
        assert grids == [56, 28, 14, 7]
        assert enc.out_dim == 768
    # The reference's parameters are the port's state, name for name.
    spec = {n: tuple(s) for n, s, _ in system.param_spec(c)}
    assert spec == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(math.prod(s) for s in spec.values()) == 56941248


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_meets_the_port(bench, seed):
    from dmfusion_torch.data.patches import gather_dual

    _, cfg, scene, params = _small(bench, seed)
    model = system.model_with(cfg, params, CPU).eval()
    ids = torch.randint(0, 64 * 72, (64,), generator=torch.Generator()
                        .manual_seed(seed))
    ms, pan = ref.windows(scene.ms, scene.pan, ids, 72, 8)
    p_ms, p_pan = gather_dual(scene.ms, scene.pan, ids.int(), 72, 8)
    assert torch.equal(p_ms, ms) and torch.equal(p_pan.reshape(pan.shape),
                                                 pan)
    with torch.no_grad():
        want = model(p_ms.float(), p_pan.float())
        got = ref.logits(params, ms, pan)
        low = ref.logits(params, ms, pan, fp8)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    assert (low - want).abs().max() > 1e-3


def _check_run(bench, seed, fault=None):
    if fault is None:
        return harness.run_cell(bench, CELL, seed, 0.3, False, CPU, 0.0,
                                SMALL_OVER)
    with faults.plant(fault, 5):
        return harness.run_cell(bench, CELL, seed, 0.3, False, CPU, 0.0,
                                SMALL_OVER)


@pytest.mark.parametrize("seed", [21, 22])
def test_check_passes_the_program_and_fails_the_control(bench, seed):
    run, nums = _check_run(bench, seed)
    correct, table = harness.judge(run, nums)
    assert correct, table
    correct, table = harness.judge(run, calibrate.control(run))
    assert not correct, table


@pytest.mark.parametrize("fault", faults.BY_ENTRY["predict_ids"])
def test_check_fails_a_planted_fault(bench, fault):
    run, nums = _check_run(bench, 41, fault)
    correct, table = harness.judge(run, nums)
    assert not correct, (fault, table)


def _forward_counted(bench):
    """One small forward; the counters' calls and masked calls by stage,
    read at each stage's end."""
    from dmfusion_torch.models.swin import WindowAttention

    _, cfg, scene, params = _small(bench, 3)
    model = system.model_with(cfg, params, CPU).eval()
    ms, pan = ref.windows(scene.ms, scene.pan, torch.arange(4), 72, 8)
    marks = []

    def mark(*_):
        marks.append((WindowAttention.calls, WindowAttention.masked))

    hooks = [m.register_forward_pre_hook(mark)
             for enc in (model.ms_encoder, model.pan_encoder)
             for m in (*enc.merges, enc.norm)]
    start = (WindowAttention.calls, WindowAttention.masked)
    try:
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU]) as prof:
            model(ms, pan)
    finally:
        for h in hooks:
            h.remove()
    # The MS encoder's four stage ends, then the PAN encoder's.
    at = [start] + marks
    return [(b[0] - a[0], b[1] - a[1]) for a, b in zip(at, at[1:])], prof


def test_core_is_a_span_and_two_counters(bench):
    by_stage, prof = _forward_counted(bench)
    # Each stage runs its two blocks; the second shifts except on the 1 x 1
    # grid (shift 1 mod 1), the 2 x 2 grid's included.
    assert by_stage == [(2, 1), (2, 1), (2, 1), (2, 0)] * 2
    spans = [e for e in prof.events() if e.name == "swin.attn"]
    assert len(spans) == 2 * sum(SMALL_TRANS["depths"])


def test_the_reference_lists_the_port_calls(bench):
    c = bench.config(CONFIG)
    calls = ref.attention_calls(c)
    assert len(calls) == 24 and sum(m for *_, m in calls) == 12
    small = dict(c, **SMALL_OVER["config"])
    got = [(nw, nh, n, hd, m) for nw, nh, n, hd, m in ref.attention_calls(
        small)]
    # Stages of grids 8, 4, 2, 1 at window 2: 16, 4, 1, 1 windows of 4, 4,
    # 4, 1 tokens; heads 3, 6, 12, 24 of 8 channels.
    one = [(16, 3, 4, 8, False), (16, 3, 4, 8, True),
           (4, 6, 4, 8, False), (4, 6, 4, 8, True),
           (1, 12, 4, 8, False), (1, 12, 4, 8, True),
           (1, 24, 1, 8, False), (1, 24, 1, 8, False)]
    assert got == one * 2


def test_byte_count_by_hand():
    # The small size, bf16: q, k, v and the output of each call are four
    # (windows x tokens x channels) tensors an anchor: 8 x 8 x 24, 4 x 4 x
    # 48, 2 x 2 x 96, 1 x 1 x 192 tokens x channels a stage, two calls a
    # stage, two encoders.
    calls = [(16, 3, 4, 8, False), (16, 3, 4, 8, True),
             (4, 6, 4, 8, False), (4, 6, 4, 8, True),
             (1, 12, 4, 8, False), (1, 12, 4, 8, True),
             (1, 24, 1, 8, False), (1, 24, 1, 8, False)] * 2
    per_anchor = 2 * 2 * 4 * 2 * (64 * 24 + 16 * 48 + 4 * 96 + 1 * 192)
    assert attnbytes.per_anchor(calls, "bfloat16") == per_anchor == 92160
    # Tables of (2 ws - 1)^2 x heads and masks of windows x tokens^2, four
    # bytes an element, once a call.
    tables = 2 * 2 * (9 * 3 + 9 * 6 + 9 * 12 + 1 * 24)
    masks = 2 * (16 * 16 + 4 * 16 + 1 * 16)
    assert attnbytes.per_forward(calls) == 4 * (tables + masks)
    assert attnbytes.window_attention(calls, 100, 3, "bfloat16") == (
        100 * per_anchor + 3 * 4 * (tables + masks))


def test_byte_count_at_swin_t(bench):
    calls = ref.attention_calls(bench.config(CONFIG))
    # 22.88 MB an anchor: 4 x 2 bytes x (3136 x 96 x 2 + 784 x 192 x 2 +
    # 196 x 384 x 6 + 49 x 768 x 2) tokens x channels, two encoders.
    assert attnbytes.per_anchor(calls, "bfloat16") == 22880256
    assert attnbytes.per_forward(calls) == 4 * 2 * (
        169 * (3 * 2 + 6 * 2 + 12 * 6 + 24 * 2)
        + 49 * 49 * (64 + 16 + 4 * 3 + 1))


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _avg(key, device_us):
    return SimpleNamespace(key=key, is_user_annotation=True,
                           device_type=DeviceType.CPU,
                           device_time_total=device_us)


def _traced(bench, spans, device_us):
    """A traced run of two requests of 1,024 anchors whose forwards hold
    ``spans`` swin.attn spans, ``device_us`` device time launched in
    them."""
    events = [_ev("user_annotation", WINDOW, 0.0, 1e6),
              _ev("user_annotation", "model.forward", 10.0, 5e5)]
    events += [_ev("user_annotation", "swin.attn", 20.0 + i, 0.5)
               for i in range(spans)]
    averages = [_avg("model.forward", 3 * device_us)] + (
        [_avg("swin.attn", device_us)] if spans else [])
    return SimpleNamespace(
        trace=Trace(events, averages),
        traced_units={"requests": 2, "pixels": 2048},
        config=bench.config(CONFIG))


def test_attention_metrics_read_the_spans(bench):
    ms = bench.reader("window_attn_ms.serve")
    roof = bench.reader("window_attn_roofline.span")
    run = _traced(bench, 48, 40000.0)
    assert ms(run) == pytest.approx(20.0)
    calls = ref.attention_calls(run.config)
    want = attnbytes.window_attention(calls, 2048, 2, "bfloat16")
    assert roof(run) == pytest.approx(100 * want / 3.35e12 / 0.04)
    # A program without the spans (the parent of the change that brought
    # them): nothing to read, never 0.
    run = _traced(bench, 0, 40000.0)
    assert ms(run) is None and roof(run) is None
    run.trace = None
    assert ms(run) is None and roof(run) is None
