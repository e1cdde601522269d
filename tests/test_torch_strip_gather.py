"""The port's strip gather (B3) against the JAX package, bit for bit.

The plain version ``dmfusion_torch.ops.strip_gather.gather_dual_strips_ref``
and the CPU dispatch of ``gather_dual_strips`` are held against
``dmfusion.ops.pallas_strip_gather.gather_dual_strips`` in interpret mode
on numpy-seeded scenes (48 rows, patch 8, strips of 32 and 64, as in
``tests/test_strip_gather.py``), including strips that run past the
view's bottom and right edge (zeros) and starts off the TPU's lane
alignment.  The CUDA kernel is held against the plain version on the card
by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmfusion.ops import pallas_strip_gather as jstrip
from dmfusion_torch.data import patches as tpatches
from dmfusion_torch.ops import strip_gather as tstrip
from dmfusion_torch.tools import strip_gather_bench

H, C, PS = 48, 4, 8


def _scene(strip, seed=0):
    """Padded-scene-shaped MS (H+ps-1, W+ps-1, C) and PAN, W = 4*strip."""
    w = 4 * strip
    rng = np.random.default_rng(seed)
    ms = rng.standard_normal((H + PS - 1, w + PS - 1, C)).astype(np.float32)
    pan = rng.standard_normal((4 * H + 4 * PS - 1, 4 * w + 4 * PS - 1)
                              ).astype(np.float32)
    return ms, pan, w


_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(ms, pan, xs, y0s, w, strip, dtype):
    """(JAX in interpret mode, the port's plain version) on one input."""
    jdt, tdt = _DT[dtype]
    want = jstrip.gather_dual_strips(
        jnp.asarray(ms).astype(jdt), jnp.asarray(pan).astype(jdt),
        jnp.asarray(xs, jnp.int32), jnp.asarray(y0s, jnp.int32), w, PS,
        strip=strip, interpret=True)
    got = tstrip.gather_dual_strips_ref(
        torch.from_numpy(ms).to(tdt), torch.from_numpy(pan).to(tdt),
        torch.tensor(xs, dtype=torch.int32),
        torch.tensor(y0s, dtype=torch.int32), w, PS, strip)
    return got, want


def _assert_equal(got, want, tdt):
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strip,xs", [(32, [5, 12, 30]), (64, [0, 7, 40])])
def test_dual_strips_match_jax_interpret(dtype, strip, xs):
    ms, pan, w = _scene(strip, seed=strip)
    y0s = [0, strip, 2 * strip]  # on the strip grid
    got, want = _both(ms, pan, xs, y0s, w, strip, dtype)
    _assert_equal(got, want, _DT[dtype][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_and_unaligned_strips_match_jax(dtype):
    """Past the bottom, past the right edge, and a y0 whose lane offset
    y0*C is no multiple of 128: the TPU kernel reads zeros past the view
    (it pads; it does not clamp) and gives the same windows at any y0."""
    strip = 32
    ms, pan, w = _scene(strip, seed=3)
    hv, wv = ms.shape[:2]  # 55 x 135
    xs, y0s = [hv - 3, 40, 17], [wv - 20, 3, 45]
    got, want = _both(ms, pan, xs, y0s, w, strip, dtype)
    _assert_equal(got, want, _DT[dtype][1])
    ms_w, pan_w = got
    # Strip 0: MS window rows 3.. and PAN rows 15.. lie below the view.
    assert not ms_w[:strip, 3:].any() and ms_w[:strip, :3].any()
    assert not pan_w[:strip, 15:].any() and pan_w[:strip, :15].any()
    # Its last window starts at column wv - 20 + 31 = wv + 11: all zeros.
    assert not ms_w[strip - 1].any()


@pytest.mark.parametrize("strip", [32, 64])
def test_in_range_strips_equal_gather_dual(strip):
    """Strips that fit inside the view give the per-anchor windows."""
    ms, pan, w = _scene(strip, seed=7)
    xs = np.array([2, 9, 9, 33], np.int32)
    y0s = np.array([0, 1, strip + 5, 2 * strip - 3], np.int32)
    ids = (xs[:, None] * w + y0s[:, None] + np.arange(strip)).reshape(-1)
    ms_t, pan_t = torch.from_numpy(ms), torch.from_numpy(pan)
    got = tstrip.gather_dual_strips(ms_t, pan_t, torch.from_numpy(xs),
                                    torch.from_numpy(y0s), w, PS, strip)
    want = tpatches.gather_dual(ms_t, pan_t, torch.from_numpy(ids), w, PS)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("fn", [tstrip.gather_dual_strips_ref,
                                tstrip.gather_dual_strips])
@pytest.mark.parametrize("xs,y0s", [([3, -1], [0, 0]), ([3, 4], [0, -32])])
def test_negative_starts_raise(fn, xs, y0s):
    ms, pan, w = _scene(32)
    with pytest.raises(ValueError, match="negative strip start"):
        fn(torch.from_numpy(ms), torch.from_numpy(pan),
           torch.tensor(xs, dtype=torch.int32),
           torch.tensor(y0s, dtype=torch.int32), w, PS, 32)


def test_strip_grid_is_the_jax_tools_grid():
    """The grid of ``tools/strip_gather_bench.py:51-58``: full strips per
    row, rows from the top, raster order."""
    xs, y0s = strip_gather_bench.strip_grid(2001, 2101, 16, 98_304, 128)
    assert len(xs) == 768 and xs.max() == 47
    assert list(y0s[:17]) == [128 * k for k in range(16)] + [0]
    assert list(xs[15:17]) == [0, 1]
    ids = strip_gather_bench.strip_ids(xs[:2], y0s[:2], 2101, 128)
    assert list(ids[[0, 127, 128, 255]]) == [0, 127, 128, 255]


def test_moved_bytes_counts_windows_and_covered_elements():
    ms, pan, w = _scene(32, seed=5)
    ms_t, pan_t = torch.from_numpy(ms), torch.from_numpy(pan)
    xs = torch.tensor([0, 1, 50], dtype=torch.int32)  # overlapping; past
    y0s = torch.tensor([0, 4, 120], dtype=torch.int32)
    cover_ms = np.zeros(ms.shape[:2], bool)
    cover_pan = np.zeros(pan.shape, bool)
    for x, y in zip(xs.tolist(), y0s.tolist()):
        cover_ms[x:x + PS, y:y + 31 + PS] = True
        cover_pan[4 * x:4 * x + 4 * PS, 4 * y:4 * y + 4 * 31 + 4 * PS] = True
    written = 3 * 32 * (PS * PS * C + 16 * PS * PS)
    read = C * cover_ms.sum() + cover_pan.sum()
    assert strip_gather_bench.moved_bytes(ms_t, pan_t, xs, y0s, PS, 32) \
        == 4 * (written + read) + 2 * 3 * 4


def test_strip_gather_bench_runs_on_cpu():
    out = strip_gather_bench.run("cpu", anchors=512, strip=32, patch=PS,
                                 size=(H, 128, C))
    assert out["bit_equal_to_per_anchor"] and out["strips"] == 16
    assert out["strips_per_row"] == 3 and out["rows"] == 6
    assert out["strip_calls"] == 1 and "ms" not in out


def test_strip_gather_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        strip_gather_bench.run()
