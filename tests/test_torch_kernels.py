"""The port's CUDA kernels against their plain versions.

This file imports neither JAX nor ``dmfusion``, so it also runs on the
machine with the card, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)  Tests
marked ``gpu`` skip without a CUDA device; the rest check the wrappers'
dispatch and argument checks on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dmfusion_torch.data import patches
from dmfusion_torch.models import dense_fusion
from dmfusion_torch.ops import conv3x3, gather, pool, strip_gather
from dmfusion_torch.tools import conv_kernel_probe

H, W, C, PS = 40, 44, 4, 8


def _scene(dtype=torch.float32, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    ms = rng.standard_normal((H + PS - 1, W + PS - 1, C)).astype(np.float32)
    pan = rng.standard_normal((4 * H + 4 * PS - 1, 4 * W + 4 * PS - 1)
                              ).astype(np.float32)
    return (torch.from_numpy(ms).to(device, dtype),
            torch.from_numpy(pan).to(device, dtype))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_cpu_dispatch_takes_plain_version():
    ms, _ = _scene()
    view = ms.reshape(ms.shape[0], -1)
    xs = torch.tensor([0, 3, -2], dtype=torch.int32)
    before = gather.gather_windows_cuda.launches
    out = gather.gather_windows(view, xs, xs, PS, C)
    assert gather.gather_windows_cuda.launches == before
    assert torch.equal(out, gather.gather_windows_ref(view, xs, xs, PS, C))


def test_wrapper_refuses_cpu_tensor():
    ms, _ = _scene()
    xs = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_windows_cuda(ms.reshape(ms.shape[0], -1), xs, xs, PS, C)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [4096, 4093, 1])
def test_gather_dual_kernel_bit_equal(cuda, dtype, batch):
    ms, pan = _scene(dtype, cuda)
    rng = np.random.default_rng(batch)
    ids_np = rng.integers(0, H * W, batch).astype(np.int32)
    ids_np[0], ids_np[-1] = H * W - 1, 0  # both corners (one when batch=1)
    ids = torch.from_numpy(ids_np).to(cuda)
    before = gather.gather_windows_cuda.launches
    got = gather.gather_dual_fast(ms, pan, ids, W, PS)
    assert gather.gather_windows_cuda.launches == before + 2
    want = patches.gather_dual(ms, pan, ids, W, PS)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_gather_kernel_clamps_like_plain(cuda):
    ms, pan = _scene(device=cuda)
    for view, patch, chans in ((ms.reshape(ms.shape[0], -1), PS, C),
                               (pan, 4 * PS, 1)):
        hr, hc = view.shape[0] + 3, view.shape[1] // chans + 3
        xs = torch.tensor([-1, -hr, 0, hr, 2**31 - 1, -7], dtype=torch.int32,
                          device=cuda)
        ys = torch.tensor([0, 5, -hc, -1, -2**31, hc], dtype=torch.int32,
                          device=cuda)
        got = gather.gather_windows_cuda(view, xs, ys, patch, chans)
        want = gather.gather_windows_ref(view, xs, ys, patch, chans)
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_gather_kernel_empty_batch_launches_nothing(cuda):
    ms, _ = _scene(device=cuda)
    xs = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = gather.gather_windows_cuda.launches
    out = gather.gather_windows_cuda(ms.reshape(ms.shape[0], -1), xs, xs, PS, C)
    assert out.shape == (0, PS, PS * C)
    assert gather.gather_windows_cuda.launches == before


# -- phase window-pool (dmfusion_torch/ops/pool.py) --------------------------

def _s2d_feats(hm, wm, c4, dtype=torch.float32, device="cpu", seed=0):
    """s2d-2 features of an (hm, wm) full-res map and the pool's output
    size (ni, nj) for ``patch``-wide windows over it."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((-(-hm // 2), -(-wm // 2), c4)).astype(np.float32)
    return torch.from_numpy(f).to(device, dtype)


def _out(hm, wm, patch):
    return -(-(hm - patch + 1) // 2), -(-(wm - patch + 1) // 2)


def test_pool_cpu_dispatch_takes_plain_version():
    f = _s2d_feats(37, 45, 16)
    ni, nj = _out(37, 45, 8)
    before = pool.phase_pool_cuda.launches
    out = dense_fusion.phase_pooled_s2d(f, 8, 37 - 7, 45 - 7)
    assert pool.phase_pool_cuda.launches == before
    assert out.shape == (ni, nj, 16)
    assert torch.equal(out, pool.phase_pool_ref(f, 8, ni, nj))


def test_pool_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        pool.phase_pool_cuda(_s2d_feats(20, 20, 16), 8, 7, 7)


def test_pool_refuses_odd_patch():
    """Odd windows do not split into phases: dense_fusion routes them to
    the full-res window mean instead."""
    with pytest.raises(ValueError, match="even patch"):
        pool.phase_pool_ref(_s2d_feats(20, 20, 16), 7, 7, 7)


# The registers body's seams: column tiles of 15 (launch_plan with 256
# threads of 128 channels) and 5 blocks, whose row shares cross tiles.
SEAM_PLAN = {"plan": dict(max_threads=256, blocks=5)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hm,wm,c4,patch,case", [
    (73, 89, 64, 8, {}),      # odd output rows and columns
    (80, 120, 128, 16, {}),   # two row tiles, two column tiles
    (66, 41, 256, 32, {}),    # wide channels, ph = 16
    (41, 57, 12, 6, {}),      # C = 3, 1/36 not a power of two
    (35, 35, 8, 2, {}),       # ph = 1
    # outputs one below, at and one above two column tiles
    (77, 73, 128, 16, SEAM_PLAN), (79, 75, 128, 16, SEAM_PLAN),
    (81, 77, 128, 16, SEAM_PLAN),
    # the default plan's 31-column tiles: 61, 62 and 63 output columns
    (60, 137, 128, 16, {}), (60, 139, 128, 16, {}), (60, 141, 128, 16, {}),
    # a map narrower and shorter than ph + 1: windows past it read zeros
    (5, 7, 16, 16, {"out": (6, 7)}),
    # ph just above the registers body's 16: the shared body
    (80, 90, 16, 34, {}), (70, 75, 8, 40, {}),
    # pixels of 40 and 88 bytes in bf16: 8-byte copies, 1-channel stores
    (50, 61, 20, 16, {}), (39, 70, 44, 10, {})])
def test_phase_pool_kernel_bit_equal(cuda, dtype, hm, wm, c4, patch, case):
    f = _s2d_feats(hm, wm, c4, dtype, cuda, seed=hm + wm + c4)
    ni, nj = case.get("out", _out(hm, wm, patch))
    plan = None
    if "plan" in case:
        plan = pool.launch_plan(*f.shape, patch, ni, nj, f.element_size(),
                                **case["plan"])
        assert plan.body == "registers" and plan.tj == 15
        assert plan.grid == (5, 1)
    before = pool.phase_pool_cuda.launches
    got = pool.phase_pool_cuda(f, patch, ni, nj, plan)
    assert pool.phase_pool_cuda.launches == before + 1
    want = pool.phase_pool_ref(f, patch, ni, nj)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (ni, nj, c4)
    assert torch.equal(got, want)
    if "out" in case:
        assert not got[3:].any() and not got[:, 4:].any()


@pytest.mark.gpu
def test_phase_pool_kernel_refuses_bad_plan(cuda):
    """A plan the kernel cannot run is refused by the C entry and raised;
    nothing is launched and nothing falls back."""
    f = _s2d_feats(40, 40, 16, torch.float32, cuda)
    plan = pool.launch_plan(*f.shape, 8, 17, 17, 4)
    before = pool.phase_pool_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        pool.phase_pool_cuda(f, 8, 17, 17, dataclasses.replace(
            plan, smem=plan.smem - 16))
    assert pool.phase_pool_cuda.launches == before


@pytest.mark.gpu
def test_phase_pooled_s2d_launches_kernel_once(cuda):
    f = _s2d_feats(80, 120, 128, torch.bfloat16, cuda)
    before = pool.phase_pool_cuda.launches
    got = dense_fusion.phase_pooled_s2d(f, 16, 80 - 15, 120 - 15)
    assert pool.phase_pool_cuda.launches == before + 1
    assert torch.equal(got, pool.phase_pool_ref(f, 16, *_out(80, 120, 16)))


# -- strip gather (dmfusion_torch/ops/strip_gather.py) -----------------------

def _strip_starts(device="cpu"):
    """Strips of 32: on the grid, off any alignment, past the right edge,
    past the bottom, and wholly below the view (MS starts)."""
    hv, wv = H + PS - 1, W + PS - 1
    xs = torch.tensor([0, 5, hv - 3, 2, hv + 1], dtype=torch.int32)
    y0s = torch.tensor([0, 7, 1, wv - 9, 3], dtype=torch.int32)
    return xs.to(device), y0s.to(device)


def test_strip_cpu_dispatch_takes_plain_version():
    ms, pan = _scene()
    xs, y0s = _strip_starts()
    before = strip_gather.gather_strips_cuda.launches
    got = strip_gather.gather_dual_strips(ms, pan, xs, y0s, W, PS, 32)
    assert strip_gather.gather_strips_cuda.launches == before
    want = strip_gather.gather_dual_strips_ref(ms, pan, xs, y0s, W, PS, 32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_strip_wrapper_refuses_cpu_tensor():
    ms, _ = _scene()
    xs, y0s = _strip_starts()
    with pytest.raises(ValueError, match="CUDA"):
        strip_gather.gather_strips_cuda(ms.reshape(ms.shape[0], -1), xs, y0s,
                                        PS, W + PS - 1, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_strips_kernel_bit_equal(cuda, dtype):
    """MS at stride 1 and PAN at stride 4 with a 32-pixel window, edge
    strips included: two launches, the plain version's windows."""
    ms, pan = _scene(dtype, cuda)
    xs, y0s = _strip_starts(cuda)
    before = strip_gather.gather_strips_cuda.launches
    got = strip_gather.gather_dual_strips(ms, pan, xs, y0s, W, PS, 32)
    assert strip_gather.gather_strips_cuda.launches == before + 2
    want = strip_gather.gather_dual_strips_ref(ms, pan, xs, y0s, W, PS, 32)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert not got[0][4 * 32:].any() and not got[1][4 * 32:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans,patch,strip,stride", [
    (128, 16, 128, 1),   # a slab row over the budget: window groups
    (1, 64, 128, 4),     # the image6 PAN geometry: row groups
    (3, 5, 7, 2)])       # odd everything
def test_strip_kernel_bit_equal_in_groups(cuda, dtype, chans, patch, strip,
                                          stride):
    rng = np.random.default_rng(chans + patch)
    rows, width = 3 * patch, stride * strip + patch + 9
    view = torch.from_numpy(rng.standard_normal((rows, width * chans))
                            .astype(np.float32)).to(cuda, dtype)
    xs = torch.tensor([0, rows - patch, rows - 2, 1], dtype=torch.int32,
                      device=cuda)
    y0s = torch.tensor([0, 9, 3, width - stride * 3], dtype=torch.int32,
                       device=cuda)
    got = strip_gather.gather_strips_cuda(view, xs, y0s, patch, width, strip,
                                          stride)
    want = strip_gather.gather_strips_ref(view, xs, y0s, patch, width, strip,
                                          stride)
    torch.cuda.synchronize()
    assert got.shape == (4, strip, patch, patch * chans)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_strip_kernel_refuses_negative_start(cuda):
    ms, _ = _scene(device=cuda)
    xs = torch.tensor([0, -1], dtype=torch.int32, device=cuda)
    before = strip_gather.gather_strips_cuda.launches
    with pytest.raises(ValueError, match="negative strip start"):
        strip_gather.gather_strips_cuda(ms.reshape(ms.shape[0], -1), xs,
                                        xs.abs(), PS, W + PS - 1, 32)
    assert strip_gather.gather_strips_cuda.launches == before


# -- 3x3 conv (dmfusion_torch/ops/conv3x3.py) --------------------------------

def _conv_inputs(h, w, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((h, w, 128)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, 128, 128)) / np.sqrt(9 * 128)).astype(
        np.float32)
    return (torch.from_numpy(x).to(device, torch.bfloat16),
            torch.from_numpy(wgt).to(device, torch.bfloat16))


def test_conv_cpu_dispatch_takes_plain_version():
    x, wgt = _conv_inputs(6, 7)
    before = conv3x3.conv3x3_cuda.launches
    got = conv3x3.conv3x3(x, wgt)
    assert conv3x3.conv3x3_cuda.launches == before
    assert torch.equal(got, conv3x3.conv3x3_ref(x, wgt))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(37, 45), (64, 70), (1, 1),
                                 # on and off the kernel's 8 x 32 tile
                                 (9, 33), (8, 32), (7, 31), (1, 100),
                                 (100, 1)])
def test_conv_kernel_within_one_ulp(cuda, h, w):
    """Equal or one bf16 ulp apart from the plain version and cuDNN (the
    f32 sums' own error allowed near zero: ``ulp_report``); one launch."""
    x, wgt = _conv_inputs(h, w, cuda, seed=h)
    before = conv3x3.conv3x3_cuda.launches
    got = conv3x3.conv3x3(x, wgt)
    assert conv3x3.conv3x3_cuda.launches == before + 1
    abs_sum = conv3x3.conv3x3_f32(x.abs(), wgt.abs())
    for want in (conv3x3.conv3x3_ref(x, wgt),
                 conv3x3.conv3x3_library(x, wgt)):
        rep = conv3x3.ulp_report(got, want, abs_sum)
        assert rep["ok"] and rep["share_differ"] < 1e-2, rep


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(9, 33), (8, 32), (7, 31), (1, 100),
                                 (100, 1)])
def test_conv_kernel_constant_case_closed_form(cuda, h, w):
    """x = 1, w = bf16(1/1152): every sum is exact in f32, so the kernel
    gives the closed form (9, 6, 4 taps inside, on edges, in corners) bit
    for bit, and one ulp of the plain version and cuDNN; one launch."""
    x, wgt, want = conv_kernel_probe.constant_case(h, w, cuda)
    before = conv3x3.conv3x3_cuda.launches
    got = conv3x3.conv3x3(x, wgt)
    assert conv3x3.conv3x3_cuda.launches == before + 1
    assert torch.equal(got, want)
    abs_sum = conv3x3.conv3x3_f32(x.abs(), wgt.abs())
    for ref in (conv3x3.conv3x3_ref(x, wgt), conv3x3.conv3x3_library(x, wgt)):
        assert conv3x3.ulp_report(got, ref, abs_sum)["ok"]
