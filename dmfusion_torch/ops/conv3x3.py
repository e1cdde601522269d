"""3x3 SAME convolution, 128 -> 128 channels, bf16: the CUDA kernel and
its plain version.

Port of the kernel that ``tools/conv_kernel_probe.py::make_conv`` builds
for the TPU.  Its three bodies (``_body_shift9``, ``_body_copy3``,
``_body_cat384``) are Mosaic layout experiments over a zero-haloed canvas;
over the valid region all three compute what the probe's XLA reference
computes: ``lax.conv_general_dilated(x[None], w, (1, 1), "SAME", ("NHWC",
"HWIO", "NHWC"))`` with f32 accumulation and a bf16 result.  The port
has one kernel for that function (``dmfusion_torch/csrc/conv3x3.cu``,
an implicit GEMM on Hopper's ``wgmma`` with a ring of weight stages that
arrive by bulk copies) and the plain version :func:`conv3x3_ref`, nine
shifted f32 matmuls summed in ``(dy, dx)`` order and rounded once, as
``_body_shift9`` does.  :func:`pack_weights` reorders the HWIO weights
into the 18 stage images that the kernel's ``wgmma`` reads as they are.

The two sum the same products in another order, so they are not
bit-equal.  :func:`ulp_report` holds them to "equal or one bf16 ulp
apart", where the ulp is that of the output element, except where the
output is so close to zero that the f32 sums' own error passes one ulp
of it: there the difference must lie within that error,
``F32_SUM_SLACK * 2**-24 * sum(|x * w|)`` over the element's 1152
products.  :func:`conv3x3` picks the plain version for a CPU tensor and
the kernel for a CUDA tensor; there is no fallback from the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

CHANNELS = 128
# The kernel's weight stages: one tap x 64 input channels x 128 output
# channels each, 18 in all (see pack_weights).
STAGES = 18
STAGE_ELEMS = 64 * CHANNELS
# The f32 error allowance near zero, in units of 2**-24 * sum(|x * w|).
# Where two f32 sums of the same exact bf16 products, in two orders, land
# more than one bf16 ulp apart, they differ by at most 0.76 such units on
# the CPU (conv3x3_ref against F.conv2d at (128, 128, 128), numpy seeds
# 1-3); tensor cores add their products in groups and may truncate, so
# the allowance is 16 units.  A wrong tap, halo or channel moves an
# output by the scale of the outputs (about 1 here), 10**4 times more.
F32_SUM_SLACK = 16


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (H, W, C), got shape {tuple(x.shape)}")
    if w.ndim != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[2]:
        raise ValueError(f"w must be HWIO (3, 3, {x.shape[2]}, O), got shape "
                         f"{tuple(w.shape)}")


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 sum: (H, W, C) x HWIO (3, 3, C, O) -> (H, W, O) float32,
    nine shifted matmuls of the zero-padded input summed in ``(dy, dx)``
    order.  bf16 values are exact in TF32, so a card's TF32 matmul setting
    does not change the products of bf16 inputs."""
    _check_shapes(x, w)
    h, wd, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            p = xp[dy:dy + h, dx:dx + wd].reshape(-1, c) @ w[dy, dx].float()
            acc = p if acc is None else acc + p
    return acc.reshape(h, wd, w.shape[3])


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: :func:`conv3x3_f32` rounded once to ``x.dtype``."""
    return conv3x3_f32(x, w).to(x.dtype)


def conv3x3_library(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function as one ``F.conv2d`` call, channels-last: the
    yardstick the kernel is timed and checked against on the card; the
    port's path never calls it."""
    _check_shapes(x, w)
    xn = x.permute(2, 0, 1)[None]  # (1, C, H, W), channels-last strides
    wn = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    return F.conv2d(xn, wn, padding=1)[0].permute(1, 2, 0)


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 values lie between ``a`` and ``b`` (bf16 tensors of
    one shape), as int32: 0 where equal, 1 for neighbours."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def ulp_report(got: torch.Tensor, want: torch.Tensor, abs_sum: torch.Tensor
               ) -> dict:
    """Hold two bf16 convolution outputs to "equal or one bf16 ulp apart"
    (see the module docstring); ``abs_sum`` is ``conv3x3_f32(|x|, |w|)``.
    Returns the share of elements that differ, the largest absolute
    difference and ulp distance, the count beyond one ulp, the largest
    difference of those in units of ``2**-24 * abs_sum``, and ``ok``."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise ValueError("ulp_report compares bf16 tensors")
    if got.shape != want.shape or abs_sum.shape != got.shape:
        raise ValueError("ulp_report: shapes differ")
    if got.numel() == 0:
        raise ValueError("ulp_report: empty tensors")
    ulps = ulp_distance(got, want)
    diff = (got.float() - want.float()).abs()
    far = ulps > 1
    units = diff[far].double() / (abs_sum[far].double() * 2.0**-24)
    worst = float(units.max()) if units.numel() else 0.0
    return {"share_differ": float((ulps > 0).double().mean()),
            "max_abs": float(diff.max()), "max_ulps": int(ulps.max()),
            "beyond_one_ulp": int(far.sum()),
            "beyond_max_units": worst,
            "ok": worst <= F32_SUM_SLACK}


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, 128, 128) weights -> (18, 8192): the kernel's weight
    stages, each the exact shared-memory image that one ring stage holds.

    Stage ``s = 2 * (3 * dy + dx) + c // 64`` holds tap (dy, dx) and input
    channels ``64 * (c // 64)`` on, for all 128 outputs, in wgmma's K-major
    no-swizzle layout of 8 x 8 core matrices: element ``w[dy, dx, c, o]``
    lies at index ``2048 * (c % 64 // 16) + 128 * (o // 8)
    + 64 * (c % 16 // 8) + 8 * (o % 8) + c % 8`` of its stage (twice that
    in bytes), as ``csrc/conv3x3.cu`` states.  A permutation: no value
    changes."""
    if tuple(w.shape) != (3, 3, CHANNELS, CHANNELS):
        raise ValueError(f"pack_weights takes HWIO (3, 3, {CHANNELS}, "
                         f"{CHANNELS}) weights, got shape {tuple(w.shape)}")
    # c = (half, k-step, k-half, k), o = (n-group, n)
    parts = w.reshape(3, 3, 2, 4, 2, 8, 16, 8)
    return parts.permute(0, 1, 2, 3, 6, 4, 7, 5).reshape(STAGES, STAGE_ELEMS)


@functools.cache
def _kernel():
    from dmfusion_torch.ops._build import load_library
    fn = load_library("conv3x3").conv3x3_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`conv3x3_ref`, for
    contiguous bf16 CUDA tensors with C = O = 128.  Packs the weights
    (:func:`pack_weights`) on every call.  Each launch adds one to
    ``conv3x3_cuda.launches``."""
    _check_shapes(x, w)
    if x.shape[2] != CHANNELS or w.shape[3] != CHANNELS:
        raise ValueError(f"the kernel takes {CHANNELS} -> {CHANNELS} "
                         f"channels, got {x.shape[2]} -> {w.shape[3]}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16, got {x.dtype} and "
                         f"{w.dtype}")
    if not x.is_cuda:
        raise ValueError("conv3x3_cuda needs a CUDA input tensor")
    if w.device != x.device:
        raise ValueError("x and w lie on different devices")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    h, wd, _ = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    wpk = pack_weights(w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), wpk.data_ptr(), out.data_ptr(), h, wd,
                    stream, x.device.index)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError_t {err}")
    conv3x3_cuda.launches += 1
    return out


conv3x3_cuda.launches = 0


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w)
    if x.is_cuda:
        return conv3x3_cuda(x.contiguous(), w.contiguous())
    raise ValueError(f"no 3x3 conv for device {x.device}")
