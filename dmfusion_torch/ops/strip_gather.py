"""Strip gather for raster-ordered anchors: the CUDA kernel and its plain
version.

Port of ``dmfusion/ops/pallas_strip_gather.py``.  A strip is ``strip``
consecutive anchors of one scene row; strip ``k`` starts at row ``xs[k]``
and column ``y0s[k]``, and its window ``s`` is

    view[xs[k] : xs[k] + patch, (y0s[k] + s*stride)*C : ... + patch*C]

of a 2-D ``(H', W'*C)`` scene view.  Reads past the bottom and the right
edge of the view are zeros (the TPU kernel pads the view with zeros; it
does not clamp as the per-anchor gather does).  A negative start is out
of bounds on the TPU, and raises ``ValueError`` here.  The TPU's
lane-alignment rule for ``y0s`` is a DMA artifact and is not carried
over: any start gives the same windows.

:func:`gather_strips` picks the plain version :func:`gather_strips_ref`
for a CPU tensor and the kernel (``dmfusion_torch/csrc/strip_gather.cu``)
for a CUDA tensor; there is no fallback from the kernel.  The kernel is a
copy, so it is bit-equal to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

# Shared memory one block stages a slab in (csrc/strip_gather.cu): under
# the 48 KB a block gets without opting in.
SLAB_BYTES = 46 * 1024


def _check_args(scene2d: torch.Tensor, xs: torch.Tensor, y0s: torch.Tensor,
                patch: int, width: int, strip: int, stride: int) -> int:
    """Validate the arguments; returns the channel count C."""
    if scene2d.ndim != 2:
        raise ValueError(f"scene view must be 2-D (H', W'*C), got shape "
                         f"{tuple(scene2d.shape)}")
    if width < 1 or scene2d.shape[1] % width:
        raise ValueError(f"row of {scene2d.shape[1]} elements does not hold "
                         f"{width} pixels")
    if patch < 1 or strip < 1 or stride < 1:
        raise ValueError(f"patch {patch}, strip {strip} and stride {stride} "
                         f"must be positive")
    if xs.ndim != 1 or xs.shape != y0s.shape:
        raise ValueError("xs and y0s must be 1-D and of one length")
    return scene2d.shape[1] // width


def _check_starts(xs: torch.Tensor, y0s: torch.Tensor) -> None:
    if xs.numel() and int(torch.minimum(xs.min(), y0s.min())) < 0:
        raise ValueError("negative strip start: the strip gather reads "
                         "zeros past the bottom and right edge only")


def strip_grids(scene2d: torch.Tensor, xs: torch.Tensor, y0s: torch.Tensor,
                patch: int, chans: int, strip: int, stride: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The view padded with one zero row and one zero column, and the
    broadcast row and column index grids, shaped (n, 1, patch, 1) and
    (n, strip, 1, patch*C), that gather the strips from it; every index
    past the view points at the zero row or column."""
    rows, row_elems = scene2d.shape
    dev = scene2d.device
    x = xs.to(dev, torch.int64)
    y0 = y0s.to(dev, torch.int64)
    r = (x[:, None] + torch.arange(patch, device=dev)).clamp_max(rows)
    first = (y0[:, None] + stride * torch.arange(strip, device=dev)) * chans
    c = (first[:, :, None] + torch.arange(patch * chans, device=dev)
         ).clamp_max(row_elems)
    return (F.pad(scene2d, (0, 1, 0, 1)), r[:, None, :, None],
            c[:, :, None, :])


def gather_strips_ref(scene2d: torch.Tensor, xs: torch.Tensor,
                      y0s: torch.Tensor, patch: int, width: int, strip: int,
                      stride: int = 1) -> torch.Tensor:
    """Plain version: (H', W'*C) view + (n,) strip starts ->
    (n, strip, patch, patch*C), by advanced indexing with
    :func:`strip_grids` on the zero-padded view."""
    chans = _check_args(scene2d, xs, y0s, patch, width, strip, stride)
    _check_starts(xs, y0s)
    padded, r, c = strip_grids(scene2d, xs, y0s, patch, chans, strip, stride)
    return padded[r, c]


@functools.cache
def _kernel():
    from dmfusion_torch.ops._build import load_library
    fn = load_library("strip_gather").gather_strips
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def gather_strips_cuda(scene2d: torch.Tensor, xs: torch.Tensor,
                       y0s: torch.Tensor, patch: int, width: int, strip: int,
                       stride: int = 1) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`gather_strips_ref`.

    ``scene2d`` is a contiguous CUDA tensor of 2- or 4-byte elements;
    ``xs``/``y0s`` are contiguous int32 tensors on the same device.  The
    check for negative starts reads them on the host (one synchronisation).
    Each launch adds one to ``gather_strips_cuda.launches``.
    """
    if not scene2d.is_cuda:
        raise ValueError("gather_strips_cuda needs a CUDA scene tensor")
    chans = _check_args(scene2d, xs, y0s, patch, width, strip, stride)
    if not scene2d.is_contiguous():
        raise ValueError("scene view must be contiguous")
    if scene2d.element_size() not in (2, 4):
        raise ValueError(f"unsupported scene dtype {scene2d.dtype}")
    if patch * chans * scene2d.element_size() > SLAB_BYTES:
        raise ValueError(f"one window row of {patch * chans} elements does "
                         f"not fit the kernel's {SLAB_BYTES}-byte slab")
    for name, t in (("xs", xs), ("y0s", y0s)):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.device != scene2d.device):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{scene2d.device}")
    _check_starts(xs, y0s)
    n = xs.shape[0]
    rows, row_elems = scene2d.shape
    out = torch.empty((n, strip, patch, patch * chans), dtype=scene2d.dtype,
                      device=scene2d.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(scene2d.device).cuda_stream
    err = _kernel()(scene2d.data_ptr(), rows, row_elems, xs.data_ptr(),
                    y0s.data_ptr(), n, strip, patch, chans, stride,
                    scene2d.element_size(), out.data_ptr(), stream,
                    scene2d.device.index)
    if err != 0:
        raise RuntimeError(f"strip_gather kernel launch failed: "
                           f"cudaError_t {err}")
    gather_strips_cuda.launches += 1
    return out


gather_strips_cuda.launches = 0


def gather_strips(scene2d: torch.Tensor, xs: torch.Tensor, y0s: torch.Tensor,
                  patch: int, width: int, strip: int, stride: int = 1
                  ) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if scene2d.device.type == "cpu":
        return gather_strips_ref(scene2d, xs, y0s, patch, width, strip,
                                 stride)
    if scene2d.is_cuda:
        dev = scene2d.device
        return gather_strips_cuda(scene2d.contiguous(),
                                  xs.to(dev, torch.int32).contiguous(),
                                  y0s.to(dev, torch.int32).contiguous(),
                                  patch, width, strip, stride)
    raise ValueError(f"no strip gather for device {scene2d.device}")


def _dual(gather, ms, pan, xs, y0s, patch, strip):
    """MS windows at stride 1, PAN windows at anchor 4x, stride 4 and
    window 4*patch, flattened to raster order."""
    n = xs.shape[0]
    c = ms.shape[-1]
    pan3 = pan if pan.ndim == 3 else pan[..., None]
    ms_w = gather(ms.reshape(ms.shape[0], -1), xs, y0s, patch, ms.shape[1],
                  strip, 1)
    pan_w = gather(pan3.reshape(pan3.shape[0], -1), 4 * xs, 4 * y0s,
                   4 * patch, pan3.shape[1], strip, 4)
    return (ms_w.reshape(n * strip, patch, patch, c),
            pan_w.reshape(n * strip, 4 * patch, 4 * patch, pan3.shape[-1]))


def gather_dual_strips_ref(ms: torch.Tensor, pan: torch.Tensor,
                           xs: torch.Tensor, y0s: torch.Tensor, width: int,
                           patch: int, strip: int = 128
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain dual-modality strip gather: per strip ``k``, the windows of
    anchors ``(xs[k], y0s[k]) .. (xs[k], y0s[k] + strip - 1)``.  Returns
    ``(n*strip, ps, ps, C)`` MS and ``(n*strip, 4ps, 4ps, 1)`` PAN windows
    in raster order.  ``width`` is the scene width, as in the JAX
    function; the views' own widths place the windows."""
    return _dual(gather_strips_ref, ms, pan, xs, y0s, patch, strip)


def gather_dual_strips(ms: torch.Tensor, pan: torch.Tensor, xs: torch.Tensor,
                       y0s: torch.Tensor, width: int, patch: int,
                       strip: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gather_dual_strips_ref`'s contract through
    :func:`gather_strips`: on the card, two kernel launches (MS, PAN)."""
    return _dual(gather_strips, ms, pan, xs, y0s, patch, strip)
