"""Batched patch-window gather: the CUDA kernel and its plain version.

Port of ``dmfusion/ops/pallas_gather.py``.  The TPU kernel there DMAs a
tile-aligned block per anchor and cuts the window out with one-hot
matmuls; on the card the gather is a plain copy kernel
(``dmfusion_torch/csrc/gather_windows.cu``), bit-equal to the plain
advanced-indexing version :func:`gather_windows_ref`.

Both work on a 2-D scene view ``(H', W'*C)`` — a window row is one
contiguous run of ``patch*C`` elements — and place each start as
``jax.lax.dynamic_slice`` does: a negative start counts from the end,
then the start is clamped so the window fits.  :func:`gather_windows`
picks the plain version for a CPU tensor and the kernel for a CUDA
tensor; there is no fallback from the kernel.  The wrappers over it
follow dmfusion's: one stream, dual (MS and PAN), tri, quad, and the
mesh's sharded dual gather (:func:`gather_dual_sharded`).  Under a mesh
the training programs gather a rank's shard, ``mesh.shard(ids)``, with
the family's own wrapper: tri and quad have no sharded function, as
dmfusion has none (it gathers them with the XLA gather under a mesh; the
card's kernel takes any shard, so here every rank's batch is 3 or 4
launches).
"""

from __future__ import annotations

import ctypes
import functools

import torch


def gather_windows_ref(scene2d: torch.Tensor, xs: torch.Tensor,
                       ys: torch.Tensor, patch: int, chans: int) -> torch.Tensor:
    """Plain version: (H', W'*C) view + (B,) pixel anchors ->
    (B, patch, patch*C), by advanced indexing with broadcast row and
    column index tensors."""
    rows, row_elems = scene2d.shape
    width = row_elems // chans
    dev = scene2d.device
    x = xs.to(dev, torch.int64)
    y = ys.to(dev, torch.int64)
    # dynamic_slice: a negative start counts from the end, then clamps.
    x = torch.where(x < 0, x + rows, x).clamp(0, rows - patch)
    y = torch.where(y < 0, y + width, y).clamp(0, width - patch)
    r = x[:, None] + torch.arange(patch, device=dev)
    c = y[:, None] * chans + torch.arange(patch * chans, device=dev)
    return scene2d[r[:, :, None], c[:, None, :]]


@functools.cache
def _kernel():
    from dmfusion_torch.ops._build import load_library
    fn = load_library("gather_windows").gather_windows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def gather_windows_cuda(scene2d: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor, patch: int, chans: int) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`gather_windows_ref`.

    ``scene2d`` is a contiguous CUDA tensor of 2- or 4-byte elements;
    ``xs``/``ys`` are contiguous int32 tensors on the same device.  Each
    launch adds one to ``gather_windows_cuda.launches``.
    """
    if not scene2d.is_cuda:
        raise ValueError("gather_windows_cuda needs a CUDA scene tensor")
    if scene2d.ndim != 2 or not scene2d.is_contiguous():
        raise ValueError(f"scene view must be a contiguous 2-D tensor, got "
                         f"shape {tuple(scene2d.shape)}")
    if scene2d.element_size() not in (2, 4):
        raise ValueError(f"unsupported scene dtype {scene2d.dtype}")
    rows, row_elems = scene2d.shape
    if patch < 1 or chans < 1 or row_elems % chans:
        raise ValueError(f"row of {row_elems} elements does not hold "
                         f"pixels of {chans} channels")
    if rows < patch or row_elems // chans < patch:
        raise ValueError(f"scene {rows}x{row_elems // chans} is smaller than "
                         f"the {patch}x{patch} window")
    for name, t in (("xs", xs), ("ys", ys)):
        if (t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous()
                or t.device != scene2d.device):
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {scene2d.device}")
    if xs.shape != ys.shape:
        raise ValueError("xs and ys differ in length")
    batch = xs.shape[0]
    out = torch.empty((batch, patch, patch * chans), dtype=scene2d.dtype,
                      device=scene2d.device)
    if batch == 0:
        return out
    stream = torch.cuda.current_stream(scene2d.device).cuda_stream
    err = _kernel()(scene2d.data_ptr(), rows, row_elems, xs.data_ptr(),
                    ys.data_ptr(), batch, patch, chans,
                    scene2d.element_size(), out.data_ptr(), stream,
                    scene2d.device.index)
    if err != 0:
        raise RuntimeError(f"gather_windows kernel launch failed: "
                           f"cudaError_t {err}")
    gather_windows_cuda.launches += 1
    return out


gather_windows_cuda.launches = 0


def gather_windows(scene2d: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                   patch: int, chans: int) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if scene2d.device.type == "cpu":
        return gather_windows_ref(scene2d, xs, ys, patch, chans)
    if scene2d.is_cuda:
        return gather_windows_cuda(scene2d, xs.to(torch.int32).contiguous(),
                                   ys.to(torch.int32).contiguous(),
                                   patch, chans)
    raise ValueError(f"no window gather for device {scene2d.device}")


def gather_one_fast(img: torch.Tensor, ids: torch.Tensor, width: int,
                    patch: int) -> torch.Tensor:
    """Single-image window gather: (B,) ids -> (B, patch, patch, C)."""
    img3 = img if img.ndim == 3 else img[..., None]
    c = img3.shape[-1]
    out = gather_windows(img3.reshape(img3.shape[0], -1), ids // width,
                         ids % width, patch, c)
    return out.reshape(ids.shape[0], patch, patch, c)


def gather_quad_fast(ms: torch.Tensor, pan_ms: torch.Tensor,
                     ms_gan: torch.Tensor, pan_gan: torch.Tensor,
                     ids: torch.Tensor, width: int, patch: int
                     ) -> tuple[torch.Tensor, ...]:
    """Same contract as :func:`dmfusion_torch.data.patches.gather_quad`:
    four :func:`gather_one_fast` calls at the MS anchor, so four kernel
    launches on the card.  Unlike dmfusion's ``_use_fast`` rule (batches
    of 1024 or more, multiples of 64), the kernel takes every batch on the
    card, the train batches of 256 included."""
    return tuple(gather_one_fast(img, ids, width, patch)
                 for img in (ms, pan_ms, ms_gan, pan_gan))


def gather_dual_fast(ms: torch.Tensor, pan: torch.Tensor, ids: torch.Tensor,
                     width: int, patch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`dmfusion_torch.data.patches.gather_dual`:
    ``(B, ps, ps, C)`` MS windows and ``(B, 4ps, 4ps, 1)`` PAN windows,
    the PAN anchor at 4x the MS anchor."""
    x, y = ids // width, ids % width
    c = ms.shape[-1]
    pan3 = pan if pan.ndim == 3 else pan[..., None]
    pc = pan3.shape[-1]
    b = ids.shape[0]
    ms_p = gather_windows(ms.reshape(ms.shape[0], -1), x, y, patch, c)
    pan_p = gather_windows(pan3.reshape(pan3.shape[0], -1), 4 * x, 4 * y,
                           4 * patch, pc)
    return (ms_p.reshape(b, patch, patch, c),
            pan_p.reshape(b, 4 * patch, 4 * patch, pc))


def gather_tri_fast(ms: torch.Tensor, pan: torch.Tensor, mspan: torch.Tensor,
                    ids: torch.Tensor, width: int, patch: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as :func:`dmfusion_torch.data.patches.gather_tri`:
    :func:`gather_dual_fast`, then the MSPAN windows at the PAN anchor and
    window (three kernel launches on the card)."""
    ms_p, pan_p = gather_dual_fast(ms, pan, ids, width, patch)
    mspan3 = mspan if mspan.ndim == 3 else mspan[..., None]
    mc = mspan3.shape[-1]
    mspan_p = gather_windows(mspan3.reshape(mspan3.shape[0], -1),
                             4 * (ids // width), 4 * (ids % width),
                             4 * patch, mc)
    return ms_p, pan_p, mspan_p.reshape(ids.shape[0], 4 * patch, 4 * patch,
                                        mc)


def gather_dual_sharded(ms: torch.Tensor, pan: torch.Tensor, ids: torch.Tensor,
                        width: int, patch: int, mesh
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The mesh route of :func:`gather_dual_fast` (port of dmfusion's
    ``gather_dual_sharded``): every rank holds the scene and the global
    ``ids``, and gathers its own contiguous shard, ``mesh.shard(ids)``,
    with :func:`gather_dual_fast` (two kernel launches on the card, the
    plain gather on the CPU).  Returns this rank's windows,
    ``mesh.per_rank(b)`` rows; its real rows are ``mesh.bounds(b)`` of
    ``ids``, and the rows past them gather the batch's first anchor again
    and are to be masked.  The windows stay on the rank, as dmfusion's
    ``out_specs`` keep them sharded: the forward runs on the shard.  No
    padding to 64 anchors: the kernel takes any batch."""
    return gather_dual_fast(ms, pan, mesh.shard(ids), width, patch)
