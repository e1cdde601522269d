"""Batched patch-window gather: the CUDA kernel and its plain version.

Port of ``dmfusion/ops/pallas_gather.py``.  The TPU kernel there DMAs a
tile-aligned block per anchor and cuts the window out with one-hot
matmuls; on the card the gather is a copy kernel
(``dmfusion_torch/csrc/gather_windows.cu``), bit-equal to the plain
advanced-indexing version.

A family call gathers the windows of up to four streams at one batch of
flat anchor ids in one launch: each stream is a scene ``(H', W', C)``
with its anchor scale (1 at MS geometry, 4 at PAN geometry) and window
edge ``patch * scale``.  The kernel decodes the ids itself
(``x = id // width``, ``y = id % width``, floored as the plain version
floors them) and places each start as ``jax.lax.dynamic_slice`` does: a
negative start counts from the end, then the start is clamped so the
window fits.  :func:`gather_family` picks the plain version
(:func:`gather_family_ref`) for CPU tensors and the kernel
(:func:`gather_family_cuda`) for CUDA tensors; there is no fallback from
the kernel.  The wrappers over it follow dmfusion's: one stream, dual (MS
and PAN), tri, quad (whose four streams land in one ``(4B, ps, ps, C)``
buffer, :func:`gather_quad_batch`), and the mesh's sharded dual gather
(:func:`gather_dual_sharded`).  Each takes ``shard=(lo, hi, per)``, a
rank's rows of the batch (``Mesh.shard_rows``): the ``per`` output rows
gather the anchors ``ids[lo:hi]``, and the rows past them the batch's
first anchor, as ``Mesh.shard`` pads a shard.  Under a mesh the training
programs gather a rank's shard that way with the family's own wrapper,
one launch a gathered batch.  :func:`gather_windows_cuda` is the
one-stream launch at explicit ``(xs, ys)`` starts over the same kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from dmfusion_torch.trace import span

#: The most streams one launch gathers.
MAX_STREAMS = 4
#: The scale of each stream's anchor, per wrapper.
ONE, DUAL, TRI, QUAD = (1,), (1, 4), (1, 4, 4), (1, 1, 1, 1)

Shard = tuple[int, int, int]


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


def shard_ids(ids: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """The anchors a call with ``shard=(lo, hi, per)`` gathers: ``ids[lo:hi]``
    padded to ``per`` with ``ids[0]`` (``Mesh.shard``'s rule)."""
    if shard is None:
        return ids
    lo, hi, per = shard
    return torch.cat([ids[lo:hi], ids[:1].expand(per - (hi - lo))])


def _check_family(scenes: Sequence[torch.Tensor], ids: torch.Tensor,
                  scales: Sequence[int], patch: int) -> None:
    """What the plain version and the kernel both refuse."""
    if not 1 <= len(scenes) <= MAX_STREAMS or len(scales) != len(scenes):
        raise ValueError(f"a family call gathers 1 to {MAX_STREAMS} streams, "
                         f"each with its scale: got {len(scenes)} streams "
                         f"and {len(scales)} scales")
    dtype = scenes[0].dtype
    if any(t.dtype != dtype for t in scenes):
        raise ValueError(f"the streams differ in dtype: "
                         f"{[str(t.dtype) for t in scenes]}")
    if ids.ndim != 1:
        raise ValueError(f"ids must be 1-D, got shape {tuple(ids.shape)}")
    if patch < 1 or any(s < 1 for s in scales):
        raise ValueError(f"patch {patch} and scales {tuple(scales)} must be "
                         "positive")


def gather_family_ref(scenes: Sequence[torch.Tensor], ids: torch.Tensor,
                      width: int, patch: int, scales: Sequence[int],
                      shard: Shard | None = None) -> tuple[torch.Tensor, ...]:
    """Plain version of a family call: per stream ``(per, win, win, C)``
    windows, ``win = patch * scale``, at the anchors ``shard_ids(ids,
    shard)`` decoded as ``id // width, id % width`` times the scale."""
    _check_family(scenes, ids, scales, patch)
    ids = shard_ids(ids, shard).to(torch.int64)
    x, y = ids // width, ids % width
    out = []
    for img, s in zip(scenes, scales):
        img3 = img if img.ndim == 3 else img[..., None]
        h, w, c = img3.shape
        win = patch * s
        out.append(gather_windows_ref(img3.reshape(h, w * c), s * x, s * y,
                                      win, c).reshape(-1, win, win, c))
    return tuple(out)


@functools.cache
def _kernel():
    from dmfusion_torch.ops._build import load_library
    fn = load_library("gather_windows").gather_family
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(args: list[int]) -> None:
    """One kernel launch of the C entry's argument list, in a ``b1.launch``
    span; counts it."""
    with span("b1.launch"):
        err = _kernel()((ctypes.c_longlong * len(args))(*args))
    if err != 0:
        raise RuntimeError(f"gather_windows kernel launch failed: "
                           f"cudaError_t {err}")
    gather_windows_cuda.launches += 1


def _head(n: int, elem: int, patch: int, id_width: int, lo: int, hi: int,
          per: int, ids: torch.Tensor, ys: torch.Tensor | None,
          dev: int) -> list[int]:
    """The C entry's arguments before the streams'."""
    return [n, elem, patch, id_width, lo, hi, per, dev,
            ids.data_ptr(), 0 if ys is None else ys.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev)]


def gather_family_cuda(scenes: Sequence[torch.Tensor], ids: torch.Tensor,
                       width: int, patch: int, scales: Sequence[int],
                       shard: Shard | None = None, *, stacked: bool = False
                       ) -> tuple[torch.Tensor, ...] | torch.Tensor:
    """The kernel: :func:`gather_family_ref`'s windows in one launch.

    ``scenes`` are contiguous CUDA tensors of one 2- or 4-byte dtype on
    ``ids``' device; int32 ids are taken as they are, others converted.
    ``stacked=True`` (streams of one window shape) writes every stream
    into one buffer and returns it as ``(n * per, win, win, C)``.  The
    launch adds one to ``gather_windows_cuda.launches``.  The checks run
    once a call; the host work is kept small, since a call at B 256 moves
    a few megabytes."""
    n = len(scenes)
    if not 1 <= n <= MAX_STREAMS or len(scales) != n:
        _check_family(scenes, ids, scales, patch)
    dev = ids.get_device()
    if dev < 0:
        raise ValueError("the window kernel needs CUDA tensors")
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        ids = ids.to(torch.int32).contiguous()
    if ids.dim() != 1 or patch < 1:
        _check_family(scenes, ids, scales, patch)
    b = ids.shape[0]
    lo, hi, per = (0, b, b) if shard is None else shard
    if not 0 <= lo <= hi <= b or per < hi - lo or (per > 0 and b == 0):
        raise ValueError(f"shard {shard} does not fit a batch of {b}")
    dtype = scenes[0].dtype
    elem = scenes[0].element_size()
    if elem not in (2, 4):
        raise ValueError(f"unsupported scene dtype {dtype}")
    args = _head(n, elem, patch, width, lo, hi, per, ids, None, dev)
    shapes, outs = [], []
    for img, k in zip(scenes, scales):
        if (img.dtype != dtype or img.get_device() != dev
                or not img.is_contiguous()):
            _check_family(scenes, ids, scales, patch)
            raise ValueError(f"every scene must be a contiguous CUDA tensor "
                             f"on cuda:{dev}")
        h, w, *c = img.shape
        c = c[0] if c else 1
        win = patch * k
        if h < win or w < win or k < 1 or img.dim() not in (2, 3):
            raise ValueError(f"scene {tuple(img.shape)} does not hold the "
                             f"{win}x{win} window")
        shapes.append((per, win, win, c))
        if not stacked:
            outs.append(torch.empty(shapes[-1], dtype=dtype,
                                    device=ids.device))
        args += [img.data_ptr(), 0, h, w, c, k]
    if stacked:
        if shapes.count(shapes[0]) != n:
            raise ValueError(f"stacked streams need one window shape, got "
                             f"{shapes}")
        buf = torch.empty((n * per, *shapes[0][1:]), dtype=dtype,
                          device=ids.device)
        step = buf.numel() // n * elem
        ptrs = [buf.data_ptr() + i * step for i in range(n)]
    else:
        ptrs = [o.data_ptr() for o in outs]
    args[12::6] = ptrs
    if per:
        _launch(args)
    return buf if stacked else tuple(outs)


def gather_family(scenes: Sequence[torch.Tensor], ids: torch.Tensor,
                  width: int, patch: int, scales: Sequence[int],
                  shard: Shard | None = None, *, stacked: bool = False
                  ) -> tuple[torch.Tensor, ...] | torch.Tensor:
    """The plain version for CPU scenes, the kernel for CUDA scenes."""
    # ``is_cuda`` first: a device object costs host time on every call.
    if not scenes[0].is_cuda and scenes[0].device.type == "cpu":
        out = gather_family_ref(scenes, ids, width, patch, scales, shard)
        return torch.cat(out) if stacked else out
    return gather_family_cuda(scenes, ids, width, patch, scales, shard,
                              stacked=stacked)


def gather_windows_cuda(scene2d: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor, patch: int, chans: int) -> torch.Tensor:
    """The kernel at explicit starts, one stream: same contract as
    :func:`gather_windows_ref`.

    ``scene2d`` is a contiguous CUDA tensor of 2- or 4-byte elements;
    ``xs``/``ys`` are contiguous int32 tensors on the same device.  Each
    launch adds one to ``gather_windows_cuda.launches``, the count of every
    launch of the kernel.
    """
    if scene2d.ndim != 2 or not scene2d.is_contiguous():
        raise ValueError(f"scene view must be a contiguous 2-D tensor, got "
                         f"shape {tuple(scene2d.shape)}")
    rows, row_elems = scene2d.shape
    if patch < 1 or chans < 1 or row_elems % chans:
        raise ValueError(f"row of {row_elems} elements does not hold "
                         f"pixels of {chans} channels")
    for name, t in (("xs", xs), ("ys", ys)):
        if (t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous()
                or t.device != scene2d.device):
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {scene2d.device}")
    if xs.shape != ys.shape:
        raise ValueError("xs and ys differ in length")
    if not scene2d.is_cuda:
        raise ValueError("gather_windows_cuda needs a CUDA scene tensor")
    if rows < patch or row_elems // chans < patch:
        raise ValueError(f"scene {rows}x{row_elems // chans} is smaller than "
                         f"the {patch}x{patch} window")
    elem = scene2d.element_size()
    if elem not in (2, 4):
        raise ValueError(f"unsupported scene dtype {scene2d.dtype}")
    batch = xs.shape[0]
    out = torch.empty((batch, patch, patch * chans), dtype=scene2d.dtype,
                      device=scene2d.device)
    if batch:
        _launch(_head(1, elem, patch, 1, 0, batch, batch, xs, ys,
                      scene2d.get_device())
                + [scene2d.data_ptr(), out.data_ptr(), rows,
                   row_elems // chans, chans, 1])
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
                    patch: int, shard: Shard | None = None) -> torch.Tensor:
    """Single-image window gather: (B,) ids -> (B, patch, patch, C); one
    launch on the card."""
    return gather_family((img,), ids, width, patch, ONE, shard)[0]


def gather_quad_batch(ms: torch.Tensor, pan_ms: torch.Tensor,
                      ms_gan: torch.Tensor, pan_gan: torch.Tensor,
                      ids: torch.Tensor, width: int, patch: int,
                      shard: Shard | None = None) -> torch.Tensor:
    """The four MS-geometry streams' windows in one ``(4B, ps, ps, C)``
    batch, stream after stream (the quad model's input, reference
    tostagesolver.py:271), written there by one launch on the card."""
    return gather_family((ms, pan_ms, ms_gan, pan_gan), ids, width, patch,
                         QUAD, shard, stacked=True)


def gather_quad_fast(ms: torch.Tensor, pan_ms: torch.Tensor,
                     ms_gan: torch.Tensor, pan_gan: torch.Tensor,
                     ids: torch.Tensor, width: int, patch: int,
                     shard: Shard | None = None) -> tuple[torch.Tensor, ...]:
    """Same contract as :func:`dmfusion_torch.data.patches.gather_quad`:
    :func:`gather_quad_batch`'s four streams as contiguous views, one
    launch on the card.  Unlike dmfusion's ``_use_fast`` rule (batches of
    1024 or more, multiples of 64), the kernel takes every batch on the
    card, the train batches of 256 included."""
    batch = gather_quad_batch(ms, pan_ms, ms_gan, pan_gan, ids, width, patch,
                              shard)
    return tuple(batch.view(4, -1, *batch.shape[1:]).unbind(0))


def gather_dual_fast(ms: torch.Tensor, pan: torch.Tensor, ids: torch.Tensor,
                     width: int, patch: int, shard: Shard | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`dmfusion_torch.data.patches.gather_dual`:
    ``(B, ps, ps, C)`` MS windows and ``(B, 4ps, 4ps, 1)`` PAN windows,
    the PAN anchor at 4x the MS anchor; one launch on the card."""
    return gather_family((ms, pan), ids, width, patch, DUAL, shard)


def gather_tri_fast(ms: torch.Tensor, pan: torch.Tensor, mspan: torch.Tensor,
                    ids: torch.Tensor, width: int, patch: int,
                    shard: Shard | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as :func:`dmfusion_torch.data.patches.gather_tri`:
    :func:`gather_dual_fast`'s windows and the MSPAN windows at the PAN
    anchor and window; one launch on the card."""
    return gather_family((ms, pan, mspan), ids, width, patch, TRI, shard)


def gather_dual_sharded(ms: torch.Tensor, pan: torch.Tensor, ids: torch.Tensor,
                        width: int, patch: int, mesh
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The mesh route of :func:`gather_dual_fast` (port of dmfusion's
    ``gather_dual_sharded``): every rank holds the scene and the global
    ``ids``, and gathers its own contiguous shard, ``mesh.shard_rows(b)``,
    in one launch on the card (the plain gather on the CPU).  Returns this
    rank's windows, ``mesh.per_rank(b)`` rows; its real rows are
    ``mesh.bounds(b)`` of ``ids``, and the rows past them gather the
    batch's first anchor again and are to be masked.  The windows stay on
    the rank, as dmfusion's ``out_specs`` keep them sharded: the forward
    runs on the shard.  No padding to 64 anchors: the kernel takes any
    batch."""
    return gather_dual_fast(ms, pan, ids, width, patch,
                            mesh.shard_rows(ids.shape[-1]))
