"""Phase window-pool: the CUDA kernel and its plain version.

Port of ``dmfusion/ops/pallas_pool.py::phase_pool_fused``.  Both map the
``(H2, W2, 4C)`` space-to-depth-2 packing of a full-resolution
``(2*H2, 2*W2, C)`` feature map to the ``(ni, nj, 4C)`` packing of its
``patch x patch`` window-mean map, in three steps:

1. the half-res ``ph x ph`` window sums ``t`` (``ph = patch // 2``) in f32,
   as left folds of shifted adds: first along columns,
   ``rs[r, j] = f[r, j] + f[r, j+1] + ... + f[r, j+ph-1]``, then along rows,
   ``t[i, j] = rs[i, j] + rs[i+1, j] + ... + rs[i+ph-1, j]``; reads past
   the feature map are zeros;
2. ``t`` rounded to the feature dtype;
3. the phase mix: output block ``(a, b)``, channel ``k``, is
   ``sum t[i+r, j+u, (2c+d)*C + k] * (1/patch**2)`` over the input phase
   blocks ``(c, d)`` with ``a & ~c == r`` and ``b & ~d == u``, accumulated
   in f32 with the shifts ``(r, u)`` in the order (0,0), (0,1), (1,0),
   (1,1) and ``(c, d)`` ascending within a shift, then cast once.

The TPU kernel does step 3 as four selection matmuls
(:func:`phase_mix_matrices`); here the selection is computed directly,
in that fixed order, so the kernel (``dmfusion_torch/csrc/phase_pool.cu``)
is bit-equal to :func:`phase_pool_ref` on the card.  :func:`phase_pool`
picks the plain version for a CPU tensor and the kernel for a CUDA
tensor; there is no fallback from the kernel.  :func:`launch_plan`
computes the kernel's launch (which body, tile, threads, vector widths,
shared memory, grid) on the host, where the CPU tests check it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from dmfusion_torch.trace import span


@functools.lru_cache(maxsize=None)
def phase_mix_matrices(c4: int, patch: int):
    """The four ``(r, u, M)`` phase-selection operands of the TPU kernel
    (a copy of ``dmfusion/models/dense_fusion.py::phase_mix_matrices``).
    For shift ``(r, u)``, ``M`` routes input phase block ``(c, d)`` to
    every output block ``(a, b)`` with ``a&~c == r`` and ``b&~d == u``;
    each (input, output) block pair matches exactly one shift, and the
    1/patch^2 window-mean scale folds into ``M``."""
    c = c4 // 4
    eye = np.eye(c, dtype=np.float32) / float(patch * patch)
    out = []
    for r in (0, 1):
        for u in (0, 1):
            m = np.zeros((c4, c4), np.float32)
            for ci in (0, 1):
                for d in (0, 1):
                    for a in (0, 1):
                        for b in (0, 1):
                            if (a & (1 - ci)) == r and (b & (1 - d)) == u:
                                m[(ci * 2 + d) * c:(ci * 2 + d + 1) * c,
                                  (a * 2 + b) * c:(a * 2 + b + 1) * c] \
                                    = eye
            out.append((r, u, m))
    return tuple(out)


@functools.cache
def phase_terms() -> tuple[tuple[tuple[int, int, int], ...], ...]:
    """Per output block ``a*2+b``: its four ``(r, u, c*2+d)`` terms in
    summation order, read off :func:`phase_mix_matrices` (shifts in the
    matrices' order, input blocks ascending within a shift).  The CUDA
    kernel walks the same order."""
    mats = phase_mix_matrices(4, 2)
    return tuple(
        tuple((r, u, blk) for r, u, m in mats for blk in range(4)
              if m[blk, out_blk] != 0)
        for out_blk in range(4))


def _check_shapes(feats: torch.Tensor, patch: int, ni: int, nj: int) -> None:
    if feats.ndim != 3 or feats.shape[-1] % 4:
        raise ValueError(f"features must be (H2, W2, 4C), got shape "
                         f"{tuple(feats.shape)}")
    if patch < 2 or patch % 2:
        raise ValueError(f"the phase pool needs an even patch, got {patch}")
    if ni < 0 or nj < 0:
        raise ValueError(f"negative output size ({ni}, {nj})")


def phase_pool_ref(feats: torch.Tensor, patch: int, ni: int, nj: int
                   ) -> torch.Tensor:
    """Plain version: (H2, W2, 4C) s2d-2 features -> (ni, nj, 4C) s2d-2
    window-mean map, in the summation order the module docstring gives."""
    _check_shapes(feats, patch, ni, nj)
    ph = patch // 2
    h2, w2, c4 = feats.shape
    c = c4 // 4
    rows, cols = ni + ph, nj + ph
    fp = feats.new_zeros((rows, cols, c4), dtype=torch.float32)
    hr, wc = min(h2, rows), min(w2, cols)
    fp[:hr, :wc] = feats[:hr, :wc].float()
    rs = fp[:, 0:nj + 1]
    for k in range(1, ph):
        rs = rs + fp[:, k:k + nj + 1]
    t = rs[0:ni + 1]
    for k in range(1, ph):
        t = t + rs[k:k + ni + 1]
    t = t.to(feats.dtype).float()
    scale = 1.0 / float(patch * patch)
    out = torch.empty((ni, nj, c4), dtype=torch.float32, device=feats.device)
    for ob, terms in enumerate(phase_terms()):
        acc = torch.zeros((ni, nj, c), dtype=torch.float32,
                          device=feats.device)
        for r, u, ib in terms:
            acc = acc + t[r:r + ni, u:u + nj, ib * c:(ib + 1) * c] * scale
        out[..., ob * c:(ob + 1) * c] = acc
    return out.to(feats.dtype)


# The CUDA kernel's limits (csrc/phase_pool.cu): the registers body takes
# ph up to MAX_REG_PH with at most MAX_THREADS threads, each capped at
# REGS_PER_THREAD registers by its launch bounds; the shared body runs
# SMEM_THREADS threads over SMEM_ROWS output rows.  A block may have
# MAX_SMEM bytes of shared memory, an SM SM_SMEM bytes (1 KB of it reserved
# per block) and SM_REGS registers; H100_SMS is the H100 SXM's SM count.
MAX_REG_PH, MAX_THREADS, REGS_PER_THREAD = 16, 512, 128
SMEM_THREADS, SMEM_ROWS = 256, 32
MAX_SMEM, SM_SMEM, SM_REGS, H100_SMS = 232448, 233472, 65536, 132
STAGES = 3  # input rows in the registers body's staging ring


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """One launch of ``csrc/phase_pool.cu``: the C entry reads
    :meth:`as_ints` in field order and refuses a plan it cannot run."""
    body: str     # "registers" (ph <= MAX_REG_PH) or "shared"
    threads: int  # per block
    tj: int       # output columns per block
    ti: int       # output rows per block (registers body: its share of
                  # the column tiles' rows laid end to end)
    kc: int       # shared body: channels of each phase block per block
    chunk: int    # registers body: bytes per cp.async copy
    vo: int       # registers body: channels of each phase block a mix
                  # thread takes (its load and store width)
    smem: int     # dynamic shared bytes per block
    grid: tuple[int, int]

    def as_ints(self) -> tuple[int, ...]:
        return (0 if self.body == "registers" else 1, self.threads, self.tj,
                self.ti, self.kc, self.chunk, self.vo, self.smem, *self.grid)


def t_cols_per_thread(ph: int) -> int:
    """NC: the t columns one thread of the registers body folds (4 channels
    of each); NC x ph x 4 partial row folds stay in its registers."""
    return 2 if ph <= 8 else 1


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def t_pitch(pix: int) -> int:
    """Bytes from one t pixel to the next in shared memory (``pix`` bytes a
    pixel): 64 more where ``pix`` is a multiple of 128, so the pixel
    columns one warp's mix loads read fall in both halves of the banks."""
    return _round16(pix) + (64 if pix % 128 == 0 else 0)


def registers_smem(tcols: int, ph: int, pix: int) -> int:
    """A ring of STAGES staged input rows of ``tcols + ph - 1`` pixels,
    then three t rows of ``tcols`` pixels at :func:`t_pitch`."""
    return (STAGES * _round16((tcols + ph - 1) * pix)
            + 3 * _round16(tcols * t_pitch(pix)))


def shared_smem(tj: int, ph: int, kc: int) -> int:
    """The shared body's f32 staging row, ring of ph column-sum rows and
    two padded t rows."""
    g4 = 4 * kc
    return 4 * (g4 * ((tj + ph) + ph * (tj + 1)) + 2 * (tj + 1) * (g4 + kc))


def _widest(options, ok) -> int:
    return next(v for v in options if ok(v))


@functools.lru_cache(maxsize=256)
def launch_plan(h2: int, w2: int, c4: int, patch: int, ni: int, nj: int,
                elem_bytes: int, align: int = 16, sms: int = H100_SMS,
                max_threads: int = MAX_THREADS, blocks: int | None = None
                ) -> PoolPlan:
    """The kernel's launch for this shape, feature element size, feature
    pointer alignment (bytes, a power of two) and SM count.

    The registers body takes ph <= MAX_REG_PH when one block of at most
    ``max_threads`` threads, each folding 4 channels of NC t columns, holds
    two t columns of every channel, its shared memory fits and the pointer
    allows 4-byte copies; a column tile takes as many whole-pixel output
    columns as that allows (fewer where the map is narrower).  It runs one
    block per SM (``sms``, or ``blocks`` where given), each with an equal
    share of the column tiles' rows laid end to end (``ti``, rounded up).
    Any other shape takes the shared body.  Raises ``ValueError`` for a
    shape neither body takes."""
    del h2, w2  # the kernel reads past the map as zeros: any size is taken
    ph, c, pix = patch // 2, c4 // 4, c4 * elem_bytes
    nc = t_cols_per_thread(ph)
    nsets = 0  # sets of NC t columns, each c threads (4 channels a thread)
    while -(-(nsets + 1) * c // 32) * 32 <= max_threads:
        nsets += 1
    nsets = min(nsets, -(-(nj + 1) // nc))
    chunks = [b for b in (16, 8, 4) if pix % b == 0 and align % b == 0]
    if ph <= MAX_REG_PH and nsets * nc >= 2 and chunks:
        tj = min(nsets * nc - 1, nj)
        nsets = -(-(tj + 1) // nc)
        threads = -(-nsets * c // 32) * 32
        smem = registers_smem(nsets * nc, ph, pix)
        if smem <= MAX_SMEM:
            per_sm = min(SM_REGS // (threads * REGS_PER_THREAD),
                         SM_SMEM // (smem + 1024), 2048 // threads)
            rows = -(-nj // tj) * ni
            blocks = min(blocks or sms * max(per_sm, 1), rows)
            vo = _widest((4, 2, 1), lambda v: c % v == 0)
            return PoolPlan("registers", threads, tj, -(-rows // blocks), 0,
                            chunks[0], vo, smem, (blocks, 1))
    kc = _widest((8, 4, 2, 1), lambda v: c % v == 0)
    tj = 32
    while tj > 4 and shared_smem(tj, ph, kc) > 100 * 1024:
        tj //= 2
    smem = shared_smem(tj, ph, kc)
    grid = (-(-nj // tj) * (c // kc), -(-ni // SMEM_ROWS))
    if smem > MAX_SMEM or grid[0] > 2**31 - 1 or grid[1] > 65535:
        raise ValueError(f"phase pool: no kernel plan for 4C={c4}, patch "
                         f"{patch}, output ({ni}, {nj})")
    return PoolPlan("shared", SMEM_THREADS, tj, SMEM_ROWS, kc, 0, 0, smem, grid)


def _alignment(ptr: int) -> int:
    return min(16, ptr & -ptr) if ptr else 16


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _kernel():
    from dmfusion_torch.ops._build import load_library
    fn = load_library("phase_pool").phase_pool
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def phase_pool_cuda(feats: torch.Tensor, patch: int, ni: int, nj: int,
                    plan: PoolPlan | None = None) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`phase_pool_ref`.

    ``feats`` is a contiguous float32 or bfloat16 CUDA tensor.  ``plan``
    defaults to :func:`launch_plan` for this shape and card.  Each launch
    is a ``b2.launch`` span and adds one to ``phase_pool_cuda.launches``.
    The kernel has no backward (nor has dmfusion's): it refuses features
    that require grad while grad is enabled, rather than return an output
    that drops the gradient.
    """
    if not feats.is_cuda:
        raise ValueError("phase_pool_cuda needs a CUDA feature tensor")
    if feats.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("phase_pool_cuda has no backward: call it under "
                           "torch.no_grad() or inference_mode, or pool for "
                           "training through the phase SAT "
                           "(models/dense_fusion.py::phase_corner_sums)")
    _check_shapes(feats, patch, ni, nj)
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported feature dtype {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("features must be contiguous (channels innermost)")
    h2, w2, c4 = feats.shape
    out = torch.empty((ni, nj, c4), dtype=feats.dtype, device=feats.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = launch_plan(h2, w2, c4, patch, ni, nj, feats.element_size(),
                           _alignment(feats.data_ptr()),
                           _sm_count(feats.device.index))
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    with span("b2.launch"):
        err = _kernel()(feats.data_ptr(), h2, w2, c4, patch, ni, nj,
                        1.0 / float(patch * patch), feats.element_size(),
                        out.data_ptr(), stream, feats.device.index,
                        (ctypes.c_int * 10)(*plan.as_ints()))
    if err != 0:
        raise RuntimeError(f"phase_pool kernel launch failed: "
                           f"cudaError_t {err} ({plan})")
    phase_pool_cuda.launches += 1
    return out


phase_pool_cuda.launches = 0


def phase_pool(feats: torch.Tensor, patch: int, ni: int, nj: int
               ) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if feats.device.type == "cpu":
        return phase_pool_ref(feats, patch, ni, nj)
    if feats.is_cuda:
        return phase_pool_cuda(feats.contiguous(), patch, ni, nj)
    raise ValueError(f"no phase pool for device {feats.device}")
