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
tensor; there is no fallback from the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch


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


@functools.cache
def _kernel():
    from dmfusion_torch.ops._build import load_library
    fn = load_library("phase_pool").phase_pool
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def phase_pool_cuda(feats: torch.Tensor, patch: int, ni: int, nj: int
                    ) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`phase_pool_ref`.

    ``feats`` is a contiguous float32 or bfloat16 CUDA tensor.  Each
    launch adds one to ``phase_pool_cuda.launches``.
    """
    if not feats.is_cuda:
        raise ValueError("phase_pool_cuda needs a CUDA feature tensor")
    _check_shapes(feats, patch, ni, nj)
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported feature dtype {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("features must be contiguous (channels innermost)")
    h2, w2, c4 = feats.shape
    out = torch.empty((ni, nj, c4), dtype=feats.dtype, device=feats.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = _kernel()(feats.data_ptr(), h2, w2, c4, patch, ni, nj,
                    1.0 / float(patch * patch), feats.element_size(),
                    out.data_ptr(), stream, feats.device.index)
    if err != 0:
        raise RuntimeError(f"phase_pool kernel launch failed: "
                           f"cudaError_t {err}")
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
