"""B5, GroupNorm + residual + activation in one pass: the CUDA kernel and
its plain version.

B5 replaces no Pallas kernel: dmfusion's flax GroupNorm
(``dmfusion/models/common.py``) was left to XLA, which fuses the norm, the
residual add and the activation around the convolutions.  It was added
for the bytes: under CUDA autocast, ``nn.GroupNorm`` casts a channels-last
bf16 activation to f32, copies it to NCHW (ATen's CUDA group norm takes no
channels-last), reads it for the moments, writes the f32 affine and casts
back, and the residual add, the activation and the next conv's copy back
to channels-last read and write it again: 36-42 bytes of traffic a bf16
element, against the 4-6 of reading x (and the residual) and writing the
output once.  That is what bounds it: bytes at 3.35 TB/s; gmfnet-w64-p16's
13 norms at a bucket of 4,096 anchors move 2.72 GB, 0.81 ms.

Both versions compute, for an (N, C, H, W) tensor ``x``::

    out = act(round(round(group_norm(x)) + residual))

the groups' statistics and the affine in f32 with eps
:data:`GROUPNORM_EPS`, ``round`` to ``x``'s dtype (the port's
``GroupNorm`` casts its f32 result back, then the add runs in that dtype),
the residual optional, ``act`` one of :data:`ACTIVATIONS` or ``None``,
computed in f32 on the rounded value, then rounded.
:func:`group_norm_act_ref` is that arithmetic in plain PyTorch;
``csrc/group_norm_act.cu`` computes it in one kernel (sums in another
order, so not bit for bit: ``tests/test_torch_norm.py``), on bf16 or f32,
with ``x`` and the residual in one shared memory format, channels-last or
contiguous NCHW, writing the output in the same format.
:func:`launch_plan` picks the kernel's body on the host: a shared body,
one block a sample, where a sample's slab and its residual fit a block's
shared memory, else a looped body, one block a (sample, group).
:func:`group_norm_act` takes the plain version for a CPU tensor and the
kernel for a CUDA tensor; there is no fallback from the kernel.  The
kernel has no backward: ``models/common.py`` calls it only where autograd
records nothing through the norm.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from dmfusion_torch.ops import records_grad
from dmfusion_torch.trace import span

GROUPNORM_EPS = 1e-6


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


#: The activations the kernel computes, by name, as the plain version
#: computes them; the kernel's codes are 1 + their index (0: none).
ACTIVATIONS = {"relu": F.relu, "gelu": gelu_tanh, "silu": F.silu,
               "tanh": torch.tanh, "leaky_relu": F.leaky_relu}
_ACT_CODES = {None: 0, **{name: i + 1 for i, name in enumerate(ACTIVATIONS)}}


def _check(x: torch.Tensor, groups: int, weight: torch.Tensor,
           bias: torch.Tensor, act: str | None,
           residual: torch.Tensor | None) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (N, C, H, W), got shape "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"{groups} groups do not divide {c} channels")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight and bias must be ({c},)")
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}; known: "
                         f"{sorted(ACTIVATIONS)} or None")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != x "
                         f"shape {tuple(x.shape)}")


def group_norm_act_ref(x: torch.Tensor, groups: int, weight: torch.Tensor,
                       bias: torch.Tensor, act: str | None,
                       residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: ``F.group_norm`` on ``x.float()``, cast back to
    ``x``'s dtype, the residual added in that dtype, then ``act``."""
    _check(x, groups, weight, bias, act, residual)
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(),
                     GROUPNORM_EPS).to(x.dtype)
    if residual is not None:
        y = y + residual
    return y if act is None else ACTIVATIONS[act](y)


def is_channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is in channels-last memory (False: contiguous NCHW);
    raises for any other stride pattern."""
    if x.is_contiguous():
        return False
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    raise ValueError(f"x must be contiguous NCHW or channels-last, got "
                     f"strides {x.stride()} for shape {tuple(x.shape)}")


def ulp_report(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
               groups: int, weight: torch.Tensor, bias: torch.Tensor
               ) -> dict:
    """Hold the kernel's output ``got`` to the plain version's ``want``
    for the input ``x``: the share of elements bit-equal, the largest
    distance in ulps of their dtype, and the largest difference in bf16
    ulps at the scale of the norm's own f32 terms, ``|a x| + |b|`` (or of
    ``want``, where larger), ``ok`` where that is at most 2.

    The two sum the statistics in other orders, which moves ``a`` and
    ``b`` in their last f32 bits: a rounding of the normalised value to
    bf16 may then flip by one ulp, and where the result cancels (the
    affine's terms, or the value and the residual, nearly opposite) that
    ulp is many of the small result's own.  So the distance is taken at
    the terms' scale: a wrong channel, group or residual element moves an
    output by the terms themselves, hundreds of such ulps."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError("ulp_report: shapes or dtypes differ")
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    top = 1 << (8 * got.element_size() - 1)

    def line(t):  # sign-magnitude bits on a monotone integer line
        i = t.contiguous().view(bits[t.dtype]).long()
        return torch.where(i < 0, -(i + top), i)

    ulps = (line(got) - line(want)).abs()
    n, c = x.shape[:2]
    xd = x.double().reshape(n, groups, -1)
    mean = xd.mean(-1).repeat_interleave(c // groups, 1)
    rstd = (xd.var(-1, unbiased=False) + GROUPNORM_EPS).rsqrt(
        ).repeat_interleave(c // groups, 1)
    a = (rstd * weight.double())[..., None, None]
    b = (bias.double() - a[..., 0, 0] * mean)[..., None, None]
    scale = torch.maximum((a * x.double()).abs() + b.abs(),
                          want.double().abs()).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    units = float(((got.double() - want.double()).abs() / ulp).max())
    return {"bit_equal_share": float((ulps == 0).double().mean()),
            "max_ulps": int(ulps.max()), "max_units": units,
            "ok": units <= 2}


# The CUDA kernel's limits (csrc/group_norm_act.cu): at most MAX_THREADS
# threads a block; the shared body stages a sample's slab, its residual,
# the partial sums and the statistics in at most MAX_SMEM bytes of shared
# memory (a block's most), with BLOCK_THREADS threads, or fewer where the
# slab has fewer than VECTORS_PER_THREAD 16-byte vectors a thread; the
# looped body runs LOOPED_THREADS threads.
MAX_THREADS, MAX_SMEM, LOOPED_THREADS = 512, 232448, 512
BLOCK_THREADS, VECTORS_PER_THREAD = 256, 8


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """One launch of ``csrc/group_norm_act.cu``: the C entry reads
    :meth:`as_ints` in field order and refuses a plan it cannot run."""
    body: str     # "shared" (one block a sample) or "looped" (a group)
    threads: int  # per block
    grid: int     # blocks
    smem: int     # shared body: dynamic shared bytes; looped: 0

    def as_ints(self) -> tuple[int, ...]:
        return (0 if self.body == "shared" else 1, self.threads, self.grid,
                self.smem)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, c: int, h: int, w: int, groups: int,
                elem_bytes: int, channels_last: bool, residual: bool,
                aligned: bool = True) -> NormPlan:
    """The kernel's launch for an ``(n, c, h, w)`` tensor of ``elem_bytes``
    elements in the given memory format, with or without a residual, with
    ``aligned`` x, residual and output pointers (16 bytes).

    The shared body takes a sample's slab as ``nvec`` 16-byte vectors where
    each vector lies in one pixel (channels-last: ``c`` a multiple of the
    vector) or one channel (NCHW: ``h * w`` a multiple of it), and the
    slab, the residual's, the partial sums and the statistics fit MAX_SMEM
    bytes.  Its threads: VECTORS_PER_THREAD vectors a thread, at most
    BLOCK_THREADS, in whole warps and, in channels-last memory, whole
    pixels of vectors, so that a thread's vectors all cover the same
    channels.  Any other shape takes the looped body.  Raises
    ``ValueError`` for a shape neither takes."""
    v = 16 // elem_bytes
    hw = h * w
    if c * hw >= 2**31 or n * groups >= 2**31:
        raise ValueError(f"group norm: no kernel plan for ({n}, {c}, {h}, "
                         f"{w}) in {groups} groups")
    nvec = c * hw // v
    fits = (c % v == 0) if channels_last else (hw % v == 0)
    step = math.lcm(32, c // v) if channels_last and fits else 32
    if aligned and fits and step <= MAX_THREADS:
        want = _ceil(_ceil(nvec, VECTORS_PER_THREAD), step) * step
        threads = min(want, max(step, BLOCK_THREADS // step * step))
        parts = threads * v if channels_last else nvec
        smem = 16 * nvec * (2 if residual else 1) + 4 * (parts + 2 * groups)
        if smem <= MAX_SMEM:
            return NormPlan("shared", threads, n, smem)
    return NormPlan("looped", LOOPED_THREADS, n * groups, 0)


@functools.cache
def _kernel():
    from dmfusion_torch.ops._build import load_library
    fn = load_library("group_norm_act").group_norm_act
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def group_norm_act_cuda(x: torch.Tensor, groups: int, weight: torch.Tensor,
                        bias: torch.Tensor, act: str | None,
                        residual: torch.Tensor | None = None,
                        plan: NormPlan | None = None) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`group_norm_act_ref`.

    ``x`` is a float32 or bfloat16 CUDA tensor in contiguous NCHW or
    channels-last memory, the residual in the same dtype and format; the
    output takes that format.  ``plan`` defaults to :func:`launch_plan`.
    Each launch is a ``gn.launch`` span and adds one to
    ``group_norm_act_cuda.launches``; ``models/common.py`` adds one to
    ``group_norm_act_cuda.bypassed`` for each norm on the card that
    autograd records, which takes the modules' own path.  The kernel has no
    backward: it refuses inputs that require grad while grad is enabled,
    rather than return an output that drops the gradient."""
    if not x.is_cuda:
        raise ValueError("group_norm_act_cuda needs a CUDA tensor")
    if records_grad(x, weight, bias, residual):
        raise RuntimeError("group_norm_act_cuda has no backward: call it "
                           "under torch.no_grad() or inference_mode")
    _check(x, groups, weight, bias, act, residual)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    cl = is_channels_last(x)
    fmt = torch.channels_last if cl else torch.contiguous_format
    if residual is not None and (
            residual.dtype != x.dtype or residual.device != x.device
            or not residual.is_contiguous(memory_format=fmt)):
        raise ValueError("the residual must match x's dtype, device and "
                         "memory format")
    out = torch.empty_like(x, memory_format=fmt)
    if out.numel() == 0:
        return out
    weight = weight.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    n, c, h, w = x.shape
    if plan is None:
        ptrs = (x.data_ptr(), out.data_ptr(),
                0 if residual is None else residual.data_ptr())
        plan = launch_plan(n, c, h, w, groups, x.element_size(), cl,
                           residual is not None,
                           all(p % 16 == 0 for p in ptrs))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with span("gn.launch"):
        err = _kernel()(x.data_ptr(),
                        None if residual is None else residual.data_ptr(),
                        out.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                        n, c, h * w, groups, GROUPNORM_EPS, _ACT_CODES[act],
                        x.element_size(), int(cl),
                        (ctypes.c_int * 4)(*plan.as_ints()), stream,
                        x.device.index)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel launch failed: "
                           f"cudaError_t {err} ({plan})")
    group_norm_act_cuda.launches += 1
    return out


group_norm_act_cuda.launches = 0
group_norm_act_cuda.bypassed = 0


def group_norm_act(x: torch.Tensor, groups: int, weight: torch.Tensor,
                   bias: torch.Tensor, act: str | None,
                   residual: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor.

    For the kernel, ``x`` in any memory format but channels-last is made
    contiguous NCHW first, as ATen's CUDA group norm makes it (a no-op for
    NCHW; the gathered output of a conv sharded over the mesh's model axis
    is channel-major), and the residual is brought to ``x``'s format."""
    if x.device.type == "cpu":
        return group_norm_act_ref(x, groups, weight, bias, act, residual)
    if x.is_cuda:
        fmt = (torch.channels_last
               if not x.is_contiguous()
               and x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        x = x.contiguous(memory_format=fmt)
        if residual is not None:
            residual = residual.contiguous(memory_format=fmt)
        return group_norm_act_cuda(x, groups, weight, bias, act, residual)
    raise ValueError(f"no group norm for device {x.device}")
