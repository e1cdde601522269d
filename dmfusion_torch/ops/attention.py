"""B6, Swin's shifted-window attention core in one pass: the CUDA kernel,
its plain version and the operator that launches it.

B6 replaces no Pallas kernel: dmfusion's flax ``WindowAttention``
(``dmfusion/models/swin.py``) was left to XLA.  It was added for the
bytes: the torch chain of a Swin block's core (the roll and the window
partition of the grid, the qkv permute, ``q kᵀ``, the scale, the gathered
bias, the mask, an f32 softmax between two casts, ``@ v``, the transpose,
the reverse and the roll back) writes and reads the block's grid about a
dozen times and the (windows, heads, n, n) scores about eight, against q,
k and v read and the output written once.  That is what bounds it: bytes
at 3.35 TB/s; Swin-T's 24 cores a request of 1,024 anchors move 23.4 GB,
7.0 ms.

Both versions compute, for the fused projection's output on a block's
token grid, ``qkv`` (B, H, W, 3C), the relative-bias table ((2 ws - 1)²,
heads) and the optional mask (nW, n, n)::

    out = roll(reverse(core(partition(roll(qkv, -shift), ws))), +shift)

with ``core`` today's ``softmax(q kᵀ / sqrt(hd) + bias [+ mask]) v`` of
each window and head, ``sqrt(hd)`` rounded to the compute dtype as flax
computes it.  :func:`window_attn_ref` is that chain in plain PyTorch (the
port's arithmetic: scores, bias and mask in the compute dtype, softmax in
float32); ``csrc/window_attn.cu`` computes it in one kernel that reads
each token's head slices at its grid position and writes its output there,
so the shift and the partition are its addressing.  It keeps the scores,
bias and mask in float32 up to the softmax and rounds the probabilities to
the compute dtype for ``@ v``, as the chain does: no step in fewer bits.
On bf16 it runs tensor-core products (``mma.sync``); on float32 a full
float32 body on the CUDA cores.

The kernel launches inside the dispatcher operator
``torch.ops.dmfusion_torch.window_attn``, so a
profiler links its device time to that operator and to the spans around
it, as it links torch's own kernels; a bare ``ctypes`` call would be
linked to none.  The operator's CUDA implementation checks the inputs
and launches; on a CPU tensor it computes the plain version.
:func:`window_attn_cuda` refuses autograd and calls the operator.  There is
no fallback from the kernel: a CUDA tensor it does not take raises.  The
kernel has no backward, so :func:`window_attn`, what ``models/swin.py``
calls, takes it where autograd records nothing on the card and the plain
version everywhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from dmfusion_torch.ops import records_grad

#: The kernel's limits: tokens a window (ws²) and channels a head, a
#: multiple of 8 (a 16-byte bf16 chunk); one 128-thread block a window.
MAX_TOKENS, MAX_HEAD_DIM, THREADS = 64, 64, 128
MAX_SMEM = 232448  # 227 KB, a block's most


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, b: int, h: int,
                   w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) indices into the (2ws-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]     # (2, N, N)
    rel = rel + (ws - 1)
    return rel[0] * (2 * ws - 1) + rel[1]


def score_divisor(hd: int, dtype: torch.dtype) -> float:
    """flax's ``jnp.sqrt(jnp.asarray(hd, dtype))``: a sqrt in the compute
    dtype (bf16 ``sqrt(32)`` is 5.65625)."""
    return float(torch.tensor(float(hd), dtype=dtype).sqrt())


def window_core(qkv: torch.Tensor, table: torch.Tensor,
                rel_index: torch.Tensor, mask: torch.Tensor | None,
                heads: int) -> torch.Tensor:
    """The attention core of windows: ``qkv`` (b_, n, 3C) -> (b_, n, C),
    the bias ``table[rel_index]`` and ``mask`` (nW, n, n) added in the
    scores' dtype, the softmax in float32."""
    b_, n, dim = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    hd = dim // heads
    qkv = qkv.reshape(b_, n, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)      # (b_, heads, n, hd)
    attn = q @ k.transpose(-1, -2)
    attn = attn / score_divisor(hd, attn.dtype)
    bias = table[rel_index].reshape(n, n, heads)
    attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, heads, n, n)
        attn = attn + mask.to(attn.dtype)[None, :, None]
        attn = attn.reshape(b_, heads, n, n)
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    return (attn @ v).transpose(1, 2).reshape(b_, n, dim)


@functools.cache
def _rel_index(ws: int, device: torch.device) -> torch.Tensor:
    """The flat relative index on ``device``, a normal tensor even when
    first made under inference mode, so autograd may save it later."""
    with torch.inference_mode(False):
        return torch.from_numpy(relative_index(ws).reshape(-1)).to(device)


def window_attn_ref(qkv: torch.Tensor, table: torch.Tensor,
                    mask: torch.Tensor | None, ws: int, shift: int,
                    heads: int) -> torch.Tensor:
    """Plain version on the grid: ``qkv`` (B, H, W, 3C) rolled by
    ``-shift``, partitioned into windows, :func:`window_core`, reversed
    and rolled back: (B, H, W, C)."""
    b, h, w, _ = qkv.shape
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), dims=(1, 2))
    out = window_core(window_partition(qkv, ws), table,
                      _rel_index(ws, table.device), mask, heads)
    out = window_reverse(out, ws, b, h, w)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """One launch of ``csrc/window_attn.cu``: the C entry reads
    :meth:`as_ints` in field order and refuses a plan it cannot run."""
    body: str     # "mma" (bf16, tensor cores) or "simt" (float32)
    hd: int       # channels a head
    n: int        # tokens a window
    tiles: int    # 16-row tiles of the padded window
    threads: int  # per block
    grid: int     # blocks: one a window
    smem: int     # dynamic shared bytes

    def as_ints(self) -> tuple[int, ...]:
        return (0 if self.body == "mma" else 1, self.hd, self.n, self.tiles,
                self.threads, self.grid, self.smem)


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, h: int, w: int, c: int, heads: int, ws: int,
                shift: int, masked: bool, elem_bytes: int) -> AttnPlan:
    """The kernel's launch for a (b, h, w) grid of ``c`` channels in
    ``heads`` heads, window ``ws``, ``shift``, with or without a mask, on
    ``elem_bytes`` elements (2: bf16, the tensor-core body; 4: float32,
    the CUDA-core body).

    One block a window; its shared memory holds, for the tensor-core body,
    two heads' q, k and v tiles of ``16 * tiles`` rows (``n`` padded to
    the MMA's 16) and ``hd`` padded to 16 plus a 16-byte row pad, two
    heads' bias columns, the window's mask and its tokens' pixels and
    coordinates; for the float32 body one head's q, k and v with a
    one-float row pad, the scores, the bias column, the mask and the
    tokens.  Raises ``ValueError`` for a shape the kernel does not take."""
    if heads < 1 or c % heads:
        raise ValueError(f"window attention: {heads} heads do not divide "
                         f"{c} channels")
    hd = c // heads
    n = ws * ws
    if ws < 1 or n > MAX_TOKENS:
        raise ValueError(f"window attention: {n} tokens a window (ws {ws}); "
                         f"the kernel takes at most {MAX_TOKENS}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"window attention: head dim {hd} is not a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if h % ws or w % ws:
        raise ValueError(f"window attention: grid {h} x {w} is not a "
                         f"multiple of the window {ws}")
    if not 0 <= shift < ws:
        raise ValueError(f"window attention: shift {shift} not in [0, {ws})")
    if elem_bytes not in (2, 4):
        raise ValueError(f"window attention: {elem_bytes}-byte elements")
    if b * h * w >= 2**31:
        raise ValueError(f"window attention: {b} x {h} x {w} tokens exceed "
                         f"the kernel's 32-bit pixel index")
    tiles = -(-n // 16)
    table = 4 * (2 * ws - 1) ** 2
    tokens = 2 * MAX_TOKENS * 4
    mask = 4 * n * n if masked else 0
    if elem_bytes == 2:
        ld = -(-hd // 16) * 16 + 8
        body, smem = "mma", 12 * 16 * tiles * ld + 2 * table + mask + tokens
    else:
        body = "simt"
        smem = 4 * (3 * n * (hd + 1) + n * (n + 1)) + table + mask + tokens
    if smem > MAX_SMEM:
        raise ValueError(f"window attention: {smem} shared bytes a block")
    return AttnPlan(body, hd, n, tiles, THREADS,
                    b * (h // ws) * (w // ws), smem)


def check_inputs(qkv: torch.Tensor, table: torch.Tensor,
                 mask: torch.Tensor | None, ws: int, shift: int,
                 heads: int) -> AttnPlan:
    """Hold the inputs to what the kernel takes, on any device, and return
    the launch plan: ``qkv`` a contiguous (B, H, W, 3C) bf16 or float32
    tensor, ``table`` ((2 ws - 1)², heads), ``mask`` (H/ws * W/ws, ws²,
    ws²) or None, the mask given exactly when ``shift`` is.  Raises
    ``ValueError`` otherwise."""
    if qkv.ndim != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, H, W, 3C), got shape "
                         f"{tuple(qkv.shape)}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"window attention: unsupported dtype {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError(f"qkv must be contiguous, got strides "
                         f"{qkv.stride()} for shape {tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    plan = launch_plan(b, h, w, c3 // 3, heads, ws, shift, mask is not None,
                       qkv.element_size())
    if tuple(table.shape) != ((2 * ws - 1) ** 2, heads):
        raise ValueError(f"table must be ({(2 * ws - 1) ** 2}, {heads}), got "
                         f"{tuple(table.shape)}")
    if (mask is not None) != (shift > 0):
        raise ValueError("a mask goes with a shift, and only with one")
    if mask is not None and tuple(mask.shape) != (
            (h // ws) * (w // ws), ws * ws, ws * ws):
        raise ValueError(f"mask must be ({(h // ws) * (w // ws)}, {ws * ws}, "
                         f"{ws * ws}), got {tuple(mask.shape)}")
    return plan


@functools.cache
def _kernel():
    from dmfusion_torch.ops._build import load_library
    fn = load_library("window_attn").window_attn
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 7 + [
                   ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _launch(qkv: torch.Tensor, table: torch.Tensor,
            mask: torch.Tensor | None, ws: int, shift: int,
            heads: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors."""
    plan = check_inputs(qkv, table, mask, ws, shift, heads)
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    if table.device != qkv.device or (mask is not None
                                      and mask.device != qkv.device):
        raise ValueError("the table and the mask must lie on qkv's device")
    table = table.to(torch.float32).contiguous()
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    b, h, w, c3 = qkv.shape
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    div = score_divisor(c3 // 3 // heads, qkv.dtype)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _kernel()(qkv.data_ptr(), table.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), b, h, w, c3 // 3, heads, ws, shift, div,
                    qkv.element_size(), (ctypes.c_int * 7)(*plan.as_ints()),
                    stream, qkv.device.index)
    if err != 0:
        raise RuntimeError(f"window_attn kernel launch failed: cudaError_t "
                           f"{err} ({plan})")
    return out


def _op_meta(qkv: torch.Tensor, table: torch.Tensor,
             mask: torch.Tensor | None, ws: int, shift: int,
             heads: int) -> torch.Tensor:
    return qkv.new_empty((*qkv.shape[:3], qkv.shape[3] // 3))


# The dispatcher operator ``torch.ops.dmfusion_torch.window_attn``: the
# kernel for CUDA tensors, the plain version for CPU tensors, the output's
# shape for meta tensors.  (``torch.library.Library`` registers the Python
# functions as they are; ``torch.library.custom_op`` would wrap them in a
# guard that imports ``torch._dynamo`` at the first call, seconds of a
# serving process's set-up.)
_LIB = torch.library.Library("dmfusion_torch", "DEF")
_LIB.define("window_attn(Tensor qkv, Tensor table, Tensor? mask, int ws, "
            "int shift, int heads) -> Tensor")
_LIB.impl("window_attn", _launch, "CUDA")
_LIB.impl("window_attn", window_attn_ref, "CPU")
_LIB.impl("window_attn", _op_meta, "Meta")


def window_attn_cuda(qkv: torch.Tensor, table: torch.Tensor,
                     mask: torch.Tensor | None, ws: int, shift: int,
                     heads: int) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`window_attn_ref`, through
    the operator ``torch.ops.dmfusion_torch.window_attn``.

    ``qkv`` is a contiguous bf16 or float32 CUDA tensor; the table and the
    mask are read in float32; the operator raises ``ValueError`` on any
    other input (:func:`check_inputs`).  Each call adds one to
    ``window_attn_cuda.launches``; :func:`window_attn` adds one to
    ``window_attn_cuda.bypassed`` for each core on the card that autograd
    records, which takes the plain version.  The kernel has no backward:
    it refuses inputs that require grad while grad is enabled, rather than
    return an output that drops the gradient."""
    if not qkv.is_cuda:
        raise ValueError("window_attn_cuda needs a CUDA tensor")
    if records_grad(qkv, table, mask):
        raise RuntimeError("window_attn_cuda has no backward: call it under "
                           "torch.no_grad() or inference_mode")
    out = torch.ops.dmfusion_torch.window_attn(qkv, table, mask, ws, shift,
                                               heads)
    window_attn_cuda.launches += 1
    return out


window_attn_cuda.launches = 0
window_attn_cuda.bypassed = 0


def window_attn(qkv: torch.Tensor, table: torch.Tensor,
                mask: torch.Tensor | None, ws: int, shift: int,
                heads: int) -> torch.Tensor:
    """A block's attention core on its grid: :func:`window_attn_cuda` on
    the card where autograd records nothing, else :func:`window_attn_ref`
    (training, the CPU), which on the card adds one to
    ``window_attn_cuda.bypassed``."""
    if not qkv.is_cuda:
        return window_attn_ref(qkv, table, mask, ws, shift, heads)
    if records_grad(qkv, table, mask):
        window_attn_cuda.bypassed += 1
        return window_attn_ref(qkv, table, mask, ws, shift, heads)
    return window_attn_cuda(qkv.contiguous(), table, mask, ws, shift, heads)

