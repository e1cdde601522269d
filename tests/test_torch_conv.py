"""The port's 3x3 trunk conv (B4) against the JAX package.

``dmfusion_torch.ops.conv3x3.conv3x3_ref`` (nine shifted f32 matmuls,
rounded once) is held against what ``tools/conv_kernel_probe.py`` checks
its Pallas kernels against, its ``xla_conv``:
``lax.conv_general_dilated(x[None], w, (1, 1), "SAME", ("NHWC", "HWIO",
"NHWC"))`` with a bf16 result, written again here since ``tools/`` is no
package.  Both sum the same exact products in f32, in other orders, so
bf16 outputs must be equal or one bf16 ulp apart, save the few near zero
that ``ulp_report`` holds to the f32 sums' own error; f32 outputs agree
to 1e-5.
The CUDA kernel is held against the plain version and cuDNN on the card
by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.  Here the CPU
holds what the kernel's descriptors assume: ``pack_weights`` puts every
weight where the layout formula of ``csrc/conv3x3.cu`` says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dmfusion_torch.ops import conv3x3 as tconv
from dmfusion_torch.tools import conv_kernel_probe


def _inputs(h, w, seed, c=128, o=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((h, w, c)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32)
    return x, wgt


def _xla_conv(x, w, out_dtype):
    return lax.conv_general_dilated(
        x[None], w, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=out_dtype)[0]


@pytest.mark.parametrize("h,w,seed", [(20, 27, 0), (9, 40, 1)])
def test_conv3x3_ref_within_one_ulp_of_lax_bf16(h, w, seed):
    x, wgt = _inputs(h, w, seed)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(wgt).astype(jnp.bfloat16)
    want = torch.from_numpy(np.asarray(_xla_conv(xj, wj, jnp.bfloat16),
                                       np.float32)).bfloat16()
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(wgt).bfloat16()
    got = tconv.conv3x3_ref(xt, wt)
    assert got.dtype == torch.bfloat16 and got.shape == (h, w, 128)
    rep = tconv.ulp_report(got, want,
                           tconv.conv3x3_f32(xt.abs(), wt.abs()))
    assert rep["ok"], rep
    assert rep["share_differ"] < 1e-3 and rep["beyond_one_ulp"] <= 2


def test_conv3x3_ref_f32_matches_lax():
    x, wgt = _inputs(13, 22, 2, c=64, o=32)
    want = np.asarray(_xla_conv(jnp.asarray(x), jnp.asarray(wgt),
                                jnp.float32))
    got = tconv.conv3x3_ref(torch.from_numpy(x), torch.from_numpy(wgt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_library_call_is_the_same_conv():
    x, wgt = _inputs(11, 14, 3, c=32, o=16)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wgt)
    np.testing.assert_allclose(tconv.conv3x3_library(xt, wt).numpy(),
                               tconv.conv3x3_ref(xt, wt).numpy(),
                               rtol=0, atol=1e-5)


def test_ulp_distance_counts_bf16_steps():
    a = torch.tensor([1.0, 1.0, -0.0, 2.0**-10, -1.0]).bfloat16()
    b = torch.tensor([1.0, 1.0078125, 0.0, -(2.0**-10), -1.015625]
                     ).bfloat16()
    assert tconv.ulp_distance(a, b).tolist() == [0, 1, 0, 2 * 0x3A80, 2]


def test_ulp_report_catches_a_wrong_tap():
    """Dropping one tap moves outputs by their own scale: far outside
    one ulp and the f32 allowance."""
    x, wgt = _inputs(8, 9, 4)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(wgt).bfloat16()
    broken = wt.clone()
    broken[2, 0] = 0
    rep = tconv.ulp_report(tconv.conv3x3_ref(xt, broken),
                           tconv.conv3x3_ref(xt, wt),
                           tconv.conv3x3_f32(xt.abs(), wt.abs()))
    assert not rep["ok"] and rep["beyond_max_units"] > 1e3


def test_cuda_wrapper_refuses_cpu_tensor():
    x, wgt = _inputs(4, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        tconv.conv3x3_cuda(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(wgt).bfloat16())


@pytest.mark.parametrize("c,o,dtype", [(64, 128, torch.bfloat16),
                                       (128, 64, torch.bfloat16),
                                       (128, 128, torch.float32)])
def test_cuda_wrapper_refuses_other_channels_or_dtype(c, o, dtype):
    x, wgt = _inputs(4, 4, 6, c=c, o=o)
    with pytest.raises(ValueError, match="channels|bf16"):
        tconv.conv3x3_cuda(torch.from_numpy(x).to(dtype),
                           torch.from_numpy(wgt).to(dtype))


def test_conv_probe_runs_on_cpu():
    out = conv_kernel_probe.run("cpu", 20, 27)
    assert out["vs_plain"]["share_differ"] == 0.0
    assert out["vs_library"]["ok"] and out["kernel_calls"] == 1
    assert out["flop"] == 2 * 20 * 27 * 9 * 128 * 128 and "ms" not in out


def test_conv_probe_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv_kernel_probe.run()


def _packed_position(dy, dx, c, o):
    """Stage and byte offset of w[dy, dx, c, o], the formula that
    ``csrc/conv3x3.cu``'s note states."""
    stage = 2 * (3 * dy + dx) + c // 64
    byte = 2 * (2048 * (c % 64 // 16) + 128 * (o // 8) + 64 * (c % 16 // 8)
                + 8 * (o % 8) + c % 8)
    return stage, byte


def test_pack_weights_is_the_documented_permutation():
    _, wgt = _inputs(1, 1, 7)
    w = torch.from_numpy(wgt).bfloat16()
    packed = tconv.pack_weights(w)
    assert packed.shape == (tconv.STAGES, tconv.STAGE_ELEMS)
    assert packed.dtype == torch.bfloat16
    bits = packed.view(torch.int16).reshape(-1)
    assert torch.equal(bits.sort().values,
                       w.view(torch.int16).reshape(-1).sort().values)
    dy, dx, c, o = np.meshgrid(*(np.arange(n) for n in w.shape),
                               indexing="ij")
    stage, byte = _packed_position(dy, dx, c, o)
    index = torch.from_numpy(stage * tconv.STAGE_ELEMS + byte // 2)
    assert torch.equal(bits[index], w.view(torch.int16))


@pytest.mark.parametrize("element,stage,byte", [
    ((0, 0, 0, 0), 0, 0),
    ((2, 1, 77, 100), 15, 3274),
    ((2, 2, 127, 127), 17, 16382)])
def test_pack_weights_places_hand_picked_elements(element, stage, byte):
    assert _packed_position(*element) == (stage, byte)
    w = torch.zeros((3, 3, 128, 128), dtype=torch.bfloat16)
    w[element] = 1.0
    flat = tconv.pack_weights(w).reshape(-1)
    assert flat.nonzero().flatten().tolist() == [
        stage * tconv.STAGE_ELEMS + byte // 2]


@pytest.mark.parametrize("shape", [(3, 3, 128, 64), (3, 3, 64, 128),
                                   (1, 3, 128, 128), (9, 128, 128)])
def test_pack_weights_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match="pack_weights"):
        tconv.pack_weights(torch.zeros(shape, dtype=torch.bfloat16))


@pytest.mark.parametrize("h,w", [(9, 33), (1, 100), (100, 1), (1, 1)])
def test_constant_case_is_the_plain_conv(h, w):
    """The closed form the card tests hold the kernel to bit for bit is
    what the plain version computes: 9, 6 and 4 taps inside, on an edge
    and in a corner."""
    x, wgt, want = conv_kernel_probe.constant_case(h, w, "cpu")
    assert torch.equal(tconv.conv3x3_ref(x, wgt), want)
