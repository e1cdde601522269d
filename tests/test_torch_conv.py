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
by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
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
