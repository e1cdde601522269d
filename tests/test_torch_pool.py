"""Phase window pooling: the port's plain versions against dmfusion.

Inputs come from numpy seeds.  f32 tolerances are rtol 2e-5, atol 2e-6,
the ones ``tests/test_dense.py`` holds dmfusion's two pool routes to:
the port sums each window by shifted adds, dmfusion's XLA route by
summed-area-table differences and its Pallas kernel mixes phases in
matmuls, so they differ in f32 summation order only.  In bf16 the
window sums are rounded to bf16 in both before the phase mix, so they
agree within one bf16 rounding of the output (rtol 2**-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmfusion.models import dense_fusion as jdense
from dmfusion.ops.pallas_pool import phase_pool_fused
from dmfusion_torch.models import dense_fusion as tdense
from dmfusion_torch.ops.pool import (phase_mix_matrices, phase_pool_ref,
                                     phase_terms)

TOL = dict(rtol=2e-5, atol=2e-6)


def _s2d_feats(h, w, c, seed):
    """(ceil(h/2), ceil(w/2), 4c) s2d-2 packing of an (h, w, c) map padded
    with zeros to even size, as features_s2d pads."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(h, w, c)).astype(np.float32)
    h2, w2 = -(-h // 2), -(-w // 2)
    fp = np.zeros((2 * h2, 2 * w2, c), np.float32)
    fp[:h, :w] = feats
    return feats, np.array(jdense.space_to_depth(jnp.asarray(fp), 2))


@pytest.mark.parametrize("f", [2, 8])
def test_space_to_depth_exact(f):
    x = np.random.default_rng(f).normal(size=(8 * 3, 8 * 5, 3)
                                        ).astype(np.float32)
    want = np.array(jdense.space_to_depth(jnp.asarray(x), f))
    got = tdense.space_to_depth(torch.from_numpy(x), f)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdense.depth_to_space(got, f).numpy(), x)
    np.testing.assert_array_equal(
        tdense.depth_to_space(torch.from_numpy(want), f).numpy(),
        np.asarray(jdense.depth_to_space(jnp.asarray(want), f)))


@pytest.mark.parametrize("extra", [0, 1])
def test_phase_sat_matches(extra):
    _, f = _s2d_feats(33, 47, 12, extra)
    want = np.asarray(jdense.phase_sat(jnp.asarray(f), extra=extra))
    got = tdense.phase_sat(torch.from_numpy(f), extra=extra).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    # Sums of up to 17x24 terms: f32 association differs (chunked matmul
    # cumsum in dmfusion, a plain cumsum here).
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("patch", [7, 8])
def test_window_mean_matches(patch):
    feats, _ = _s2d_feats(35, 41, 12, patch)
    want = np.asarray(jdense.window_mean(jnp.asarray(feats), patch))
    got = tdense.window_mean(torch.from_numpy(feats), patch).numpy()
    assert got.shape == want.shape == (35 - patch + 1, 41 - patch + 1, 12)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw", [(33, 47), (34, 48), (35, 41), (40, 40)])
@pytest.mark.parametrize("patch", [8, 16])
def test_phase_pooled_s2d_matches(hw, patch):
    """The plain phase pool (the port's CPU route) against dmfusion's XLA
    route, packed and unpacked, and against the full-res window mean."""
    h, w = hw
    feats, f = _s2d_feats(h, w, 12, h * 100 + w + patch)
    out_r, out_c = h - patch + 1, w - patch + 1
    want = np.asarray(jdense.phase_pooled_s2d(jnp.asarray(f), patch, out_r,
                                              out_c, use_pallas=False))
    got = tdense.phase_pooled_s2d(torch.from_numpy(f), patch, out_r, out_c)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    unpacked = tdense.phase_window_mean(torch.from_numpy(f), patch, out_r,
                                        out_c).numpy()
    np.testing.assert_allclose(
        unpacked, np.asarray(jdense.window_mean(jnp.asarray(feats), patch)),
        **TOL)


@pytest.mark.parametrize("hw,col_tile,c4,patch", [
    ((40, 56), None, 16, 8), ((33, 41), None, 16, 8), ((40, 120), 16, 16, 8),
    ((40, 56), None, 128, 16)])
def test_phase_pool_ref_matches_pallas_interpret(hw, col_tile, c4, patch):
    """phase_pool_ref, the kernel's plain version, against the TPU kernel
    run in interpret mode; col_tile=16 takes its multi-stripe tiling."""
    h, w = hw
    rng = np.random.default_rng(h + w + c4)
    f = rng.normal(size=(-(-h // 2), -(-w // 2), c4)).astype(np.float32)
    ni, nj = -(-(h - patch + 1) // 2), -(-(w - patch + 1) // 2)
    want = np.asarray(phase_pool_fused(jnp.asarray(f), patch, ni, nj,
                                       interpret=True, col_tile=col_tile))
    got = phase_pool_ref(torch.from_numpy(f), patch, ni, nj).numpy()
    assert got.shape == want.shape == (ni, nj, c4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw", [(33, 41), (40, 120)])
def test_phase_pool_ref_bf16_matches_pallas_interpret(hw):
    h, w = hw
    rng = np.random.default_rng(h * w)
    f = rng.normal(size=(-(-h // 2), -(-w // 2), 16)).astype(np.float32)
    ni, nj = -(-(h - 7) // 2), -(-(w - 7) // 2)
    want = np.asarray(phase_pool_fused(jnp.asarray(f, jnp.bfloat16), 8, ni,
                                       nj, interpret=True, col_tile=16))
    got = phase_pool_ref(torch.from_numpy(f).bfloat16(), 8, ni, nj)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=2.0 ** -8, atol=0)


def test_phase_terms_follow_mix_matrices():
    """The copied selection matrices equal dmfusion's, and the summation
    order read off them routes every (input, output) phase-block pair
    through exactly one shift, ``a & ~c == r`` and ``b & ~d == u``."""
    for (r, u, m), (jr, ju, jm) in zip(phase_mix_matrices(16, 8),
                                       jdense.phase_mix_matrices(16, 8)):
        assert (r, u) == (jr, ju)
        np.testing.assert_array_equal(m, jm)
    terms = phase_terms()
    for ob, block in enumerate(terms):
        a, b = divmod(ob, 2)
        assert sorted(ib for _, _, ib in block) == [0, 1, 2, 3]
        for r, u, ib in block:
            c, d = divmod(ib, 2)
            assert (a & (1 - c), b & (1 - d)) == (r, u)
        assert list(block) == sorted(block)
