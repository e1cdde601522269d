"""The phase pool kernel's launch plan and tile walk, on the CPU.

``launch_plan`` (``dmfusion_torch/ops/pool.py``) decides on the host how
``csrc/phase_pool.cu`` runs a shape; the kernel has no CPU mode, so these
tests hold the plan to the card's limits, and a numpy emulation of the
registers body's walk (staged rows with zeros past the map, column sums,
the ring of partial row folds, t rounded to the feature dtype, the mix)
to ``phase_pool_ref``, bit for bit.  The emulation adds in the kernel's
order, so it pins that order: a running row sum, or another order of the
mix, would fail here.
"""

import numpy as np
import pytest
import torch

from dmfusion_torch.ops import pool

# (4C, patch, output rows, output cols, element bytes): the card tests'
# shapes (tests/test_torch_kernels.py), chip_smoke.py's pool cases, and the
# dense trunk's pool over image6 at widths 32 and 64.
CARD_SHAPES = [
    (64, 8, 33, 41, 2), (128, 16, 33, 53, 2), (256, 32, 18, 5, 4),
    (12, 6, 18, 26, 2), (8, 2, 17, 17, 4), (128, 16, 31, 29, 2),
    (128, 16, 62, 63, 4), (16, 16, 6, 7, 2), (16, 34, 24, 29, 4),
    (8, 40, 16, 18, 2), (20, 16, 18, 23, 2), (44, 10, 15, 31, 4),
    (128, 16, 1001, 1051, 2), (128, 16, 1001, 1051, 4),
    (64, 34, 29, 34, 4), (12, 16, 93, 143, 2),
    (256, 16, 1001, 1051, 2), (256, 16, 1001, 1051, 4)]


def _walk_geometry(plan, patch):
    ph = patch // 2
    nc = pool.t_cols_per_thread(ph)
    nsets = -(-(plan.tj + 1) // nc)
    return ph, nc, nsets, nsets * nc


@pytest.mark.parametrize("c4,patch,ni,nj,es", CARD_SHAPES)
def test_plan_fits_the_card(c4, patch, ni, nj, es):
    h2, w2 = ni + patch // 2, nj + patch // 2
    plan = pool.launch_plan(h2, w2, c4, patch, ni, nj, es)
    gx, gy = plan.grid
    assert plan.smem <= pool.MAX_SMEM and gy <= 65535 and gx < 2**31
    if patch // 2 > pool.MAX_REG_PH:
        assert plan.body == "shared"
    if plan.body == "shared":
        c = c4 // 4
        assert gy * plan.ti >= ni and (gy - 1) * plan.ti < ni
        assert plan.threads == pool.SMEM_THREADS and c % plan.kc == 0
        assert gx == -(-nj // plan.tj) * (c // plan.kc)
        assert plan.smem == pool.shared_smem(plan.tj, patch // 2, plan.kc)
        return
    ph, _, nsets, tcols = _walk_geometry(plan, patch)
    rows = -(-nj // plan.tj) * ni  # the column tiles' rows, end to end
    assert gy == 1 and 1 <= gx <= min(rows, pool.H100_SMS)
    assert plan.ti == -(-rows // gx) and plan.tj <= nj
    assert plan.threads % 32 == 0 and plan.threads <= pool.MAX_THREADS
    assert plan.threads >= nsets * (c4 // 4)
    assert (c4 * es) % plan.chunk == 0 and plan.chunk in (4, 8, 16)
    assert plan.vo in (1, 2, 4) and (c4 // 4) % plan.vo == 0
    assert plan.smem == pool.registers_smem(tcols, ph, c4 * es)


def test_image6_plan():
    """The dense w32 map's pool: column tiles of 31 whole pixels, 16-byte
    copies, a three-row ring, t pixels padded to 320 bytes, 4 channels of
    each phase block a mix thread, and one block per SM of the H100, each
    with 258 of the 34 tiles' 34,034 rows."""
    plan = pool.launch_plan(1008, 1058, 128, 16, 1001, 1051, 2)
    assert plan == pool.PoolPlan("registers", 512, 31, 258, 0, 16, 4,
                                 3 * 39 * 256 + 3 * 32 * 320, (132, 1))
    # A feature pointer off 16 bytes takes narrower copies.
    assert pool.launch_plan(1008, 1058, 128, 16, 1001, 1051, 2,
                            align=8).chunk == 8


def test_large_patch_takes_shared_body():
    for patch in (34, 40):
        plan = pool.launch_plan(40, 50, 16, patch, 20, 30, 4)
        assert plan.body == "shared" and plan.ti == pool.SMEM_ROWS
    assert pool.launch_plan(40, 50, 16, 32, 20, 30, 4).body == "registers"


def test_plan_as_ints_in_entry_order():
    plan = pool.launch_plan(50, 60, 64, 8, 40, 50, 2)
    assert plan.as_ints() == (0, plan.threads, plan.tj, plan.ti, 0,
                              plan.chunk, plan.vo, plan.smem, *plan.grid)


def kernel_mix_terms():
    """``mix_terms()`` of csrc/phase_pool.cu, step for step: per output
    block, the (r, u, c*2+d) terms in the order the kernel adds them."""
    out = []
    for ob in range(4):
        a, b = ob >> 1, ob & 1
        out.append(tuple((ru >> 1, ru & 1, ib)
                         for ru in range(4) for ib in range(4)
                         if (a & (1 - (ib >> 1))) == ru >> 1
                         and (b & (1 - (ib & 1))) == ru & 1))
    return tuple(out)


def test_kernel_mix_terms_follow_phase_terms():
    assert kernel_mix_terms() == pool.phase_terms()


def _round(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    return torch.from_numpy(x).to(dtype).float().numpy()


def emulate_registers_body(feats: torch.Tensor, patch: int, ni: int, nj: int,
                           plan: pool.PoolPlan) -> torch.Tensor:
    """The registers body's walk over ``plan``'s grid, in numpy f32 (each
    add and multiply rounded once, as ``__fadd_rn``/``__fmul_rn``)."""
    assert plan.body == "registers"
    f = feats.float().numpy()
    h2, w2, c4 = f.shape
    c = c4 // 4
    ph, _, _, tcols = _walk_geometry(plan, patch)
    scols = tcols + ph - 1
    scale = np.float32(1.0 / (patch * patch))
    out = np.full((ni, nj, c4), np.nan, np.float32)
    blocks = plan.grid[0]
    total = -(-nj // plan.tj) * ni
    for b in range(blocks):
        # The block's share of the column tiles' rows, end to end; its
        # partial folds carry over from one run to the next, as in the
        # kernel, where the stale ones are never emitted.
        acc = [np.zeros((tcols, c4), np.float32) for _ in range(ph)]
        pos, end = total * b // blocks, total * (b + 1) // blocks
        while pos < end:
            tile, i0 = divmod(pos, ni)
            j0 = tile * plan.tj
            tirows, cols = min(end - pos, ni - i0), min(plan.tj, nj - j0)
            pos += tirows
            trows = {}
            for rr in range(tirows + ph):
                staged = np.zeros((scols, c4), np.float32)  # zeros past map
                if i0 + rr < h2:
                    seg = f[i0 + rr, j0:j0 + scols]
                    staged[:seg.shape[0]] = seg
                rs = staged[0:tcols].copy()  # column sums, a left fold
                for m in range(1, ph):
                    rs = rs + staged[m:m + tcols]
                s = rr % ph  # t row rr opens, t row rr - ph + 1 completes
                acc[s] = rs.copy()
                for d in range(1, ph):
                    acc[(s + d) % ph] = acc[(s + d) % ph] + rs
                if rr >= ph - 1:
                    trows[rr - ph + 1] = _round(acc[(s + 1) % ph],
                                                feats.dtype)
            for o in range(tirows):
                t = (trows[o], trows[o + 1])
                for ob, terms in enumerate(kernel_mix_terms()):
                    mixed = np.zeros((cols, c), np.float32)
                    for r, u, ib in terms:
                        mixed = mixed + t[r][u:u + cols, ib * c:(ib + 1) * c] \
                            * scale
                    out[i0 + o, j0:j0 + cols, ob * c:(ob + 1) * c] = mixed
    assert not np.isnan(out).any(), "the grid does not cover the output"
    return torch.from_numpy(out).to(feats.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h2,w2,c4,patch,ni,nj,plan_args", [
    (17, 23, 16, 8, 13, 19, dict(max_threads=64, blocks=5)),   # 2 x 4 tiles
    (20, 26, 16, 8, 16, 22, dict(max_threads=64, blocks=5)),   # tiles meet edges
    (12, 9, 12, 6, 10, 8, dict(max_threads=32, blocks=3)),     # C = 3, 24 B
    (9, 11, 8, 2, 9, 11, dict(max_threads=32, blocks=4)),      # ph = 1
    (14, 12, 4, 32, 3, 5, dict(max_threads=32, blocks=4)),     # ph = 16, NC = 1
    (3, 4, 16, 16, 6, 7, dict(max_threads=64, blocks=5)),      # map < ph + 1
    (11, 13, 16, 10, 7, 9, {})])                             # the default plan
def test_plan_walk_bit_equal_to_plain(dtype, h2, w2, c4, patch, ni, nj,
                                      plan_args):
    rng = np.random.default_rng(h2 * w2 + c4 + patch)
    feats = torch.from_numpy(rng.standard_normal((h2, w2, c4)).astype(
        np.float32)).to(dtype)
    plan = pool.launch_plan(h2, w2, c4, patch, ni, nj,
                            feats.element_size(), **plan_args)
    got = emulate_registers_body(feats, patch, ni, nj, plan)
    assert torch.equal(got, pool.phase_pool_ref(feats, patch, ni, nj))


def test_plan_blocks_override_shares_rows():
    plan = pool.launch_plan(40, 40, 16, 8, 33, 33, 2, blocks=4)
    assert plan.grid == (4, 1) and plan.ti == -(-33 * 1 // 4)
    assert pool.launch_plan(40, 40, 16, 8, 2, 3, 2).grid == (2, 1)
