"""The window gather's family calls against the JAX package, bit for bit.

A family call (``dmfusion_torch/ops/gather.py``) gathers every stream of
one arity at one batch of flat anchor ids: one launch of the CUDA kernel
on the card, its plain version (``gather_family_ref``, with the same id
decode and shard rule) on the CPU.  Here the plain version, through the
public wrappers and directly, is held against dmfusion's Pallas wrappers
in interpret mode (B a multiple of the Pallas group of 64) and against
``dmfusion.data.patches`` for ragged batches, negative ids and ids past
the scene, in f32 and bf16; the shard rule against ``Mesh.shard``'s
padding; and the wrappers' argument checks.  The kernel itself is held
against the plain version on the card by ``tests/test_torch_kernels.py``
and ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmfusion.data import patches as jpatches
from dmfusion.ops import pallas_gather as jpallas
from dmfusion_torch.ops import gather as tgather
from dmfusion_torch.parallel.mesh import Mesh
from dmfusion_torch.tools import gather_probe

H, W, C, PS = 20, 24, 4, 8
N = H * W
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# name: (stream keys, dmfusion's Pallas wrapper, dmfusion's plain gather,
#        the port's wrapper, anchor scales)
FAMILIES = {
    "one": (("ms",), jpallas.gather_one_fast, jpatches.gather_one,
            tgather.gather_one_fast, tgather.ONE),
    "dual": (("ms", "pan"), jpallas.gather_dual_fast, jpatches.gather_dual,
             tgather.gather_dual_fast, tgather.DUAL),
    "tri": (("ms", "pan", "mspan"), jpallas.gather_tri_fast,
            jpatches.gather_tri, tgather.gather_tri_fast, tgather.TRI),
    "quad": (("ms", "pan_ms", "ms_gan", "pan_gan"), jpallas.gather_quad_fast,
             jpatches.gather_quad, tgather.gather_quad_fast, tgather.QUAD),
}


@functools.cache
def _scenes() -> dict:
    """Padded-scene-shaped streams: MS geometry (H+ps-1, W+ps-1, C), PAN
    geometry 4x (2-D)."""
    rng = np.random.default_rng(0)
    ms_shape = (H + PS - 1, W + PS - 1, C)
    pan_shape = (4 * H + 4 * PS - 1, 4 * W + 4 * PS - 1)
    return {"ms": rng.standard_normal(ms_shape),
            "pan": rng.standard_normal(pan_shape),
            "mspan": rng.standard_normal(pan_shape),
            "pan_ms": rng.standard_normal(ms_shape),
            "ms_gan": rng.standard_normal(ms_shape),
            "pan_gan": rng.standard_normal(ms_shape)}


def _streams(keys, dtype):
    jdt, tdt = DTYPES[dtype]
    s = _scenes()
    return ([jnp.asarray(s[k], jnp.float32).astype(jdt) for k in keys],
            [torch.from_numpy(s[k]).float().to(tdt) for k in keys])


def _ids(n, seed=1, wild=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, n).astype(np.int32)
    edge = [0, N - 1, W - 1, (H - 1) * W]
    if wild:
        edge += [-1, -W, -W - 1, -N, -N - 5, N, N + W + 3, 10 * N,
                 2**31 - 1, -2**31]
    ids[:len(edge)] = edge[:n]
    return ids


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_pallas_interpret(name, dtype):
    """B 128: the port's wrapper (the plain family on the CPU) equals
    dmfusion's Pallas wrapper in interpret mode, stream by stream."""
    keys, pallas, _, port, _ = FAMILIES[name]
    js, ts = _streams(keys, dtype)
    ids = _ids(128, seed=len(name))
    want = pallas(*js, jnp.asarray(ids), W, PS, interpret=True)
    got = port(*ts, torch.from_numpy(ids), W, PS)
    for g in (got if isinstance(got, tuple) else (got,)):
        assert g.dtype == DTYPES[dtype][1]
    _same(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["ragged", "wild"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_dmfusion_plain(name, case, dtype):
    """A ragged batch of 93, and negative ids and ids past the scene
    (dynamic_slice's negative-start and clamping rule after the floored
    decode): the plain family equals dmfusion's plain gather."""
    keys, _, plain, port, scales = FAMILIES[name]
    js, ts = _streams(keys, dtype)
    ids = _ids(93, seed=7, wild=case == "wild")
    want = plain(*js, jnp.asarray(ids), W, PS)
    _same(port(*ts, torch.from_numpy(ids), W, PS), want)
    _same(tgather.gather_family_ref(ts, torch.from_numpy(ids), W, PS,
                                    scales), want)


@pytest.mark.parametrize("data", [2, 3])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_shard_rule_matches_mesh_shard(name, data):
    """B 4160 over 2 and 3 ranks (3: a padded tail): each rank's
    ``shard=mesh.shard_rows(b)`` call equals dmfusion's plain gather of
    ``Mesh.shard(ids)``, the rows past the batch at its first anchor."""
    keys, _, plain, port, _ = FAMILIES[name]
    js, ts = _streams(keys, "float32")
    ids = _ids(4160, seed=11)
    b = ids.shape[0]
    rows = 0
    for rank in range(data):
        mesh = Mesh(data=data, rank=rank, device=torch.device("cpu"),
                    backend="gloo")
        lo, hi, per = mesh.shard_rows(b)
        assert (lo, hi) == mesh.bounds(b) and per == mesh.per_rank(b)
        rows += hi - lo
        shard = mesh.shard(torch.from_numpy(ids))
        assert torch.equal(tgather.shard_ids(torch.from_numpy(ids),
                                             (lo, hi, per)), shard)
        want = plain(*js, jnp.asarray(shard.numpy()), W, PS)
        _same(port(*ts, torch.from_numpy(ids), W, PS, (lo, hi, per)), want)
    assert rows == b


def test_dual_sharded_takes_the_shard_rows():
    """``gather_dual_sharded`` is the dual family at ``mesh.shard_rows``."""
    _, ts = _streams(("ms", "pan"), "float32")
    ids = torch.from_numpy(_ids(1025, seed=3))
    mesh = Mesh(data=3, rank=2, device=torch.device("cpu"), backend="gloo")
    got = tgather.gather_dual_sharded(*ts, ids, W, PS, mesh)
    want = tgather.gather_dual_fast(*ts, mesh.shard(ids), W, PS)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape[0] == mesh.per_rank(1025) == 342


def test_quad_batch_is_the_four_streams_stacked():
    """``gather_quad_batch`` is the quad model's (4B, ps, ps, C) input:
    the four streams of ``gather_quad_fast`` one after another."""
    _, ts = _streams(FAMILIES["quad"][0], "float32")
    ids = torch.from_numpy(_ids(70, seed=5))
    batch = tgather.gather_quad_batch(*ts, ids, W, PS)
    assert batch.shape == (4 * 70, PS, PS, C)
    assert torch.equal(batch, torch.cat(tgather.gather_quad_fast(*ts, ids, W,
                                                                 PS)))


@pytest.mark.parametrize("bad", ["dtypes", "streams", "scales", "ids_2d"])
def test_family_refuses_bad_calls_on_cpu(bad):
    """Mismatched stream dtypes, more than four streams, a scale a stream
    missing and 2-D ids raise before any gather, on the CPU too."""
    _, (ms, pan) = _streams(("ms", "pan"), "float32")
    ids = torch.zeros(4, dtype=torch.int32)
    args = {"dtypes": ((ms, pan.bfloat16()), ids, tgather.DUAL),
            "streams": ((ms,) * 5, ids, (1,) * 5),
            "scales": ((ms, pan), ids, (1,)),
            "ids_2d": ((ms, pan), ids[None], tgather.DUAL)}[bad]
    scenes, i, scales = args
    with pytest.raises(ValueError):
        tgather.gather_family(scenes, i, W, PS, scales)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int16])
def test_explicit_starts_must_be_int32(dtype):
    _, (ms,) = _streams(("ms",), "float32")
    xs = torch.zeros(3, dtype=dtype)
    with pytest.raises(ValueError, match="int32"):
        tgather.gather_windows_cuda(ms.reshape(ms.shape[0], -1), xs, xs, PS,
                                    C)


def test_kernel_wrapper_refuses_cpu_scenes():
    """A family call through the kernel wrapper raises on CPU tensors
    rather than falling back to the plain version."""
    _, (ms, pan) = _streams(("ms", "pan"), "float32")
    before = tgather.gather_windows_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tgather.gather_family_cuda((ms, pan), torch.zeros(2, dtype=torch.int32),
                                   W, PS, tgather.DUAL)
    assert tgather.gather_windows_cuda.launches == before


def test_gather_probe_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_probe.run()
