"""The contourlet transform and the pieces of the last three zoo models
against dmfusion's, on the CPU in float32, and the port's ``proof`` phase.

Tolerances, with the largest readings:
  * ``contourlet_decompose`` and every level of ``contourlet_pyramid(3)``:
    atol 1e-5 (3.8e-6, the third PAN lowband; 2.4e-6 at the levels of an
    (8, 8) input whose reflect pads are longer than the axis);
  * ``q_sampling`` and the bare quincunx resample, whose corner outputs
    read neighbours outside the image: atol 1e-5 (1.5e-6); the resample
    against torch's ``affine_grid`` + ``grid_sample`` (align_corners, zero
    padding) too;
  * a shifted ``SwinBlock`` and the LSTM against flax's: atol 1e-5;
  * the relative index and the shift mask: equal;
  * ct_lstm's stacked gates (``(4, h, in)``, ``(4, h, h)``, ``(4, h)``):
    its logits from a flax tree equal, bit for bit, those of the flat
    ``(4h, .)`` layout the port held before, and the eight gate kernels
    and four biases cross to torch and back unchanged.
"""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from flax import serialization

from dmfusion.models import swin as jswin
from dmfusion.ops import contourlet as jct
from dmfusion_torch.config import load_config
from dmfusion_torch.models import swin
from dmfusion_torch.models.ct_lstm import LSTM
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.convert import (_lstm_to_torch, load_flax_params,
                                           params_from_flax, params_to_flax)
from dmfusion_torch.ops import attention
from dmfusion_torch.ops import contourlet as ct
from dmfusion_torch.report.viz import channel_grid
from dmfusion_torch.solvers import Solver, TwoStageSolver

ATOL = 1e-5
SHAPES = [(2, 32, 32, 1), (2, 8, 8, 4)]


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _inputs(shape, seed=0):
    # Uniform on [0.5, 1.5): every pixel, border rows and columns too, is
    # far from 0.
    return np.random.default_rng(seed).random(shape, np.float32) + 0.5


@pytest.mark.parametrize("shape", SHAPES)
def test_decompose_matches_dmfusion(shape):
    x = _inputs(shape)
    jlow, jsub = jct.contourlet_decompose(jnp.asarray(x))
    low, sub = ct.contourlet_decompose(_nchw(x))
    assert low.dtype == sub.dtype == torch.float32
    assert _nhwc(sub).shape == jsub.shape == (shape[0], shape[1] // 2,
                                              shape[2] // 2, 4 * shape[3])
    np.testing.assert_allclose(_nhwc(low), np.asarray(jlow), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(_nhwc(sub), np.asarray(jsub), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_pyramid_matches_dmfusion(shape):
    """Three levels; at (8, 8) the last two run on (4, 4) and (2, 2)
    inputs, where numpy's reflect pads (4 and 3 wide) wrap past the axis."""
    x = _inputs(shape, seed=1)
    jlows, jsubs = jct.contourlet_pyramid(jnp.asarray(x), levels=3)
    lows, subs = ct.contourlet_pyramid(_nchw(x), levels=3)
    assert len(lows) == len(subs) == 3
    for got, want in zip(lows + subs, jlows + jsubs):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_reflect_index_is_numpys():
    for n in (1, 2, 3, 5, 8):
        for pad in (0, 1, 2, 4, 7, 11):
            np.testing.assert_array_equal(
                ct._reflect_index(n, pad, torch.device("cpu")).numpy(),
                np.pad(np.arange(n), pad, mode="reflect"))


@pytest.mark.parametrize("q", sorted(ct._Q_MATS))
def test_quincunx_resample_border(q):
    """q_sampling as dmfusion's; the bare resample of an unpadded image,
    whose outer outputs read neighbours past the border (zeros), as
    ``map_coordinates(mode="constant")`` and as torch's ``grid_sample``
    with zero padding."""
    x = _inputs((2, 16, 12, 3), seed=2)
    want = np.asarray(jct.q_sampling(jnp.asarray(x), *q))
    np.testing.assert_allclose(_nhwc(ct.q_sampling(_nchw(x), *q)), want,
                               rtol=0, atol=ATOL)
    h, w = x.shape[1:3]
    want = np.asarray(jct._grid_sample_affine(jnp.asarray(x),
                                              ct._Q_MATS[q]))
    got = ct._grid_sample_affine(_nchw(x), q, (0, h), (0, w))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=ATOL)
    grid = F.affine_grid(torch.from_numpy(ct._Q_MATS[q]).float()[None]
                         .expand(2, 2, 3), (2, 3, h, w), align_corners=True)
    np.testing.assert_allclose(
        got.numpy(), F.grid_sample(_nchw(x), grid, mode="bilinear",
                                   padding_mode="zeros",
                                   align_corners=True).numpy(),
        rtol=0, atol=ATOL)
    # Every neighbour reads at least 0.5, so an output under 0.5 read
    # zeros past the border: the down lattices rotate the image's corners
    # out of it, the up lattices stay inside.
    assert (want < 0.5).any() == (q[1] == "down")


def test_autocast_keeps_the_transform_f32():
    x = _nchw(_inputs((2, 16, 16, 1), seed=3))
    want = ct.contourlet_decompose(x)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = ct.contourlet_decompose(x)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("ws", [2, 4])
def test_swin_tables_are_dmfusions(ws):
    np.testing.assert_array_equal(attention.relative_index(ws),
                                  jswin._relative_index(ws))
    for h in (ws, 2 * ws, 4 * ws):
        for shift in range(1, ws):
            np.testing.assert_array_equal(swin._shift_mask(h, h, ws, shift),
                                          jswin._shift_mask(h, h, ws, shift))


def test_shifted_swin_block_matches_flax():
    """A shifted block (grid 4, window 2, shift 1: the roll, the -100 mask
    and the bias table) from flax's params; unmasked, the output parts."""
    dim, heads = 8, 2
    x = np.random.default_rng(4).standard_normal((3, 4, 4, dim)).astype(
        np.float32)
    blk = jswin.SwinBlock(dim, heads, 2, 1, act=fnn.gelu,
                          dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.jit(blk.init)(jax.random.PRNGKey(5), jnp.asarray(x))
    tree = jax.tree.map(np.asarray,
                        serialization.to_state_dict(params["params"]))
    # A bias table of scale 1 (flax draws 0.02), so the bias moves the
    # output.
    tree["WindowAttention_0"]["rel_bias"] = np.random.default_rng(
        6).standard_normal((9, heads)).astype(np.float32)
    want = np.asarray(blk.apply({"params": tree}, jnp.asarray(x)))
    port = swin.SwinBlock(dim, heads, 2, 1, (4, 4),
                          lambda t: F.gelu(t, approximate="tanh"))
    assert port.shift == 1 and port.mask is not None
    port.load_state_dict(params_from_flax(tree, "SwinBlock"))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        port.mask = None
        unmasked = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(unmasked - want).max() > 1e-2


class _RNN(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, seq):
        return fnn.RNN(fnn.OptimizedLSTMCell(self.features))(seq)[:, -1]


@pytest.mark.parametrize("kernel", [f"{side}{g}" for side in "ih"
                                    for g in "ifgo"])
def test_lstm_gate_order(kernel):
    """One gate kernel non-zero at a time (with random biases, so every
    gate is open): the port's LSTM feeds it to the same gate as flax's
    OptimizedLSTMCell."""
    feat, steps = 4, 3
    rng = np.random.default_rng(7)
    seq = rng.standard_normal((2, steps, feat)).astype(np.float32)
    cell = {f"{s}{g}": {"kernel": np.zeros((feat, feat), np.float32)}
            for s in "ih" for g in "ifgo"}
    for g in "ifgo":
        cell[f"h{g}"]["bias"] = rng.standard_normal(feat).astype(np.float32)
    cell[kernel]["kernel"] = 2 * rng.standard_normal(
        (feat, feat)).astype(np.float32)
    rnn = _RNN(feat)
    shapes = rnn.init(jax.random.PRNGKey(0), jnp.asarray(seq))["params"]
    (name,) = shapes
    want = np.asarray(rnn.apply({"params": {name: cell}}, jnp.asarray(seq)))
    port = LSTM(feat, feat)
    port.load_state_dict(_lstm_to_torch(cell, name))
    with torch.no_grad():
        got = port(torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


class _FlatLSTM(torch.nn.Module):
    """The port's LSTM in its flat layout: flax's gate kernels, gates i, f,
    g, o, concatenated on their columns into one ``(4h, in)`` input and
    one ``(4h, h)`` hidden weight and a ``(4h,)`` bias, and the same
    step."""

    def __init__(self, cell):
        super().__init__()

        def cat(prefix, leaf):
            return torch.cat([torch.from_numpy(np.asarray(
                cell[f"{prefix}{g}"][leaf], np.float32)) for g in "ifgo"],
                dim=-1)
        self.input_weight = cat("i", "kernel").t().contiguous()
        self.hidden_weight = cat("h", "kernel").t().contiguous()
        self.hidden_bias = cat("h", "bias")
        self.features = self.hidden_bias.shape[0] // 4

    def forward(self, seq):
        b, steps, _ = seq.shape
        c = h = seq.new_zeros(b, self.features, dtype=torch.float32)
        for t in range(steps):
            gates = (F.linear(h, self.hidden_weight, self.hidden_bias)
                     + F.linear(seq[:, t], self.input_weight))
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h


def _ct_lstm(dtype):
    cfg = load_config(overrides={"data_city": "synth64", "patch_size": 8,
                                 "model_name": "ct_lstm", "model_width": 8,
                                 "precision": {"compute_dtype": dtype}})
    return build_model(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_stacked_gates_equal_the_flat_layout(dtype):
    """One flax tree into ct_lstm: its logits with the stacked gates equal,
    bit for bit, those with the flat layout's LSTM in their place."""
    tree = params_to_flax(init_params(_ct_lstm("float32"),
                                      torch.Generator().manual_seed(5)))
    model = load_flax_params(_ct_lstm(dtype), tree)
    rng = np.random.default_rng(2)
    ms = torch.from_numpy(rng.random((3, 8, 8, 4), np.float32))
    pan = torch.from_numpy(rng.random((3, 32, 32, 1), np.float32))
    with torch.no_grad():
        got = model(ms, pan)
        model.lstm = _FlatLSTM(tree["OptimizedLSTMCell_0"])
        want = model(ms, pan)
    assert torch.equal(got, want)


def test_lstm_gates_round_trip_flax():
    """The eight gate kernels and four biases of a flax tree load into the
    stacked tensors and come back out unchanged, and the stacked tensors
    hold each gate's kernel transposed at its place on dimension 0."""
    tree = params_to_flax(init_params(_ct_lstm("float32"),
                                      torch.Generator().manual_seed(6)))
    model = load_flax_params(_ct_lstm("float32"), tree)
    cell, back = tree["OptimizedLSTMCell_0"], params_to_flax(model)
    assert set(cell) == {f"{s}{g}" for s in "ih" for g in "ifgo"}
    for k, leaves in cell.items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(
                back["OptimizedLSTMCell_0"][k][leaf], arr)
    lstm = model.lstm
    assert lstm.input_weight.shape == (4, 8, 8)
    for i, g in enumerate("ifgo"):
        np.testing.assert_array_equal(lstm.input_weight[i].detach().numpy(),
                                      cell[f"i{g}"]["kernel"].T)
        np.testing.assert_array_equal(lstm.hidden_weight[i].detach().numpy(),
                                      cell[f"h{g}"]["kernel"].T)
        np.testing.assert_array_equal(lstm.hidden_bias[i].detach().numpy(),
                                      cell[f"h{g}"]["bias"])


def _png(path):
    """(width, height, colour type, rows) of a PNG the port wrote."""
    data = open(path, "rb").read()
    w, h, _, ctype = struct.unpack(">IIBB", data[16:26])
    idat = data[data.index(b"IDAT") + 4: data.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return w, h, ctype, raw.reshape(h, -1)[:, 1:]


def test_channel_grid_layout(tmp_path):
    """First element, min(num_channels, C) channels row by row in
    ``cols`` columns, each min-max scaled, enlarged to 64 pixels."""
    x = np.zeros((2, 4, 4, 6), np.float32)
    x[0] = np.arange(16, dtype=np.float32).reshape(4, 4, 1) * np.arange(
        1, 7, dtype=np.float32)
    x[0, ..., 5] = 3.0                        # constant: black
    path = tmp_path / "g.png"
    channel_grid(x, path, num_channels=6, cols=4)
    w, h, ctype, img = _png(path)
    assert (w, h, ctype) == (4 * 64, 2 * 64, 0)
    ramp = np.round(np.arange(16).reshape(4, 4) / 15 * 255).astype(np.uint8)
    for i in range(5):
        r, c = divmod(i, 4)
        cell = img[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64]
        np.testing.assert_array_equal(cell[::16, ::16], ramp)
    assert not img[64:, 64:].any()           # channel 5 and the empty cells


def _proof_cfg(tmp_path, **over):
    return load_config(overrides={
        "data_city": "synth64", "patch_size": 8, "model_name": "ct_lstm",
        "model_width": 8, "seed": 0, "device": "cpu", "nohup": 1,
        "time": 1, "train": {"index": 0}, "test": {"index": 0},
        "color": {"index": 0}, "proof": {"index": 1, "samples": 2},
        "expo_result": str(tmp_path) + "/", **over}, prepare=True)


def test_proof_phase_renders_contourlet_grids(tmp_path):
    """``proof.index`` renders the four grids into the run's output dir,
    as dmfusion's (``tests/test_viz.py``): MS (8x8x4) gives a 4-channel
    lowband and 16 subbands, PAN (32x32x1) one lowband and 4 subbands."""
    cfg = _proof_cfg(tmp_path)
    Solver(cfg).run()
    out = cfg["RESULT_output"]
    want = {"0_ct_ms_low.png": (256, 64), "0_ct_ms_dfb.png": (256, 256),
            "0_ct_pan_low.png": (256, 64), "0_ct_pan_dfb.png": (256, 64)}
    for name, size in want.items():
        w, h, ctype, img = _png(os.path.join(out, name))
        assert (w, h) == size and ctype == 0 and img.any(), name


def test_two_stage_solver_has_no_proof(tmp_path):
    cfg = _proof_cfg(tmp_path, model_name="dqtl", solver="twostage")
    with pytest.raises(NotImplementedError, match="two-stage"):
        TwoStageSolver(cfg).proof()
