"""The dense family and gmfnet_conv on the mesh's ``data`` axis: the port's
two ranks against dmfusion's two-device mesh.

Two CPU ranks over gloo (started as ``torchrun`` starts them) run every
scenario once, in one module fixture, while this process runs dmfusion on
a ``mesh.data: 2`` mesh of the suite's CPU devices and the port on one
rank.  dense_fusion at width 8, patch 8, SGD, float32; dmfusion's scenes
and flax parameters go to both packages.  Two dense scenes:

  * **band**, 97 x 40 px (MS 104 rows): it bands on two ranks (band 49
    output rows, halo 18, 94 scene rows a band); band 1 is clamped upward
    to start at scene row 10, so the two bands overlap;
  * **tiny**, synth64 (MS 71 rows, a band would need 76): it does not
    band, and every program runs the whole scene on every rank
    (dmfusion's ``test_dense_tiny_scene_falls_back_unsharded``).

Held, with dmfusion's own tolerances (``tests/test_dense.py``) and the
readings behind them:

  * ``band_plan`` equal to dmfusion's ``_band_plan``, and each rank's
    reported band;
  * a two-batch ``train_epoch`` (32 anchors each, the second padded: 20
    real) against dmfusion's mesh epoch: losses rtol 1e-5 (reading 8.6e-8
    relative on the band scene), parameters rtol 1e-4 atol 1e-7 (largest
    gap 1.5e-8); with the band checkpointed and with remat off.  Under the
    mesh the features' gradients are summed over the ranks and the
    head's are not: the head runs on the summed window sums, the whole
    batch's on every rank.  The control, the window sums added by
    ``torch.distributed.nn``'s ``all_reduce`` (whose backward sums every
    rank's gradient into each rank's sums: twice the features' gradient),
    misses the limits (losses 1.06e-5 relative, parameters 1.0e-4);
  * ``eval_epoch``: the loss sum rel 1e-5 (readings 0), confusions within
    2 (equal);
  * ``predict``, ``predict_map`` and ``test_confusion``: argmax agreement
    with dmfusion's ``logits_map_sharded`` at least 0.9995 (1.0);
    ``logits_map`` within 1e-4 (readings 4.5e-6 band, 5.9e-6 tiny, at a
    logit scale of 0.95-1.46: dmfusion's mesh pools by its SAT, the port by
    the pool's window sums).  The eval parameters scale the head's second
    kernel by 50, so logits spread near 1 and the argmax is not a random
    init's near-tie;
  * the CLI in two ranks, SGD as in the other mesh tests: dense_fusion on
    a 97 x 80 px scene (it bands) and gmfnet_conv at patch 35 on synth64.
    One output tree, written by rank 0 alone, test matrices that agree
    with the single-rank port run's on at least 99.9 % of the anchors
    (both: all of them);
    gmfnet_conv tests and colors per anchor under the mesh
    (``supports_map`` false, its map route never called), as dmfusion.
"""

import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data import synthetic_scene as jax_synthetic_scene
from dmfusion.models import build_model as jax_build_model
from dmfusion.parallel.mesh import get_mesh as jax_get_mesh
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import DensePrograms as JaxDensePrograms
from dmfusion_torch import cli
from dmfusion_torch.config import load_config
from dmfusion_torch.models import build_model
from dmfusion_torch.train.steps import DensePrograms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLORS = [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]]
F32 = {"compute_dtype": "float32", "param_dtype": "float32"}
DENSE = {"model_name": "dense_fusion", "patch_size": 8, "model_width": 8,
         "seed": 3, "device": "cpu", "schedule": {"optimizer": "SGD"},
         "precision": F32}
SCENES = {
    "band": {**DENSE, "data_city": "synthodd", "DATA_DICT": {"synthodd": {
        "size": [97, 40, 4], "color": COLORS}}},
    "tiny": {**DENSE, "data_city": "synth64"}}
STEPS, BATCH = 2, 32
CLI_COMMON = ["device=cpu", "model_width=8", "batchsize=32",
              "test_batchsize=32", "color_batchsize=32", "time=1",
              "verify_rate=0.05", "seed=0", "color.index=1",
              "precision.compute_dtype=float32", "schedule.optimizer=SGD",
              "nohup=1"]
CLI = {
    "dense": ["--city", "synth97", "--set", "model_name=dense_fusion",
              "DATA_DICT.synth97.size=[97,80,4]",
              f"DATA_DICT.synth97.color={COLORS}".replace(" ", ""),
              "patch_size=8", "epoch=2", "train_rate=0.1", *CLI_COMMON],
    "conv": ["--city", "synth64", "--set", "model_name=gmfnet_conv",
             "patch_size=35", "epoch=1", "train_rate=0.05", *CLI_COMMON]}

WORKER = r'''
import builtins, io, os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed.nn
from dmfusion_torch import cli, parallel
from dmfusion_torch.config import load_config
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import load_flax_params, params_to_flax
from dmfusion_torch.parallel import Mesh
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import ConvMapPrograms, DensePrograms

inp = pickle.load(open(sys.argv[1], "rb"))
rank = int(os.environ["RANK"])
cfg = {"mesh": {"distributed": 1}, "device": "cpu"}
assert parallel.maybe_initialize_distributed(cfg)
mesh = parallel.get_mesh(cfg)
out = {"rank": rank, "mesh": [mesh.data, mesh.rank, mesh.backend]}


class NnMesh(Mesh):
    """The control: the window sums added by torch.distributed.nn's
    all_reduce, whose backward sums every rank's gradient into each
    rank's sums."""
    def sum_live(self, t):
        return torch.distributed.nn.all_reduce(t)


def programs(case, tree, m=mesh, remat=True):
    pcfg = load_config(overrides=inp["dense"][case]["over"])
    model = load_flax_params(build_model(pcfg), tree)
    model.remat = remat
    opt = make_optimizer(pcfg, model.parameters(), inp["steps"])
    return DensePrograms(model, pcfg["patch_size"], optimizer=opt, cfg=pcfg,
                         mesh=m)


variants = {"sum": (mesh, True), "remat_off": (mesh, False),
            "nn_all_reduce": (NnMesh(*vars(mesh).values()), True)}
for case, c in inp["dense"].items():
    args = tuple(map(torch.from_numpy, c["args"]))
    for variant, (m, remat) in variants.items():
        if case == "tiny" and variant != "sum":
            continue
        prog = programs(case, c["params0"], m, remat)
        losses = prog.train_epoch(args, *map(torch.from_numpy, c["train"]))
        out[case, variant] = (losses.numpy(), params_to_flax(prog.model))
    prog = programs(case, c["params_eval"])
    ids, labels, mask = map(torch.from_numpy, c["eval"])
    loss_sum, conf = prog.eval_epoch(args, ids, labels, mask)
    out[case, "eval"] = {
        "loss_sum": float(loss_sum), "conf": conf.numpy(),
        "test": prog.test_confusion(args, ids, labels, mask).numpy(),
        "predict": prog.predict(args, ids).numpy(),
        "map": prog.predict_map(*args).numpy(),
        "logits": prog.logits_map(*args).numpy(),
        "band": prog.mesh_band(args[0].shape[0])}

written = []
for mod in (builtins, io):
    def opener(file, mode="r", *a, _open=mod.open, **kw):
        if any(c in mode for c in "wax+"):
            written.append(os.fspath(file))
        return _open(file, mode, *a, **kw)
    mod.open = opener
save = torch.save


def recorded_save(obj, f, *a, **kw):
    written.append(os.fspath(f))  # torch.save opens its file in C++
    return save(obj, f, *a, **kw)


torch.save = recorded_save
map_calls = []
conv_map = ConvMapPrograms.predict_map


def counted(self, *a, **kw):
    map_calls.append(1)
    return conv_map(self, *a, **kw)


ConvMapPrograms.predict_map = counted
for run, argv in inp["cli"].items():
    del written[:], map_calls[:]
    solver = cli.main(argv)
    out["cli", run] = {
        "written": list(written), "output": solver.cfg["RESULT_output"],
        "matrix": solver.test_matrix, "mesh": solver.mesh.data,
        "programs": type(solver.programs).__name__,
        "supports_map": solver.programs.supports_map,
        "map_calls": len(map_calls), "color": solver.color_maps[1]}
with open(inp["out"] % rank, "wb") as f:
    pickle.dump(out, f)
parallel.shutdown()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(tmp):
    """Two worker processes with the variables torchrun sets."""
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "inputs.pkl")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]


def _finish(procs):
    try:
        return [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()


def _tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _vec(tree):
    flat = _flat(tree)
    return {k: np.asarray(flat[k], np.float64) for k in sorted(flat)}


def _batches(label, rng, n_real, steps):
    """(steps, 32) ids, labels and mask of ``n_real`` labeled anchors, the
    rest padding (anchor 0, masked)."""
    labeled = np.flatnonzero(label.reshape(-1) != 0)
    ids = np.zeros(steps * BATCH, np.int32)
    ids[:n_real] = rng.choice(labeled, n_real, replace=False)
    mask = np.zeros(steps * BATCH, np.float32)
    mask[:n_real] = 1
    shape = (steps, BATCH)
    return (ids.reshape(shape),
            label.reshape(-1)[ids].astype(np.int32).reshape(shape),
            mask.reshape(shape))


def _jax_dense(case, mesh, rng):
    """dmfusion's ``DensePrograms`` on its two-device mesh over the case's
    scene: its inputs, and its epoch, eval and maps."""
    jcfg = jax_load_config(overrides=SCENES[case])
    scene = jax_synthetic_scene(jcfg)
    jprog = JaxDensePrograms(jax_build_model(jcfg),
                             jax_make_optimizer(jcfg, STEPS), jcfg,
                             scene.width, scene.patch, mesh)
    params0, opt0 = jprog.init(jax.random.PRNGKey(1))
    tree0 = _tree(params0)
    tree_eval = dict(tree0, head2_kernel=tree0["head2_kernel"] * 50.0)
    args = (jnp.asarray(scene.ms), jnp.asarray(scene.pan))
    train = _batches(scene.label, rng, BATCH + 20, STEPS)
    ev = _batches(scene.label, rng, 90, 3)
    params, _, losses = jprog.train_epoch(
        jax.tree.map(jnp.array, tree0), opt0, args, *map(jnp.asarray, train))
    pe = jax.tree.map(jnp.asarray, tree_eval)
    jev = tuple(map(jnp.asarray, ev))
    loss_sum, conf = jprog.eval_epoch(pe, args, *jev)
    logits = np.asarray(jax.jit(
        lambda p, a: jprog.logits_map_sharded(p, a, mesh))(pe, args))
    ref = {"train": (np.asarray(losses), _tree(params)),
           "eval": {"loss_sum": float(loss_sum), "conf": np.asarray(conf),
                    "test": np.asarray(jprog.test_confusion(pe, args, *jev)),
                    "predict": np.asarray(jprog.predict(pe, args, jev[0])),
                    "logits": logits},
           "plan": jprog._band_plan(scene.ms.shape[0], mesh)}
    inp = {"over": SCENES[case], "args": tuple(map(np.asarray, args)),
           "params0": tree0, "params_eval": tree_eval, "train": train,
           "eval": ev}
    return inp, ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results, dmfusion's on its two-device mesh, and the
    single-rank port CLI runs."""
    tmp = tmp_path_factory.mktemp("ranks")
    mesh = jax_get_mesh({"mesh": {"data": 2, "model": 1}})
    assert mesh.shape["data"] == 2
    rng = np.random.default_rng(0)
    dense, ref = {}, {}
    for case in SCENES:
        dense[case], ref[case] = _jax_dense(case, mesh, rng)
    cli_dirs = {run: tmp / f"cli2_{run}" for run in CLI}
    inp = {"steps": STEPS, "dense": dense,
           "cli": {run: [*argv, "mesh.distributed=1",
                         f"expo_result={cli_dirs[run]}/"]
                   for run, argv in CLI.items()},
           "out": str(tmp / "rank%d.pkl")}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    (tmp / "worker.py").write_text(WORKER)
    procs = _start_ranks(tmp)
    try:
        single = {run: cli.main([*argv, f"expo_result={tmp / run}/"])
                  for run, argv in CLI.items()}
        ref["single"] = {run: s.test_matrix for run, s in single.items()}
        logs = _finish(procs)
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode and "address already in use" in log.lower()
           for p, log in zip(procs, logs)):
        # Another test took the free port before rank 0 bound it: once
        # more on a fresh one (the ranks failed before writing anything).
        procs = _start_ranks(tmp)
        logs = _finish(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for r in (0, 1):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "ref": ref, "dense": dense, "cli_dirs": cli_dirs}


def test_ranks_join_and_report_their_bands(run):
    """Rank 0 owns output rows [0, 49) from scene row 0; rank 1 owns [49,
    97), its band clamped to output rows [48, 97) from scene row 10, 94
    rows each.  The tiny scene does not band."""
    want = [{"out_start": 0, "s0": 0, "need": 94, "band": 49},
            {"out_start": 48, "s0": 10, "need": 94, "band": 49}]
    for r, out in enumerate(run["ranks"]):
        assert out["mesh"] == [2, r, "gloo"]
        assert out["band", "eval"]["band"] == want[r]
        assert out["tiny", "eval"]["band"] is None


@pytest.mark.parametrize("ms_rows,parts", [(104, 2), (71, 2), (104, 3),
                                           (2016, 2), (2016, 8)])
def test_band_plan_matches_dmfusion(ms_rows, parts):
    """The port's ``band_plan`` is dmfusion's ``_band_plan`` (the odd scene
    on 2 and 3 parts, synth64, which does not band, and image6)."""
    cfg = load_config(overrides=SCENES["band"])
    port = DensePrograms(build_model(cfg), 8)
    jcfg = jax_load_config(overrides=SCENES["band"])
    jprog = JaxDensePrograms(jax_build_model(jcfg), jax_make_optimizer(
        jcfg, 1), jcfg, 40, 8, None)
    assert port.band_plan(ms_rows, parts) == jprog._band_plan(ms_rows, parts)


def _epoch_within(got, want) -> bool:
    """An epoch's (losses, parameters) within dmfusion's limits of
    ``want``'s (``tests/test_dense.py``)."""
    g, w = _vec(got[1]), _vec(want[1])
    assert g.keys() == w.keys()
    return np.allclose(got[0], want[0], rtol=1e-5, atol=0) and all(
        np.allclose(g[k], w[k], rtol=1e-4, atol=1e-7) for k in w)


def _check_epoch(run, case, variant):
    want = run["ref"][case]["train"]
    for out in run["ranks"]:
        assert _epoch_within(out[case, variant], want)


@pytest.mark.parametrize("case,variant", [("band", "sum"),
                                          ("band", "remat_off"),
                                          ("tiny", "sum")])
def test_dense_epoch_matches_mesh(run, case, variant):
    """Two SGD steps, the second batch padded: every rank's losses (the
    whole batch's) and parameters equal dmfusion's mesh epoch's.  Banded,
    each rank's gradients are its band's share, summed; on the tiny scene
    each rank's are already the whole batch's and are not summed."""
    _check_epoch(run, case, variant)


def test_dense_collective_gradient_misses(run):
    """``torch.distributed.nn``'s ``all_reduce`` of the window sums sends
    every rank's gradient into each rank's sums: the epoch misses the
    limits that the banded epoch meets."""
    for out in run["ranks"]:
        assert not _epoch_within(out["band", "nn_all_reduce"],
                                 run["ref"]["band"]["train"])


@pytest.mark.parametrize("case", list(SCENES))
def test_dense_eval_matches_mesh(run, case):
    """The eval loss sum and confusion, and the test confusion, of 90
    anchors in 3 batches, against dmfusion's mesh eval (each anchor
    counted once: the confusion sums to 90)."""
    want = run["ref"][case]["eval"]
    assert want["conf"].sum() == 90
    for out in run["ranks"]:
        got = out[case, "eval"]
        assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)
        assert np.abs(got["conf"] - want["conf"]).sum() <= 2
        assert np.abs(got["test"] - want["test"]).sum() <= 2


@pytest.mark.parametrize("case", list(SCENES))
def test_dense_maps_match_mesh(run, case):
    """``logits_map`` within 1e-4 of dmfusion's ``logits_map_sharded``;
    ``predict_map`` and ``predict`` agree with its argmax on at least
    0.9995 of the pixels and anchors; both ranks hold the same map."""
    want = run["ref"][case]["eval"]["logits"]
    want_map = want.argmax(-1)
    ids = run["dense"][case]["eval"][0]
    maps = []
    for out in run["ranks"]:
        got = out[case, "eval"]
        assert got["logits"].shape == want.shape
        np.testing.assert_allclose(got["logits"], want, rtol=1e-4, atol=1e-4)
        assert got["map"].shape == want_map.shape
        assert (got["map"] == want_map).mean() >= 0.9995
        assert (got["predict"] == want_map.reshape(-1)[ids]).mean() >= 0.9995
        maps.append(got["map"])
    np.testing.assert_array_equal(*maps)


def _rank_writes(run, name):
    r0, r1 = (out["cli", name] for out in run["ranks"])
    d = str(run["cli_dirs"][name])
    assert not [f for f in r1["written"] if f.startswith(d)]
    return r0, r1, {os.path.basename(f).split(".tmp")[0]
                    for f in r0["written"] if f.startswith(d)}


@pytest.mark.parametrize("name,model,programs,maps", [
    ("dense", "dense_fusion", "DensePrograms", True),
    ("conv", "gmfnet_conv", "ConvMapPrograms", False)])
def test_cli_two_ranks(run, name, model, programs, maps):
    """One result tree, written by rank 0 alone; the same test matrix and
    color map on both ranks, within 0.1 % of one rank's test matrix.
    dense_fusion bands the scene; gmfnet_conv tests and colors per anchor
    (its map route is never called under the mesh)."""
    r0, r1, mine = _rank_writes(run, name)
    assert r0["mesh"] == r1["mesh"] == 2
    assert r0["programs"] == r1["programs"] == programs
    assert r0["supports_map"] is r1["supports_map"] is maps
    assert r0["map_calls"] == r1["map_calls"] == 0
    assert sorted(os.listdir(r0["output"])) == [
        "0_curweights.pt", "0_matrix.npy", "0_pic_1.png", "0_pic_2.png",
        "0_records.json", "0_weights.pt"]
    assert {"0_weights.pt", "0_matrix.npy", "0_pic_1.png", "0_pic_2.png",
            f"{model}__0_result.xlsx"} <= mine
    np.testing.assert_array_equal(r0["matrix"], r1["matrix"])
    np.testing.assert_array_equal(r0["color"], r1["color"])
    single = run["ref"]["single"][name]
    assert r0["matrix"].sum() == single.sum() > 0
    moved = np.abs(r0["matrix"] - single).sum() / 2
    assert moved <= 0.001 * single.sum(), moved
