"""The mesh's ``data`` axis: the port's two ranks against dmfusion's mesh.

Two CPU ranks over gloo (``dmfusion_torch.parallel``, started as
``torchrun`` starts them: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) run every scenario once, in one module
fixture, while this process runs dmfusion on the suite's 8-device CPU mesh
(``tests/conftest.py``) and the port on one rank.  synth64, patch 8,
gmfnet width 8, SGD, float32.  Held:

  * the sharded gather: the rows of both ranks' ``gather_dual_sharded``
    exactly equal to dmfusion's ``gather_dual_sharded(interpret=True)`` at
    B 72, 104, 128 and 1024 (``tests/test_pallas_gather.py``'s sizes); at
    B 1025 to ``gather_dual``, where dmfusion's shard padding raises (the
    deviation ROADMAP §C records);
  * training: dmfusion's mesh ``train_epoch`` over two batches of 32, the
    second padded, against the ranks' losses and every parameter (rtol
    1e-5, atol 1e-6); once with 20 real rows in the second batch (16 on
    rank 0, 4 on rank 1) and once with 10 (rank 1 holds none).  A mean of
    the ranks' own means, which DDP's averaging gives, misses both;
  * eval and predict: dmfusion's mesh ``eval_epoch`` (loss sum rtol 1e-5,
    confusion equal) and ``predict`` (equal);
  * the CLI in two ranks: one output directory and one workbook, every
    file written by rank 0 alone, and a test matrix that agrees with the
    single-rank port run's on at least 99.9 % of the anchors;
  * refusals: ``mesh.model: 4`` on two ranks (dmfusion's divisibility
    error), a ``mesh.data`` other than the world size, a model with
    BatchNorm (naming its ROADMAP item), and ``mesh.distributed`` without
    ``torchrun``'s variables; resnet18,
    dense_fusion and gmfnet_conv are accepted under a mesh, and the dense
    and conv-map program families build on it (tri_net, dqtl and the GAN
    run under a mesh: ``tests/test_torch_parallel_streams.py``; the dense
    bands and gmfnet_conv: ``tests/test_torch_parallel_maps.py``).
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
import torch
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data import synthetic_scene as jax_synthetic_scene
from dmfusion.data.patches import gather_dual as jax_gather_dual
from dmfusion.models import build_model as jax_build_model
from dmfusion.ops.pallas_gather import gather_dual_sharded as jax_sharded
from dmfusion.parallel.mesh import get_mesh as jax_get_mesh
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import DualPrograms as JaxDualPrograms
from dmfusion_torch import cli, parallel
from dmfusion_torch.data.patches import batched_ids_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVER = {"data_city": "synth64", "patch_size": 8, "batchsize": 32,
        "test_batchsize": 32, "color_batchsize": 32, "seed": 0,
        "model_width": 8, "device": "cpu", "nohup": 1,
        "schedule": {"optimizer": "SGD"},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
GATHER_B = (72, 104, 128, 1024, 1025)
STEPS = 2
# The SKILL.md CPU drive's sizes, with SGD.
CLI_SET = ["device=cpu", "patch_size=8", "model_width=16", "batchsize=64",
           "test_batchsize=64", "color_batchsize=64", "epoch=3", "time=1",
           "train_rate=0.1", "verify_rate=0.05", "seed=0", "color.index=1",
           "precision.compute_dtype=float32", "schedule.optimizer=SGD",
           "nohup=1"]

WORKER = r'''
import builtins, io, json, os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dmfusion_torch import cli, parallel
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import load_flax_params, params_to_flax
from dmfusion_torch.ops.gather import gather_dual_sharded
from dmfusion_torch.solvers import build_solver
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import (ConvMapPrograms, DensePrograms,
                                        DualPrograms)

inp = pickle.load(open(sys.argv[1], "rb"))
rank = int(os.environ["RANK"])
assert parallel.maybe_initialize_distributed(
    {"mesh": {"distributed": 1}, "device": "cpu"})
cfg = load_config(overrides={**inp["over"], "mesh": {"distributed": 1}})
mesh = parallel.get_mesh(cfg)
scene = synthetic_scene(cfg, device="cpu")
args = (scene.ms, scene.pan)
out = {"rank": rank, "mesh": [mesh.data, mesh.rank, str(mesh.device),
                              mesh.backend]}


class LocalMeans(DualPrograms):
    """DDP's rule: each rank's own masked mean, gradients averaged."""
    def train_step(self, inputs, labels_b, mask_b=None, count=None):
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(self.model(*inputs), labels_b, mask_b)
        loss.backward()
        grads = [p.grad for p in self.model.parameters()]
        self.mesh.sum_all_(grads)
        for g in grads:
            g /= self.mesh.data
        self.optimizer.step()
        return loss.detach() / self.mesh.data


def programs(cls, tree):
    model = load_flax_params(build_model(cfg), tree)
    opt = make_optimizer(cfg, model.parameters(), inp["steps"])
    return cls(model, opt, cfg, scene.width, scene.patch, mesh=mesh)


out["gather"] = {}
for b, ids in inp["gather"].items():
    ms_p, pan_p = gather_dual_sharded(
        scene.ms, scene.pan, torch.from_numpy(ids), scene.width,
        scene.patch, mesh)
    rows = [mesh.rows(ms_p)[:b].numpy(), mesh.rows(pan_p)[:b].numpy()]
    out["gather"][b] = {"bounds": mesh.bounds(b), "shape": list(ms_p.shape),
                        "rows": rows if rank == 0 else None}

out["train"] = {}
for name, batches in inp["train"].items():
    for variant, cls in (("sum", DualPrograms), ("local_means", LocalMeans)):
        prog = programs(cls, inp["params0"])
        losses = prog.train_epoch(args, *map(torch.from_numpy, batches))
        out["train"][name, variant] = (losses.numpy(),
                                       params_to_flax(prog.model))

prog = programs(DualPrograms, inp["params0"])
ids, labels, mask = map(torch.from_numpy, inp["eval"])
loss_sum, conf = prog.eval_epoch(args, ids, labels, mask)
out["eval"] = (float(loss_sum), conf.numpy(), prog.predict(args, ids).numpy())

out["refusals"], out["programs"] = {}, {}
for name, over in inp["refusals"].items():
    try:
        solver = build_solver(load_config(overrides={
            **inp["over"], "mesh": {"distributed": 1}, **over,
            "expo_result": inp["refusal_dir"] + "/"}))
        solver.dataloader()
        solver.init_model()
        out["refusals"][name] = "accepted"
        out["programs"][name] = [type(solver.programs).__name__,
                                 solver.programs.mesh is solver.mesh,
                                 solver.programs.supports_map]
    except (NotImplementedError, ValueError) as e:
        out["refusals"][name] = str(e)

out["families"] = {}
for family, over in (("DensePrograms", {"model_name": "dense_fusion"}),
                     ("ConvMapPrograms", {"model_name": "gmfnet_conv",
                                          "patch_size": 35})):
    fcfg = load_config(overrides={**inp["over"], **over})
    model = build_model(fcfg)
    ps = fcfg["patch_size"]
    if family == "DensePrograms":
        prog = DensePrograms(model, ps, cfg=fcfg, mesh=mesh)
    else:
        prog = ConvMapPrograms(model, None, fcfg, scene.width, ps, mesh=mesh)
    try:
        prog.predict_map(*args)
        refused = None
    except ValueError as e:
        refused = str(e)
    out["families"][family] = {"supports_map": prog.supports_map,
                               "map_refused": refused}

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
solver = cli.main(["--city", "synth64", "--set", *inp["cli_set"],
                   "mesh.distributed=1",
                   "expo_result=" + inp["cli_dir"] + "/"])
out["cli"] = {"written": written, "output": solver.cfg["RESULT_output"],
              "excel": solver.cfg["RESULT_excel"],
              "matrix": solver.test_matrix, "mesh": solver.mesh.data}
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
        return [p.communicate(timeout=300)[0] for p in procs]
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


def _batches(label, rng, n):
    labeled = np.flatnonzero(label.reshape(-1) != 0).astype(np.int32)
    ids = rng.choice(labeled, n, replace=False).astype(np.int32)
    chunks, mask, _ = batched_ids_np(ids, 32)
    labels = label.reshape(-1)[chunks].astype(np.int32)
    return chunks, labels, mask.astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results, dmfusion's on its mesh, and the single-rank
    port CLI run's test matrix."""
    tmp = tmp_path_factory.mktemp("ranks")
    jcfg = jax_load_config(overrides=OVER)
    scene = jax_synthetic_scene(jcfg)
    rng = np.random.default_rng(1)
    gather_ids = {b: rng.integers(0, scene.num_pixels, b).astype(np.int32)
                  for b in GATHER_B}
    train = {"padded": _batches(scene.label, rng, 52),
             "rank1_empty": _batches(scene.label, rng, 42)}
    evb = _batches(scene.label, rng, 90)
    jprog = JaxDualPrograms(jax_build_model(jcfg),
                            jax_make_optimizer(jcfg, STEPS), jcfg,
                            scene.width, scene.patch, jax_get_mesh(None))
    params0, opt0 = jprog.init(jax.random.PRNGKey(0))
    tree0, opt_tree0 = _tree(params0), _tree(opt0)
    inp = {"over": OVER, "steps": STEPS, "gather": gather_ids,
           "train": train, "params0": tree0, "eval": evb,
           "refusals": {"model_axis": {"mesh": {"distributed": 1,
                                                "model": 4}},
                        "data_4": {"mesh": {"distributed": 1, "data": 4}},
                        "dense_fusion": {"model_name": "dense_fusion"},
                        "gmfnet_conv": {"model_name": "gmfnet_conv",
                                        "patch_size": 35},
                        "resnet18": {"model_name": "resnet18"}},
           "refusal_dir": str(tmp / "refusals"), "cli_set": CLI_SET,
           "cli_dir": str(tmp / "cli2"), "out": str(tmp / "rank%d.pkl")}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    (tmp / "worker.py").write_text(WORKER)
    procs = _start_ranks(tmp)
    try:
        # dmfusion on its 8-device mesh while the ranks work.
        jargs = (scene.ms, scene.pan)
        ref = {"gather": {}, "train": {}}
        for b in GATHER_B:
            ids = jnp.asarray(gather_ids[b])
            ref["gather"][b] = [np.asarray(a) for a in jax_gather_dual(
                *jargs, ids, scene.width, scene.patch)]
            if b % 8 == 0:
                ref["gather"][b, "sharded"] = [np.asarray(a) for a in
                                               jax_sharded(
                    *jargs, ids, scene.width, scene.patch,
                    jax_get_mesh(None), interpret=True)]
            else:
                with pytest.raises(TypeError, match="nonnegative"):
                    jax_sharded(*jargs, ids, scene.width, scene.patch,
                                jax_get_mesh(None), interpret=True)
        for name, batches in train.items():
            p = serialization.from_state_dict(params0, tree0)
            o = serialization.from_state_dict(opt0, opt_tree0)
            p, _, losses = jprog.train_epoch(p, o, jargs,
                                             *map(jnp.asarray, batches))
            ref["train"][name] = (np.asarray(losses), _tree(p))
        p = serialization.from_state_dict(params0, tree0)
        loss_sum, conf = jprog.eval_epoch(p, jargs,
                                          *map(jnp.asarray, evb))
        preds = jprog.predict(p, jargs, jnp.asarray(evb[0]))
        ref["eval"] = (float(loss_sum), np.asarray(conf), np.asarray(preds))
        single = cli.main(["--city", "synth64", "--set", *CLI_SET,
                           f"expo_result={tmp / 'cli1'}/"])
        ref["single_matrix"] = single.test_matrix
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
    return {"ranks": ranks, "ref": ref, "logs": logs, "tmp": tmp,
            "gather_ids": gather_ids, "evb": evb}


def _vec(tree):
    flat = _flat(tree)
    return {k: np.asarray(flat[k], np.float64) for k in sorted(flat)}


def test_ranks_join_over_gloo(run):
    for r, out in enumerate(run["ranks"]):
        assert out["rank"] == r
        assert out["mesh"] == [2, r, "cpu", "gloo"]
        assert f"[dmfusion] rank {r}/2: backend gloo (CPU ranks), " \
               "device cpu" in run["logs"][r]


@pytest.mark.parametrize("b", GATHER_B)
def test_sharded_gather_rows(run, b):
    """Each rank gathers ceil(b / 2) rows; both ranks' rows, trimmed to
    b, equal dmfusion's sharded gather exactly (its plain gather at 1025,
    where dmfusion's sharded gather raises)."""
    per = -(-b // 2)
    for r, out in enumerate(run["ranks"]):
        g = out["gather"][b]
        assert g["bounds"] == (min(r * per, b), min((r + 1) * per, b))
        assert g["shape"] == [per, 8, 8, 4]
    got = run["ranks"][0]["gather"][b]["rows"]
    want = run["ref"]["gather"][b, "sharded"] if b % 8 == 0 \
        else run["ref"]["gather"][b]
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, run["ref"]["gather"][b]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["padded", "rank1_empty"])
def test_train_epoch_matches_mesh(run, case):
    want_losses, want_params = run["ref"]["train"][case]
    want = _vec(want_params)
    for out in run["ranks"]:
        losses, params = out["train"][case, "sum"]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
        got = _vec(params)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("case", ["padded", "rank1_empty"])
def test_mean_of_local_means_misses(run, case):
    """The padded batch's shards hold 16 and 4 (or 10 and 0) real rows: a
    mean of the ranks' own means weighs them wrongly, and the checks above
    would catch it."""
    want_losses, want_params = run["ref"]["train"][case]
    losses, params = run["ranks"][0]["train"][case, "local_means"]
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-5)
    assert abs(losses[1] - want_losses[1]) > 1e-3
    got, want = _vec(params), _vec(want_params)
    assert max(np.abs(got[k] - want[k]).max() for k in want) > 1e-5


def test_eval_and_predict_match_mesh(run):
    loss_sum, conf, preds = run["ref"]["eval"]
    n = int(run["evb"][2].sum())
    assert conf.sum() == n
    for out in run["ranks"]:
        got_loss, got_conf, got_preds = out["eval"]
        np.testing.assert_allclose(got_loss, loss_sum, rtol=1e-5)
        np.testing.assert_array_equal(got_conf, conf)
        np.testing.assert_array_equal(got_preds, preds)


def test_cli_two_ranks(run):
    r0, r1 = (out["cli"] for out in run["ranks"])
    assert r0["mesh"] == r1["mesh"] == 2
    assert r0["output"] == r1["output"] and r0["excel"] == r1["excel"]
    root = os.path.dirname(r0["excel"])
    assert sorted(os.listdir(root)) == ["gmfnet__0_output",
                                        "gmfnet__0_result.xlsx"]
    assert sorted(os.listdir(r0["output"])) == [
        "0_curweights.pt", "0_matrix.npy", "0_pic_1.png", "0_pic_2.png",
        "0_records.json", "0_weights.pt"]
    cli_dir = run["tmp"] / "cli2"
    assert not [f for f in r1["written"] if f.startswith(str(cli_dir))]
    mine = {os.path.basename(f).split(".tmp")[0] for f in r0["written"]
            if f.startswith(str(cli_dir))}
    assert {"0_weights.pt", "0_curweights.pt", "0_matrix.npy",
            "0_records.json", "0_pic_1.png", "0_pic_2.png",
            "gmfnet__0_result.xlsx"} <= mine
    np.testing.assert_array_equal(r0["matrix"], r1["matrix"])
    np.testing.assert_array_equal(
        np.load(os.path.join(r0["output"], "0_matrix.npy")), r0["matrix"])
    single = run["ref"]["single_matrix"]
    assert r0["matrix"].sum() == single.sum() > 0
    moved = np.abs(r0["matrix"] - single).sum() / 2
    assert moved <= 0.001 * single.sum(), moved


@pytest.mark.parametrize("name,item", [
    ("model_axis", "2 devices not divisible by model axis 4"),
    ("data_4", "mesh.data 4 with 2 rank")])
def test_unported_mesh_paths_refuse(run, name, item):
    for out in run["ranks"]:
        assert item in out["refusals"][name], out["refusals"][name]


@pytest.mark.parametrize("name,programs,maps", [
    ("dense_fusion", "DensePrograms", True),
    ("gmfnet_conv", "ConvMapPrograms", False)])
def test_mesh_paths_are_accepted(run, name, programs, maps):
    """dense_fusion (A14 item 3: row bands) and gmfnet_conv (A14 item 4:
    per anchor) build their programs on the solver's mesh; gmfnet_conv
    then tests and colors per anchor."""
    for out in run["ranks"]:
        assert out["refusals"][name] == "accepted", out["refusals"][name]
        assert out["programs"][name] == [programs, True, maps]


def test_resnet18_is_not_refused(run):
    """resnet18 normalises by GroupNorm in both packages: per sample, so a
    shard's forward is the whole batch's rows."""
    for out in run["ranks"]:
        assert out["refusals"]["resnet18"] == "accepted"


_MESH = parallel.Mesh(data=2, rank=0, device=torch.device("cpu"),
                      backend="gloo")


@pytest.mark.parametrize("family,maps", [("DensePrograms", True),
                                         ("ConvMapPrograms", False)])
def test_program_families_accept_a_mesh(run, family, maps):
    """Both families build on a mesh of two ranks.  The dense programs
    render maps (every rank's band); gmfnet_conv's map route is one rank's
    and refuses the mesh."""
    for out in run["ranks"]:
        got = out["families"][family]
        assert got["supports_map"] is maps
        if maps:
            assert got["map_refused"] is None
        else:
            assert "per anchor" in got["map_refused"]


def test_plain_gather_refuses_a_mesh():
    from dmfusion_torch.train.steps import DualPrograms
    with pytest.raises(ValueError, match="gather_dual_sharded"):
        DualPrograms(None, None, {"Categories_Number": 2}, 64, 8,
                     plain_gather=True, mesh=_MESH)


def test_batchnorm_model_refuses():
    with pytest.raises(NotImplementedError, match="A14 item 5"):
        parallel.check_model(torch.nn.Sequential(torch.nn.BatchNorm2d(3)))


def test_distributed_without_torchrun_env_raises(monkeypatch, tmp_path):
    for k in parallel.mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE.*not set"):
        parallel.maybe_initialize_distributed({"mesh": {"distributed": 1}})
    monkeypatch.setenv("DMFUSION_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="Refusing to continue"):
        cli.main(["--city", "synth64", "--set", *CLI_SET,
                  f"expo_result={tmp_path}/"])
    assert not parallel.is_distributed()
    assert not list(tmp_path.iterdir())
