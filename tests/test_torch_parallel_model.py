"""The mesh's ``model`` axis: the port's four ranks against dmfusion's
``data 2 x model 2`` mesh.

Four CPU ranks over gloo (started as ``torchrun`` starts them) form the
port's ``data 2 x model 2`` mesh (rank ``r``: data index ``r // 2``,
model index ``r % 2``) and run every scenario once, in one module
fixture, while this process runs dmfusion on a mesh of the same shape (4
of the suite's 8 CPU devices, ``dmfusion/parallel/partition.py``'s
``shard_params`` and ``shard_opt_state``) and the port on one rank.
synth64 at patch 8, SGD, float32; the seeded whole parameters go to both
packages as one flax tree, which each rank loads as its shards.  Held:

  * placement: in process, for every model of the zoo at small widths
    (vit with 4 heads, which shard, and with 3, which do not; an even and
    an odd class count), the port's placement of every flax leaf equals
    dmfusion's ``param_partition_specs`` on the mesh, leaf by leaf;
  * training: a two-batch ``train_epoch`` of 32 anchors (the second
    padded: 20 real) of gmfnet w8, vit (``embed_dim`` 16 with 2 heads;
    12 with 3 heads, attention replicated) and dense_fusion w8 on a 97 x
    40 px scene that bands over the data axis, against dmfusion's mesh
    epoch: losses rtol 1e-5, parameters rtol 1e-4 atol 1e-6 (dmfusion's
    own limits for its TP mesh, ``tests/test_parallel.py``);
  * the controls, which must miss those limits: gmfnet's gradients summed
    over every rank (model peers' shards of one shape added together, the
    replicated gradients counted twice), and rank 0's shard broadcast over
    every rank (model index 1 starts from model index 0's shard);
  * eval and predict of gmfnet and dense_fusion (loss sums rtol 1e-5,
    confusions and predictions equal), Adam's moments after one gmfnet
    step (rtol 1e-4, atol 1e-6 on the first moment, 1e-9 on the second),
    each rank's parameters and moments of its shard's shape, and a hook
    on every sharded layer showing that it ran with a shard-shaped
    weight;
  * the CLI on four ranks with ``mesh.model=2``: rank 0 writes the one
    output tree; the test matrix agrees with the one-rank port run's on
    at least 99.9 % of the anchors, and a test-only run on the four ranks
    reads the best weights back and gives it again; its checkpoints hold
    the whole model and load in one process, and ``python -m
    dmfusion_torch.export`` serves them;
  * refusals under ``model: 2``: tri_net, gmfnet_conv, the two-stage
    solver and swin_transformer name ROADMAP A14 item 7.
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
from jax.sharding import PartitionSpec as P

from dmfusion.config import load_config as jax_load_config
from dmfusion.data import synthetic_scene as jax_synthetic_scene
from dmfusion.models import build_model as jax_build_model
from dmfusion.models.registry import model_arity as jax_model_arity
from dmfusion.parallel.mesh import get_mesh as jax_get_mesh
from dmfusion.parallel.partition import (param_partition_specs,
                                         shard_opt_state, shard_params)
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import DensePrograms as JaxDensePrograms
from dmfusion.train.steps import DualPrograms as JaxDualPrograms
from dmfusion_torch import cli
from dmfusion_torch.config import load_config
from dmfusion_torch.data.patches import batched_ids_np
from dmfusion_torch.export import load_artifact
from dmfusion_torch.export import main as export_main
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import init_params
from dmfusion_torch.models.convert import params_to_flax
from dmfusion_torch.parallel.partition import flax_specs
from dmfusion_torch.train.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, MODEL = 4, 2
F32 = {"compute_dtype": "float32", "param_dtype": "float32"}
COLORS4 = [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]]
OVER = {"data_city": "synth64", "patch_size": 8, "batchsize": 32,
        "test_batchsize": 32, "color_batchsize": 32, "seed": 0,
        "model_width": 8, "device": "cpu", "nohup": 1,
        "schedule": {"optimizer": "SGD"}, "precision": F32}
VIT = {"model_name": "vision_transformer"}
# The parity cases: gmfnet and two vits on synth64 (5 classes: the head's
# last kernel stays replicated), dense_fusion on a 97 x 40 scene of 4
# classes that bands over the data axis.
CASES = {
    "gmfnet": {},
    "vit_heads": {**VIT, "trans": {"embed_dim": 16, "num_head": 2,
                                   "depth": 1, "patch_size": 1}},
    "vit_3heads": {**VIT, "trans": {"embed_dim": 12, "num_head": 3,
                                    "depth": 1, "patch_size": 1}},
    "dense": {"model_name": "dense_fusion", "data_city": "synthodd",
              "DATA_DICT": {"synthodd": {"size": [97, 40, 4],
                                         "color": COLORS4}}}}
EVAL_CASES = ("gmfnet", "dense")
STEPS, BATCH = 2, 32
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
# Adam's moments after one step: the first moment is 0.1 g, the second
# 1e-3 g^2 (about 1e-9 at a gradient of 1e-3).
MU_ATOL, NU_ATOL = 1e-6, 1e-9
# The SKILL.md CPU drive's sizes, with SGD.
CLI_SET = ["device=cpu", "patch_size=8", "model_width=16", "batchsize=64",
           "test_batchsize=64", "color_batchsize=64", "epoch=3", "time=1",
           "train_rate=0.1", "verify_rate=0.05", "seed=0", "color.index=1",
           "precision.compute_dtype=float32", "schedule.optimizer=SGD",
           "nohup=1"]
REFUSALS = {"tri_net": ["--set", "model_name=tri_net"],
            "gmfnet_conv": ["--set", "model_name=gmfnet_conv",
                            "patch_size=35"],
            "twostage": ["--solver", "twostage", "--set", "model_name=dqtl"],
            "swin_transformer": ["--set", "model_name=swin_transformer"]}
# Every model of the zoo, at small widths, for the placement.
ZOO = {
    "gmfnet": {"model_width": 8},
    "gmfnet_4_classes": {"model_width": 8, "data_city": "synthodd",
                         "DATA_DICT": {"synthodd": {"size": [64, 64, 4],
                                                    "color": COLORS4}}},
    "gmfnet_pyramid": {"model_width": 8, "gmfnet_pan": "pyramid"},
    "gmfnet_conv": {"model_name": "gmfnet_conv", "model_width": 8,
                    "patch_size": 35},
    "dense_fusion": {"model_name": "dense_fusion", "model_width": 8},
    "tri_net": {"model_name": "tri_net", "model_width": 8},
    "dqtl": {"model_name": "dqtl", "model_width": 8},
    "resnet18": {"model_name": "resnet18", "model_width": 4},
    "cross_net": {"model_name": "cross_net", "trans": {
        "embed_dim": 12, "depth": 1, "num_head": 2, "patch_size": 1}},
    "vit_4_heads": {**VIT, "trans": {"embed_dim": 16, "depth": 1,
                                     "num_head": 4, "patch_size": 1}},
    "vit_3_heads": {**VIT, "trans": {"embed_dim": 12, "depth": 2,
                                     "num_head": 3, "patch_size": 2}},
    "vit_4_classes": {**VIT, "data_city": "synthodd", "DATA_DICT": {
        "synthodd": {"size": [64, 64, 4], "color": COLORS4}},
        "trans": {"embed_dim": 12, "depth": 1, "num_head": 2,
                  "patch_size": 1}},
    "swin_transformer": {"model_name": "swin_transformer", "trans": {
        "embed_dim": 12, "window_size": 2, "depths": [2, 2],
        "num_heads": [2, 3]}},
    "swin_T_dual": {"model_name": "swin_T_dual", "trans": {
        "embed_dim": 12, "window_size": 2, "depths": [2, 2],
        "num_heads": [2, 2]}},
    "ct_lstm": {"model_name": "ct_lstm", "model_width": 8},
    "generator": {"model_name": "generator", "gan_width": 8},
    "discriminator": {"model_name": "discriminator", "gan_width": 8},
}

WORKER = r'''
import builtins, dataclasses, io, os, pickle, sys
import torch
torch.set_num_threads(1)
from dmfusion_torch import cli, parallel
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_to_optax, params_to_flax)
from dmfusion_torch.parallel.partition import shard_model
from dmfusion_torch.parallel.tensor import shard_dims
from dmfusion_torch.train import steps
from dmfusion_torch.train.optim import make_optimizer

inp = pickle.load(open(sys.argv[1], "rb"))
rank = int(os.environ["RANK"])
axes = {"distributed": 1, "model": inp["model"]}
assert parallel.maybe_initialize_distributed({"mesh": axes, "device": "cpu"})
mesh = parallel.get_mesh({"mesh": axes, "device": "cpu"})
out = {"rank": rank, "mesh": [mesh.data, mesh.model, mesh.data_index,
                              mesh.model_index, mesh.backend]}


def programs(case, tree, optimizer=None):
    cfg = load_config(overrides={**inp["over"], **inp["cases"][case],
                                 **({"schedule": {"optimizer": optimizer}}
                                    if optimizer else {})})
    model = build_model(cfg)
    shard_model(model, mesh)
    load_flax_params(model, tree)  # the whole tree, as this rank's shards
    opt = make_optimizer(cfg, model.parameters(), inp["steps"])
    scene = synthetic_scene(cfg, device="cpu")
    if cfg["model_name"] == "dense_fusion":
        prog = steps.DensePrograms(model, scene.patch, optimizer=opt,
                                   cfg=cfg, mesh=mesh)
    else:
        prog = steps.DualPrograms(model, opt, cfg, scene.width,
                                  scene.patch, mesh=mesh)
    return prog, (scene.ms, scene.pan)


def shard_hooks(model):
    """Record the weight each sharded layer computes with."""
    seen = {}

    def hook(mod, args, name):
        seen.setdefault(name, (mod.tp.mode, tuple(mod.weight.shape)))

    for name, m in model.named_modules():
        tp = m.__dict__.get("tp")
        if tp is not None and tp.mode != "gather":
            m.register_forward_pre_hook(
                lambda mod, args, name=name: hook(mod, args, name))
    return seen


def shapes(prog):
    model, opt = prog.model, prog.optimizer
    dims = shard_dims(model)
    return {n: {"param": tuple(p.shape),
                "moment": tuple(opt.state[p]["momentum_buffer"].shape
                                if "momentum_buffer" in opt.state[p]
                                else opt.state[p]["exp_avg"].shape),
                "dim": dims[n][1] if n in dims else None}
            for n, p in model.named_parameters()}


def world_sum(params, m):
    """The control: gradients summed over every rank."""
    return sum_grads(params, dataclasses.replace(m, data_group=None))


def shard_broadcast(model, m):
    """The control: rank 0's shards broadcast over every rank."""
    if m is not None:
        with torch.no_grad():
            m.broadcast_all_(model.parameters())


sum_grads, take_rank0 = steps.sum_grads, steps.take_rank0_params
out["train"], out["shapes"], out["hooks"] = {}, {}, {}
for case, c in inp["train"].items():
    variants = {"sum": {}}
    if case == "gmfnet":
        variants.update(world_sum={"sum_grads": world_sum},
                        shard_broadcast={"take_rank0_params":
                                         shard_broadcast})
    for variant, patch in variants.items():
        for k, v in patch.items():
            setattr(steps, k, v)
        try:
            prog, args = programs(case, c["params0"])
            seen = shard_hooks(prog.model)
            losses = prog.train_epoch(args, *map(torch.from_numpy,
                                                 c["batches"]))
            out["train"][case, variant] = (losses.numpy(),
                                           params_to_flax(prog.model))
        finally:
            steps.sum_grads, steps.take_rank0_params = sum_grads, take_rank0
        if variant == "sum":
            out["shapes"][case] = shapes(prog)
            out["hooks"][case] = seen

out["eval"] = {}
for case in inp["eval_cases"]:
    c = inp["train"][case]
    prog, args = programs(case, c["params_eval"])
    ids, labels, mask = map(torch.from_numpy, c["eval"])
    loss_sum, conf = prog.eval_epoch(args, ids, labels, mask)
    out["eval"][case] = (float(loss_sum), conf.numpy(),
                         prog.predict(args, ids).numpy())

prog, args = programs("gmfnet", inp["train"]["gmfnet"]["params0"], "ADAM")
losses = prog.train_epoch(args, *map(torch.from_numpy, inp["adam"]))
out["adam"] = {"losses": losses.numpy(),
               "opt": opt_state_to_optax(prog.model, prog.optimizer),
               "shapes": shapes(prog)}

out["refusals"] = {}
for name, argv in inp["refusals"].items():
    try:
        cli.main(argv)
        out["refusals"][name] = "accepted"
    except NotImplementedError as e:
        out["refusals"][name] = str(e)

written = []
for mod in (builtins, io):
    def opener(file, mode="r", *a, _open=mod.open, **kw):
        if any(c in mode for c in "wax+"):
            written.append(os.fspath(file))
        return _open(file, mode, *a, **kw)
    mod.open = opener
save = torch.save


def recorded_save(obj, f, *a, **kw):
    if isinstance(f, (str, os.PathLike)):  # not a pickled tensor's buffer
        written.append(os.fspath(f))  # torch.save opens its file in C++
    return save(obj, f, *a, **kw)


torch.save = recorded_save
solver = cli.main(["--city", "synth64", "--set", *inp["cli_set"],
                   "mesh.distributed=1", f"mesh.model={inp['model']}",
                   "expo_result=" + inp["cli_dir"] + "/"])
out["cli"] = {"written": list(written),
              "output": solver.cfg["RESULT_output"],
              "excel": solver.cfg["RESULT_excel"],
              "matrix": solver.test_matrix,
              "mesh": [solver.mesh.data, solver.mesh.model],
              "sharded": sorted(shard_dims(solver.model))}
# A test-only run in the same slot: the best weights read back from the
# file by rank 0, every rank taking its shards of them.
solver = cli.main(["--city", "synth64", "--set", *inp["cli_set"],
                   "train.index=0", "color.index=0", "mesh.distributed=1",
                   f"mesh.model={inp['model']}",
                   "expo_result=" + inp["cli_dir"] + "/"])
out["cli"]["test_only"] = [solver.cfg["RESULT_output"], solver.test_matrix]
with open(inp["out"] % rank, "wb") as f:
    pickle.dump(out, f)
parallel.shutdown()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(tmp):
    """Four worker processes with the variables torchrun sets."""
    env = dict(os.environ, WORLD_SIZE=str(RANKS), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "inputs.pkl")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]


def _finish(procs):
    try:
        return [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _vec(tree):
    flat = _flat(tree)
    return {k: np.asarray(flat[k], np.float64) for k in sorted(flat)}


def _tree(x):
    from flax import serialization
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


def _batches(label, rng, n_real, steps):
    """(steps, 32) ids, labels and mask of ``n_real`` labeled anchors, the
    rest padding (anchor 0, masked)."""
    labeled = np.flatnonzero(label.reshape(-1) != 0)
    ids = np.zeros(steps * BATCH, np.int32)
    ids[:n_real] = rng.choice(labeled, n_real, replace=False)
    chunks, mask, _ = batched_ids_np(ids[:n_real], BATCH)
    pad = np.zeros((steps, BATCH), np.int32)
    pad[:chunks.shape[0]] = chunks
    m = np.zeros((steps, BATCH), np.float32)
    m[:mask.shape[0]] = mask
    return (pad, label.reshape(-1)[pad].astype(np.int32), m)


def _inputs(case, rng):
    """The case's seeded whole flax tree (the port's init, one tree for
    both packages) and its batches; for EVAL_CASES the eval tree (dense:
    the head's second kernel scaled by 50, so the logits spread and the
    argmax is not a random init's near-tie) and eval batches."""
    over = {**OVER, **CASES[case]}
    cfg = load_config(overrides=over)
    tree0 = params_to_flax(init_params(build_model(cfg),
                                       torch.Generator().manual_seed(3)))
    label = jax_synthetic_scene(jax_load_config(overrides=over)).label
    inp = {"params0": tree0,
           "batches": _batches(label, rng, BATCH + 20, STEPS)}
    if case in EVAL_CASES:
        inp["params_eval"] = (
            dict(tree0, head2_kernel=tree0["head2_kernel"] * 50.0)
            if cfg["model_name"] == "dense_fusion" else tree0)
        inp["eval"] = _batches(label, rng, 90, 3)
    return inp


def _jax_programs(over, mesh):
    jcfg = jax_load_config(overrides={**OVER, **over})
    scene = jax_synthetic_scene(jcfg)
    cls = (JaxDensePrograms if jcfg["model_name"] == "dense_fusion"
           else JaxDualPrograms)
    jprog = cls(jax_build_model(jcfg), jax_make_optimizer(jcfg, STEPS), jcfg,
                scene.width, scene.patch, mesh)
    return jprog, (jnp.asarray(scene.ms), jnp.asarray(scene.pan))


def _sharded(jprog, tree, mesh):
    p = shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    return p, shard_opt_state(jprog.tx.init(p), mesh)


def _jax_case(case, inp, mesh):
    """dmfusion's mesh epoch from the case's tree (and, for EVAL_CASES,
    its mesh eval and predict)."""
    jprog, args = _jax_programs(CASES[case], mesh)
    p, _, losses = jprog.train_epoch(*_sharded(jprog, inp["params0"], mesh),
                                     args, *map(jnp.asarray, inp["batches"]))
    ref = {"train": (np.asarray(losses), _tree(p))}
    if case in EVAL_CASES:
        pe = shard_params(jax.tree.map(jnp.asarray, inp["params_eval"]),
                          mesh)
        jev = tuple(map(jnp.asarray, inp["eval"]))
        loss_sum, conf = jprog.eval_epoch(pe, args, *jev)
        ref["eval"] = (float(loss_sum), np.asarray(conf),
                       np.asarray(jprog.predict(pe, args, jev[0])))
    return ref


def _jax_adam(tree0, batch, mesh):
    """One Adam step of gmfnet w8 on dmfusion's mesh: its losses and optax
    state."""
    jprog, args = _jax_programs({"schedule": {"optimizer": "ADAM"}}, mesh)
    p, o, losses = jprog.train_epoch(*_sharded(jprog, tree0, mesh), args,
                                     *map(jnp.asarray, batch))
    return {"losses": np.asarray(losses), "opt": _tree(o)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' results, dmfusion's on its ``data 2 x model 2``
    mesh, and the single-rank port CLI run's test matrix."""
    tmp = tmp_path_factory.mktemp("ranks")
    mesh = jax_get_mesh({"mesh": {"data": 2, "model": MODEL}})
    assert dict(mesh.shape) == {"data": 2, "model": MODEL}
    rng = np.random.default_rng(0)
    train = {case: _inputs(case, rng) for case in CASES}
    label = jax_synthetic_scene(jax_load_config(overrides=OVER)).label
    adam = _batches(label, rng, BATCH, 1)
    refusal_set = ["data_city=synth64", "device=cpu", "patch_size=8",
                   "model_width=8", "epoch=1", "time=1", "train_rate=0.05",
                   "nohup=1", "mesh.distributed=1", f"mesh.model={MODEL}",
                   f"expo_result={tmp / 'refusals'}/"]
    inp = {"over": OVER, "cases": CASES, "model": MODEL, "steps": STEPS,
           "train": train, "eval_cases": EVAL_CASES, "adam": adam,
           "refusals": {k: [*v, *refusal_set] for k, v in REFUSALS.items()},
           "cli_set": CLI_SET, "cli_dir": str(tmp / "cli4"),
           "out": str(tmp / "rank%d.pkl")}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    (tmp / "worker.py").write_text(WORKER)
    procs = _start_ranks(tmp)
    try:
        # dmfusion on its mesh and the one-rank CLI while the ranks work.
        ref = {case: _jax_case(case, train[case], mesh) for case in CASES}
        ref["adam"] = _jax_adam(train["gmfnet"]["params0"], adam, mesh)
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
    for r in range(RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "ref": ref, "train": train, "logs": logs,
            "tmp": tmp}


# -- placement ---------------------------------------------------------------

def _jax_inputs(jcfg):
    """Inputs of the model's arity, for its flax param shapes."""
    arity = jax_model_arity(jcfg["model_name"])
    ps, c = int(jcfg["patch_size"]), 4
    if arity == "dense":
        return (jnp.zeros((ps + 15, ps + 15, c)),
                jnp.zeros((4 * (ps + 15), 4 * (ps + 15), 1)), ps)
    ms = jnp.zeros((2, ps, ps, c))
    pan = jnp.zeros((2, 4 * ps, 4 * ps, 1))
    return {"dual": (ms, pan), "tri": (ms, pan, pan),
            "quad": (jnp.zeros((8, ps, ps, c)),),
            "image": (jnp.zeros((1, 32, 32, c)),)}[arity]


def _names(path):
    return tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


@pytest.mark.parametrize("name", list(ZOO))
def test_placement_matches_dmfusion(name):
    """Every flax leaf's placement on ``model: 2`` equals dmfusion's
    ``param_partition_specs`` on its ``data 2 x model 2`` mesh, leaf by
    leaf (dmfusion's tree from its own init, by shape only)."""
    over = {**OVER, **ZOO[name]}
    jcfg = jax_load_config(overrides=over)
    jm = jax_build_model(jcfg)
    inputs = _jax_inputs(jcfg)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *inputs)["params"])
    mesh = jax_get_mesh({"mesh": {"data": 2, "model": MODEL}})
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        param_partition_specs(shapes, mesh),
        is_leaf=lambda x: isinstance(x, P))
    want = {_names(path): tuple(spec) for path, spec in leaves}
    got = flax_specs(build_model(load_config(overrides=over)), MODEL)
    assert got == want
    assert any(want.values())


def test_vit_heads_shard_only_when_they_divide():
    """4 heads on two model ranks shard q/k/v over heads and row-shard the
    out kernel; 3 heads leave the attention replicated while the MLP and
    ``pos``, ``modality`` and ``cls`` still shard."""
    for name, heads in (("vit_4_heads", True), ("vit_3_heads", False)):
        specs = flax_specs(build_model(load_config(
            overrides={**OVER, **ZOO[name]})), MODEL)
        attn = ("block_0", "MultiHeadDotProductAttention_0")
        assert specs[(*attn, "query", "kernel")] == (
            (None, "model", None) if heads else ())
        assert specs[(*attn, "query", "bias")] == (
            ("model", None) if heads else ())
        assert specs[(*attn, "out", "kernel")] == (
            ("model", None, None) if heads else ())
        assert specs[(*attn, "out", "bias")] == ()
        assert specs[("block_0", "Dense_0", "kernel")] == (None, "model")
        for leaf in ("pos", "modality", "cls"):
            assert specs[(leaf,)][-1] == "model"


# -- the four ranks ------------------------------------------------------------

def test_ranks_form_the_grid(run):
    for r, out in enumerate(run["ranks"]):
        assert out["rank"] == r
        assert out["mesh"] == [2, MODEL, r // MODEL, r % MODEL, "gloo"]


def _within(got_losses, got_params, want_losses, want_params):
    got, want = _vec(got_params), _vec(want_params)
    assert got.keys() == want.keys()
    loss_ok = np.allclose(got_losses, want_losses, rtol=LOSS_RTOL, atol=0)
    params_ok = all(np.allclose(got[k], want[k], rtol=PARAM_RTOL,
                                atol=PARAM_ATOL) for k in want)
    return loss_ok and params_ok


@pytest.mark.parametrize("case", list(CASES))
def test_train_epoch_matches_mesh(run, case):
    want_losses, want_params = run["ref"][case]["train"]
    want = _vec(want_params)
    for out in run["ranks"]:
        losses, params = out["train"][case, "sum"]
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        got = _vec(params)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("variant", ["world_sum", "shard_broadcast"])
def test_controls_miss(run, variant):
    """Gradients summed over every rank, or rank 0's shards broadcast over
    every rank, fall outside the limits on every rank."""
    want = run["ref"]["gmfnet"]["train"]
    for out in run["ranks"]:
        assert not _within(*out["train"]["gmfnet", variant], *want)


@pytest.mark.parametrize("case", EVAL_CASES)
def test_eval_and_predict_match_mesh(run, case):
    loss_sum, conf, preds = run["ref"][case]["eval"]
    assert conf.sum() == run["train"][case]["eval"][2].sum() > 0
    for out in run["ranks"]:
        got_loss, got_conf, got_preds = out["eval"][case]
        np.testing.assert_allclose(got_loss, loss_sum, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got_conf, conf)
        np.testing.assert_array_equal(got_preds, preds)


def test_adam_step_matches_mesh(run):
    """One Adam step: the loss and both moments against dmfusion's sharded
    optax state, gathered to the whole tree.  The parameters are not held:
    Adam's first step moves each by about its learning rate whatever the
    gradient's size, so a gradient at rounding level (a conv bias that a
    per-channel GroupNorm cancels) moves either way in either package."""
    ref = run["ref"]["adam"]
    for out in run["ranks"]:
        got = out["adam"]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        for moment, atol in (("mu", MU_ATOL), ("nu", NU_ATOL)):
            g, w = _vec(got["opt"]["0"][moment]), _vec(ref["opt"]["0"][moment])
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=PARAM_RTOL,
                                           atol=atol, err_msg=f"{moment} {k}")
        assert int(got["opt"]["0"]["count"]) == int(ref["opt"]["0"]["count"])


@pytest.mark.parametrize("case", [*CASES, "adam"])
def test_ranks_hold_their_shards(run, case):
    """Each rank's sharded parameters, and their moments, have the shard's
    shape: the whole shape halved on the sharded dimension."""
    over = {**OVER, **CASES.get(case, {})}
    whole = {n: tuple(p.shape) for n, p in
             build_model(load_config(overrides=over)).named_parameters()}
    for out in run["ranks"]:
        shapes = (out["adam"]["shapes"] if case == "adam"
                  else out["shapes"][case])
        assert shapes.keys() == whole.keys()
        sharded = 0
        for name, s in shapes.items():
            assert s["moment"] == s["param"], name
            want = list(whole[name])
            if s["dim"] is not None:
                want[s["dim"]] //= MODEL
                sharded += 1
            assert s["param"] == tuple(want), name
        assert sharded > 0


@pytest.mark.parametrize("case,modes", [
    ("gmfnet", {"column"}), ("vit_heads", {"column", "heads", "row"}),
    ("vit_3heads", {"column"})])
def test_sharded_layers_ran_with_shards(run, case, modes):
    """A hook on every sharded conv and dense layer saw it run with a
    weight of its shard's shape, in the expected modes (heads and row only
    where the heads shard)."""
    for out in run["ranks"]:
        shapes, hooks = out["shapes"][case], out["hooks"][case]
        layers = {n.rsplit(".", 1)[0] for n, s in shapes.items()
                  if s["dim"] is not None and n.endswith("weight")}
        assert set(hooks) <= layers and hooks
        assert {m for m, _ in hooks.values()} == modes
        for name, (_, shape) in hooks.items():
            assert shape == shapes[f"{name}.weight"]["param"], name
        raw = layers - set(hooks)  # pos, modality, cls: gathered on use
        assert all(n in ("pos", "modality", "cls") for n in raw), raw


def test_cli_four_ranks(run):
    outs = [out["cli"] for out in run["ranks"]]
    r0 = outs[0]
    for o in outs:
        assert o["mesh"] == [2, MODEL]
        assert o["output"] == r0["output"] and o["excel"] == r0["excel"]
        assert o["sharded"] == r0["sharded"] and o["sharded"]
        np.testing.assert_array_equal(o["matrix"], r0["matrix"])
    root = os.path.dirname(r0["excel"])
    assert sorted(os.listdir(root)) == ["gmfnet__0_output",
                                        "gmfnet__0_result.xlsx"]
    assert sorted(os.listdir(r0["output"])) == [
        "0_curweights.pt", "0_matrix.npy", "0_pic_1.png", "0_pic_2.png",
        "0_records.json", "0_weights.pt"]
    cli_dir = str(run["tmp"] / "cli4")
    for o in outs[1:]:
        assert not [f for f in o["written"] if f.startswith(cli_dir)]
    for o in outs:  # the test-only run reads the checkpoint back
        assert o["test_only"][0] == r0["output"]
        np.testing.assert_array_equal(o["test_only"][1], r0["matrix"])
    single = run["ref"]["single_matrix"]
    assert r0["matrix"].sum() == single.sum() > 0
    moved = np.abs(r0["matrix"] - single).sum() / 2
    assert moved <= 0.001 * single.sum(), moved


def test_tp_checkpoints_load_in_one_process(run, tmp_path):
    """The four ranks' best and current checkpoints hold the whole model
    and its whole Adam-less state: they load strictly into a one-process
    model and optimizer, and the export CLI serves the best weights."""
    from dmfusion_torch.config import parse_overrides
    from dmfusion_torch.train.optim import make_optimizer
    out = run["ranks"][0]["cli"]["output"]
    cfg = load_config(overrides={**parse_overrides(CLI_SET),
                                 "data_city": "synth64"})
    model = build_model(cfg)
    best = load_checkpoint(os.path.join(out, "0_weights.pt"), None,
                           strict=True)
    model.load_state_dict(best, strict=True)
    cur = load_checkpoint(os.path.join(out, "0_curweights.pt"), None,
                          strict=True)
    opt = make_optimizer(cfg, model.parameters())
    opt.load_state_dict(cur["opt_state"])
    for p in model.parameters():
        assert opt.state[p]["momentum_buffer"].shape == p.shape
    art = tmp_path / "tp.zip"
    export_main(["--city", "synth64", "--set", "model_width=16",
                 "patch_size=8", "seed=0", "precision.compute_dtype=float32",
                 "--out", str(art), "--weights",
                 os.path.join(out, "0_weights.pt")])
    served = load_artifact(art, device="cpu")
    got, want = _vec(params_to_flax(served.model)), _vec(params_to_flax(model))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_unported_families_refuse_on_the_model_axis(run, name):
    for out in run["ranks"]:
        assert "A14 item 7" in out["refusals"][name], out["refusals"][name]
