"""The tri and quad arities and stage 1's GAN on the mesh's ``data`` axis:
the port's two ranks against dmfusion's two-device mesh.

Two CPU ranks over gloo (started as ``torchrun`` starts them) run every
scenario once, in one module fixture, while this process runs dmfusion on
a ``mesh.data: 2`` mesh of the suite's CPU devices (``get_mesh``'s
``devices[:2]``) and the port on one rank.  synth64, patch 8, tri_net and
dqtl at width 8, SGD, gan_width 8, pic 32, float32.  dmfusion's own scenes
go to both packages (MS, PAN, its IHS MSPAN; its four quad streams over
seeded stand-ins of the GAN scenes), so the programs are held, not the
code that makes the scenes.  Held:

  * the tri gather: both ranks' rows of ``gather_tri_fast`` on their
    shards (``mesh.shard``) exactly equal to dmfusion's ``gather_tri`` (the
    XLA gather its mesh uses) at B 72, 104 and 1025; and the port's MSPAN,
    built on each rank, equal bit for bit on both;
  * tri: a ``train_epoch`` of two batches of 32, the second padded (20 real:
    16 on rank 0, 4 on rank 1), against dmfusion's ``TriPrograms`` on its
    mesh: losses and every parameter to rtol 1e-5, atol 1e-6 (readings to
    3.6e-7 and 3e-8); ``eval_epoch`` (loss sum rtol 1e-5, confusion equal)
    and ``predict`` (equal);
  * quad: the same against dmfusion's ``QuadPrograms``, whose ``qua_loss``
    XLA partitions over the whole batch: losses and parameters, the eval
    loss sum and its five confusions, the fused prediction.  The control,
    each rank's ``qua_loss`` on its own shard with the gradients summed,
    misses the limits (its losses part from dmfusion's by 8.3e-4 and
    8.1e-3, its parameters by 4.6e-4);
  * the GAN: three steps of dmfusion's ``GanPrograms`` on its mesh (batch 4,
    two tiles a rank), each run by the ranks from dmfusion's state before
    it and with its noise: the d and g losses to dmfusion's own rtol 1e-4,
    atol 1e-6 (``tests/test_gan.py``; readings to 4e-7 relative), the fakes
    to atol 1e-5 (1e-6), Adam's moments to 1e-2 of the largest (readings
    to 6.5e-5, the largest 1.1-1.7) and every parameter within 3 lr of dmfusion's (1.3e-4;
    from one state Adam moves an element by at most about 1.05 lr a step,
    so two runs part by at most about 2.1 lr); both ranks' parameters
    equal.  Not closer: the GAN's gradient moves with the order of its sums
    (an L1 term's sign flips on a rounding-level difference of the
    convolutions and moves the gradient of all of gP by about 1e-4 of its
    size): the port on one rank parts from dmfusion by as much (moments
    2.1e-5 and 6.5e-5 at steps 2 and 3), and so does a change of the CPU's
    thread count (3.4e-5 at step 1), while dmfusion's mesh and
    single-device steps agree to 2e-7.  The control sums the ranks'
    gradients: Adam's update barely sees the doubled scale, but its moments
    miss by 0.9-1.1;
  * the ``collect`` modes of a two-step epoch: the same fakes and losses
    on two ranks as on one (fakes atol 5e-4: the second step's come from
    parameters that part as above, readings to 5.2e-5; losses rtol 1e-4);
  * the two-stage CLI in two ranks (``dqtl.pre_trained=0``, one GAN epoch,
    one stage-2 epoch, ``dqtl.batch_size=3``, rounded up to 4 as dmfusion
    rounds it): stage 1 takes ceil(6 tiles / 4) steps of 4, one
    ``dqtl_weights/`` tree and one workbook, every file written by rank 0,
    ``pan.npy`` written once, and ``msgan.npy`` within 1e-3 of the
    single-rank run's at batch 4 (reading 8.9e-7);
  * the tri CLI in two ranks: a test matrix that agrees with the
    single-rank port run's on at least 99.9 % of the anchors (reading: all
    2,738).
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dmfusion.config import load_config as jax_load_config
from dmfusion.data import synthetic_scene as jax_synthetic_scene
from dmfusion.data.patches import gather_tri as jax_gather_tri
from dmfusion.data.scene import prep_scene as jax_prep_scene
from dmfusion.models import build_model as jax_build_model
from dmfusion.ops.ihs import ihs_transform as jax_ihs_transform
from dmfusion.ops.ihs import pan2ms as jax_pan2ms
from dmfusion.parallel.mesh import get_mesh as jax_get_mesh
from dmfusion.train.gan import GanPrograms as JaxGanPrograms
from dmfusion.train.losses import make_loss as jax_make_loss
from dmfusion.train.optim import make_optimizer as jax_make_optimizer
from dmfusion.train.steps import QuadPrograms as JaxQuadPrograms
from dmfusion.train.steps import TriPrograms as JaxTriPrograms
from dmfusion_torch import cli
from dmfusion_torch.config import load_config
from dmfusion_torch.data.patches import batched_ids_np
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax)
from dmfusion_torch.train.gan import GanPrograms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVER = {"data_city": "synth64", "patch_size": 8, "batchsize": 32,
        "test_batchsize": 32, "color_batchsize": 32, "seed": 0,
        "model_width": 8, "gan_width": 8, "device": "cpu", "nohup": 1,
        "dqtl": {"pic_size": 32, "batch_size": 4},
        "schedule": {"optimizer": "SGD"},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
GATHER_B = (72, 104, 1025)
STEPS, GAN_STEPS, GAN_BATCH, PIC = 2, 3, 4, 32
NETS = {"gP": "generator", "gM": "generator", "dP": "discriminator",
        "dM": "discriminator"}
OPTS = {"opt_g": ("gP", "gM"), "opt_d": ("dP", "dM")}
LR = 1e-4  # the config's dqtl.lr
# Adam's moments are held relative to the largest of them: the GAN's
# gradient moves with the order of its sums (the module docstring).
MOMENT_RTOL = 1e-2
CLI_COMMON = ["device=cpu", "patch_size=8", "model_width=8", "batchsize=32",
              "test_batchsize=32", "color_batchsize=32", "time=1",
              "verify_rate=0.05", "seed=0", "precision.compute_dtype=float32",
              "schedule.optimizer=SGD", "nohup=1"]
TRI_SET = ["model_name=tri_net", "epoch=2", "train_rate=0.1",
           "color.index=1", *CLI_COMMON]
TWOSTAGE_SET = ["--solver", "twostage", "--set", "model_name=dqtl",
                "gan_width=8", "dqtl.pic_size=32", "dqtl.epochs=1",
                "dqtl.pre_trained=0", "dqtl.save_model=1", "epoch=1",
                "train_rate=0.1", "color.index=1", *CLI_COMMON]

WORKER = r'''
import builtins, io, os, pickle, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from dmfusion_torch import cli, parallel
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import mspan_scene, synthetic_scene
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import (load_flax_params,
                                           opt_state_from_optax,
                                           opt_state_to_optax, params_to_flax)
from dmfusion_torch.ops.gather import gather_tri_fast
from dmfusion_torch.train.gan import GanPrograms
from dmfusion_torch.train.losses import qua_loss
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import DualPrograms, QuadPrograms, TriPrograms

inp = pickle.load(open(sys.argv[1], "rb"))
rank = int(os.environ["RANK"])
assert parallel.maybe_initialize_distributed(
    {"mesh": {"distributed": 1}, "device": "cpu"})
cfg = load_config(overrides={**inp["over"], "mesh": {"distributed": 1}})
mesh = parallel.get_mesh(cfg)
out = {"rank": rank, "mesh": [mesh.data, mesh.rank, str(mesh.device),
                              mesh.backend]}
scene = synthetic_scene(cfg, device="cpu")
out["mspan"] = mspan_scene(scene, cfg["seed"]).numpy()
tri_args = tuple(map(torch.from_numpy, inp["tri_args"]))
quad_args = tuple(map(torch.from_numpy, inp["quad_args"]))
w, ps = scene.width, scene.patch


class ShardLoss(QuadPrograms):
    """The control: each rank's qua_loss on its own shard, the ranks'
    gradients summed."""
    def _shard(self, labels_b, mask_b):
        return DualPrograms._shard(self, labels_b, mask_b)

    def loss(self, logits, labels_b, mask_b, count=None):
        return qua_loss(logits, labels_b.shape[0], labels_b, self.cfg, mask_b)


class SummedGan(GanPrograms):
    """The control: the ranks' gradients summed, not averaged."""
    def _reduce(self, params, loss):
        loss = super()._reduce(params, loss)
        for q in params:
            q.grad *= self.mesh.data
        return loss


out["gather"] = {}
for b, ids in inp["gather"].items():
    parts = gather_tri_fast(*tri_args, mesh.shard(torch.from_numpy(ids)),
                            w, ps)
    out["gather"][b] = {"shape": [list(p.shape) for p in parts],
                        "rows": [mesh.rows(p)[:b].numpy() for p in parts]}


def programs(cls, name, tree):
    mcfg = load_config(overrides={**inp["over"], "model_name": name})
    model = load_flax_params(build_model(mcfg), tree)
    opt = make_optimizer(mcfg, model.parameters(), inp["steps"])
    return cls(model, opt, mcfg, w, ps, mesh=mesh)


for fam, cls, args, classes in (
        ("tri", TriPrograms, tri_args, {"sum": TriPrograms}),
        ("quad", QuadPrograms, quad_args,
         {"sum": QuadPrograms, "shard_loss": ShardLoss})):
    name = "tri_net" if fam == "tri" else "dqtl"
    for variant, c in classes.items():
        prog = programs(c, name, inp[fam]["params0"])
        losses = prog.train_epoch(args, *map(torch.from_numpy,
                                             inp[fam]["train"]))
        out[fam, variant] = (losses.numpy(), params_to_flax(prog.model))
    prog = programs(cls, name, inp[fam]["params0"])
    ids, labels, mask = map(torch.from_numpy, inp[fam]["eval"])
    loss_sum, conf = prog.eval_epoch(args, ids, labels, mask)
    out[fam, "eval"] = (float(loss_sum), conf.numpy(),
                        prog.predict(args, ids).numpy())

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
for run, argv in inp["cli"].items():
    del written[:]
    solver = cli.main(argv)
    out["cli", run] = {
        "written": list(written), "output": solver.cfg["RESULT_output"],
        "excel": solver.cfg["RESULT_excel"], "matrix": solver.test_matrix,
        "mesh": solver.mesh.data,
        "stage1": getattr(solver, "stage1_log", None),
        "msgan": getattr(solver, "ms_gan", None)}
torch.save = save
del written[:]

# The GAN: dmfusion's states arrive once this process has computed them.
deadline = time.time() + 600
while not os.path.exists(inp["gan"]):
    assert time.time() < deadline, "no GAN inputs"
    time.sleep(0.2)
gan = pickle.load(open(inp["gan"], "rb"))
gcfg = load_config(overrides=inp["over"])


def gan_programs(state, cls=GanPrograms):
    nets = {k: load_flax_params(build_model(gcfg, n), state["params"][k])
            for k, n in inp["nets"].items()}
    prog = cls(*nets.values(), gcfg, mesh=mesh)
    for opt, keys in inp["opts"].items():
        opt_state_from_optax(state[opt], {k: nets[k] for k in keys},
                             getattr(prog, opt))
    return prog


def run_epoch(prog, steps, noise, collect):
    draws = iter(noise)
    prog.noise = lambda m, p: next(draws)
    m, p = (torch.from_numpy(gan[k][steps]) for k in ("m", "p"))
    return {k: v.numpy() for k, v in prog.train_epoch(m, p, collect).items()}


for i, st in enumerate(gan["steps"]):
    for variant, cls in (("mean", GanPrograms), ("summed", SummedGan)):
        prog = gan_programs(st["before"], cls)
        noise = [tuple(map(torch.from_numpy, st["noise"]))]
        res = run_epoch(prog, slice(i, i + 1), noise, "all")
        out["gan", i, variant] = {
            "out": res,
            "params": {k: params_to_flax(n) for k, n in prog.nets.items()},
            "opt": {opt: opt_state_to_optax(
                {k: prog.nets[k] for k in keys}, getattr(prog, opt))
                for opt, keys in inp["opts"].items()}}
noise = [tuple(map(torch.from_numpy, st["noise"])) for st in gan["steps"]]
for collect in ("all", "first", "none"):
    prog = gan_programs(gan["steps"][0]["before"])
    out["gan_collect", collect] = run_epoch(prog, slice(0, 2), noise[:2],
                                            collect)
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


def _cat(tree):
    return np.concatenate([v.ravel() for v in _vec(tree).values()])


def _batches(label, rng, n):
    labeled = np.flatnonzero(label.reshape(-1) != 0).astype(np.int32)
    ids = rng.choice(labeled, n, replace=False).astype(np.int32)
    chunks, mask, _ = batched_ids_np(ids, 32)
    labels = label.reshape(-1)[chunks].astype(np.int32)
    return chunks, labels, mask.astype(np.float32)


def _quad_args(jscene):
    """dmfusion's four stage-2 streams over seeded stand-ins of the GAN
    scenes: msgan is pan2ms(PAN) and pangan is MS, each plus normal
    noise."""
    size = (jscene.height, jscene.width, 4)
    pms = np.asarray(jax_pan2ms(jnp.asarray(jscene.raw_pan), size))
    rng = np.random.default_rng(0)
    raw_ms = np.asarray(jscene.raw_ms, np.float32)
    msgan = pms + 0.1 * rng.standard_normal(size) * pms.std()
    pangan = raw_ms + 0.1 * rng.standard_normal(size) * raw_ms.std()
    return tuple(np.asarray(jax_prep_scene(
        jnp.asarray(np.asarray(a, np.float32)), jscene.patch, jnp.float32))
        for a in (raw_ms, pms, msgan, pangan))


def _jax_gan(mesh, tmp):
    """Three dmfusion GAN steps on its mesh, one jitted call each: the
    state before and after, the noise each drew and its outputs."""
    jcfg = jax_load_config(overrides=OVER)
    prog = JaxGanPrograms(*(jax_build_model(jcfg, n) for n in NETS.values()),
                          jcfg, mesh=mesh)
    state = prog.init(jax.random.PRNGKey(0), PIC, 4)
    rng = np.random.default_rng(3)
    shape = (GAN_STEPS, GAN_BATCH, PIC, PIC, 4)
    m = rng.random(shape, dtype=np.float32)
    p = rng.random(shape, dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), GAN_STEPS)
    step = jax.jit(prog._step)
    steps = []
    for i in range(GAN_STEPS):
        km, kp = jax.random.split(keys[i])
        noise = (np.array(jax.random.normal(km, m[i].shape)),
                 np.array(jax.random.normal(kp, p[i].shape)))
        before = _tree(state)
        state, res = step(state, jnp.asarray(m[i]), jnp.asarray(p[i]),
                          keys[i])
        steps.append({"before": before, "after": _tree(state),
                      "noise": noise, "out": jax.tree.map(np.asarray, res)})
    gan = {"m": m, "p": p, "steps": steps}
    with open(tmp / "gan.tmp", "wb") as f:
        pickle.dump(gan, f)
    os.replace(tmp / "gan.tmp", tmp / "gan.pkl")
    return gan


def _port_gan(state):
    """The port's ``GanPrograms`` on one rank, holding dmfusion's
    ``state``."""
    cfg = load_config(overrides=OVER)
    nets = {k: load_flax_params(build_model(cfg, n), state["params"][k])
            for k, n in NETS.items()}
    prog = GanPrograms(*nets.values(), cfg)
    for opt, keys in OPTS.items():
        opt_state_from_optax(state[opt], {k: nets[k] for k in keys},
                             getattr(prog, opt))
    return prog


def _one_rank_collect(gan):
    """The port's ``collect`` epochs of two steps on one rank."""
    noise = [tuple(map(torch.from_numpy, st["noise"])) for st in gan["steps"]]
    out = {}
    for collect in ("all", "first", "none"):
        prog = _port_gan(gan["steps"][0]["before"])
        draws = iter(noise[:2])
        prog.noise = lambda m, p: next(draws)
        res = prog.train_epoch(*(torch.from_numpy(gan[k][:2])
                                 for k in ("m", "p")), collect)
        out[collect] = {k: v.numpy() for k, v in res.items()}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results, dmfusion's on its two-device mesh, and the
    single-rank port runs."""
    tmp = tmp_path_factory.mktemp("ranks")
    jcfg = jax_load_config(overrides=OVER)
    mesh = jax_get_mesh({"mesh": {"data": 2, "model": 1}})
    assert mesh.shape["data"] == 2
    jscene = jax_synthetic_scene(jcfg)
    mspan = jax_ihs_transform(jnp.asarray(jscene.raw_ms),
                              jnp.asarray(jscene.raw_pan),
                              jax.random.PRNGKey(int(jcfg["seed"])))
    mspan = jax_prep_scene(mspan, 4 * jscene.patch, mspan.dtype)
    tri_args = tuple(np.asarray(a) for a in (jscene.ms, jscene.pan, mspan))
    quad_args = _quad_args(jscene)
    rng = np.random.default_rng(1)
    gather_ids = {b: rng.integers(0, jscene.num_pixels, b).astype(np.int32)
                  for b in GATHER_B}
    fams = {}
    for fam, name, cls, args in (("tri", "tri_net", JaxTriPrograms, tri_args),
                                 ("quad", "dqtl", JaxQuadPrograms,
                                  quad_args)):
        fcfg = jax_load_config(overrides={**OVER, "model_name": name})
        extra = (jax_make_loss("qua_loss", fcfg),) if fam == "quad" else ()
        jprog = cls(jax_build_model(fcfg), jax_make_optimizer(fcfg, STEPS),
                    fcfg, jscene.width, jscene.patch, mesh, *extra)
        params0, opt0 = jprog.init(jax.random.PRNGKey(0))
        fams[fam] = {"jprog": jprog, "params0": params0, "opt0": opt0,
                     "args": tuple(map(jnp.asarray, args)),
                     "train": _batches(jscene.label, rng, 52),
                     "eval": _batches(jscene.label, rng, 90)}
    cli_dirs = {run: tmp / f"cli2_{run}" for run in ("tri", "twostage")}
    inp = {"over": OVER, "steps": STEPS, "gather": gather_ids,
           "tri_args": tri_args, "quad_args": quad_args,
           **{fam: {"params0": _tree(f["params0"]), "train": f["train"],
                    "eval": f["eval"]} for fam, f in fams.items()},
           "cli": {"tri": ["--city", "synth64", "--set", *TRI_SET,
                           "mesh.distributed=1",
                           f"expo_result={cli_dirs['tri']}/"],
                   "twostage": ["--city", "synth64", *TWOSTAGE_SET,
                                "mesh.distributed=1", "dqtl.batch_size=3",
                                f"expo_result={cli_dirs['twostage']}/"]},
           "nets": NETS, "opts": OPTS, "gan": str(tmp / "gan.pkl"),
           "out": str(tmp / "rank%d.pkl")}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    (tmp / "worker.py").write_text(WORKER)
    procs = _start_ranks(tmp)
    try:
        # dmfusion on its two-device mesh while the ranks work.
        gan = _jax_gan(mesh, tmp)
        ref = {"gather": {b: [np.asarray(a) for a in jax_gather_tri(
            *fams["tri"]["args"], jnp.asarray(ids), jscene.width,
            jscene.patch)] for b, ids in gather_ids.items()}}
        for fam, f in fams.items():
            jprog, tree0 = f["jprog"], inp[fam]["params0"]

            def params0():  # train_epoch donates its parameters
                return serialization.from_state_dict(f["params0"], tree0)
            p, _, losses = jprog.train_epoch(
                params0(), serialization.from_state_dict(
                    f["opt0"], _tree(f["opt0"])),
                f["args"], *map(jnp.asarray, f["train"]))
            ref[fam] = (np.asarray(losses), _tree(p))
            loss_sum, conf = jprog.eval_epoch(params0(), f["args"],
                                              *map(jnp.asarray, f["eval"]))
            preds = jprog.predict(params0(), f["args"],
                                  jnp.asarray(f["eval"][0]))
            ref[fam, "eval"] = (float(loss_sum), np.asarray(conf),
                                np.asarray(preds))
        ref["collect"] = _one_rank_collect(gan)
        single = {}
        for run_, argv in (("tri", ["--city", "synth64", "--set", *TRI_SET]),
                           ("twostage", ["--city", "synth64",
                                         *TWOSTAGE_SET,
                                         "dqtl.batch_size=4"])):
            single[run_] = cli.main(
                [*argv, f"expo_result={tmp / ('cli1_' + run_)}/"])
        ref["single"] = {"tri": single["tri"].test_matrix,
                         "msgan": single["twostage"].ms_gan,
                         "stage1": single["twostage"].stage1_log}
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
    return {"ranks": ranks, "ref": ref, "gan": gan, "fams": fams,
            "logs": logs, "tmp": tmp, "cli_dirs": cli_dirs}


def test_ranks_join_and_build_one_mspan(run):
    """Both ranks join over gloo, and build the same MSPAN, bit for bit
    (nothing is broadcast)."""
    for r, out in enumerate(run["ranks"]):
        assert out["mesh"] == [2, r, "cpu", "gloo"]
    a, b = (out["mspan"] for out in run["ranks"])
    assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("b", GATHER_B)
def test_tri_gather_rows(run, b):
    """Each rank gathers ceil(b / 2) rows of each stream; both ranks' rows,
    trimmed to b, equal dmfusion's ``gather_tri`` exactly."""
    per = -(-b // 2)
    for out in run["ranks"]:
        assert out["gather"][b]["shape"] == [[per, 8, 8, 4], [per, 32, 32, 1],
                                             [per, 32, 32, 1]]
        got = out["gather"][b]["rows"]
        for g, w in zip(got, run["ref"]["gather"][b], strict=True):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _check_epoch(run, fam, variant="sum", rtol=1e-5, atol=1e-6):
    want_losses, want_params = run["ref"][fam]
    want = _vec(want_params)
    for out in run["ranks"]:
        losses, params = out[fam, variant]
        np.testing.assert_allclose(losses, want_losses, rtol=rtol, atol=atol)
        got = _vec(params)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=k)


def _check_eval(run, fam):
    loss_sum, conf, preds = run["ref"][fam, "eval"]
    n = int(run["fams"][fam]["eval"][2].sum())
    assert conf[..., :, :].sum(axis=(-1, -2)).min() == n
    for out in run["ranks"]:
        got_loss, got_conf, got_preds = out[fam, "eval"]
        np.testing.assert_allclose(got_loss, loss_sum, rtol=1e-5)
        np.testing.assert_array_equal(got_conf, conf)
        np.testing.assert_array_equal(got_preds, preds)


@pytest.mark.parametrize("fam", ["tri", "quad"])
def test_epoch_matches_mesh(run, fam):
    """Two SGD steps, the second batch padded (16 real rows on rank 0, 4
    on rank 1): every rank's losses and parameters equal dmfusion's mesh
    epoch's.  For quad the loss is the whole batch's qua_loss on every
    rank, and the summed gradients are the whole batch's."""
    _check_epoch(run, fam)


@pytest.mark.parametrize("fam", ["tri", "quad"])
def test_eval_and_predict_match_mesh(run, fam):
    """The eval loss sum (quad: the whole batches' qua_loss times their
    real counts), the confusion (quad: all five) and the prediction (quad:
    the fused rule)."""
    _check_eval(run, fam)


def test_quad_per_rank_loss_misses(run):
    """qua_loss is not a sum over rows: each rank's loss on its own shard,
    with the gradients summed, is another loss, and the parity checks above
    would catch it."""
    want_losses, want_params = run["ref"]["quad"]
    losses, params = run["ranks"][0]["quad", "shard_loss"]
    assert np.abs(losses - want_losses).max() > 1e-4
    got, want = _vec(params), _vec(want_params)
    assert max(np.abs(got[k] - want[k]).max() for k in want) > 1e-5


def _moment_gap(got, want):
    return max(np.abs(_cat(got[opt]["0"][key]) - _cat(want[opt]["0"][key]))
               .max() for opt in OPTS for key in ("mu", "nu"))


def _moment_max(state):
    return max(np.abs(_cat(state[opt]["0"][key])).max()
               for opt in OPTS for key in ("mu", "nu"))


@pytest.mark.parametrize("step", range(GAN_STEPS))
def test_gan_step_matches_mesh(run, step):
    """One D + G step on two ranks (two tiles each) from dmfusion's mesh
    state before it and with its noise."""
    st = run["gan"]["steps"][step]
    a, b = (out["gan", step, "mean"] for out in run["ranks"])
    np.testing.assert_array_equal(_cat(a["params"]), _cat(b["params"]))
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(a["out"][k][0], st["out"][k], rtol=1e-4,
                                   atol=1e-6)
    for k in ("fake_pan", "fake_ms"):
        np.testing.assert_allclose(a["out"][k][0], st["out"][k], rtol=0,
                                   atol=1e-5)
    assert _moment_gap(a["opt"], st["after"]) <= MOMENT_RTOL * _moment_max(
        st["after"])
    assert np.abs(_cat(a["params"])
                  - _cat(st["after"]["params"])).max() <= 3 * LR


def test_gan_summed_gradients_miss(run):
    """Summing the ranks' gradients instead of averaging them: Adam's
    update barely sees the doubled scale, but its moments miss."""
    for step in range(GAN_STEPS):
        got = run["ranks"][0]["gan", step, "summed"]
        after = run["gan"]["steps"][step]["after"]
        gap = _moment_gap(got["opt"], after)
        assert gap > MOMENT_RTOL * _moment_max(after), gap


def test_gan_collect_modes_gather_one_ranks_fakes(run):
    """A two-step epoch in each ``collect`` mode: every rank holds the whole
    batch's fakes in batch order, as one rank makes them."""
    for out in run["ranks"]:
        for collect, ref in run["ref"]["collect"].items():
            got = out["gan_collect", collect]
            assert {k: v.shape for k, v in got.items()} == \
                {k: v.shape for k, v in ref.items()}, collect
            for k in ref:
                np.testing.assert_allclose(
                    got[k], ref[k], rtol=1e-4,
                    atol=5e-4 if "fake" in k else 1e-6,
                    err_msg=f"{collect} {k}")


def _rank_writes(run, name):
    r0, r1 = (out["cli", name] for out in run["ranks"])
    d = str(run["cli_dirs"][name])
    assert not [f for f in r1["written"] if f.startswith(d)]
    return r0, r1, [f for f in r0["written"] if f.startswith(d)]


def test_twostage_cli_two_ranks(run):
    r0, r1, mine = _rank_writes(run, "twostage")
    assert r0["mesh"] == r1["mesh"] == 2
    assert r0["output"] == r1["output"] and r0["excel"] == r1["excel"]
    d = run["cli_dirs"]["twostage"]
    assert sorted(os.listdir(d)) == ["dqtl_weights",
                                     "synth64_tr0.1_ep1_bs32"]
    assert sorted(os.listdir(d / "synth64_tr0.1_ep1_bs32")) == [
        "dqtl__0_output", "dqtl__0_result.xlsx"]
    weights = sorted(os.listdir(d / "dqtl_weights"))
    assert weights == ["disc_m.ckpt", "disc_p.ckpt", "fake_ms.png",
                       "fake_pan.png", "gen_m.ckpt", "gen_p.ckpt",
                       "msgan.npy", "pan.npy", "pangan.npy", "saved_images"]
    names = [os.path.basename(f).split(".tmp")[0] for f in mine]
    assert names.count("pan.npy") == 1
    assert {*weights[:-1], "dqtl__0_result.xlsx", "0_matrix.npy",
            "0_weights.pt"} <= set(names)
    # dqtl.batch_size 3 rounds up to 4 on two ranks: 6 tiles, 2 steps.
    single = run["ref"]["single"]
    for r in (r0, r1):
        assert r["stage1"]["batch"] == single["stage1"]["batch"] == 4
        assert [len(x) for x in r["stage1"]["d_loss"]] == [-(-6 // 4)]
        assert np.isfinite(r["stage1"]["d_loss"] + r["stage1"]["g_loss"]
                           ).all()
    np.testing.assert_array_equal(r0["msgan"], r1["msgan"])
    np.testing.assert_array_equal(
        np.load(d / "dqtl_weights" / "msgan.npy"), r0["msgan"])
    np.testing.assert_allclose(r0["msgan"], single["msgan"], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(r0["matrix"], r1["matrix"])
    assert r0["matrix"].sum() > 0


def test_tri_cli_two_ranks(run):
    r0, r1, mine = _rank_writes(run, "tri")
    assert r0["mesh"] == r1["mesh"] == 2
    assert sorted(os.listdir(r0["output"])) == [
        "0_curweights.pt", "0_matrix.npy", "0_pic_1.png", "0_pic_2.png",
        "0_records.json", "0_weights.pt"]
    assert {"0_weights.pt", "0_matrix.npy", "0_pic_1.png",
            "tri_net__0_result.xlsx"} <= {
        os.path.basename(f).split(".tmp")[0] for f in mine}
    np.testing.assert_array_equal(r0["matrix"], r1["matrix"])
    single = run["ref"]["single"]["tri"]
    assert r0["matrix"].sum() == single.sum() > 0
    moved = np.abs(r0["matrix"] - single).sum() / 2
    assert moved <= 0.001 * single.sum(), moved
