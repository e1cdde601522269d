"""The port's solver, run slots, reports, checkpoints and CLI against
dmfusion's, on the CPU (synth64, patch 8, width 8, f32).

Exact throughout: split ids, shuffled batches, masks and labels (numpy
draws in the same order), the run slot and the dirs it collects, the
xlsx bytes, the PNG pixels, and the test confusion that the port's
``test()`` computes from dmfusion's own trained weights.
"""

import os
import shutil
import time
import types
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from dmfusion.config import load_config as jax_load_config
from dmfusion.config import prepare_run as jax_prepare_run
from dmfusion.ops.metrics import render_class_map as jax_render_class_map
from dmfusion.report.excel import expo_result as jax_expo_result
from dmfusion.solvers import build_solver as jax_build_solver
from dmfusion.solvers.base import BaseSolver as JaxBaseSolver
from dmfusion_torch import cli
from dmfusion_torch.config import load_config, prepare_run
from dmfusion_torch.export import _msgpack_restore
from dmfusion_torch.models import build_model
from dmfusion_torch.models.convert import params_from_flax
from dmfusion_torch.ops.metrics import aa_oa, render_class_map
from dmfusion_torch.report.excel import Workbook, expo_result
from dmfusion_torch.report.png import write_png
from dmfusion_torch.solvers import build_solver
from dmfusion_torch.solvers.base import BaseSolver
from dmfusion_torch.train.checkpoint import (AsyncCheckpointWriter,
                                             load_checkpoint, save_checkpoint,
                                             snapshot)
from dmfusion_torch.train.optim import make_optimizer

OVER = {"data_city": "synth64", "patch_size": 8, "model_width": 8,
        "batchsize": 32, "test_batchsize": 32, "color_batchsize": 32,
        "epoch": 2, "time": 1, "train_rate": 0.05, "verify_rate": 0.05,
        "seed": 0, "nohup": 1, "mesh": {"data": 1},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(tmp, **more):
    return {**OVER, "expo_result": f"{tmp}/", **more}


def _port_cfg(tmp, **more):
    return load_config(overrides={**_over(tmp, **more), "device": "cpu"},
                       prepare=True)


def _jax_cfg(tmp, **more):
    return jax_load_config(overrides=_over(tmp, **more), prepare=True)


# -- splits and batches ----------------------------------------------------

@pytest.fixture(scope="module")
def masked_dir(tmp_path_factory):
    """A scene directory in the reference layout with train/test masks."""
    cfg = jax_load_config(overrides=OVER)
    from dmfusion.data.scene import synthetic_scene
    sc = synthetic_scene(cfg)
    d = tmp_path_factory.mktemp("scene")
    np.save(d / "ms4.npy", sc.raw_ms)
    np.save(d / "pan.npy", sc.raw_pan)
    np.save(d / "label.npy", sc.label)
    coin = np.random.default_rng(0).random(sc.label.shape)
    labeled = sc.label != 0
    np.save(d / "train.npy", (labeled & (coin < 0.3)) * sc.label)
    np.save(d / "test.npy", (labeled & (coin >= 0.3)) * sc.label)
    return str(d) + "/"


@pytest.mark.parametrize("data_new", [0, 1])
def test_dataloader_ids_equal(tmp_path, masked_dir, data_new):
    more = {"data_new": data_new, "verify_rate": 0.1}
    if data_new:
        more["data_address"] = masked_dir
    jax_s = JaxBaseSolver(_jax_cfg(tmp_path / "j", **more))
    port_s = BaseSolver(_port_cfg(tmp_path / "t", **more))
    for repeat in (0, 1):
        jax_s.time = port_s.time = repeat
        jax_s.dataloader()
        port_s.dataloader()
        for part in ("train", "test", "valid", "labeled", "unlabeled"):
            want = getattr(jax_s.split, part)
            got = getattr(port_s.split, part)
            assert got.dtype == want.dtype and np.array_equal(got, want), part


def test_batches_equal(tmp_path):
    jax_s = JaxBaseSolver(_jax_cfg(tmp_path / "j"))
    port_s = BaseSolver(_port_cfg(tmp_path / "t"))
    jax_s.dataloader()
    port_s.dataloader()
    calls = [((jax_s.split.train, 32), {"shuffle": True}),   # epoch 0
             ((jax_s.split.train, 32), {"shuffle": True}),   # epoch 1
             ((jax_s.split.valid, 300), {"round_to": 64}),
             ((jax_s.split.test, 300), {"round_to": 4096}),
             ((jax_s.split.train, 32), {"trim": True})]
    for args, kw in calls:
        want = jax_s.batches(*args, **kw)
        got = port_s.batches(*args, **kw)
        assert got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert np.array_equal(g.numpy(), np.asarray(w)), kw
        assert got[2].dtype == torch.bool


# -- run slots -------------------------------------------------------------

def _slot_tree(root):
    """Finished slots 0 and 2, orphan output dirs 1 and 3."""
    res = root / "synth64_tr0.05_ep2_bs32"
    res.mkdir(parents=True)
    for n in (0, 1, 2, 3):
        (res / f"gmfnet__{n}_output").mkdir()
        (res / f"gmfnet__{n}_output" / "x.npy").write_bytes(b"x")
    for n in (0, 2):
        (res / f"gmfnet__{n}_result.xlsx").write_bytes(b"x")


def _listing(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.mark.parametrize("more", [{}, {"delete": 0},
                                  {"train": {"resume": 1}},
                                  {"train": {"index": 0}, "FILE_NUM": 2}])
def test_prepare_run_same_slot_and_gc(tmp_path, more):
    _slot_tree(tmp_path / "tree")
    shutil.copytree(tmp_path / "tree", tmp_path / "j")
    shutil.copytree(tmp_path / "tree", tmp_path / "t")
    raw = {k: v for k, v in OVER.items() if k != "mesh"}
    want = jax_prepare_run(jax_load_config(overrides={
        **raw, **more, "expo_result": f"{tmp_path}/j/"}))
    got = prepare_run(load_config(overrides={
        **raw, **more, "expo_result": f"{tmp_path}/t/"}))
    assert got["FILE_NUM"] == want["FILE_NUM"]
    assert _listing(tmp_path / "t") == _listing(tmp_path / "j")
    assert got["RESULT_output"].replace("/t/", "/j/") == want["RESULT_output"]


def test_prepare_run_slots_gc_orphans(tmp_path):
    _slot_tree(tmp_path)
    cfg = prepare_run(load_config(overrides={**OVER, "expo_result":
                                             f"{tmp_path}/"}))
    assert cfg["FILE_NUM"] == 1  # 3 and 1 were orphans; 1 is the lowest
    assert not os.path.exists(os.path.join(cfg["RESULT"], "gmfnet__3_output"))


# -- reports ---------------------------------------------------------------

def test_expo_result_xlsx_bytes_equal(tmp_path, monkeypatch):
    """One result block, and a second repeat appended, from each package:
    the same bytes (zip member times pinned, as two writes may straddle a
    two-second boundary)."""
    clock = types.SimpleNamespace(time=lambda: 1.7e9,
                                  localtime=time.localtime)
    monkeypatch.setattr(zipfile, "time", clock)
    rng = np.random.default_rng(0)
    result = aa_oa(rng.integers(0, 50, (5, 5)).astype(np.float32))
    cfg = load_config(overrides=OVER)
    cfg["RESULT_excel"] = str(tmp_path / "r.xlsx")  # dumped in the book
    written = []
    for fn in (jax_expo_result, expo_result):
        for rep in (0, 1):
            fn(result, cfg, [12.5, 3.25], rep)
        with open(cfg["RESULT_excel"], "rb") as f:
            written.append(f.read())
        if fn is jax_expo_result:
            os.remove(cfg["RESULT_excel"])
    assert written[0] == written[1]
    sheet = Workbook.load(cfg["RESULT_excel"]).active
    assert sheet.cell(6, 2) == "OA" and sheet.cell(14, 6) == "KAPPA"


def test_png_pixels_equal_pil(tmp_path):
    """The stdlib PNG of a class map has the pixels of dmfusion's PIL file."""
    import jax.numpy as jnp
    cfg = load_config(overrides={"data_city": "image6"})
    palette = np.asarray(cfg["DATA_DICT"]["image6"]["color"], np.uint8)
    lab = np.random.default_rng(1).integers(0, len(palette), (37, 53))
    img_j = np.asarray(jax_render_class_map(jnp.asarray(lab),
                                            jnp.asarray(palette)))
    Image.fromarray(img_j).save(tmp_path / "j.png")
    img_t = render_class_map(torch.from_numpy(lab),
                             torch.from_numpy(palette)).numpy()
    write_png(tmp_path / "t.png", img_t)
    want = np.asarray(Image.open(tmp_path / "j.png"))
    got = np.asarray(Image.open(tmp_path / "t.png"))
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    assert np.array_equal(got, want)


# -- checkpoints -----------------------------------------------------------

def _model_and_opt(seed=0):
    cfg = load_config(overrides=OVER)
    model = build_model(cfg)
    from dmfusion_torch.models.common import init_params
    init_params(model, torch.Generator().manual_seed(seed))
    return cfg, model, make_optimizer(cfg, model.parameters(), 1)


def _step(model, opt):
    opt.zero_grad()
    ms = torch.rand(4, 8, 8, 4, generator=torch.Generator().manual_seed(1))
    pan = torch.rand(4, 32, 32, 1, generator=torch.Generator().manual_seed(2))
    model(ms, pan).square().mean().backward()
    opt.step()


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def test_checkpoint_round_trip(tmp_path):
    _, model, opt = _model_and_opt()
    _step(model, opt)
    tree = {"params": model.state_dict(), "opt_state": opt.state_dict(),
            "epoch": 3}
    path = tmp_path / "0_curweights.pt"
    save_checkpoint(path, tree, meta={"model": "gmfnet", "width": 8})
    assert not list(tmp_path.glob("*.tmp*"))  # written atomically
    _, fresh, fresh_opt = _model_and_opt(seed=9)
    got = load_checkpoint(path, {"params": fresh.state_dict(),
                                 "opt_state": fresh_opt.state_dict(),
                                 "epoch": 0},
                          expect={"model": "gmfnet", "width": 8})
    assert _equal_trees(got["params"], tree["params"])
    assert got["epoch"] == 3
    fresh.load_state_dict(got["params"])
    fresh_opt.load_state_dict(got["opt_state"])
    assert fresh_opt.param_groups[0]["count"] == 1
    assert _equal_trees(fresh_opt.state_dict()["state"],
                        opt.state_dict()["state"])


def test_checkpoint_meta_mismatch_raises(tmp_path):
    _, model, _ = _model_and_opt()
    path = tmp_path / "w.pt"
    save_checkpoint(path, model.state_dict(), meta={"model": "gmfnet",
                                                    "width": 8})
    with pytest.raises(ValueError, match="different configuration"):
        load_checkpoint(path, model.state_dict(),
                        expect={"model": "gmfnet", "width": 64})
    with pytest.warns(UserWarning, match="leniently"):
        got = load_checkpoint(path, model.state_dict(),
                              expect={"model": "gmfnet", "width": 64},
                              lenient=True)
    assert _equal_trees(got, model.state_dict())


def test_checkpoint_lenient_merge(tmp_path):
    """Leaves missing from the file or of another shape keep the
    template's values, with a warning naming them."""
    _, model, _ = _model_and_opt()
    stored = dict(model.state_dict())
    stored.pop("head.out.bias")
    stored["head.out.weight"] = torch.zeros(3, 3)
    path = tmp_path / "w.pt"
    save_checkpoint(path, stored)
    _, fresh, _ = _model_and_opt(seed=5)
    template = fresh.state_dict()
    with pytest.warns(UserWarning, match="2 leaves kept"):
        got = load_checkpoint(path, template)
    assert torch.equal(got["head.out.bias"], template["head.out.bias"])
    assert torch.equal(got["head.out.weight"], template["head.out.weight"])
    assert torch.equal(got["ms_stem.conv.weight"],
                       model.state_dict()["ms_stem.conv.weight"])
    assert load_checkpoint(path, template, strict=True).keys() == \
        stored.keys()


def test_async_save_equals_sync(tmp_path):
    _, model, opt = _model_and_opt()
    _step(model, opt)
    tree = {"params": model.state_dict(), "opt_state": opt.state_dict(),
            "epoch": 1}
    meta = {"model": "gmfnet", "width": 8}
    save_checkpoint(tmp_path / "sync.pt", tree, meta=meta)
    writer = AsyncCheckpointWriter()
    writer.save(tmp_path / "async.pt", tree, copy=True, meta=meta)
    _step(model, opt)  # moves the live tensors while the write may run
    writer.close()
    a = torch.load(tmp_path / "sync.pt", weights_only=True)
    b = torch.load(tmp_path / "async.pt", weights_only=True)
    assert a["__meta__"] == b["__meta__"] == {"format": 1, **meta}
    assert _equal_trees(a["tree"], b["tree"])


def test_best_snapshot_does_not_move(tmp_path):
    _, model, opt = _model_and_opt()
    _step(model, opt)
    best = snapshot(model.state_dict())
    held = model.state_dict()  # references: these follow the updates
    before = {k: v.clone() for k, v in held.items()}
    for _ in range(2):
        _step(model, opt)
    assert _equal_trees(best, before)
    assert not torch.equal(held["ms_stem.conv.weight"],
                           before["ms_stem.conv.weight"])


def test_resume_restarts_at_next_epoch(tmp_path):
    """A run stopped before its report leaves an unfinished slot; resume
    reloads its curweights, starts at epoch + 1 and trims the records to
    the epochs before it."""
    res = {"RESULT": f"{tmp_path}/res/", "test": {"index": 0}}
    first = build_solver(_port_cfg(tmp_path, **res))
    first.run()
    out = first.cfg["RESULT_output"]
    rec_path = os.path.join(out, "0_records.json")
    import json
    with open(rec_path) as f:
        rec = json.load(f)
    assert rec["Epoch"] == [0, 1]
    rec["Epoch"].append(7)  # an epoch past the checkpoint: trimmed
    rec["Loss"].append(99.0)
    with open(rec_path, "w") as f:
        json.dump(rec, f)
    second = build_solver(_port_cfg(tmp_path, epoch=3, train={"resume": 1},
                                    **res))
    assert second.cfg["RESULT_output"] == out
    second.dataloader()
    second.train()
    assert second.records["Epoch"] == [0, 1, 2]
    assert second.records["Loss"][:2] == rec["Loss"][:2]
    assert len(second.records["Loss"]) == 3
    assert second.optimizer.param_groups[0]["count"] == 3 * -(
        -len(second.split.train) // 32)


def test_test_only_without_weights_raises(tmp_path):
    solver = build_solver(_port_cfg(tmp_path, train={"index": 0}))
    solver.dataloader()
    with pytest.raises(FileNotFoundError, match="eval weights not found"):
        solver.test()


def test_unported_paths_raise(tmp_path):
    # One rank cannot hold a model axis of two: dmfusion's mesh error.
    with pytest.raises(ValueError,
                       match="1 devices not divisible by model axis 2"):
        BaseSolver(_port_cfg(tmp_path, mesh={"data": 1, "model": 2}))
    # The image arity (stage 1's GAN nets) is refused by the main solver
    # with dmfusion's kind of error, naming the two-stage solver.
    solver = build_solver(_port_cfg(tmp_path, model_name="generator"))
    solver.dataloader()
    with pytest.raises(ValueError, match="arity 'image'.*--solver twostage"):
        solver.train()
    solver = build_solver(_port_cfg(tmp_path, model_name="dqtl"))
    solver.dataloader()
    with pytest.raises(NotImplementedError, match="--solver twostage"):
        solver.train()
    solver = build_solver(_port_cfg(tmp_path, schedule={"loss": "MSE"}))
    solver.dataloader()
    with pytest.raises(ValueError, match="not usable with the main solver"):
        solver.train()


# -- the CLI, end to end ---------------------------------------------------

def test_cli_end_to_end(tmp_path, capsys):
    solver = cli.main([
        "--city", "synth64", "--set", "device=cpu", "patch_size=8",
        "model_width=8", "batchsize=32", "test_batchsize=32",
        "color_batchsize=32", "epoch=2", "time=1", "train_rate=0.05",
        "verify_rate=0.05", "seed=0", "color.index=1",
        f"expo_result={tmp_path}/", "precision.compute_dtype=float32"])
    out = solver.cfg["RESULT_output"]
    assert solver.cfg["FILE_NUM"] == 0
    for name in ("0_weights.pt", "0_curweights.pt", "0_matrix.npy",
                 "0_records.json", "0_pic_1.png", "0_pic_2.png"):
        assert os.path.isfile(os.path.join(out, name)), name
    rec = solver.records
    for key in ("Epoch", "Loss", "ValLoss", "ValOA", "EpochTime"):
        assert len(rec[key]) == 2, key
    assert all(np.isfinite(rec["Loss"]))
    assert solver.test_matrix.sum() == len(solver.split.test)
    sheet = Workbook.load(solver.cfg["RESULT_excel"]).active
    assert sheet.cell(6, 2) == "OA" and sheet.cell(6, 6) == "KAPPA"
    assert sheet.cell(6, 3) == pytest.approx(solver.last_result[1])
    lab1, lab2 = solver.color_maps
    img = np.asarray(Image.open(os.path.join(out, "0_pic_2.png")))
    assert img.shape == (*lab2.shape, 3)
    assert "[repeat 0] epoch 1 loss" in capsys.readouterr().out


def test_dmfusion_weights_give_dmfusion_test_matrix(tmp_path):
    """dmfusion trains and tests; its best weights, converted into the
    port's checkpoint, give the port's test() the same confusion."""
    jsolver = jax_build_solver(_jax_cfg(tmp_path / "j", epoch=1))
    jsolver.run()
    jout = jsolver.cfg["RESULT_output"]
    with open(os.path.join(jout, "0_weights.msgpack"), "rb") as f:
        payload = _msgpack_restore(f.read())
    assert payload["__meta__"]["model"] == "gmfnet"
    state = params_from_flax(payload["tree"])

    cfg = _port_cfg(tmp_path / "t", epoch=1, train={"index": 0})
    solver = build_solver(cfg)
    save_checkpoint(solver.best_weights_path(), state,
                    meta={"model": "gmfnet", "width": 8})
    solver.dataloader()
    solver.test()
    assert solver.test_matrix.dtype == np.float32
    assert np.array_equal(solver.test_matrix, jsolver.test_matrix)
    assert solver.last_result[1] == pytest.approx(jsolver.last_result[1],
                                                  abs=0)
