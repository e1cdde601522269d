"""The port's spans (``dmfusion_torch/trace.py``): off, one shared null
context; under a CPU ``torch.profiler``, each path's Chrome trace holds
its spans, nested at the layer boundaries; the solver's exporter
(``profile.enabled``) writes them too."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmfusion_torch import trace
from dmfusion_torch.config import load_config
from dmfusion_torch.data.scene import synthetic_scene
from dmfusion_torch.export import load_artifact, save_artifact
from dmfusion_torch.infer import ScenePredictor
from dmfusion_torch.models import build_model
from dmfusion_torch.models.common import init_params
from dmfusion_torch.train.optim import make_optimizer
from dmfusion_torch.train.steps import DensePrograms, DualPrograms

OVER = {"data_city": "synth64", "patch_size": 8, "model_width": 8,
        "seed": 0, "device": "cpu",
        "precision": {"compute_dtype": "float32"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_span_off_is_one_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    a, b = trace.span("predict_ids"), trace.span("b1.launch")
    assert a is b
    with a:
        with b:
            pass


def _spans(path):
    """The trace's program spans: name -> [(start, end, parent)], the
    parent the innermost other span around it on its thread."""
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    out = {}
    for e in events:
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        around = [o for o in events if o is not e and o["tid"] == e["tid"]
                  and float(o["ts"]) <= s
                  and t <= float(o["ts"]) + float(o["dur"])]
        parent = min(around, key=lambda o: float(o["dur"]), default=None)
        out.setdefault(e["name"], []).append(
            (s, t, None if parent is None else parent["name"]))
    return out


def _predict_ids(tmp_path):
    cfg = load_config(overrides=OVER)
    model = init_params(build_model(cfg), torch.Generator().manual_seed(1))
    save_artifact(tmp_path / "dual.zip", cfg, model)
    pred = ScenePredictor(load_artifact(tmp_path / "dual.zip", "cpu"),
                          synthetic_scene(cfg, device="cpu"), bucket=64)
    ids = np.arange(50, dtype=np.int32)
    return lambda: pred.predict_ids(ids)


def _class_map(tmp_path):
    cfg = load_config(overrides={**OVER, "model_name": "dense_fusion"})
    model = init_params(build_model(cfg), torch.Generator().manual_seed(2))
    save_artifact(tmp_path / "dense.zip", cfg, model)
    clf = load_artifact(tmp_path / "dense.zip", "cpu")
    scene = synthetic_scene(cfg, device="cpu")
    return lambda: clf.class_map(scene.ms, scene.pan)


def _batches(scene, steps, batch):
    flat = scene.label.reshape(-1)
    ids = np.flatnonzero(flat)[:steps * batch].astype(np.int32)
    return (torch.from_numpy(ids.reshape(steps, batch)),
            torch.from_numpy(flat[ids].astype(np.int64).reshape(steps, batch)),
            torch.ones((steps, batch)))


def _train(tmp_path, model_name):
    cfg = load_config(overrides={**OVER, "model_name": model_name})
    model = init_params(build_model(cfg), torch.Generator().manual_seed(3))
    opt = make_optimizer(cfg, model.parameters(), 2)
    scene = synthetic_scene(cfg, device="cpu")
    if model_name == "dense_fusion":
        prog = DensePrograms(model, 8, optimizer=opt, cfg=cfg)
    else:
        prog = DualPrograms(model, opt, cfg, scene.width, 8)
    batches = _batches(scene, 2, 16)
    return lambda: prog.train_epoch((scene.ms, scene.pan), *batches)


#: Each path: its call, and every span it holds with the parent of each.
PATHS = {
    "predict_ids": (_predict_ids, {
        "predict_ids": [None],
        "predict_ids.ids_to_card": ["predict_ids"],
        "predict_ids.gather": ["predict_ids"],
        "model.forward": ["predict_ids"],
        "predict_ids.labels_to_host": ["predict_ids"]}),
    "class_map": (_class_map, {
        "class_map": [None],
        "model.forward": ["class_map"],
        "model.features": ["model.forward"],
        "model.head": ["model.forward"]}),
    # ``train.dense_remat`` is on: the backward recomputes the features.
    "dense_train_epoch": (lambda p: _train(p, "dense_fusion"), {
        "train.step": [None] * 2,
        "train.forward": ["train.step"] * 2,
        "model.features": ["train.backward"] * 2 + ["train.forward"] * 2,
        "model.head": ["train.forward"] * 2,
        "train.backward": ["train.step"] * 2}),
    "dual_train_epoch": (lambda p: _train(p, "gmfnet"), {
        "train.step": [None] * 2,
        "train.forward": ["train.step"] * 2,
        "train.backward": ["train.step"] * 2}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_profiled_path_holds_its_spans(tmp_path, path):
    make, want = PATHS[path]
    call = make(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    got = _spans(tmp_path / "trace.json")
    for name, parents in want.items():
        assert sorted((p for _, _, p in got.get(name, [])), key=str) == (
            sorted(parents, key=str)), (name, got.get(name))
    # Torch's own annotation of Adam's step stays beside the program's.
    if "train.step" in want:
        assert [p for _, _, p in got["Optimizer.step#Adam.step"]] == [
            "train.step"] * 2
    # No span beyond the table.
    program = {n for n in got if not n.startswith("Optimizer.")}
    assert program == set(want)


def test_solver_profile_exports_the_spans(tmp_path):
    from dmfusion_torch.solvers import build_solver

    solver = build_solver(load_config(overrides={
        **OVER, "expo_result": f"{tmp_path}/", "batchsize": 32, "epoch": 1,
        "time": 1, "train_rate": 0.05, "verify_rate": 0.05, "nohup": 1,
        "profile": {"enabled": 1, "dir": str(tmp_path / "profile")}},
        prepare=True))
    solver.dataloader()
    solver.train()
    found = list((tmp_path / "profile").glob("train_*/trace.json"))
    assert len(found) == 1
    spans = _spans(found[0])
    steps = -(-len(solver.split.train) // 32)
    assert len(spans["train.step"]) == steps
    assert len(spans["train.backward"]) == steps
