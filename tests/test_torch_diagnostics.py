"""Reports and diagnostics of the port against dmfusion's and sklearn's,
on the CPU: ``report/collect.py``, the t-SNE of ``report/tsne.py``, the
scatter of ``report/viz.py::embedding_scatter`` and both solvers'
``visualize`` (synth64, patch 8, width 8, float32).

Tolerances:
  * ``collect``: the summary cells equal dmfusion's, exactly;
  * the t-SNE in float64 against sklearn 1.9's own functions on the same
    inputs: the joint probabilities rtol 1e-5 (sklearn rounds the
    distances to float32 and so does the port: readings about 1e-15), the
    KL divergence and its gradient rtol 1e-6, ten descent steps rtol 1e-5;
  * a whole run's final KL within 5 % of sklearn's exact method's from
    the same PCA start (sklearn keeps the embedding in float32, the port
    in float64: 0.7 % apart on 200 points), and its trustworthiness (10
    neighbours) within 0.02 of dmfusion's own Barnes-Hut call's;
  * ``visualize``: the scatter's logits atol 1e-5, its labels (or stream
    ids), file name and seed equal to dmfusion's, from the same
    converted weights.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image
from scipy.spatial.distance import squareform
from sklearn.manifold import TSNE, trustworthiness
from sklearn.manifold import _t_sne as sk_tsne

import dmfusion.report.viz as jax_viz
from dmfusion.config import load_config as jax_load_config
from dmfusion.report.collect import collect_results as jax_collect_results
from dmfusion.report.excel import expo_result as jax_expo_result
from dmfusion.solvers import build_solver as jax_build_solver
from dmfusion_torch import cli
from dmfusion_torch.config import load_config
from dmfusion_torch.models.convert import load_flax_params
from dmfusion_torch.report import collect, tsne
from dmfusion_torch.report import viz
from dmfusion_torch.report.excel import Workbook, expo_result
from dmfusion_torch.solvers import build_solver
from dmfusion_torch.solvers import main as port_main
from dmfusion_torch.train.checkpoint import snapshot

OVER = {"data_city": "synth64", "patch_size": 8, "model_width": 8,
        "batchsize": 32, "test_batchsize": 32, "color_batchsize": 32,
        "epoch": 1, "time": 1, "train_rate": 0.05, "verify_rate": 0.05,
        "seed": 0, "nohup": 1, "mesh": {"data": 1},
        "precision": {"compute_dtype": "float32", "param_dtype": "float32"}}
TWOSTAGE = {"solver": "twostage", "model_name": "dqtl", "train_rate": 0.1,
            "dqtl": {"pre_trained": 1}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone, and
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n, seed=0, dims=12, centres=6):
    """``n`` float64 rows around ``centres`` seeded centres: logits-like
    clusters."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, dims)) * 4
    return c[rng.integers(0, centres, n)] + rng.normal(size=(n, dims))


# -- collect ----------------------------------------------------------------

def _write_run(root, name, expo, repeats):
    run_dir = os.path.join(root, name)
    os.makedirs(run_dir, exist_ok=True)
    cfg = {"RESULT_excel": os.path.join(run_dir, "gmfnet__0_result.xlsx"),
           "model_name": "gmfnet"}
    for rep, (aa, oa, k) in enumerate(repeats):
        expo([aa, oa, k, [(10, 9, 0.9), (5, 4, 0.8)]], cfg, [1.5, 0.5], rep)


def test_collect_equals_dmfusion(tmp_path, capsys):
    """One tree of workbooks, two written by dmfusion's ``expo_result`` and
    two by the port's: both collectors give the same summary cells; the
    port's CLI prints its output path."""
    root = str(tmp_path / "tree")
    _write_run(root, "city1_tr0.02", jax_expo_result, [(0.8, 0.9, 0.85)])
    _write_run(root, "city2_tr0.02", expo_result,
               [(0.7, 0.75, 0.7), (0.72, 0.77, 0.72)])
    _write_run(root, "city3_tr0.1", jax_expo_result,
               [(0.6, 0.65, 0.6), (0.61, 0.66, 0.62), (0.5, 0.55, 0.52)])
    _write_run(root, "city4_tr0.1", expo_result, [(0.9, 0.95, 0.93)])
    want = Workbook.load(jax_collect_results(root, str(tmp_path / "j.xlsx")))
    collect.main([root, "-o", str(tmp_path / "t.xlsx")])
    assert capsys.readouterr().out.strip() == str(tmp_path / "t.xlsx")
    got = Workbook.load(str(tmp_path / "t.xlsx"))
    ws, gs = want["summary"], got["summary"]
    rows = 1 + (1 + 1) + (2 + 1) + (3 + 1) + (1 + 1) + 3  # blanks between
    cells = [(r, c) for r in range(1, rows + 1) for c in range(1, 8)]
    assert [gs.cell(r, c) for r, c in cells] == [ws.cell(r, c)
                                                 for r, c in cells]
    assert gs.cell(2, 1) == "city1_tr0.02/gmfnet__0" and gs.cell(3, 2) == \
        "mean"
    assert [m["oa"] for m in collect.read_run_metrics(os.path.join(
        root, "city3_tr0.1", "gmfnet__0_result.xlsx"))] == [0.65, 0.66, 0.55]


# -- t-SNE against sklearn's functions ----------------------------------------

@pytest.fixture(scope="module")
def joint():
    x = _blobs(300)
    from sklearn.metrics import pairwise_distances
    d = pairwise_distances(x, squared=True)
    return x, d, sk_tsne._joint_probabilities(d, 30.0, 0), \
        tsne.joint_probabilities(torch.from_numpy(d))


def test_joint_probabilities_equal_sklearn(joint):
    _, d, want, got = joint
    assert got.dtype == torch.float64 and got.shape == (300, 300)
    assert torch.equal(got, got.T) and not got.diagonal().any()
    np.testing.assert_allclose(squareform(got.numpy(), checks=False), want,
                               rtol=1e-5, atol=0)
    # The distances as the port forms them give the same P.
    mine = tsne.joint_probabilities(tsne.squared_distances(
        torch.from_numpy(joint[0])))
    np.testing.assert_allclose(mine.numpy(), got.numpy(), rtol=1e-5)


def test_kl_and_gradient_equal_sklearn(joint):
    _, _, p, pt = joint
    y = np.random.default_rng(1).normal(size=(300, 2)) * 1e-2
    for scale in (1.0, 12.0):  # plain and exaggerated
        kl, grad = sk_tsne._kl_divergence(y.ravel().copy(), p * scale, 1,
                                          300, 2)
        klt, gradt = tsne.kl_divergence(torch.from_numpy(y), pt * scale)
        np.testing.assert_allclose(float(klt), kl, rtol=1e-6)
        np.testing.assert_allclose(gradt.numpy().ravel(), grad, rtol=1e-6,
                                   atol=1e-6 * np.abs(grad).max())
    assert tsne.kl_divergence(torch.from_numpy(y), pt, False)[0] is None


def test_ten_descent_steps_equal_sklearn(joint):
    """Ten steps of sklearn's ``_gradient_descent`` (momentum, gains, the
    exaggerated P), the KL checked every 5."""
    _, _, p, pt = joint
    y0 = np.random.default_rng(2).normal(size=(300, 2)) * 1e-4
    lr = max(300 / 12 / 4, 50)
    want, err, it = sk_tsne._gradient_descent(
        sk_tsne._kl_divergence, y0.ravel().copy(), 0, 10, n_iter_check=5,
        momentum=0.5, learning_rate=lr, args=[p * 12.0, 1, 300, 2],
        kwargs={})
    got, gerr, git = tsne.gradient_descent(
        torch.from_numpy(y0), pt * 12.0, 0, 10, momentum=0.5,
        learning_rate=lr, n_iter_without_progress=250, n_iter_check=5)
    assert git == it == 9
    np.testing.assert_allclose(gerr, err, rtol=1e-5)
    np.testing.assert_allclose(got.numpy().ravel(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def runs():
    """200 points through the port, sklearn's exact method and dmfusion's
    own call (Barnes-Hut, float32 input)."""
    x = _blobs(200, seed=3)
    port = tsne.tsne(torch.from_numpy(x))
    exact = TSNE(n_components=2, random_state=0, init="pca", method="exact")
    exact.fit(x)
    bh = TSNE(n_components=2, random_state=0, init="pca")
    xy_bh = bh.fit_transform(x.astype(np.float32))
    return x, port, exact, xy_bh


def test_full_run_kl_near_sklearn_exact(runs):
    _, port, exact, _ = runs
    assert port.n_iter == exact.n_iter_ == 999
    assert abs(port.kl_divergence - exact.kl_divergence_) <= \
        0.05 * exact.kl_divergence_
    np.testing.assert_allclose(float(port.p.sum()), 1.0, rtol=1e-9)


def test_trustworthiness_near_dmfusion(runs):
    x, port, _, xy_bh = runs
    mine = trustworthiness(x, port.xy.numpy(), n_neighbors=10)
    theirs = trustworthiness(x, xy_bh, n_neighbors=10)
    assert abs(mine - theirs) <= 0.02, (mine, theirs)


def test_pca_start_is_sklearns():
    """The start: sklearn's PCA projection (its ``svd_flip`` signs),
    column 0 scaled to std 1e-4."""
    from sklearn.decomposition import PCA
    x = _blobs(150, seed=4)
    want = PCA(n_components=2, random_state=0).fit_transform(x)
    want = want / np.std(want[:, 0]) * 1e-4
    got = tsne.pca_init(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12)


def test_perplexity_above_the_points_raises():
    with pytest.raises(ValueError, match="perplexity"):
        tsne.tsne(torch.zeros(20, 3, dtype=torch.float64))


# -- the scatter ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 11, 12, 20, 25])
def test_scatter_colours_are_matplotlibs(n):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    cmap = plt.get_cmap("tab20", n)
    want = np.array([[round(v * 255) for v in cmap(i)[:3]]
                     for i in range(n)])
    assert np.array_equal(viz.scatter_colors(n), want)


def test_scatter_embeds_dmfusions_rows(tmp_path, monkeypatch):
    """Above ``max_points`` both packages embed the same subsampled rows
    (with their labels); the port's PNG holds every class's colour."""
    x = _blobs(260, seed=5).astype(np.float32)
    labels = np.random.default_rng(6).integers(1, 4, 260)
    seen = {}

    def fake_fit(self, emb):
        seen["jax"] = np.array(emb)
        return np.zeros((len(emb), 2))

    monkeypatch.setattr(TSNE, "fit_transform", fake_fit)
    jax_viz.embedding_scatter(x, labels, str(tmp_path / "j.png"),
                              max_points=200, seed=7)
    real = viz.tsne

    def spy(emb):
        seen["port"] = emb.numpy()
        return real(emb)

    monkeypatch.setattr(viz, "tsne", spy)
    path = tmp_path / "t.png"
    run = viz.embedding_scatter(torch.from_numpy(x), labels, path,
                                max_points=200, seed=7)
    assert np.array_equal(seen["port"], seen["jax"])
    assert run.xy.shape == (200, 2) and np.isfinite(run.kl_divergence)
    img = np.asarray(Image.open(path).convert("RGB"))
    assert img.shape == (*viz.SCATTER_HW, 3)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    for c in viz.scatter_colors(3):
        assert tuple(c) in colours


# -- visualize, both solvers ---------------------------------------------------

def _tree(x):
    return jax.tree.map(np.asarray, serialization.to_state_dict(x))


def _write_gan(expo):
    """Seeded stand-ins of stage 1's scenes under ``expo``'s weights dir."""
    d = os.path.join(expo, "dqtl_weights")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(1)
    for name in ("msgan.npy", "pangan.npy"):
        np.save(os.path.join(d, name),
                rng.random((64, 72, 4)).astype(np.float32))


def _scatter_args(monkeypatch, tmp, over):
    """Each package's ``visualize`` on one split from the same weights
    (dmfusion's seeded initial ones, converted): the arguments each hands
    its ``embedding_scatter``."""
    seen = {}

    def grab(key):
        def scatter(emb, labels, path, max_points=2000, seed=0, names=None):
            emb = emb.cpu().numpy() if isinstance(emb, torch.Tensor) \
                else np.asarray(emb)
            seen[key] = (emb, np.asarray(labels), os.path.basename(path),
                         seed, names)
        return scatter

    monkeypatch.setattr(jax_viz, "embedding_scatter", grab("jax"))
    monkeypatch.setattr(port_main, "embedding_scatter", grab("port"))
    for side in ("j", "t"):
        if over.get("solver") == "twostage":
            _write_gan(f"{tmp}/{side}")
    jsolver = jax_build_solver(jax_load_config(
        overrides={**OVER, **over, "expo_result": f"{tmp}/j/"}, prepare=True))
    jsolver.dataloader()
    jsolver.init_model()
    jsolver.best_params = jsolver.params
    jsolver.visualize()
    solver = build_solver(load_config(
        overrides={**OVER, **over, "expo_result": f"{tmp}/t/",
                   "device": "cpu"}, prepare=True))
    solver.dataloader()
    solver.init_model()
    load_flax_params(solver.model, _tree(jsolver.params))
    solver.best_params = snapshot(solver.model.state_dict())
    solver.visualize()
    return seen


@pytest.mark.parametrize("over", [
    {}, {"model_name": "dense_fusion", "train": {"dense_remat": "off"}},
    TWOSTAGE], ids=["gmfnet", "dense_fusion", "twostage"])
def test_visualize_feeds_dmfusions_scatter(tmp_path, monkeypatch, over):
    seen = _scatter_args(monkeypatch, tmp_path, over)
    (jemb, jlab, jname, jseed, jnames) = seen["jax"]
    (emb, lab, name, seed, names) = seen["port"]
    n = 2000 if not over.get("solver") else len(jlab) // 4
    assert len(jlab) == (n if not over.get("solver") else 4 * n)
    assert emb.dtype == np.float32 and emb.shape == jemb.shape
    np.testing.assert_allclose(emb, jemb, rtol=0, atol=1e-5)
    assert np.array_equal(lab, jlab) and (name, seed) == (jname, jseed)
    # The port's legend has no text: stream ids 0-3 stand for dmfusion's
    # names, in their order.
    assert names is None
    if over.get("solver"):
        assert name == "0_tsne_streams.png" and jnames == ["M", "PAN", "GM",
                                                           "GP"]
        assert np.array_equal(lab, np.repeat(np.arange(4), n))
    else:
        assert name == "0_tsne_test.png"


def test_trim_to_mesh_equals_dmfusion(tmp_path):
    """A diagnostic id set under a stub mesh of ``data`` 3 is trimmed to a
    multiple of 3, as dmfusion trims it."""
    jsolver = jax_build_solver(jax_load_config(
        overrides={**OVER, "expo_result": f"{tmp_path}/j/"}, prepare=True))
    solver = build_solver(load_config(
        overrides={**OVER, "expo_result": f"{tmp_path}/t/",
                   "device": "cpu"}, prepare=True))
    jsolver.programs = types.SimpleNamespace(
        mesh=types.SimpleNamespace(shape={"data": 3}))
    solver.programs = types.SimpleNamespace(
        mesh=types.SimpleNamespace(data=3))
    for n in (0, 2, 3, 10, 2000):
        ids = np.arange(n, dtype=np.int32)
        got = solver._trim_to_mesh(ids)
        assert np.array_equal(got, jsolver._trim_to_mesh(ids))
        assert len(got) == n // 3 * 3
    solver.programs = types.SimpleNamespace(mesh=None)
    assert len(solver._trim_to_mesh(np.arange(10))) == 10


@pytest.mark.parametrize("sets", [
    ["model_name=gmfnet"],
    ["model_name=dense_fusion", "train.dense_remat=off"],
    ["--solver", "twostage", "--set", "model_name=dqtl",
     "dqtl.pre_trained=1", "train_rate=0.1"]],
    ids=["gmfnet", "dense_fusion", "twostage"])
def test_cli_visualize_writes_the_scatter(tmp_path, sets):
    """``--set visualize.index=1`` through the CLI writes the scatter PNG of
    ``visualize.samples`` points (their t-SNE run kept on the solver)."""
    _write_gan(str(tmp_path))
    head, rest = (sets[:3], sets[3:]) if sets[0] == "--solver" else (
        ["--set"], sets)
    solver = cli.main([
        "--city", "synth64", *head, *rest, "device=cpu", "patch_size=8",
        "model_width=8", "batchsize=32", "test_batchsize=32",
        "color_batchsize=32", "epoch=1", "time=1", "verify_rate=0.05",
        "seed=0", "color.index=0", "test.index=0", "nohup=1",
        "visualize.index=1", "visualize.samples=200",
        f"expo_result={tmp_path}/", "precision.compute_dtype=float32"])
    tag = "streams" if sets[0] == "--solver" else "test"
    path = os.path.join(solver.cfg["RESULT_output"], f"0_tsne_{tag}.png")
    img = np.asarray(Image.open(path).convert("RGB"))
    assert img.shape == (*viz.SCATTER_HW, 3)
    n = 200 if tag == "test" else 4 * 50
    assert solver.tsne.xy.shape == (n, 2)
    assert np.isfinite(solver.tsne.kl_divergence)
