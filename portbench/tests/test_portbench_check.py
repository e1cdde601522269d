"""The check that decides ``correct`` passes the program and fails what it
must fail: the control (the reference computed with float8 operands in
the program's place) and every fault the cell can have, planted in the
program underneath a whole run.  On the CPU at small sizes; the ``gpu``
cases run the control at the cells' own sizes on the card.  The cells
that ``BENCHMARK.json`` does not hold yet (``conftest.PENDING``) are held
to the same, in a copy of the benchmark that adds them."""

import pytest
import torch

from portbench import calibrate, faults, harness

CPU = torch.device("cpu")
ENTRY = {"gmfnet.serve-b4096": "predict_ids",
         "dense_fusion.map-image6": "class_map",
         "dense_fusion.train-b256": "train_epoch",
         "gmfnet.train-b256": "train_epoch"}
CELLS = tuple(ENTRY)


@pytest.fixture
def over(small_over, pending):
    return dict(small_over, **{c: p["over"] for c, p in pending.items()})


def _run(bench, cell, seed, over, device=CPU, fault=None):
    # Training's numbers come from set-up: it needs no window.
    window = ENTRY[cell] != "train_epoch"
    if fault is None:
        return harness.run_cell(bench, cell, seed, 0.3, False, device, 0.0,
                                over, window)
    classes = int(bench.config(bench.workload(cell)["config"])["classes"])
    if over:
        classes = over["config"]["classes"]
    with faults.plant(fault, classes):
        return harness.run_cell(bench, cell, seed, 0.3, False, device, 0.0,
                                over, window)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [21, 22])
def test_sound_run_is_correct(pending_bench, over, cell, seed):
    run, nums = _run(pending_bench, cell, seed, over[cell])
    if ENTRY[cell] == "train_epoch":
        run.attempted = 1  # no window: the numbers come from set-up
    correct, table = harness.judge(run, nums)
    assert correct, table


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [31, 32])
def test_control_is_not_correct(pending_bench, over, cell, seed):
    run, _ = _run(pending_bench, cell, seed, over[cell])
    run.attempted = max(run.attempted, 1)
    correct, table = harness.judge(run, calibrate.control(run))
    assert not correct, table


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in faults.BY_ENTRY[ENTRY[c]]])
def test_fault_is_not_correct(pending_bench, over, cell, fault):
    run, nums = _run(pending_bench, cell, 41, over[cell], fault=fault)
    run.attempted = max(run.attempted, 1)
    correct, table = harness.judge(run, nums)
    assert not correct, (fault, table)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_cell_size_on_the_card(pending_bench, card, cell):
    for seed in (51, 52, 53):
        run, nums = _run(pending_bench, cell, seed, None, device=card)
        run.attempted = max(run.attempted, 1)
        correct, table = harness.judge(run, nums)
        assert correct, (seed, table)
        correct, table = harness.judge(run, calibrate.control(run))
        assert not correct, (seed, table)
