"""`correct`: the program against the plain reference at a small size on
the CPU, each fault a cell can have caught, and the control caught on the
card."""

import time

import pytest

from portbench import harness, readings

from conftest import small_run

TRAIN = ["sparseunet-fp32.train-b8", "pointnet-fp32.train-b8"]
MASKS = "sparseunet-fp32.masks-b1"


def drive(run, mode=""):
    undo = readings.plant(mode)
    try:
        return harness.traffic_module(run).run(run)
    finally:
        undo()


@pytest.mark.parametrize("cell", TRAIN + [MASKS])
def test_program_agrees_with_the_reference(cell):
    out = drive(small_run(cell))
    assert harness.is_correct(out.compared), out.compared
    if cell in TRAIN:
        assert out.compared["proposals"]["value"] == 0
        assert out.compared["loss"]["value"] < 1e-6


@pytest.mark.parametrize("cell, mode", [(TRAIN[0], "frozen"), (TRAIN[0], "half"),
                                        (TRAIN[0], "stuck"), (TRAIN[1], "frozen"),
                                        (TRAIN[1], "half"), (TRAIN[1], "stuck"),
                                        (MASKS, "altered")])
def test_a_broken_timed_path_is_not_correct(cell, mode):
    out = drive(small_run(cell), mode)
    assert not harness.is_correct(out.compared), out.compared


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483990, 2147483991, 2147483992])
@pytest.mark.parametrize("cell", TRAIN + [MASKS])
def test_control_is_not_correct(card, cell, seed):
    """The plain reference in TF32 in the program's place, at the cell's
    own size (a one-second window for requests)."""
    run = harness.make_run(harness.benchmark(), cell, seed, 1.0, False, time.perf_counter())
    run.control = "tf32"
    assert not harness.is_correct(drive(run).compared)
