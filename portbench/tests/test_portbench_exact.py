"""`correct` in the exact-grouping cell: the program against the plain
reference (portbench/reference/exact.py) at a small size on the CPU, and
planted faults in the program's grouping that the cell catches.

On the asset no point has more than 33 same-label neighbours within r on
xyz, and on xyz + offsets the points of an instance collapse onto its
centre, where any K >= 1 links every point to the instance's least index.
So a K one short (49 and 299) and the last K of a row's hits in place of
the first leave every proposal as it was: only `grouping`, what the ball
queries list, shows them (the shifted set's rows reach K = 300).  The first
query's K cut to 1 splits components (`proposals`); an iteration cap of 1
stops the CCL before its fixpoint (`counters`)."""

import pytest
import torch

from portbench import harness

from conftest import small_run

CELL = "sparseunet-exact-fp32.train-b8"
POINTS = 6000


def exact_run(seed: int = 7):
    """The cell's small run: conftest's sizes but 6000 points a cloud (at
    2000 and 4000 no row of the shifted set reaches K = 300; at 6000, 771
    of a cloud's 798 do), two clouds a batch."""
    run = small_run(CELL, seed)
    for key in ("pool", "compared"):
        run.traffic.pop(key, None)
    run.traffic.update(batch=2, num_points=POINTS)
    run.config["model"]["max_points"] = POINTS
    return run


def last_k(query):
    """The ball query with the last K of each row's hits: the first K of the
    cloud in reverse order, mapped back."""
    def reversed_query(xyz, labels, valid, radius, k):
        n = xyz.shape[0]
        nbr, counts = query(xyz.flip(0), labels.flip(0), valid.flip(0), radius, k)
        nbr = torch.where(nbr >= 0, n - 1 - nbr, nbr).flip(0)
        return nbr, counts.flip(0)
    return reversed_query


def plant(monkeypatch, fault: str):
    from gapartnet_tpu_torch.models import grouping

    query = grouping.ball_query_single
    if fault == "k1":
        monkeypatch.setattr(grouping, "ball_query_single",
                            lambda xyz, labels, valid, radius, k:
                            query(xyz, labels, valid, radius, 1 if k == 50 else k))
    elif fault == "k_one_short":
        monkeypatch.setattr(grouping, "ball_query_single",
                            lambda xyz, labels, valid, radius, k:
                            query(xyz, labels, valid, radius, k - 1))
    elif fault == "last_k":
        monkeypatch.setattr(grouping, "ball_query_single", last_k(query))
    elif fault == "one_iteration":
        ccl = grouping.connected_components_single
        monkeypatch.setattr(grouping, "connected_components_single",
                            lambda nbr, valid: ccl(nbr, valid, max_iters=1))


def test_program_agrees_with_the_reference():
    run = exact_run()
    out = harness.traffic_module(run).run(run)
    assert harness.is_correct(out.compared), out.compared
    for name in ("proposals", "counters", "grouping"):
        assert out.compared[name]["value"] == 0
    assert min(min(n) for n in out.notes["reference_proposals"]) > 1
    listed = out.notes["listed"]
    assert listed == out.notes["reference_listed"] and listed["ball_query_full_rows"] > 0


@pytest.mark.parametrize("fault, caught_by", [("k1", "proposals"),
                                              ("k_one_short", "grouping"),
                                              ("last_k", "grouping"),
                                              ("one_iteration", "counters")])
def test_a_broken_grouping_is_not_correct(monkeypatch, fault, caught_by):
    plant(monkeypatch, fault)
    run = exact_run()
    out = harness.traffic_module(run).run(run)
    assert not harness.is_correct(out.compared), out.compared
    assert out.compared[caught_by]["value"] > out.compared[caught_by]["limit"]
    if fault in ("k_one_short", "last_k"):
        assert out.compared["proposals"]["value"] == 0
