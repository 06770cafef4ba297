"""``correct`` comes out false for the control (the reference with fp8
operands in the program's place) and for each fault that a cell can have
(``perfbench/faults.py``), planted under the timed path of a whole run at a
small size on the CPU: a sampler step, or a train step, that leaves its
state unchanged; half of the batch left out, the mean taken over the rest;
an answer altered where it is produced; and, for training, every step of
the right size taken uphill."""

import pytest
import torch

from perfbench import faults
from perfbench.harness import checks
from perfbench.tests.tiny import tiny_run, tiny_system


@pytest.mark.parametrize("seed", [11, 12])
def test_a512_control_is_not_correct(seed):
    system, traffic, spec = tiny_system("a512.request")
    ref = system.reference(system.draw(seed))
    control = system.reference(system.draw(seed), numerics="fp8")
    req = system.make_request(traffic, seed, 0)
    with torch.no_grad():
        nums = system.check(ref, req, control.run(req, system.device), spec["check"])
    ok, table = checks.judge(nums, spec["limits"])
    assert not ok, table


@pytest.mark.parametrize("cell, kind, fault", [
    (cell, kind, fault) for cell, kind, names in (
        ("a512.request", "a512", faults.REQUEST_FAULTS),
        ("svd.request", "svd", faults.REQUEST_FAULTS),
        ("a512.train_b4", "train", faults.TRAIN_FAULTS)) for fault in names])
def test_faults_are_not_correct(cell, kind, fault):
    undo = []

    def patch(program):
        undo.append(faults.plant(kind, fault, program))
        return program

    try:
        result = tiny_run(cell, seed=21, patch=patch)
    finally:
        for u in undo:
            u()
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("seed", [13])
def test_svd_control_is_not_correct(seed):
    system, traffic, spec = tiny_system("svd.request")
    ref = system.reference(system.draw(seed))
    control = system.reference(system.draw(seed), numerics="fp8")
    req = system.make_request(traffic, seed, 0)
    with torch.no_grad():
        nums = system.check(ref, req, control.run(req, system.device), spec["check"])
    ok, table = checks.judge(nums, spec["limits"])
    assert not ok, table



def test_train_control_is_not_correct():
    """The reference's step with fp8 operands in the program's place."""
    from perfbench.loops.train import change_norms, changes, cosines, leaf_norms

    system, traffic, spec = tiny_system("a512.train_b4")
    seed = 14
    ref = system.train_reference(system.draw(seed))
    control = system.train_reference(system.draw(seed), numerics="fp8")
    readings = []
    for side in (ref, control):
        start = {k: v.detach().clone() for k, v in side.params.items()}
        gen = torch.Generator().manual_seed(seed)
        losses, first = [], None
        for i in range(spec["check"]["steps"]):
            loss, grads = side.step(system.make_batch(traffic, seed, i), gen)
            losses.append(loss)
            first = leaf_norms(grads) if first is None else first
        readings.append((losses, first, change_norms(side.params, start),
                         changes(side.params, start) if side is control else start))
    (rl, rg, rc, start), (cl, cg, cc, deltas) = readings
    cos = cosines(ref.params, start, deltas)
    share = spec["check"]["min_leaf_share"]
    nums = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(cl, rl)),
            "grad_leaf_gap": checks.leaf_gap(cg, rg, rg, share),
            "update_leaf_gap": checks.leaf_gap(cc, rc, rg, share),
            "update_leaf_cos": checks.leaf_worst({k: (1 - c) * rc[k] for k, c in cos.items()},
                                                 rc, rg, share)}
    ok, table = checks.judge(nums, spec["limits"])
    assert not ok, table


def test_reversed_update_fails_its_direction():
    """Every step of the right size taken uphill: the norms of the change
    agree with the reference's, its direction does not."""
    undo = []

    def patch(trainer):
        undo.append(faults.plant("train", "reversed_update", trainer))
        return trainer

    try:
        result = tiny_run("a512.train_b4", seed=23, patch=patch)
    finally:
        for u in undo:
            u()
    row = result["checks"]["update_leaf_cos"]
    assert row["value"] > 1.5 and row["value"] > row["limit"], result["checks"]
