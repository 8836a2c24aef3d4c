"""A run with the timed path broken underneath comes out not correct, and
so does the control (the reference in TF32 in the program's place, TF32
emulated on the CPU), for each fault a cell can have. The harness's look
for a card is skipped: the runs are on the CPU at a small size, held to the
cells' own limits (``limits/<cell>.json``)."""

import pytest

from conftest import small_run

import faults

CASES = [
    ("stream-b8", "answer_altered", 2),
    ("eval-s-b32", "answer_altered", 2),
    ("train-b8", "state_unchanged", 4),
    ("train-b8", "half_batch", 4),
    ("train-b8", "statistics_frozen", 4),
    ("train-b8", "loss_nonfinite_late", 4),
]


@pytest.mark.parametrize("cell, fault, batch", CASES)
def test_fault_is_not_correct(cell, fault, batch):
    undo = faults.FAULTS[fault]()
    try:
        res = small_run(cell, batch=batch)
    finally:
        undo()
    assert res["checks"] and not res["correct"], res["checks"]


@pytest.mark.parametrize("cell, batch", [("stream-b8", 2), ("eval-s-b32", 2), ("train-b8", 4)])
def test_control_is_not_correct(cell, batch):
    res = small_run(cell, batch=batch, control=True)
    assert res["checks"] and not res["correct"], res["checks"]
