"""The control of each one-card cell, on the card: the plain reference
computed one precision step below the configuration's float32 (TF32), put
in the program's place, at the cell's own size, on three seeds.  Some
number of the cell has to exceed its limit on every seed, so that a run of
such a program would be refused.  Skips without a card.

    python3 -m pytest benchmark/tests/test_bench_control.py -m card
"""

import json
import os

import pytest
import torch

import harness

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["n512_spectrum"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_a_limit(card, workload, seed):
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        cell = harness.Cell(workload, json.load(fh))
    limits = cell.workload["limits"]
    model, batches = harness.make_inputs(cell, seed, card)
    ctx = harness.Context(cell, card, 0, 1, model, batches)
    over = []
    for q in cell.checked(seed):
        ref = cell.entry.reference(ctx, q)
        readings = cell.entry.compare(ctx, q, cell.entry.reference(ctx, q, control=True), ref)
        over += [(name, value) for name, value in readings.items()
                 if name in limits and not value <= limits[name]]
    torch.cuda.empty_cache()
    assert over, f"the control passed every limit on seed {seed}"
