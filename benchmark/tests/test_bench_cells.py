"""Every cell driven on the CPU at a small size through the harness (the
look for a card skipped): a sound run comes out correct, and each fault the
cell can have, planted under the timed path, comes out not correct."""

import json

import pytest

from benchmark import control
from benchmark.harness import benchmark_spec, load_json, run_cell
from benchmark.tests.tiny import SECONDS, TINY

CELLS = sorted(TINY)
FAULT_CASES = [(cell, fault) for cell in CELLS
               for fault in control.FAULTS[load_json("workloads", cell)["driver"]]]


def _run(cell, seed, trace=False):
    return run_cell(cell, seed, SECONDS, trace, "cpu", overrides=TINY[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = _run(cell, 2**31 + 5)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    json.dumps(result)


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_fault_is_not_correct(cell, fault):
    result = control.reading(cell, 11, SECONDS, "fault:" + fault, "cpu", TINY[cell])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell,arm", [(c, a) for c in CELLS for a in control.arms(c)
                                      if a.startswith("control:")])
def test_control_reads_worse_than_the_program(cell, arm):
    """Each control at a small size, in the program's place through the
    harness, reads above the program's own run on the same seed on at
    least one number (its limits are set on the card, at the cell's size:
    test_bench_card.py)."""
    program = control.reading(cell, 13, SECONDS, "program", "cpu", TINY[cell])["checks"]
    low = control.reading(cell, 13, SECONDS, arm, "cpu", TINY[cell])["checks"]
    assert any(low[k]["value"] > program[k]["value"] for k in program), (program, low)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_counter_metrics(cell):
    """A --trace 1 run on the CPU has no device trace: the per-layer
    metrics read from counters are there, the trace's are left out."""
    result = _run(cell, 17, trace=True)
    from_counters = [m["name"] for m in benchmark_spec()["per_layer"] if cell in m["workloads"]
                     and m["source"] != "device_trace"]
    assert set(from_counters) <= set(result["metrics"])
    assert all(m["unit"] for m in result["metrics"].values())
