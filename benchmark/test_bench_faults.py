"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(``run.run_cell``: inputs, warm-up, the closed loop, the judge) on the CPU,
where the program's kernel wrappers run their plain versions, at a size a
test run holds, with the cell's own limits. Once sound, then once for each
fault the cell can have (``faults``): a sweep that returns its state
unchanged; half of the positions' counts left out of the tau and swap
updates; an answer altered where it is produced (for a bin also its
selected positions, its G and its gene calls, each alone).
"""
import json

import pytest

from benchmark import run
from benchmark.faults import FAULTS, reaches

# cell -> (generator sizes, workload sizes): every cell's layers at a size
# the CPU runs in seconds
SMALL = {
    "ecoli_mock.chain": ({"V": 1500, "S": 16}, {}),
    "synth_1e5.chain": ({"V": 1500, "S": 16, "G": 4}, {"G": 4}),
    "synth_1e5.resident": ({"V": 1500, "S": 16, "G": 4}, {"G": 4}),
    "ecoli_mock.bin": ({"V": 1000, "S": 16, "n_genes": 100},
                       {"grid": {"g_min": 1, "g_max": 5, "seeds": [0, 1],
                                 "iterations": 250, "kernel": "cuda", "fix_eta": True},
                        "bins_written": 1}),
}
CELLS = sorted(SMALL)


def small(name):
    _, _, wl, config = run.load(name)
    gen_sizes, wl_sizes = SMALL[name]
    config["generator"].update(gen_sizes)
    wl.update(wl_sizes)
    return wl, config


def run_small(name, seed=2**31 + 7):
    wl, config = small(name)
    lines = []
    result = run.run_cell(name, seed, 0.5, False, device="cpu", wl=wl, config=config,
                          log=lines.append)
    json.dumps(result)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_small(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


# each cell with each fault its entry can have
PAIRS = [(name, fault) for name in CELLS for fault in sorted(FAULTS)
         if reaches(fault, run.load(name)[2]["entry"])]


@pytest.mark.parametrize("name,fault", PAIRS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_small(name)
    assert not result["correct"], result["checks"]
