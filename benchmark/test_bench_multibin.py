"""The cell ``ecoli_mock.multibin12`` run small on the CPU through
``run.run_cell`` (the look for a card skipped; the program's kernel
wrappers run their plain versions): three bins of V 300, 650 and 1000
over S=16, padded to 1000, with the cell's own limits. A sound run is
correct; a sweep that returns its state unchanged, the tau and swap updates
reading half of the padded positions' counts, and padded rows of ones in
the counts the chains run on are not; neither is the control (the
reference sampler in TF32 in the program's place). The entry's least time
is the bins' own; a traced run reports the span metrics."""
import json

import numpy as np
import pytest
import torch

from benchmark import control, gen, peaks, run
from benchmark.faults import FAULTS

CELL = "ecoli_mock.multibin12"
V_SMALL = [300, 650, 1000]


def small():
    _, _, wl, config = run.load(CELL)
    config["generator"].update({"V": V_SMALL, "S": 16})
    return wl, config


def run_small(trace=False, seed=2**31 + 7):
    wl, config = small()
    result = run.run_cell(CELL, seed, 0.5, trace, device="cpu", wl=wl, config=config,
                          log=lambda s: None)
    json.dumps(result)
    return result


def padded_ones(mp) -> None:
    """The padded rows of the [B, V_max, S, 4] counts are ones, not zeros,
    when the chains start: a padding that leaks into the likelihood."""
    from desman_tpu_torch import multibin

    run_chains = multibin.run_chains

    def chains(n, *args, **kw):
        n = n.clone()
        for b, v in enumerate(V_SMALL):
            n[b, v:] = 1.0
        return run_chains(n, *args, **kw)

    mp.setattr(multibin, "run_chains", chains)


def test_sound_run_is_correct():
    result = run_small()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"]["rows_gap"]["value"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "padded_ones"])
def test_fault_is_not_correct(fault, monkeypatch):
    (padded_ones if fault == "padded_ones" else FAULTS[fault])(monkeypatch)
    result = run_small()
    assert not result["correct"], result["checks"]


def test_control_is_not_correct():
    wl, config = small()
    (row,) = control.readings(CELL, [2**31 + 3], 0.5, device="cpu", wl=wl,
                              config=config, log=lambda s: None, control_items=1)
    assert row["precision"] == "tf32"
    assert row["program_correct"], row["program"]
    assert row["control_correct"] is False, row["control"]
    assert row["control"]["rows_gap"] == 0


def test_least_time_is_the_bins_own():
    """The entry's shape and observed counts give the least time of the
    bins' own rows: the sum of each bin's, padded rows counting nothing."""
    from benchmark.entries.run_bins import Entry

    wl, config = small()
    entry = Entry(wl, config, 2**31 + 11, torch.device("cpu"))
    try:
        truths, _ = gen.draw(config, 2**31 + 11)
        assert [t.counts.shape[0] for t in truths] == V_SMALL
        bins = sum(peaks.sweep_least_s(*t.counts.shape[:2], wl["G"],
                                       int((t.counts > 0).sum())) for t in truths)
        assert entry.shape == (sum(V_SMALL), 16, wl["G"])
        assert peaks.sweep_least_s(*entry.shape, entry.observed) == pytest.approx(
            bins, rel=1e-3)
    finally:
        entry.close()


def test_the_full_configuration_pads_to_1_818():
    _, _, _, config = run.load(CELL)
    V = config["generator"]["V"]
    assert V == np.linspace(1000, 10000, 12).round().astype(int).tolist()
    assert len(V) * max(V) / sum(V) == pytest.approx(1.818, abs=1e-3)


def test_a_traced_run_reports_the_span_metrics():
    """On the CPU the device metrics read nothing (no CUDA event); the wall
    and the span metrics read the traced runs."""
    from desman_tpu_torch import profiling

    profiling.take_spans()
    metrics = run_small(trace=True)["metrics"]
    assert metrics["pad_share.multibin"]["value"] == pytest.approx(
        3 * max(V_SMALL) / sum(V_SMALL))
    for name in ("multibin_wall_s", "read_s.multibin", "nmf_s.multibin",
                 "write_s.multibin"):
        assert metrics[name]["value"] > 0, name
    assert metrics["multibin_wall_s"]["value"] > metrics["write_s.multibin"]["value"]
    assert profiling.take_spans() == []
