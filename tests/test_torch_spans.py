"""The program's spans (``desman_tpu_torch.profiling.span``): recorded only
under a torch profiler, on the profiler's clock (the card's trace's too: the
test marked ``cuda`` runs on a GPU with ``python -m pytest --noconftest -m
cuda tests/test_torch_spans.py``); placed in the pipeline, the grid and the
chains; exported by ``desman --profile``; read by the benchmark's span
arithmetic (``benchmark.spans``) and its span metrics. What the program
writes does not depend on them."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run as bench_run
from benchmark import spans as bspans
from benchmark import trace as btrace
from desman_tpu_torch import cli, io, profiling, synth
from desman_tpu_torch.pipeline import run_pipeline

ROOT = Path(__file__).resolve().parent.parent
G_VALUES, SEEDS = (1, 2, 3), (0, 1)
SPAN_METRICS = {"ecoli_mock.bin": ("read_s.bin", "filter_s.bin", "write_filter_s.bin",
                                   "write_outputs_s.bin", "star_ll_s.bin", "nmf_s.bin",
                                   "sweep_host_ms.bin"),
                "ecoli_mock.chain": ("nmf_s.chain", "sweep_host_ms.chain")}
# the spans of a bin: the pipeline's stages, the grid's runs, the chains
BIN_SPANS = {"pipeline.read_counts", "pipeline.filter", "pipeline.write_filter", "grid",
             "chains", "chains.init", "chains.sweeps", "chains.summaries",
             "write_outputs", "write_outputs.star_ll", "genes"}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _span(name, start, end, **attrs):
    return profiling.Span(name, start, end, attrs)


def test_no_spans_without_a_profiler():
    profiling.take_spans()
    with profiling.span("outer") as outer:
        with profiling.span("inner", k=1):
            torch.ones(4).sum()
    assert outer.seconds > 0
    assert profiling.take_spans() == []


def test_an_op_lies_inside_the_span_that_wraps_it():
    """The spans' clock is kineto's: an aten op's interval, as the
    benchmark's trace reads it (start_ns), lies inside its span."""
    profiling.take_spans()
    with _cpu_profile() as prof:
        with profiling.span("wrap"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    (wrap,) = profiling.take_spans()
    ops = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::mm"]
    assert ops
    for ev in ops:
        assert wrap.start_ns <= ev.start_ns()
        assert ev.start_ns() + ev.duration_ns() <= wrap.end_ns


def test_spans_end_in_order_with_their_attributes():
    profiling.take_spans()
    with _cpu_profile():
        with profiling.span("a") as a:
            with profiling.span("b", n=2) as b:
                b.attrs["late"] = 3
            with profiling.span("c"):
                with profiling.span("d"):
                    pass
        with pytest.raises(ValueError), profiling.span("e"):
            raise ValueError("the span still ends")
    spans = {s.name: s for s in profiling.take_spans()}
    assert list(spans) == ["b", "d", "c", "a", "e"]   # the order they ended
    assert spans["b"].attrs == {"n": 2, "late": 3} and spans["a"].attrs == {}
    assert a.seconds == bspans.seconds(spans["a"])
    assert spans["a"].start_ns <= spans["b"].start_ns <= spans["b"].end_ns \
        <= spans["c"].start_ns <= spans["d"].start_ns <= spans["d"].end_ns \
        <= spans["c"].end_ns <= spans["a"].end_ns <= spans["e"].start_ns


def test_a_span_records_under_the_profiler_it_began_in():
    """A span begun untraced stays unrecorded though a profiler starts
    inside it; one begun traced is recorded though the profiler stops."""
    profiling.take_spans()
    with profiling.span("before"):
        with _cpu_profile():
            with profiling.span("inside"):
                pass
            opened = profiling.span("across").__enter__()
    opened.__exit__(None, None, None)
    assert [s.name for s in profiling.take_spans()] == ["inside", "across"]


# ---- a tiny bin through the pipeline, traced and not ----


@pytest.fixture(scope="module")
def bin_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans_bin")
    _, data = synth.mock_community(V=120, S=8, G=2, seed=5)
    counts = str(tmp / "counts.csv")
    io.write_counts_csv(counts, data)
    rng = np.random.default_rng(3)
    x = rng.poisson(40.0, size=(20, 8)).astype(np.float64)
    gene_cov = str(tmp / "gene_cov.csv")
    io.write_gene_table(gene_cov, [f"gene{d}" for d in range(20)],
                        [f"s{i}" for i in range(8)], x, "gene")
    return tmp, counts, gene_cov


def _pipeline(tmp, counts, gene_cov):
    out = str(tmp / "out")
    return out, run_pipeline({
        "counts": counts, "output_dir": out,
        "grid": {"g_min": G_VALUES[0], "g_max": G_VALUES[-1], "seeds": list(SEEDS),
                 "iterations": 20},
        "genes": {"coverage_csv": gene_cov},
    }, device="cpu")


@pytest.fixture(scope="module")
def bin_runs(bin_inputs):
    """The same bin untraced (its directory moved aside), then under a CPU
    profiler in the same directory: (untraced dir, traced dir, summary,
    spans)."""
    tmp, counts, gene_cov = bin_inputs
    profiling.take_spans()
    plain, _ = _pipeline(tmp, counts, gene_cov)
    assert profiling.take_spans() == []
    shutil.move(plain, str(tmp / "plain"))
    with _cpu_profile():
        traced, summary = _pipeline(tmp, counts, gene_cov)
    return str(tmp / "plain"), traced, summary, profiling.take_spans()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _within(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_pipeline_spans_sit_where_the_work_is(bin_runs):
    _, _, summary, spans = bin_runs
    assert {s.name for s in spans} == BIN_SPANS
    (read,) = _named(spans, "pipeline.read_counts")
    assert read.attrs["S"] == 8 and read.attrs["V"] > 0
    for name in ("pipeline.filter", "pipeline.write_filter", "grid", "genes"):
        assert len(_named(spans, name)) == 1, name
    runs = sorted((s.attrs["G"], s.attrs["seed"]) for s in _named(spans, "write_outputs"))
    assert runs == [(g, s) for g in G_VALUES for s in SEEDS]
    assert len(_named(spans, "write_outputs.star_ll")) == len(runs)
    # the NMF starts one a chain; the rest one a G, for its chains at once
    assert len(_named(spans, "chains.init")) == len(runs)
    for name in ("chains", "chains.sweeps", "chains.summaries"):
        assert len(_named(spans, name)) == len(G_VALUES), name
    assert all(s.attrs["chains"] == len(SEEDS) for s in _named(spans, "chains"))
    assert sum(s.attrs["sweeps"] for s in _named(spans, "chains.sweeps")) == \
        summary["grid_sweeps"] // len(SEEDS)
    (grid,) = _named(spans, "grid")
    (genes,) = _named(spans, "genes")
    chains = _named(spans, "chains")
    for name in ("chains", "write_outputs", "write_outputs.star_ll"):
        assert all(_within(s, grid) for s in _named(spans, name)), name
    for name in ("chains.init", "chains.sweeps", "chains.summaries"):
        assert all(any(_within(s, c) for c in chains) for s in _named(spans, name))
    assert all(any(_within(s, w) for w in _named(spans, "write_outputs"))
               for s in _named(spans, "write_outputs.star_ll"))
    order = ["pipeline.read_counts", "pipeline.filter", "pipeline.write_filter",
             "grid", "genes"]
    stages = [_named(spans, name)[0] for name in order]
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
    # the summary's walls are the grid's and the genes' spans
    assert summary["grid_wall_s"] == bspans.seconds(grid)
    assert summary["genes_wall_s"] == bspans.seconds(genes)


def test_files_are_the_same_with_spans_recorded_or_not(bin_runs):
    plain, traced, _, _ = bin_runs
    names = sorted(os.path.relpath(os.path.join(d, f), plain)
                   for d, _, files in os.walk(plain) for f in files)
    assert len(names) > 40
    for name in names:
        if os.path.basename(name) in ("pipeline_summary.json", "metrics.json"):
            continue   # walls and elapsed times
        with open(os.path.join(plain, name), "rb") as a, \
                open(os.path.join(traced, name), "rb") as b:
            assert a.read() == b.read(), name


def test_the_summary_keeps_its_walls_untraced(bin_runs):
    plain, _, _, _ = bin_runs
    with open(os.path.join(plain, "pipeline_summary.json")) as f:
        summary = json.load(f)
    assert summary["grid_wall_s"] > 0 and summary["genes_wall_s"] > 0


def test_cli_profile_writes_the_spans_around_the_ops(tmp_path):
    counts = str(tmp_path / "counts.csv")
    io.write_counts_csv(counts, synth.generate(V=60, S=6, G=2, coverage=40.0,
                                               seed=3).data)
    trace = tmp_path / "trace"
    assert cli.main(["desman", counts, "-g", "2", "-i", "20", "--device", "cpu",
                     "-o", str(tmp_path / "o"), "--profile", str(trace)]) == 0
    with open(trace / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert {"chains", "chains.init", "chains.sweeps", "chains.summaries"} <= set(spans)
    assert spans["chains.sweeps"]["args"]["sweeps"] == 20
    chain = spans["chains"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops
    inside = [e for e in ops if chain["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= chain["ts"] + chain["dur"]]
    assert len(inside) > len(ops) // 2
    assert any(e.get("ph") == "M" and e["args"].get("name") == profiling.SPAN_TRACK
               for e in events)


# ---- the benchmark's side ----


def test_span_sums():
    ns = 1_000_000_000
    spans = [_span("pipeline.read_counts", 0, 2 * ns, V=5, S=2),
             _span("grid", 3 * ns, 9 * ns),
             _span("chains.sweeps", 3 * ns, 4 * ns, sweeps=250),
             _span("chains.sweeps", 5 * ns, 5 * ns + ns // 2, sweeps=250),
             _span("write_outputs", 6 * ns, 8 * ns)]
    assert bspans.seconds(spans[1]) == 6.0
    assert bspans.per_item_s(spans, "chains.sweeps", 1) == pytest.approx(1.5)
    assert bspans.per_item_s(spans, "write_outputs", 2) == pytest.approx(1.0)
    assert bspans.per_item_s(spans, "genes", 1) is None
    assert bspans.per_item_s(spans, "grid", 0) is None
    assert bspans.per_item_s(None, "grid", 1) is None
    assert bspans.per_unit_ms(spans, "chains.sweeps", "sweeps") == pytest.approx(3.0)
    assert bspans.per_unit_ms(spans, "grid", "sweeps") is None
    assert bspans.per_unit_ms(None, "chains.sweeps", "sweeps") is None


def test_span_arithmetic_imports_nothing_of_the_program():
    path = ROOT / "benchmark" / "spans.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"desman_tpu_torch", "desman_tpu", "jax", "torch"}
    code = ("import sys, benchmark.spans; print(sorted({m.split('.')[0] for m in "
            "sys.modules} & {'desman_tpu_torch', 'desman_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


@pytest.mark.parametrize("name", sorted(n for names in SPAN_METRICS.values()
                                         for n in names))
def test_a_span_metric_reads_nothing_without_the_programs_spans(name, monkeypatch):
    """A program without ``take_spans`` (an older checkout of the port)
    leaves the span metric out of the line; it never raises."""
    monkeypatch.delattr(profiling, "take_spans")
    w = bench_run.Window(seconds=10.0, item_s=[10.0], sweeps=250)
    assert bench_run.reader(name)(w) is None
    assert w.spans["program"] is None


def test_span_metrics_are_declared_for_their_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for cell, names in SPAN_METRICS.items():
        for name in names:
            assert declared[name]["workloads"] == [cell], name
            assert declared[name]["source"] == "program_span", name
            assert name in {m["name"] for m in bench_run.metrics_of(bench, cell, True)}


def _small_cell(name):
    _, _, wl, config = bench_run.load(name)
    if name == "ecoli_mock.bin":
        config["generator"].update({"V": 300, "S": 8, "n_genes": 30})
        wl.update({"grid": {"g_min": 1, "g_max": 2, "seeds": [0, 1], "iterations": 20,
                            "kernel": "cuda", "fix_eta": True}, "bins_written": 1})
    else:
        config["generator"].update({"V": 300, "S": 8})
        wl.update({"iterations": 20, "trace_items": 2})
    return wl, config


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_cell_reports_every_span_metric(cell):
    """``--trace 1`` on the CPU at a small size: each new metric has a
    value, read from the program's spans of the traced window alone."""
    profiling.take_spans()
    wl, config = _small_cell(cell)
    result = bench_run.run_cell(cell, 2**31 + 23, 0.5, True, device="cpu", wl=wl,
                                config=config, log=lambda s: None)
    metrics = result["metrics"]
    for name in SPAN_METRICS[cell]:
        assert metrics[name]["value"] > 0, name
    if cell == "ecoli_mock.bin":
        assert metrics["grid_s.bin"]["value"] > metrics["write_outputs_s.bin"]["value"]
        assert metrics["write_outputs_s.bin"]["value"] > metrics["star_ll_s.bin"]["value"]
        assert metrics["bin_wall_s"]["value"] > metrics["filter_s.bin"]["value"]
    assert profiling.take_spans() == []   # the metrics took them all


def test_the_window_keeps_what_the_metrics_took():
    from benchmark.entries import program_spans

    profiling.take_spans()
    with _cpu_profile():
        with profiling.span("chains.init"):
            pass
    w = SimpleNamespace(spans={})
    first = program_spans.of(w)
    assert [s.name for s in first] == ["chains.init"]
    assert program_spans.of(w) is first and w.spans["program"] is first


@pytest.mark.cuda
def test_spans_and_the_cards_trace_share_a_clock(bin_inputs, tmp_path):
    """On the card, under the benchmark's CUDA-only profiler, a small bin's
    device operations all lie between the end of its counts read (which
    does no device work) and the end of GeneAssign (which reads its tables
    back); the span names the first copy's offset after the read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, counts, gene_cov = bin_inputs
    dev = torch.device("cuda")
    config = {"counts": counts, "output_dir": str(tmp_path / "out"),
              "grid": {"g_min": 1, "g_max": 2, "seeds": [0, 1], "iterations": 20},
              "genes": {"coverage_csv": gene_cov}}
    run_pipeline(config, device=dev)   # builds the kernels, outside the trace
    profiling.take_spans()
    with btrace.profiler(dev) as prof:
        run_pipeline(config, device=dev)
        torch.cuda.synchronize(dev)
    spans = profiling.take_spans()
    events = btrace.from_profiler(prof, 0.0).intervals
    assert events
    (read,) = _named(spans, "pipeline.read_counts")
    (genes,) = _named(spans, "genes")
    first, last = events[0][0], max(e for _, e, _ in events)
    assert read.end_ns * 1e-9 <= first and last <= genes.end_ns * 1e-9
    copy = next(s for s, _, name in events if "HtoD" in name)
    print(f"first HtoD copy {(copy - read.end_ns * 1e-9) * 1e3:.3f} ms after "
          f"pipeline.read_counts ends; device events {len(events)}")
