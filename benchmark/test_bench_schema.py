"""BENCHMARK.json keeps the benchmark's contract: its keys, the characters
of every name and unit, the files each entry names, and that every cell
that reports a per-layer metric reports the end-to-end metric it moves."""
import json
import re
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(isinstance(w, str) and _line(w) for w in cmd)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_its_time():
    """2 + 14 runs a cell of run_seconds + 60 s, 2 x 90 s a cell to
    compile, 1200 s spare: within 43200 s at the full 24 cells."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [m["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for m in BENCH[key]]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        group = [m["name"] for m in BENCH[key]]
        assert len(group) == len(set(group)), key
    assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    assert set(conf) == KEYS["config"]
    assert _line(conf["source"]) and _line(conf["why"])
    assert conf["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
    assert len(conf["reduced"]) <= 16 and all(NAME.match(k) for k in conf["reduced"])
    for k in conf["reduced"]:
        assert not k.endswith(("_dim", "_rank", "_size")) and k in data
    # its inputs' generator is a file found by the kind's name
    assert (ROOT / "benchmark" / "generators" / f"{data['generator']['kind']}.py").is_file()
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == KEYS["workload"]
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    wl = json.loads((ROOT / "benchmark" / "workloads" / f"{cell['name']}.json").read_text())
    for k in KEYS["workload"]:
        assert wl[k] == cell[k], k
    assert wl["limits"] and all(lim >= 0 for lim in wl["limits"].values())
    # the entry it drives is a file found by its name
    assert (ROOT / "benchmark" / "entries" / f"{wl['entry']}.py").is_file()
    e2e = {m["name"] for m in run.metrics_of(BENCH, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_of(BENCH, cell["name"], True)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) - {"workloads"} == KEYS["end_to_end"]
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert (Path(run.HERE) / "metrics" / f"{m['name']}.py").is_file()


def test_setup_s_everywhere():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) - {"workloads"} == KEYS["per_layer"]
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(m["layer"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert callable(run.reader(m["name"]))
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        # the cell reports the end-to-end metric this one moves
        assert m["moves"] in {e["name"] for e in run.metrics_of(BENCH, cell, False)}


def test_one_layer_one_name():
    """Metrics of one layer name it alike: a layer's module list in
    parentheses appears under one name only."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    heads = [layer.split(" (")[0] for layer in layers]
    assert len(heads) == len(set(heads))


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_no_card_no_result(tmp_path):
    """Without CUDA the run exits non-zero and prints no result, also in a
    directory that holds only BENCHMARK.json and the benchmark's files."""
    import shutil
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the look for one passes")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload", "ecoli_mock.chain",
             "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == "", out
