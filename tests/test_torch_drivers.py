"""The port's drivers against the JAX package's: ``desman_tpu_torch.bench``
against the root ``bench.py``, ``complete_example`` against
``examples/complete_example.py``, ``bench_suite`` against
``scripts/bench_suite.py`` and ``make_testdata`` against
``scripts/make_testdata.py`` (whose committed outputs are ``TestData/`` and
``complete_example_out/``). The drivers' data are held byte for byte to the
JAX side's; their rates only to being positive, as a CPU rate is no card's.

The subprocesses start together in a module fixture, so that they run
beside the in-process tests.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from desman_tpu import synth as jsynth
from desman_tpu.geneassign import strain_coverage as jstrain_coverage
from desman_tpu_torch import bench, complete_example, make_testdata

from torch_helpers import REPO, TESTDATA

SMALL = dict(V=200, S=8, G=3, sweeps=5)
# the bench at SMALL's size on the CPU: the module's constants set in the child
BENCH_SMALL = (
    "import sys; from desman_tpu_torch import bench; "
    f"bench.V, bench.S, bench.G, bench.SWEEPS = {SMALL['V']}, {SMALL['S']}, "
    f"{SMALL['G']}, {SMALL['sweeps']}; sys.exit(bench.main(sys.argv[1:]))")
SUITE_ENTRIES = "filter,geneassign,io"


def _source(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


@pytest.fixture(scope="module")
def procs():
    """The driver subprocesses, started together: (a)/(b) the bench at
    SMALL's size on the CPU, with the parent's thread variables at 2;
    (c) the bench with no card and no --device cpu; (g) the suite."""
    env = dict(os.environ, OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    argvs = {
        "bench_cpu": ["-c", BENCH_SMALL, "--device", "cpu"],
        "bench_no_card": ["-m", "desman_tpu_torch.bench"],
        "suite": ["-m", "desman_tpu_torch.bench_suite", "--quick", "--device",
                  "cpu", "--only", SUITE_ENTRIES],
    }
    started = {}
    for name, argv in argvs.items():
        run_env = dict(env, CUDA_VISIBLE_DEVICES="") if name == "bench_no_card" else env
        started[name] = subprocess.Popen([sys.executable, *argv], cwd=REPO,
                                         env=run_env, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True)
    done = {}

    def result(name):
        if name not in done:
            out, err = started[name].communicate(timeout=240)
            done[name] = (started[name].returncode, out, err)
        return done[name]

    yield result
    for p in started.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def test_bench_data_and_baseline_inputs_are_bench_pys():
    """(a) The counts are JAX's ``synth.generate`` at V=1e4 S=64 G=8 seed 0;
    the baseline's start is bench.py's (its lines 86-89)."""
    want = jsynth.generate(V=10_000, S=64, G=8, coverage=50.0, seed=0).data.counts
    assert np.array_equal(bench.counts(), want)
    rng = np.random.default_rng(0)
    tau = rng.integers(0, 4, size=(10_000, 8))
    gamma = rng.dirichlet(np.ones(8), size=64)
    eta = np.full((4, 4), 0.01 / 3) + np.eye(4) * (0.99 - 0.01 / 3)
    for a, b in zip(bench.baseline_inputs(10_000, 64, 8), (tau, gamma, eta)):
        assert np.array_equal(a, b)


def test_bench_measure_gives_a_positive_rate():
    m = bench.measure(V=SMALL["V"], S=SMALL["S"], G=SMALL["G"],
                      sweeps=SMALL["sweeps"], kernel="torch", device="cpu",
                      repeats=1)
    assert len(m["times"]) == 1 and m["seconds"] == m["times"][0]
    assert m["sweeps_per_s"] > 0 and np.isfinite(m["final_loglik"])


def test_bench_last_line_has_bench_pys_keys(procs):
    """(a) Run on the CPU at SMALL's size, the last stdout line has exactly
    the four keys of bench.py's, with its metric name and unit."""
    rc, out, err = procs("bench_cpu")
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    jax_dumps = re.search(r"print\(json\.dumps\(\{(.*?)\}\)\)", _source("bench.py"),
                          re.DOTALL).group(1)
    assert list(line) == re.findall(r'"(\w+)":', jax_dumps)
    assert line["metric"] == re.search(r'"metric": "(\w+)"', jax_dumps).group(1)
    assert line["unit"] == "sweeps/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0


def test_bench_baseline_child_has_one_blas_thread(procs):
    """(b) The bench ran with the three thread variables at 2; the
    baseline's child process saw each at 1."""
    rc, _, err = procs("bench_cpu")
    assert rc == 0, err
    said = [ln for ln in err.splitlines() if ln.startswith("# baseline")]
    assert len(said) == 1
    for var in bench.THREAD_VARS:
        assert f"{var}=1" in said[0], said[0]


def test_bench_without_a_card_exits_nonzero_and_prints_nothing(procs):
    """(c)"""
    rc, out, err = procs("bench_no_card")
    assert rc != 0 and out == ""
    assert "CUDA is not available" in err


def _jax_mock_and_genes(scale: str, seed: int = 2017):
    """examples/complete_example.py:54-140 replayed with numpy and the JAX
    package's generator: its scale, mock counts and gene truth."""
    V, S, G_true, _, _, _, D = {
        "quick": (200, 12, 3, 5, [0, 1], 80, 40),
        "paper": (7000, 64, 5, 8, [0, 1, 2, 3, 4], 250, 1500),
        "default": (1000, 16, 5, 8, [0, 1, 2], 250, 200)}[scale]
    gen_kw = dict(max_alleles=2, gamma_alpha=0.6) if scale == "paper" else {}
    rng = np.random.default_rng(seed)
    t = jsynth.generate(V=V, S=S, G=G_true, coverage=50.0, error_rate=0.005,
                        gamma_alpha=gen_kw.pop("gamma_alpha", 2.0), seed=seed,
                        **gen_kw)
    mono_base = rng.integers(0, 4, size=V)
    mono = rng.poisson(
        50.0 * t.eta[mono_base][:, None, :].repeat(S, axis=1)).astype(np.int32)
    counts = np.concatenate([t.data.counts, mono], axis=0)
    total_cov = t.data.counts.sum(2).mean(0)
    etaG_true = rng.integers(0, 2, size=(D, G_true))
    etaG_true[etaG_true.sum(1) == 0, 0] = 1
    cov_true = jstrain_coverage(t.gamma, total_cov)
    x = rng.poisson(np.maximum(etaG_true @ cov_true, 1e-9)).astype(np.float64)
    return counts, etaG_true, x


@pytest.mark.parametrize("scale", ["quick", "default", "paper"])
def test_complete_example_mock_and_gene_truth_are_the_jax_examples(scale):
    """(d) Each scale's mock counts and accessory-gene draws (etaG_true, x)
    equal the JAX example's, drawn from one stream."""
    counts, etaG_true, x = _jax_mock_and_genes(scale)
    sc = complete_example.SCALES[scale]
    t, full, rng = complete_example.mock(sc, 2017)
    assert np.array_equal(full.counts, counts)
    got_eta, got_x = complete_example.gene_truth(rng, t, sc.n_genes)
    assert np.array_equal(got_eta, etaG_true) and np.array_equal(got_x, x)


def test_complete_example_paper_counts_csv_is_the_committed_one(tmp_path):
    """(d) The --paper mock's core_counts.csv is byte for byte the JAX run's
    committed complete_example_out/core_counts.csv."""
    from desman_tpu_torch import io

    _, full, _ = complete_example.mock(complete_example.SCALES["paper"], 2017)
    path = tmp_path / "core_counts.csv"
    io.write_counts_csv(str(path), full)
    with open(os.path.join(REPO, "complete_example_out", "core_counts.csv"), "rb") as f:
        assert path.read_bytes() == f.read()


def test_complete_example_quick_passes_on_the_cpu(tmp_path, capsys):
    """(e) --quick --device cpu: exit 0, the five [k/5] lines and PASS;
    summary.json has the committed JAX summary's keys, in order; G=3."""
    rc = complete_example.main(["--quick", "--device", "cpu",
                                "--outdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.strip().splitlines()
    assert [ln[:5] for ln in lines[:5]] == [f"[{k}/5]" for k in range(1, 6)]
    assert lines[-1] == "COMPLETE_EXAMPLE PASS"
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    with open(os.path.join(REPO, "complete_example_out", "summary.json")) as f:
        committed = json.load(f)
    assert list(summary) == list(committed)
    assert summary["scale"] == "quick" and summary["selected_G"] == 3
    assert summary["pass"] is True


def test_make_testdata_writes_the_committed_testdata(tmp_path, capsys):
    """(f)"""
    assert make_testdata.main([str(tmp_path)]) == 0
    for name in make_testdata.FILES:
        with open(os.path.join(TESTDATA, name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name


def test_bench_suite_prints_the_jax_suites_entries(procs):
    """(g) One parseable line per entry, named as scripts/bench_suite.py
    names them (its csv_pandas is the port's csv_python), every value
    positive."""
    rc, out, err = procs("suite")
    assert rc == 0, err
    rows = [json.loads(ln) for ln in out.strip().splitlines()]
    jax_names = re.findall(r'"bench": "(\w+)"', _source("scripts", "bench_suite.py"))
    want = [("csv_python" if n == "csv_pandas" else n) for n in jax_names
            if n != "time_to_converged_deviance"]
    assert [r["bench"] for r in rows] == want
    for r in rows:
        assert set(r) == {"bench", "value", "unit", "config"}
        assert r["value"] > 0, r
