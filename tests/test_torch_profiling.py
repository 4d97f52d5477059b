"""The port's profiling hooks (``desman_tpu_torch.profiling``, ``desman
--profile``) against the JAX package's behaviour: the trace is a no-op
without a directory; with one, each branch of ``run`` runs inside it and
the sampled files do not change; ``run_multi`` (``--chains > 1``) opens no
trace, as the JAX package's does not."""
import json
import os

import pytest

from desman_tpu import profiling as jprofiling
from desman_tpu_torch import cli, io, profiling, run, synth

SAMPLED = ("Filtered_Tau_star.csv", "Tau_mean.csv", "Gamma_mean.csv",
           "Gamma_star.csv", "Eta_mean.csv", "Eta_star.csv", "fit.txt",
           "loglik_trace.csv")


@pytest.fixture(scope="module")
def counts_csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("prof") / "counts.csv")
    io.write_counts_csv(path, synth.generate(V=60, S=6, G=2, coverage=40.0,
                                             seed=3).data)
    return path


def _events(trace_dir):
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_none_is_a_noop(tmp_path):
    with profiling.device_trace(None):
        pass
    with profiling.device_trace(""):
        pass
    assert not os.listdir(tmp_path)


def test_device_trace_writes_a_cpu_trace(tmp_path):
    import torch

    d = str(tmp_path / "trace")
    with profiling.device_trace(d, "cpu"):
        torch.ones((8, 8)) @ torch.ones((8, 8))
    assert os.listdir(d) == [profiling.TRACE_FILE]
    assert any("aten::mm" in e.get("name", "") for e in _events(d))
    assert profiling.activities("cpu") == [torch.profiler.ProfilerActivity.CPU]
    assert torch.profiler.ProfilerActivity.CUDA in profiling.activities("cuda")


def test_sweep_timer_matches_jax(tmp_path):
    ours, theirs = profiling.SweepTimer(), jprofiling.SweepTimer()
    for t in (ours, theirs):
        t.start()
        t.stop(10, label="a")
        t.start()
        t.stop(30, label="b")
    s = ours.summary()
    assert set(s) == set(theirs.summary())
    assert s["total_sweeps"] == 40 and s["sweeps_per_s"] > 0
    p = str(tmp_path / "timer.json")
    ours.write(p)
    with open(p) as f:
        assert json.load(f)["segments"][1]["label"] == "b"


def _same_sampled_files(a, b):
    for name in SAMPLED:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_cli_profile_writes_a_trace_and_the_same_files(counts_csv, tmp_path):
    base = ["desman", counts_csv, "-g", "2", "-i", "20", "-s", "1", "--device", "cpu"]
    plain, traced = str(tmp_path / "plain"), str(tmp_path / "traced")
    trace = str(tmp_path / "trace")
    assert cli.main([*base, "-o", plain]) == 0
    assert cli.main([*base, "-o", traced, "--profile", trace]) == 0
    _same_sampled_files(plain, traced)
    names = [e.get("name", "") for e in _events(trace)]
    assert any(n.startswith("aten::") for n in names)


@pytest.mark.parametrize("mode", [
    dict(), dict(kernel="cuda_resident"), dict(pt_replicas=2),
    dict(auto_burn=True, auto_max_burn=20), dict(checkpoint_path="ck.npz"),
], ids=["plain", "resident", "pt", "auto", "checkpoint"])
def test_every_run_branch_is_traced(mode, counts_csv, tmp_path):
    """JAX's run opens the trace around all its branches; so does the
    port's, and the files are those of the same run untraced."""
    mode = dict(mode)
    kernel = mode.pop("kernel", "cuda")
    if "checkpoint_path" in mode:
        mode["checkpoint_path"] = str(tmp_path / mode["checkpoint_path"])
    data = io.read_counts_csv(counts_csv)
    outs = {}
    for name, prof in (("plain", None), ("traced", str(tmp_path / "trace"))):
        if "checkpoint_path" in mode and name == "traced":
            os.remove(mode["checkpoint_path"])
        outs[name] = str(tmp_path / name)
        rc = run.RunConfig(G=2, iterations=20, seed=0, out_dir=outs[name],
                           profile_dir=prof, **mode)
        run.run(data, rc, device="cpu", kernel=kernel)
    _same_sampled_files(outs["plain"], outs["traced"])
    assert os.listdir(tmp_path / "trace") == [profiling.TRACE_FILE]


def test_chains_run_untraced_as_in_jax(counts_csv, tmp_path):
    """run_multi, the --chains > 1 path, never opens the trace in the JAX
    package (its run has the only device_trace): neither does the port's."""
    trace = tmp_path / "trace"
    assert cli.main(["desman", counts_csv, "-g", "2", "-i", "10", "--chains", "2",
                     "--device", "cpu", "-o", str(tmp_path / "o"),
                     "--profile", str(trace)]) == 0
    assert os.path.isfile(tmp_path / "o" / "chains.json")
    assert not trace.exists()
