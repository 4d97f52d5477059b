"""``desman --mesh CxD`` through the port's CLI on the CPU (gloo): the ranks
it starts itself, with --chains, --store_every, --checkpoint (SIGTERM ->
exit 75 -> resume on another mesh shape), -f, --eta_update rows and each
kernel choice that takes a mesh; the torchrun path (a world already
joined, whose size the mesh must match); the refusals, at the CLI and at
the API, message for message.

Each CLI run's best chain is held against the same run on one device
(tau_star agreement >= 0.99, the position shards' sums adding in another
order) and its run record names the mesh, the gloo backend and the ranks.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from desman_tpu_torch import cli, io, synth
from desman_tpu_torch.run import RunConfig, mesh_waiting, run_multi, run_sharded_checkpointed
from desman_tpu_torch.parallel import launch, make_mesh

import mesh_workers
from torch_helpers import REPO

SWEEPS = 40


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A counts CSV (V=150: a zero row on a data axis of 4) and its truth."""
    tmp = tmp_path_factory.mktemp("mesh_cli")
    t = synth.generate(V=150, S=10, G=3, coverage=50.0, seed=4)
    csv = str(tmp / "counts.csv")
    io.write_counts_csv(csv, t.data)
    return csv, t


def _argv(csv, out, *extra):
    return ["desman", csv, "-g", "3", "-i", str(SWEEPS), "-s", "0", "-o", out,
            "--device", "cpu", *extra]


def _tau(out):
    return io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))[0]


def _metrics(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


def _agree(a, b):
    return (a == b).all(axis=1).mean()


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def _mesh_cli(argv):
    """`python -m desman_tpu_torch` with argv, which starts its ranks;
    bounded by the worlds' timeout."""
    done = subprocess.run([sys.executable, "-m", "desman_tpu_torch", *argv], env=_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=mesh_workers.WORLD_TIMEOUT_S)
    assert done.returncode == 0, done.stderr


@pytest.mark.parametrize("mesh,extra", [
    ("2x2", ["--chains", "2", "--store_every", "4"]),
    ("1x2", ["--eta_update", "rows", "--kernel", "torch"]),
    ("1x4", ["-f", "TRUTH"]),
], ids=["chains-store", "rows-torch", "tau-fixed"])
def test_cli_mesh_against_one_device(case, tmp_path, mesh, extra):
    csv, t = case
    if "TRUTH" in extra:
        truth = str(tmp_path / "truth.csv")
        io.write_tau_star_csv(truth, t.tau_idx, t.data.contigs, t.data.positions)
        extra = [truth if x == "TRUTH" else x for x in extra]
    one, sharded = str(tmp_path / "one"), str(tmp_path / "mesh")
    assert cli.main(_argv(csv, one, *extra)) == 0
    _mesh_cli(_argv(csv, sharded, "--mesh", mesh, *extra))
    m = _metrics(sharded)
    c, d = (int(x) for x in mesh.split("x"))
    assert (m["mesh"], m["ranks"], m["backend"]) == (mesh, c * d, "gloo")
    assert m["collectives_per_sweep"] <= (5 if "rows" in extra else 3)
    assert _agree(_tau(sharded), _tau(one)) >= 0.99
    if "-f" in extra:
        assert np.array_equal(_tau(sharded), t.tau_idx)
    if "--chains" in extra:
        with open(os.path.join(sharded, "chains.json")) as f:
            chains = json.load(f)
        with open(os.path.join(one, "chains.json")) as f:
            assert chains["seeds"] == json.load(f)["seeds"] == [0, 1]
        d_mesh = np.load(os.path.join(sharded, "draws.npz"))
        d_one = np.load(os.path.join(one, "draws.npz"))
        assert d_mesh["tau"].shape == d_one["tau"].shape == (5, 150, 3)


def test_cli_mesh_topk(tmp_path):
    """--kernel cuda_topk on biallelic counts at 1x2, against one device."""
    t = synth.generate(V=120, S=8, G=3, coverage=50.0, error_rate=0.0, max_alleles=2,
                       seed=5)
    csv = str(tmp_path / "bi.csv")
    io.write_counts_csv(csv, t.data)
    one, sharded = str(tmp_path / "one"), str(tmp_path / "mesh")
    assert cli.main(_argv(csv, one, "--kernel", "cuda_topk")) == 0
    _mesh_cli(_argv(csv, sharded, "--kernel", "cuda_topk", "--mesh", "1x2"))
    assert _metrics(sharded)["kernel"] == "cuda_topk"
    assert _agree(_tau(sharded), _tau(one)) >= 0.99


def _manifest_it(ck):
    try:
        with open(os.path.join(ck, "manifest.json")) as f:
            return int(json.load(f)["it"])
    except (OSError, ValueError):
        return None


def test_cli_mesh_sigterm_exits_75_and_resumes_on_another_mesh(case, tmp_path):
    """`desman --mesh 1x2 --checkpoint DIR` SIGTERMed once its manifest
    shows 0 < it < 400 forwards the signal to its ranks, which commit and
    exit 75 together; rerun on a 1x1 mesh (this process) it completes, and
    agrees with the uninterrupted run."""
    csv, _ = case
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    argv = ["desman", csv, "-g", "3", "-i", "400", "-s", "0", "--device", "cpu",
            "--checkpoint_every", "20", "--checkpoint", ck]
    proc = subprocess.Popen([sys.executable, "-m", "desman_tpu_torch", *argv, "-o", out,
                             "--mesh", "1x2"], env=_env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    seen = None
    try:
        deadline = time.time() + 120
        while proc.poll() is None and time.time() < deadline:
            it = _manifest_it(ck)
            if it is not None and 0 < it < 400:
                proc.send_signal(signal.SIGTERM)
                seen = it
                break
            time.sleep(0.002)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 75 and seen is not None, (proc.returncode, err)
    assert "desman: preempted" in err and "SIGTERM" in err
    at = _manifest_it(ck)
    assert seen <= at < 400
    assert not os.path.exists(os.path.join(out, "fit.txt"))
    assert cli.main([*argv, "-o", out, "--mesh", "1x1"]) == 0
    assert _manifest_it(ck) == 400
    whole = str(tmp_path / "whole")
    _mesh_cli([*argv[:-1], str(tmp_path / "ck2"), "-o", whole, "--mesh", "1x2"])
    assert _agree(_tau(out), _tau(whole)) >= 0.99
    assert _metrics(out)["mesh"] == "1x1"


def test_cli_joins_a_world_and_checks_its_size(case, tmp_path):
    """Under a joined world (as torchrun starts it) the CLI starts no ranks
    of its own: --mesh 1x2 runs on the world's two ranks; --mesh 1x4 on
    them exits 2 with make_mesh's message."""
    csv, _ = case
    out = str(tmp_path / "out")
    assert launch(mesh_workers.desman, 2, (_argv(csv, out, "--mesh", "1x2")[1:],),
                  timeout_s=mesh_workers.WORLD_TIMEOUT_S) == 0
    assert _metrics(out)["ranks"] == 2
    assert launch(mesh_workers.desman, 2, (_argv(csv, out, "--mesh", "1x4")[1:],),
                  timeout_s=mesh_workers.WORLD_TIMEOUT_S) == 2


@pytest.mark.parametrize("argv,words", [
    (["--mesh", "1x2", "--pt", "4"], "--mesh with --pt is not ported"),
    (["--mesh", "1x2", "--auto_burn"], "--mesh with --auto_burn/--auto_samples"),
    (["--mesh", "1x2", "--auto_samples", "50"], "item 15"),
    (["--mesh", "2"], "--mesh expects CHAINxDATA"),
    (["--mesh", "0x2"], "--mesh expects CHAINxDATA"),
    (["--mesh", "2x1"], "needs --chains a multiple of its chain axis 2, not 1"),
    (["--mesh", "2x1", "--chains", "3"], "not 3"),
    (["--mesh", "1x2", "--kernel", "cuda_resident"], "single-device speed mode"),
], ids=["pt", "auto_burn", "auto_samples", "shape", "zero", "chains", "chains3",
        "resident"])
def test_cli_mesh_refusals(argv, words, tmp_path, capsys):
    rc = cli.main(["desman", "x.csv", "-g", "2", "-o", str(tmp_path / "o"),
                   "--device", "cpu", *argv])
    assert rc == 2
    assert words in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("kw", [dict(pt_replicas=4), dict(auto_burn=True),
                                dict(auto_samples=50.0)], ids=["pt", "auto_burn", "auto_samples"])
def test_run_refuses_what_the_cli_refuses(case, kw):
    """run_multi(mesh=...) and run_sharded_checkpointed raise ValueError
    with the CLI's item-15 text; a mesh refuses cuda_resident."""
    _, t = case
    rc = RunConfig(G=2, iterations=10, checkpoint_path="unused", **kw)
    text = mesh_waiting(True, False) if "pt_replicas" in kw else mesh_waiting(False, True)
    for fn in (lambda: run_multi(t.data, rc, 1, device="cpu", mesh=make_mesh(1, 1)),
               lambda: run_sharded_checkpointed(t.data, rc, make_mesh(1, 1), device="cpu")):
        with pytest.raises(ValueError) as e:
            fn()
        assert str(e.value) == text
    with pytest.raises(ValueError, match="single-device"):
        run_multi(t.data, RunConfig(G=2, iterations=10), 1, device="cpu",
                  kernel="cuda_resident", mesh=make_mesh(1, 1))


def test_cuda_mesh_without_cuda_exits_2(case, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    csv, _ = case
    assert cli.main(["desman", csv, "-g", "2", "-o", str(tmp_path / "o"),
                     "--mesh", "1x2"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
