"""``--debug``, the NaN trap, against the JAX CLI's (``jax_debug_nans``): the
same poisoned input (a NaN in the -e eta file) fails with
FloatingPointError in both, the flag is taken from anywhere in the
arguments, a mesh's ranks all raise at the same sweep, and without the
flag (or with it, on clean input) the port's files are the same bytes."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from desman_tpu import cli as jcli
from desman_tpu_torch import cli, io, sampler, synth

import mesh_workers
from torch_helpers import REPO

FILES = ("fit.txt", "Gamma_mean.csv", "Gamma_star.csv", "Eta_mean.csv", "Eta_star.csv",
         "Filtered_Tau_star.csv", "Tau_mean.csv", "loglik_trace.csv")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A small counts CSV (V=60: one tiny JAX compile), a clean eta file and
    one with a NaN."""
    tmp = tmp_path_factory.mktemp("debug")
    t = synth.generate(V=60, S=6, G=2, coverage=30.0, seed=3)
    io.write_counts_csv(str(tmp / "c.csv"), t.data)
    eta = np.full((4, 4), 0.01 / 3) + np.eye(4) * (0.99 - 0.01 / 3)
    io.write_eta_csv(str(tmp / "eta.csv"), eta)
    eta[1, 2] = np.nan
    io.write_eta_csv(str(tmp / "nan_eta.csv"), eta)
    return {k: str(tmp / f"{k}.csv") for k in ("c", "eta", "nan_eta")}


def _argv(inputs, eta, out):
    return ["desman", inputs["c"], "-g", "2", "-e", inputs[eta], "-o", out, "-i", "4"]


def test_a_nan_in_the_eta_file_fails_both_clis(inputs, tmp_path):
    """JAX's --debug raises FloatingPointError at the op that made the NaN;
    the port's at the end of sweep 0, naming the sweep and the field (the
    loglik, checked first). jax_debug_nans is reset afterwards: JAX's main
    leaves it on. The port's trap is on for its call only."""
    try:
        with pytest.raises(FloatingPointError):
            jcli.main(["--debug", *_argv(inputs, "nan_eta", str(tmp_path / "jax"))])
    finally:
        jax.config.update("jax_debug_nans", False)
    with pytest.raises(FloatingPointError, match=r"^sweep 0: non-finite loglik"):
        cli.main([*_argv(inputs, "nan_eta", str(tmp_path / "port")), "--device", "cpu",
                  "--debug"])
    assert not sampler.nan_trap()
    assert not os.path.exists(tmp_path / "port" / "fit.txt")


@pytest.mark.parametrize("extra", [[], ["--pt", "2"], ["--chains", "2", "--auto_burn"]],
                         ids=["plain", "pt", "chains-auto"])
def test_the_trap_checks_every_chain_and_replica(inputs, tmp_path, extra):
    """--debug first, on each run mode: the NaN fails the run at sweep 0;
    without the NaN the trap changes no byte of the output."""
    with pytest.raises(FloatingPointError, match="sweep 0"):
        cli.main(["--debug", *_argv(inputs, "nan_eta", str(tmp_path / "bad")), "--device",
                  "cpu", *extra])
    outs = []
    for flag, name in ((["--debug"], "on"), ([], "off")):
        out = str(tmp_path / name)
        assert cli.main([*flag, *_argv(inputs, "eta", out), "--device", "cpu", *extra]) == 0
        outs.append(out)
    for f in FILES:
        with open(os.path.join(outs[0], f), "rb") as a, open(os.path.join(outs[1], f), "rb") as b:
            assert a.read() == b.read(), f


def test_every_rank_of_a_mesh_raises_at_the_same_sweep(inputs, tmp_path):
    """`desman --debug --mesh 1x2` (the CLI starts two ranks and hands them
    the trap): both ranks agree on the flags over the world and raise
    FloatingPointError at sweep 0, none is left in a collective, and the
    world fails."""
    done = subprocess.run(
        [sys.executable, "-m", "desman_tpu_torch", "desman", "--debug",
         *_argv(inputs, "nan_eta", str(tmp_path / "o"))[1:], "--device", "cpu",
         "--mesh", "1x2"],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, capture_output=True, text=True,
        timeout=mesh_workers.WORLD_TIMEOUT_S)
    assert done.returncode == 1, done.stderr
    assert done.stderr.count("FloatingPointError: sweep 0: non-finite loglik") == 2
