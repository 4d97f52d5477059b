"""The bundled TestData quickstart through the port's CLI on the CPU, held to
the accuracy gates of tests/test_quickstart.py and against the JAX
package's run on the same input; and the CLI's refusals."""
import os

import numpy as np
import pytest

from desman_tpu import io as jio
from desman_tpu.run import RunConfig as JaxRunConfig
from desman_tpu.run import run as jax_run
from desman_tpu_torch import cli, io

from torch_helpers import TESTDATA, TRUE_ETA as ETA
from torch_helpers import check_quickstart_gates as _gates

OUTPUTS = ("fit.txt", "Gamma_mean.csv", "Gamma_star.csv", "Eta_mean.csv",
           "Eta_star.csv", "Filtered_Tau_star.csv", "Tau_mean.csv",
           "metrics.json", "loglik_trace.csv")


@pytest.fixture(scope="module")
def variant_half(tmp_path_factory):
    """TestData's true-variant positions (the half tests/test_quickstart.py
    checks the filter keeps) as a counts CSV."""
    data = io.read_counts_csv(os.path.join(TESTDATA, "variant_counts.csv"))
    data = data.select(np.flatnonzero(data.positions < 1000))
    path = str(tmp_path_factory.mktemp("qs") / "variants.csv")
    io.write_counts_csv(path, data)
    return path


@pytest.fixture(scope="module")
def port_out(variant_half, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port") / "out")
    rc = cli.main(["desman", variant_half, "-g", "5", "-e", ETA, "-o", out,
                   "-i", "150", "-s", "0", "--device", "cpu"])
    assert rc == 0
    return out


def test_port_cli_meets_the_quickstart_gates(port_out):
    for f in OUTPUTS:
        assert os.path.exists(os.path.join(port_out, f)), f
    # readable by the JAX package's readers
    fit = jio.read_fit_txt(os.path.join(port_out, "fit.txt"))
    assert (fit["G"], fit["V"], fit["S"]) == (5, 1000, 16)
    assert np.isfinite(fit["star_deviance"]) and np.isfinite(fit["mean_deviance"])
    assert jio.read_tau_mean_csv(os.path.join(port_out, "Tau_mean.csv")).shape == (1000, 5, 4)
    np.testing.assert_allclose(jio.read_eta_csv(os.path.join(port_out, "Eta_star.csv")),
                               io.read_eta_csv(ETA), atol=1e-7)
    _gates(port_out)


def test_jax_run_agrees_with_the_port(variant_half, port_out, tmp_path):
    out = str(tmp_path / "jax")
    jax_run(jio.read_counts_csv(variant_half),
            JaxRunConfig(G=5, iterations=150, seed=0, out_dir=out, eta_file=ETA))
    _gates(out)
    ours = io.read_fit_txt(os.path.join(port_out, "fit.txt"))
    theirs = jio.read_fit_txt(os.path.join(out, "fit.txt"))
    assert abs(ours["star_deviance"] - theirs["star_deviance"]) \
        <= 0.01 * abs(theirs["star_deviance"])


def test_cuda_device_without_cuda_exits_nonzero(variant_half, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    rc = cli.main(["desman", variant_half, "-g", "2", "-o", str(tmp_path / "o")])
    assert rc == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("argv,item", [
    (["--store_every=4"], "item 3"),
    (["--pt", "4"], "item 12"),
    (["--mesh=2x4"], "item 14"),
    (["--checkpoint", "ck.npz"], "item 11"),
    (["--auto_burn"], "item 11"),
    (["-f", "tau.csv"], "item 5"),
    (["--eta_update", "rows"], "item 3"),
    (["--store_every", "5"], "item 3"),
])
def test_unported_flags_exit_2(argv, item, variant_half, capsys):
    rc = cli.main(["desman", variant_half, "-g", "2", "--device", "cpu", *argv])
    assert rc == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["multibin", "geneassign", "diag", "nope"])
def test_unported_subcommands_exit_2(cmd, capsys):
    assert cli.main([cmd, "x.csv"]) == 2
    assert cmd in capsys.readouterr().err
