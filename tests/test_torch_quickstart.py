"""The bundled TestData quickstart through the port's CLI on the CPU, held to
the accuracy gates of tests/test_quickstart.py and against the JAX
package's run on the same input; the run-mode flags and subcommands
ported since; and the CLI's refusals."""
import json
import os

import numpy as np
import pytest

from desman_tpu import cli as jcli
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
def test_unported_flags_exit_2(argv, item, variant_half, tmp_path, capsys):
    """A flag of an item still to port exits 2 naming its item. The flags
    of items 3 and 5 are ported: each runs on the quickstart input
    (``_ported_flag``)."""
    if item in ("item 3", "item 5"):
        _ported_flag(argv, variant_half, str(tmp_path / "out"))
        return
    rc = cli.main(["desman", variant_half, "-g", "2", "--device", "cpu", *argv])
    assert rc == 2
    assert item in capsys.readouterr().err


def _run_mode(variant_half, out, argv):
    rc = cli.main(["desman", variant_half, "-g", "5", "-o", out, "-i", "150",
                   "-s", "0", "--device", "cpu", *argv])
    assert rc == 0
    _gates(out)
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


def _ported_flag(argv, variant_half, out):
    """--store_every that does not divide the sampling sweeps fails as in
    the JAX package; -f holds tau to the file; --eta_update rows samples
    eta row by row; --store_every 5 writes draws.npz. The runs meet the
    quickstart gates."""
    if argv == ["--store_every=4"]:
        # 250 sweeps -> 125 sampling sweeps: 4 does not divide them, and
        # both packages say so before any work
        for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
            with pytest.raises(ValueError, match="must divide the sampling"):
                main(["desman", variant_half, "-g", "2", *argv, "-o", out, *extra])
        assert not os.path.exists(os.path.join(out, "fit.txt"))
    elif argv[0] == "-f":
        true_tau = os.path.join(TESTDATA, "true_tau.csv")
        m = _run_mode(variant_half, out, ["-e", ETA, "-f", true_tau])
        got, gc, gp = io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))
        want, wc, wp = io.read_tau_star_csv(true_tau)
        row = {(str(c), int(p)): i for i, (c, p) in enumerate(zip(wc, wp))}
        np.testing.assert_array_equal(
            got, want[[row[(str(c), int(p))] for c, p in zip(gc, gp)]])
        assert m["accept_eta"] == 0.0
    elif argv[0] == "--eta_update":
        m = _run_mode(variant_half, out, ["-e", ETA, "--sample_eta", *argv])
        assert m["accept_eta"] > 0
        assert not np.allclose(io.read_eta_csv(os.path.join(out, "Eta_mean.csv")),
                               io.read_eta_csv(ETA))
    else:
        m = _run_mode(variant_half, out, ["-e", ETA, *argv])
        draws = jio.read_draws(os.path.join(out, "draws.npz"))
        assert (draws["burn"], draws["thin"]) == (75, 5)
        assert draws["tau"].shape == (15, 1000, 5) and draws["tau"].dtype == np.int8
        assert draws["gamma"].shape == (15, 16, 5) and draws["eta"].shape == (15, 4, 4)
        assert np.isfinite(m["gamma_ess_min"]) and m["gamma_ess_min"] > 0
        assert "eta_ess_min" in m and "gamma_ess_median" in m


@pytest.mark.parametrize("cmd", ["multibin", "geneassign", "diag", "nope",
                                 "extract", "strainfasta"])
def test_unported_subcommands_exit_2(cmd, port_out, variant_half, tmp_path, capsys):
    """A subcommand still to port, or an unknown one, exits 2 naming
    itself. geneassign and diag are ported: each runs on the quickstart
    run (``_ported_subcommand``)."""
    if cmd in ("geneassign", "diag"):
        _ported_subcommand(cmd, port_out, variant_half, tmp_path, capsys)
        return
    assert cli.main([cmd, "x.csv"]) == 2
    assert cmd in capsys.readouterr().err


def _ported_subcommand(cmd, port_out, variant_half, tmp_path, capsys):
    """geneassign on the quickstart run's strains and planted accessory
    genes; diag on the quickstart run directory."""
    if cmd == "diag":
        assert cli.main(["diag", port_out, "-o", str(tmp_path / "diag.csv")]) == 0
        assert "G=5: chains=1" in capsys.readouterr().out
        with open(tmp_path / "diag.csv") as f:
            assert f.readline().startswith("G,V,chains,split_rhat,ess_bulk")
        return
    from desman_tpu_torch.geneassign import sample_total_coverage, strain_coverage

    gamma = io.read_gamma_csv(os.path.join(port_out, "Gamma_mean.csv"))
    total = sample_total_coverage(io.read_counts_csv(variant_half).counts)
    rng = np.random.default_rng(0)
    etaG = rng.integers(0, 2, size=(40, 5))
    etaG[etaG.sum(axis=1) == 0, 0] = 1
    x = rng.poisson(etaG @ strain_coverage(gamma, total)).astype(np.float64)
    cov = str(tmp_path / "gene_cov.csv")
    io.write_gene_table(cov, [f"g{d}" for d in range(40)],
                        [f"S{s}" for s in range(16)], x)
    stub = str(tmp_path / "ga_")
    assert cli.main(["geneassign", "-g", os.path.join(port_out, "Gamma_mean.csv"),
                     "-c", cov, "--core_counts", variant_half, "-o", stub,
                     "--device", "cpu"]) == 0
    etaS = io.read_gene_cov_csv(stub + "etaS_df.csv")
    assert etaS.columns == [f"H{g + 1}" for g in range(5)]
    assert (etaS.values == etaG).mean() > 0.9
