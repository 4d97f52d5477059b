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
    (["--mesh=1x2", "--pt", "4"], "item 15"),
    (["--mesh=1x2", "--auto_burn"], "item 15"),
])
def test_unported_flags_exit_2(argv, item, variant_half, port_out, tmp_path, capsys):
    """A flag of an item still to port exits 2 naming its item: --mesh with
    --pt or --auto_* (item 15). The flags of items 3, 5, 11, 12 and 14 are
    ported: each runs on the quickstart input (``_ported_flag``)."""
    if item in ("item 3", "item 5", "item 11", "item 12", "item 14"):
        _ported_flag(argv, variant_half, str(tmp_path / "out"), port_out)
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


def _ported_flag(argv, variant_half, out, port_out):
    """--store_every that does not divide the sampling sweeps fails as in
    the JAX package; -f holds tau to the file; --eta_update rows samples
    eta row by row; --store_every 5 writes draws.npz; --checkpoint writes
    the files of the run without it (port_out), and leaves its snapshot at
    the last sweep; --auto_burn burns at least -i/2 sweeps; --pt 4 runs
    four tempered replicas and reports their exchange rate. The runs meet
    the quickstart gates. --mesh=2x4 with --chains 2 runs on eight ranks
    the CLI starts (gloo on the CPU), the best chain's files within the
    gates, chains.json beside them."""
    if argv[0] == "--mesh=2x4":
        m = _run_mode(variant_half, out, ["-e", ETA, *argv, "--chains", "2"])
        assert (m["mesh"], m["ranks"], m["backend"], m["chains"]) == ("2x4", 8, "gloo", 2)
        with open(os.path.join(out, "chains.json")) as f:
            assert json.load(f)["seeds"] == [0, 1]
        return
    if argv[0] == "--checkpoint":
        ck = os.path.join(os.path.dirname(out), argv[1])
        m = _run_mode(variant_half, out, ["-e", ETA, "--checkpoint", ck])
        for f in OUTPUTS:
            if f != "metrics.json":
                with open(os.path.join(out, f), "rb") as a, \
                        open(os.path.join(port_out, f), "rb") as b:
                    assert a.read() == b.read(), f
        with np.load(ck) as z:
            assert int(z["it"]) == m["sweeps"] == 150
    elif argv == ["--auto_burn"]:
        m = _run_mode(variant_half, out, ["-e", ETA, *argv])
        assert m["sampling_sweeps"] == 75 and m["sweeps"] - 75 >= 75
        assert len(np.loadtxt(os.path.join(out, "loglik_trace.csv"))) == m["sweeps"]
    elif argv[0] == "--pt":
        m = _run_mode(variant_half, out, ["-e", ETA, *argv])
        assert 0.0 < m["pt_swap_accept"] <= 1.0 and m["sweeps"] == 150
    elif argv == ["--store_every=4"]:
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
    """An unknown subcommand exits 2 naming itself. Every subcommand of the
    JAX package is ported: each runs on the quickstart input or run
    (``_ported_subcommand``)."""
    if cmd != "nope":
        _ported_subcommand(cmd, port_out, variant_half, tmp_path, capsys)
        return
    assert cli.main([cmd, "x.csv"]) == 2
    assert cmd in capsys.readouterr().err


def _ported_subcommand(cmd, port_out, variant_half, tmp_path, capsys):
    """geneassign on the quickstart run's strains and planted accessory
    genes; diag on the quickstart run directory; multibin on the
    quickstart input as one bin (the quickstart gates); extract on the
    quickstart input written as a pileup (the counts back); strainfasta on
    the quickstart run's calls (each strain's string is its tau column)."""
    if cmd == "multibin":
        stub = str(tmp_path / "bins_")
        assert cli.main(["multibin", variant_half, "-g", "5", "-e", ETA, "-i", "150",
                         "-o", stub, "--device", "cpu"]) == 0
        _gates(stub + "variants")
        return
    if cmd == "extract":
        from desman_tpu_torch.pileup import write_pileup

        data = io.read_counts_csv(variant_half)
        pileup, names = str(tmp_path / "qs.pileup"), tmp_path / "names.txt"
        write_pileup(pileup, data)
        names.write_text("\n".join(data.samples) + "\n")
        out = str(tmp_path / "counts.csv")
        assert cli.main(["extract", pileup, "-n", str(names), "-o", out]) == 0
        with open(out, "rb") as a, open(variant_half, "rb") as b:
            assert a.read() == b.read()
        return
    if cmd == "strainfasta":
        tau, _, _ = io.read_tau_star_csv(os.path.join(port_out, "Filtered_Tau_star.csv"))
        out = tmp_path / "strains.fasta"
        assert cli.main(["strainfasta", os.path.join(port_out, "Filtered_Tau_star.csv"),
                         "-o", str(out)]) == 0
        lines = out.read_text().split("\n")
        heads = [i for i, ln in enumerate(lines) if ln.startswith(">")]
        assert [lines[i] for i in heads] == [f">hap{g + 1} variants=1000" for g in range(5)]
        for g, i in enumerate(heads):
            seq = "".join(lines[i + 1:heads[g + 1] if g + 1 < 5 else None])
            assert seq == "".join("ACGT"[b] for b in tau[:, g])
        return
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
