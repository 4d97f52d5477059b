"""The port's GeneAssign, genecov and their host I/O against the JAX
package's: exact enumeration value for value, the Gibbs paths on the JAX
tests' own quality bars, ``assign_gene_tau`` replayed on JAX's Gumbel
streams, and the ``geneassign``/``genecov``/``validate``/``diag`` CLIs
against the JAX CLIs on the same inputs."""
import csv
import os

import numpy as np
import pytest
import torch

from desman_tpu import cli as jcli
from desman_tpu import geneassign as jga
from desman_tpu import genecov as jgc
from desman_tpu import io as jio
from desman_tpu_torch import cli, convert, geneassign, genecov, io, synth

from torch_helpers import TESTDATA, GeneTauReplay


def _gene_dataset(D=60, S=12, G=3, seed=0, max_copy=1, mean_cov=30.0):
    """tests/test_geneassign.py's planted copy numbers + Poisson coverage."""
    rng = np.random.default_rng(seed)
    gamma = rng.dirichlet(np.ones(G) * 2.0, size=S)      # [S,G]
    total = rng.uniform(0.5, 1.5, size=S) * mean_cov     # [S]
    cov = geneassign.strain_coverage(gamma, total)       # [G,S]
    etaG = rng.integers(0, max_copy + 1, size=(D, G))
    none = etaG.sum(axis=1) == 0
    etaG[none, rng.integers(0, G, size=none.sum())] = 1
    x = rng.poisson(np.maximum(etaG @ cov, 1e-9)).astype(np.float64)
    return x, cov, etaG, gamma, total


# ---- enumeration ----


@pytest.mark.parametrize("model", ["quasipoisson", "gaussian"])
@pytest.mark.parametrize("max_copy", [1, 2])
def test_enumeration_matches_jax(max_copy, model):
    x, cov, etaG, _, _ = _gene_dataset(max_copy=max_copy,
                                       mean_cov=30.0 * max_copy)
    cfg = geneassign.GeneAssignConfig(max_copy=max_copy, model=model)
    ours = geneassign.assign_genes(x, cov, cfg, device="cpu")
    theirs = jga.assign_genes(x, cov, jga.GeneAssignConfig(max_copy=max_copy,
                                                           model=model))
    assert ours.eta_star.dtype == torch.int32
    np.testing.assert_array_equal(ours.eta_star.numpy(), np.asarray(theirs.eta_star))
    for f in ("presence_prob", "copy_post_mean", "confidence") + (
            ("loglik",) if model == "quasipoisson" else ()):
        np.testing.assert_allclose(getattr(ours, f).numpy(),
                                   np.asarray(getattr(theirs, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    if model == "gaussian":
        # -(x2 - 2 x.mu + m2)/2 cancels terms of size x2 = sum_s x^2 in f32
        # in both packages (each is ~1e-7 x2 from the f64 value): the two
        # are held to 1e-6 of x2, the f32 rounding of the terms
        x2 = (x * x).sum(axis=1)
        diff = np.abs(ours.loglik.numpy() - np.asarray(theirs.loglik))
        assert (diff <= 1e-6 * x2).all(), (diff / x2).max()
    if model == "quasipoisson":
        assert (ours.eta_star.numpy() == etaG).mean() > 0.9


def test_states_keep_product_order():
    st = geneassign._states(3, 2)
    np.testing.assert_array_equal(st, jga._states(3, 2))
    assert list(st[1]) == [0, 0, 1]


def test_coverage_helpers_match_jax():
    t = synth.generate(V=50, S=4, G=2, coverage=30.0, seed=1)
    total = geneassign.sample_total_coverage(t.data.counts)
    np.testing.assert_array_equal(total, jga.sample_total_coverage(t.data.counts))
    np.testing.assert_array_equal(geneassign.strain_coverage(t.gamma, total),
                                  jga.strain_coverage(t.gamma, total))


# ---- Gibbs (quality, as the JAX tests hold it) ----


def test_gibbs_agrees_with_enumeration():
    x, cov, _, _, _ = _gene_dataset(D=30)
    enum = geneassign.assign_genes(x, cov, device="cpu")
    gibbs = geneassign.assign_genes(
        x, cov, geneassign.GeneAssignConfig(state_cap=1, gibbs_sweeps=200),
        generator=torch.Generator().manual_seed(0), device="cpu")
    agree = (enum.eta_star == gibbs.eta_star).float().mean().item()
    assert agree > 0.95, agree
    gc, ec = gibbs.confidence.numpy(), enum.confidence.numpy()
    assert np.isfinite(gc).all() and ((gc >= 0) & (gc <= 1 + 1e-6)).all()
    same = (enum.eta_star == gibbs.eta_star).all(dim=1).numpy()
    assert np.abs(gc[same] - ec[same]).mean() < 0.15
    np.testing.assert_array_equal(gibbs.presence_prob.numpy(),
                                  np.clip(gibbs.copy_post_mean.numpy(), 0, 1))


def test_gibbs_large_G():
    """G=14 (2^14 > state_cap): accuracy, agreement of two seeds, and no
    state less likely than the planted truth (best of the restarts)."""
    x, cov, etaG, _, _ = _gene_dataset(D=120, S=48, G=14, mean_cov=120.0, seed=7)
    cfg = geneassign.GeneAssignConfig(gibbs_sweeps=600)
    assert 2 ** 14 > cfg.state_cap
    r0, r1 = (geneassign.assign_genes(x, cov, cfg,
                                      generator=torch.Generator().manual_seed(s),
                                      device="cpu")
              for s in (0, 1))
    e0 = r0.eta_star.numpy()
    assert (e0 == etaG).mean() > 0.99
    assert (e0 == r1.eta_star.numpy()).mean() > 0.99

    def ll(eta):
        mu = np.maximum(eta @ cov, geneassign._MU_FLOOR)
        return (x * np.log(mu)).sum(axis=1) - mu.sum(axis=1)

    deficit = ll(etaG.astype(float)) - ll(e0.astype(float))
    assert (deficit <= 1e-3).all(), deficit.max()
    conf = r0.confidence.numpy()
    assert np.isfinite(conf).all() and ((conf >= 0) & (conf <= 1 + 1e-6)).all()


def test_anneal_temperature_schedule():
    assert geneassign._anneal_temp(0, 50) == pytest.approx(30.0)
    assert geneassign._anneal_temp(50, 50) == 1.0
    assert geneassign._anneal_temp(80, 50) == 1.0
    assert 1.0 < geneassign._anneal_temp(25, 50) < 30.0


# ---- assign_gene_tau ----


def test_assign_gene_tau_enumeration_matches_jax():
    t = synth.generate(V=80, S=10, G=3, coverage=60.0, seed=2)
    star, mean = geneassign.assign_gene_tau(t.data.counts, t.gamma, t.eta,
                                            device="cpu")
    jstar, jmean = jga.assign_gene_tau(t.data.counts, t.gamma, t.eta)
    np.testing.assert_array_equal(star.numpy(), np.asarray(jstar))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)


def test_assign_gene_tau_gibbs_replays_jax():
    """The annealed path (state_cap below 4^G) fed JAX's Gumbel streams
    gives JAX's tau_star (bar float near-ties)."""
    t = synth.generate(V=80, S=10, G=3, coverage=60.0, seed=2)
    star, mean = geneassign.assign_gene_tau(
        t.data.counts, t.gamma, t.eta, sweeps=20, state_cap=4,
        noise=GeneTauReplay(0), device="cpu")
    jstar, _ = jga.assign_gene_tau(t.data.counts, t.gamma, t.eta, sweeps=20,
                                   state_cap=4)
    same = (star.numpy() == np.asarray(jstar)).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(mean.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_assign_gene_tau_enumeration_recovers_truth():
    """tests/test_geneassign.py's bar: at most 5 of 240 calls wrong."""
    t = synth.generate(V=80, S=10, G=3, coverage=60.0, seed=2)
    star, _ = geneassign.assign_gene_tau(t.data.counts, t.gamma, t.eta, sweeps=40,
                                         device="cpu")
    assert int((star.numpy() != t.tau_idx).sum()) <= 5


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_assign_gene_tau_gibbs_matches_jax_quality(kernel):
    """On its own generator the annealed path errs as often as the JAX
    package's on the same input, within 5% of the calls. (Both freeze in
    strain-exchanged states here, 64-66 of 240 calls: single-site moves
    from the plurality start do not cross between them, PERF.md.)"""
    t = synth.generate(V=80, S=10, G=3, coverage=60.0, seed=2)
    star, mean = geneassign.assign_gene_tau(t.data.counts, t.gamma, t.eta,
                                            sweeps=40, state_cap=4, kernel=kernel,
                                            device="cpu")
    jstar, _ = jga.assign_gene_tau(t.data.counts, t.gamma, t.eta, sweeps=40,
                                   state_cap=4)
    assert star.dtype == torch.int32 and mean.shape == (80, 3, 4)
    ours = int((star.numpy() != t.tau_idx).sum())
    theirs = int((np.asarray(jstar) != t.tau_idx).sum())
    assert abs(ours - theirs) <= 0.05 * t.tau_idx.size, (ours, theirs)


def test_geneassign_defaults_to_the_card():
    """assign_genes and assign_gene_tau run on CUDA unless the caller asks
    for the CPU, and raise naming cuda where there is none."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device runs")
    x, cov, _, _, _ = _gene_dataset(D=4)
    with pytest.raises(RuntimeError, match="cuda"):
        geneassign.assign_genes(x, cov)
    t = synth.generate(V=10, S=3, G=2, coverage=20.0, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        geneassign.assign_gene_tau(t.data.counts, t.gamma, t.eta)


def test_assign_gene_tau_refuses_unknown_kernel():
    t = synth.generate(V=10, S=3, G=2, coverage=20.0, seed=0)
    with pytest.raises(ValueError, match="kernel"):
        geneassign.assign_gene_tau(t.data.counts, t.gamma, t.eta,
                                   kernel="cuda_resident", device="cpu")


# ---- genecov and host I/O ----


def _genecov_data():
    t = synth.generate(V=100, S=4, G=2, coverage=30.0, seed=0)
    t.data.contigs[:60] = "c1"
    t.data.contigs[60:] = "c2"
    t.data.positions[:60] = np.arange(60)
    t.data.positions[60:] = np.arange(40)
    return t.data


def test_gene_coverage_matches_jax():
    data = _genecov_data()
    table = dict(names=["gA", "gB", "gEmpty", "gEdge"],
                 contigs=np.array(["c2", "c1", "c1", "c1"]),
                 starts=np.array([0, 10, 500, 59]), ends=np.array([40, 20, 600, 61]))
    names, cov, nps = genecov.gene_coverage(data, genecov.GeneTable(**table))
    df = jgc.gene_coverage(data, jgc.GeneTable(**table))
    assert names == list(df.index)
    np.testing.assert_array_equal(nps, df["n_positions"].to_numpy())
    np.testing.assert_allclose(cov, df[data.samples].to_numpy(), rtol=1e-12)
    assert list(nps) == [40, 10, 0, 1] and (cov[2] == 0).all()


@pytest.mark.parametrize("name,text", [
    ("genes.csv", "gene,contig,start,end\ng1,c1,0,10\ng2,c2,5,9\n"),
    ("genes.tsv", "Contig\tGene\tEnd\tStart\nc1\tg1\t10\t0\nc2\tg2\t9\t5\n"),
    ("genes.bed", "g1\tc1\t0\t10\ng2\tc2\t5\t9\n"),
], ids=["csv", "tsv_header", "headerless"])
def test_read_gene_table_matches_jax(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    ours, theirs = genecov.read_gene_table(str(path)), jgc.read_gene_table(str(path))
    assert ours.names == theirs.names == ["g1", "g2"]
    assert list(ours.contigs) == list(theirs.contigs)
    np.testing.assert_array_equal(ours.starts, theirs.starts)
    np.testing.assert_array_equal(ours.ends, theirs.ends)


@pytest.mark.parametrize("with_n_positions", [False, True])
def test_read_gene_cov_csv_matches_jax(tmp_path, with_n_positions):
    path = str(tmp_path / "gene_cov.csv")
    extra = ",n_positions" if with_n_positions else ""
    lines = [f"gene{extra},S0,S1,S2"]
    for d in range(5):
        n = f",{d + 3}" if with_n_positions else ""
        lines.append(f"g{d}{n},{d * 1.5},{d + 0.25},{7 - d}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    ours = io.read_gene_cov_csv(path)
    theirs = jio.read_gene_cov_csv(path)
    assert ours.names == list(theirs.index) and ours.columns == list(theirs.columns)
    assert ours.index_label == "gene"
    np.testing.assert_array_equal(ours.values, theirs.to_numpy(dtype=np.float64))


def test_total_cov_reader_matches_the_jax_cli(tmp_path):
    path = tmp_path / "total.csv"
    path.write_text(",total\nS0,30.5\nS1,12.25\nS2,7\n")
    np.testing.assert_array_equal(io.read_total_cov_csv(str(path)), [30.5, 12.25, 7.0])


def test_draws_npz_reads_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    tau = rng.integers(0, 4, size=(3, 20, 2))
    gamma = rng.dirichlet(np.ones(2), size=(3, 5))
    eta = rng.dirichlet(np.ones(4), size=(3, 4))
    for write, read in ((io.write_draws, jio.read_draws),
                        (jio.write_draws, io.read_draws)):
        path = str(tmp_path / f"{write.__module__}.npz")
        write(path, tau, gamma, eta, burn=10, thin=2)
        d = read(path)
        assert d["tau"].dtype == np.int8 and d["gamma"].dtype == np.float32
        assert (d["burn"], d["thin"]) == (10, 2)
        np.testing.assert_array_equal(d["tau"], tau)
        np.testing.assert_array_equal(d["eta"], eta.astype(np.float32))
        assert not os.path.exists(path + ".tmp.npz")


def test_geneassign_result_round_trips():
    x, cov, _, _, _ = _gene_dataset(D=10)
    res = geneassign.assign_genes(x, cov, device="cpu")
    d = convert.geneassign_to_numpy(res)
    back = convert.geneassign_from_numpy(d)
    assert back.eta_star.dtype == torch.int32
    for f in res._fields:
        assert torch.equal(getattr(back, f), getattr(res, f)), f
    jres = jga.assign_genes(x, cov)
    from_jax = convert.geneassign_from_numpy(
        {k: np.asarray(v) for k, v in jres._asdict().items()})
    np.testing.assert_array_equal(from_jax.eta_star.numpy(), d["eta_star"])


# ---- CLIs against the JAX CLIs ----


def _table(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array(
        [[float(v) if v else np.nan for v in r[1:]] for r in rows[1:]])


def _same_table(ours, theirs, atol=None):
    """Same header and index; values equal, or within rtol 1e-5 / atol."""
    (h0, i0, v0), (h1, i1, v1) = _table(ours), _table(theirs)
    assert (h0, i0) == (h1, i1)
    if atol is None:
        np.testing.assert_array_equal(v0, v1)
    else:
        np.testing.assert_allclose(v0, v1, rtol=1e-5, atol=atol)


@pytest.fixture(scope="module")
def ga_inputs(tmp_path_factory):
    """A gene-coverage table over a synthetic bin, its core counts, gamma,
    per-sample totals, gene variant counts and eta, as files."""
    tmp = tmp_path_factory.mktemp("ga")
    t = synth.generate(V=60, S=6, G=3, coverage=40.0, seed=3)
    core = str(tmp / "core.csv")
    io.write_counts_csv(core, t.data)
    total = geneassign.sample_total_coverage(t.data.counts)
    gamma = str(tmp / "Gamma_mean.csv")
    io.write_gamma_csv(gamma, t.gamma)
    rng = np.random.default_rng(5)
    etaG = rng.integers(0, 2, size=(25, 3))
    x = rng.poisson(etaG @ geneassign.strain_coverage(t.gamma, total) + 1e-9)
    cov_csv = str(tmp / "gene_cov.csv")
    io.write_gene_table(cov_csv, [f"gene{d}" for d in range(25)],
                        ["n_positions", *t.data.samples],
                        [np.full(25, 100), *x.T.astype(np.float64)])
    totals = tmp / "totals.csv"
    totals.write_text(",total\n" + "".join(f"{s},{v}\n" for s, v in
                                          zip(t.data.samples, total)))
    gv = synth.generate(V=40, S=6, G=3, coverage=40.0, seed=9)
    var = str(tmp / "gene_var.csv")
    io.write_counts_csv(var, gv.data)
    eta = str(tmp / "eta.csv")
    io.write_eta_csv(eta, gv.eta)
    return dict(core=core, gamma=gamma, cov=cov_csv, totals=str(totals),
                var=var, eta=eta, etaG=etaG)


@pytest.mark.parametrize("source", ["core_counts", "total_cov", "fallback"])
def test_geneassign_cli_matches_jax(ga_inputs, tmp_path, capsys, source):
    extra = {"core_counts": ["--core_counts", ga_inputs["core"]],
             "total_cov": ["-t", ga_inputs["totals"]], "fallback": []}[source]
    argv = ["-g", ga_inputs["gamma"], "-c", ga_inputs["cov"], *extra]
    ours, theirs = str(tmp_path / "ours_"), str(tmp_path / "jax_")
    assert cli.main(["geneassign", *argv, "-o", ours, "--device", "cpu"]) == 0
    warned = "WARNING" in capsys.readouterr().err
    assert jcli.main(["geneassign", *argv, "-o", theirs]) == 0
    assert warned == (source == "fallback") == ("WARNING" in capsys.readouterr().err)
    _same_table(ours + "etaS_df.csv", theirs + "etaS_df.csv")
    # the genes' logliks are ~1e3 here, where an f32 ulp is 6e-5: the
    # softmax probabilities carry that rounding
    _same_table(ours + "etaP_df.csv", theirs + "etaP_df.csv", atol=1e-4)
    _same_table(ours + "eta_conf.csv", theirs + "eta_conf.csv", atol=1e-4)
    if source != "fallback":
        _, _, etaS = _table(ours + "etaS_df.csv")
        assert (etaS == ga_inputs["etaG"]).mean() > 0.9


def test_geneassign_cli_assign_tau_matches_jax(ga_inputs, tmp_path):
    argv = ["-g", ga_inputs["gamma"], "-c", ga_inputs["cov"], "--core_counts",
            ga_inputs["core"], "--assign_tau", ga_inputs["var"], "-e", ga_inputs["eta"]]
    ours, theirs = str(tmp_path / "ours_"), str(tmp_path / "jax_")
    assert cli.main(["geneassign", *argv, "-o", ours, "--device", "cpu"]) == 0
    assert jcli.main(["geneassign", *argv, "-o", theirs]) == 0
    with open(ours + "gene_tau_star.csv") as f, open(theirs + "gene_tau_star.csv") as g:
        assert f.read() == g.read()
    np.testing.assert_allclose(io.read_tau_mean_csv(ours + "gene_tau_mean.csv"),
                               jio.read_tau_mean_csv(theirs + "gene_tau_mean.csv"),
                               rtol=1e-5, atol=1e-6)


def test_geneassign_cli_assign_tau_needs_eta(ga_inputs, tmp_path, capsys):
    rc = cli.main(["geneassign", "-g", ga_inputs["gamma"], "-c", ga_inputs["cov"],
                   "--core_counts", ga_inputs["core"], "--assign_tau",
                   ga_inputs["var"], "-o", str(tmp_path / "x_"), "--device", "cpu"])
    assert rc == 2
    assert "--assign_tau requires -e" in capsys.readouterr().err


def test_genecov_cli_matches_jax(tmp_path):
    data = _genecov_data()
    counts = str(tmp_path / "counts.csv")
    io.write_counts_csv(counts, data)
    genes = tmp_path / "genes.tsv"
    genes.write_text("gene\tcontig\tstart\tend\ngA\tc1\t10\t20\ngB\tc2\t0\t40\n"
                     "gEmpty\tc1\t500\t600\n")
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "jax.csv")
    assert cli.main(["genecov", counts, "-G", str(genes), "-o", ours]) == 0
    assert jcli.main(["genecov", counts, "-G", str(genes), "-o", theirs]) == 0
    _same_table(ours, theirs)
    # its output is geneassign's input, n_positions dropped
    m = io.read_gene_cov_csv(ours)
    assert m.columns == list(data.samples) and m.names == ["gA", "gB", "gEmpty"]


@pytest.mark.parametrize("with_gamma", [False, True])
def test_validate_cli_matches_jax(tmp_path, capsys, with_gamma):
    true = os.path.join(TESTDATA, "true_tau.csv")
    t = synth.generate(V=30, S=4, G=3, coverage=20.0, seed=0)
    p = str(tmp_path / "pred_tau.csv")
    # a prediction on a subset of the truth's positions, strains permuted,
    # with a few calls changed
    tau, contigs, positions = io.read_tau_star_csv(true)
    keep = np.arange(0, len(positions), 3)
    ptau = tau[keep][:, ::-1].copy()
    ptau[:7, 0] = (ptau[:7, 0] + 1) % 4
    io.write_tau_star_csv(p, ptau, contigs[keep], positions[keep])
    argv = ["validate", "-p", p, "-t", true]
    if with_gamma:
        g1, g2 = str(tmp_path / "g1.csv"), str(tmp_path / "g2.csv")
        io.write_gamma_csv(g1, t.gamma)
        io.write_gamma_csv(g2, t.gamma[:, ::-1] * 0.9 + 0.1 / 3)
        argv += ["--pred_gamma", g2, "--true_gamma", g1]
    assert cli.main(argv) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert ours == capsys.readouterr().out
    assert ours.splitlines()[1].split(",")[2] == "7"


@pytest.fixture(scope="module")
def diag_runs(tmp_path_factory):
    """Two G=2 runs (one with stored draws) and one G=3 run of the port."""
    tmp = tmp_path_factory.mktemp("diag")
    t = synth.generate(V=60, S=6, G=2, coverage=40.0, seed=4)
    counts = str(tmp / "counts.csv")
    io.write_counts_csv(counts, t.data)
    for g, seed, extra in ((2, 0, ["--store_every", "2"]), (2, 1, []), (3, 0, [])):
        rc = cli.main(["desman", counts, "-g", str(g), "-i", "24", "-s", str(seed),
                       "-o", str(tmp / f"run_{g}_{seed}"), "--device", "cpu", *extra])
        assert rc == 0
    return str(tmp)


def test_diag_cli_matches_jax(diag_runs, tmp_path, capsys):
    runs = os.path.join(diag_runs, "run_*")
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "jax.csv")
    assert cli.main(["diag", runs, "-o", ours]) == 0
    out = capsys.readouterr().out
    assert jcli.main(["diag", runs, "-o", theirs]) == 0
    assert out == capsys.readouterr().out.replace("jax.csv", "ours.csv")
    with open(ours) as f, open(theirs) as g:
        a, b = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert [list(r) for r in a] == [list(r) for r in b]
    for ra, rb in zip(a, b):
        for k in ra:
            if ra[k] == "" or rb[k] == "":
                assert ra[k] == rb[k], k
            else:
                assert float(ra[k]) == pytest.approx(float(rb[k]), rel=1e-9), k
    assert a[0]["draws_n_draws"] == "6" and a[1]["draws_runs"] == ""


def test_diag_cli_without_runs_exits_1(tmp_path, capsys):
    assert cli.main(["diag", str(tmp_path / "none_*")]) == 1
    assert "no run dirs" in capsys.readouterr().err


def test_gibbs_default_generator_is_seeded():
    """assign_genes' Gibbs path draws from a torch.Generator on the device;
    without one it seeds its own with 0, so two calls agree."""
    x, cov, _, _, _ = _gene_dataset(D=8)
    cfg = geneassign.GeneAssignConfig(state_cap=1, gibbs_sweeps=10)
    a, b = (geneassign.assign_genes(x, cov, cfg, device="cpu") for _ in range(2))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
