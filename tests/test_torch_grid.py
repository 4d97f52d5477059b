"""The port's strain-count grid against the JAX package's: independent
chains (``run_chains``), ``snv_uncertainty``, the selection rule
(``resolve_nhap``, ``scan_run_dirs``), ``fit_grid`` with its elastic
resume and fingerprints, and the CLI subcommands around them.

JAX's ``fit_grid`` and ``run_pipeline`` are not run here (each G is a fresh
XLA compile); the grid is held to JAX through its parts, and the port's
grid to the truth of the JAX package's pipeline test data.
"""
import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import cli as jcli
from desman_tpu import likelihood as jlik
from desman_tpu import model_selection as jms
from desman_tpu import sampler as js
from desman_tpu_torch import (
    cli, diagnostics, io, likelihood, model_selection, sampler, synth,
)


def _counts(kind="biallelic", V=40, S=5, G=2, seed=1):
    if kind == "biallelic":
        return synth.generate(V=V, S=S, G=G, coverage=40.0, seed=seed,
                              error_rate=0.0, max_alleles=2)
    return synth.generate(V=V, S=S, G=G, coverage=40.0, seed=seed)


@pytest.mark.parametrize("kernel", ["cuda", "cuda_resident", "cuda_topk"])
def test_run_chains_stacks_run_chain_of_each_seed(kernel):
    t = _counts()
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=2, burn=5, samples=5, nmf_iters=20)
    seeds = [3, 7, 0]
    res = sampler.run_chains(n, cfg, seeds, kernel=kernel)
    assert res.loglik_trace.shape == (3, 10) and res.tau_star.shape == (3, 40, 2)
    for i, seed in enumerate(seeds):
        one = sampler.run_chain(n, cfg, torch.Generator().manual_seed(seed),
                                kernel=kernel)
        for name, a, b in zip(one._fields, res, one):
            if b is None:   # no stored draws
                assert a is None, name
                continue
            assert torch.equal(a[i], b), (seed, name)
    assert not torch.equal(res.loglik_trace[0], res.loglik_trace[1])


@pytest.mark.parametrize("threshold", [0.9, 0.5, 0.99])
def test_snv_uncertainty_matches_jax(threshold):
    rng = np.random.default_rng(int(threshold * 100))
    tau_mean = rng.dirichlet(np.full(4, 0.3), size=(300, 4)).astype(np.float32)
    tau_mean[:50] = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (50, 4))]
    ours = likelihood.snv_uncertainty(torch.as_tensor(tau_mean), threshold)
    theirs = jlik.snv_uncertainty(jnp.asarray(tau_mean), threshold)
    assert ours.dtype == torch.float32
    assert float(ours) == float(theirs)


def _records(rng, pkg, veto=False):
    """A random grid of RunRecords of package pkg: deviances falling fast
    up to a true G, then flat; with veto, an uncertain G+1 step."""
    true_g = int(rng.integers(2, 6))
    out = []
    for g in range(1, 9):
        base = 1e6 / (g if g <= true_g else true_g) * (1 - 0.004 * max(g - true_g, 0))
        for seed in range(3):
            unc = 0.3 if (veto and g == true_g + 1) else float(rng.uniform(0, 0.05))
            out.append(pkg.RunRecord(G=g, seed=seed, uncertainty=unc,
                                     mean_deviance=base * (1 + 0.01 * rng.random()),
                                     run_dir=f"run_{g}_{seed}"))
    return out


@pytest.mark.parametrize("seed,veto", [(0, False), (1, False), (2, True), (3, True)])
def test_resolve_nhap_picks_what_jax_picks(seed, veto):
    ours = model_selection.resolve_nhap(_records(np.random.default_rng(seed),
                                                 model_selection, veto))
    theirs = jms.resolve_nhap(_records(np.random.default_rng(seed), jms, veto))
    assert ours.summary_line() == theirs.summary_line()
    assert (ours.G, ours.seed, ours.run_dir) == (theirs.G, theirs.seed, theirs.run_dir)


def test_run_fingerprint_and_digest_match_jax():
    t = _counts()
    eta = synth.make_eta(0.02)
    for counts, e in ((t.data.counts, eta), (t.data.counts, None)):
        assert model_selection._data_digest(counts, e) == jms._data_digest(counts, e)
    digest = model_selection._data_digest(t.data.counts, eta)
    for kw in (dict(G=3, burn=10, samples=20), dict(G=2, fix_eta=True, kappa_eta=5.0)):
        assert model_selection.run_fingerprint(digest, sampler.SamplerConfig(**kw), 4) \
            == jms.run_fingerprint(digest, js.SamplerConfig(**kw), 4)


@pytest.fixture(scope="module")
def pipeline_data():
    """The data of tests/test_pipeline.py::test_pipeline_end_to_end."""
    return synth.generate(V=150, S=10, G=2, coverage=60.0, seed=21)


@pytest.mark.parametrize("kernel", ["cuda", "cuda_resident"])
def test_fit_grid_selects_the_true_G(pipeline_data, kernel):
    records = model_selection.fit_grid(
        pipeline_data.data.counts, g_values=[1, 2, 3], seeds=[0, 1],
        iterations=60, kernel=kernel, device="cpu")
    assert [(r.G, r.seed) for r in records] == [(g, s) for g in (1, 2, 3) for s in (0, 1)]
    assert all(np.isfinite(r.mean_deviance) for r in records)
    assert model_selection.resolve_nhap(records).G == 2


@pytest.fixture(scope="module")
def grid_dirs(tmp_path_factory, pipeline_data):
    out = tmp_path_factory.mktemp("grid")
    stub = str(out / "run")
    records = model_selection.fit_grid(
        pipeline_data.data.counts, g_values=[1, 2], seeds=[0, 1], iterations=20,
        eta_init=pipeline_data.eta, fix_eta=True, out_stub=stub,
        data=pipeline_data.data, device="cpu")
    return stub, records


def test_grid_dirs_scan_like_jax(grid_dirs):
    stub, records = grid_dirs
    dirs = [r.run_dir for r in records]
    ours = model_selection.scan_run_dirs(dirs)
    theirs = jms.scan_run_dirs(dirs)
    assert [(r.G, r.seed, r.run_dir) for r in ours] == \
        [(r.G, r.seed, r.run_dir) for r in theirs]
    for a, b, r in zip(ours, theirs, records):
        assert a.uncertainty == b.uncertainty == r.uncertainty
        assert a.mean_deviance == b.mean_deviance
        assert abs(a.mean_deviance - r.mean_deviance) < 1e-6  # fit.txt's %.6f
    with open(os.path.join(dirs[0], "metrics.json")) as f:
        m = json.load(f)
    assert m["seed"] == 0 and m["kernel"] == "cuda" and len(m["config_fingerprint"]) == 16


def test_fit_grid_resumes_finished_runs(grid_dirs, pipeline_data, monkeypatch):
    stub, records = grid_dirs
    calls = []
    real = model_selection.run_chains

    def counted(n, cfg, seeds, **kw):
        calls.append(cfg.G)
        return real(n, cfg, seeds, **kw)

    monkeypatch.setattr(model_selection, "run_chains", counted)
    kw = dict(g_values=[1, 2], seeds=[0, 1], eta_init=pipeline_data.eta, fix_eta=True,
              out_stub=stub, data=pipeline_data.data, device="cpu")
    again = model_selection.fit_grid(pipeline_data.data.counts, iterations=20, **kw)
    assert calls == []
    assert [(r.G, r.seed, r.run_dir) for r in again] == \
        [(r.G, r.seed, r.run_dir) for r in records]
    # a missing run dir recomputes its G only
    os.remove(os.path.join(f"{stub}_2_1", "fit.txt"))
    model_selection.fit_grid(pipeline_data.data.counts, iterations=20, **kw)
    assert calls == [2]
    # another iteration count is another config: everything recomputes
    model_selection.fit_grid(pipeline_data.data.counts, iterations=22, **kw)
    assert calls == [2, 1, 2]
    model_selection.fit_grid(pipeline_data.data.counts, iterations=22, resume=False,
                             **kw)
    assert calls == [2, 1, 2, 1, 2]


@pytest.mark.parametrize("kw,item", [(dict(mesh=object()), "item 14"),
                                     (dict(ess_target=100.0), "item 11")])
def test_fit_grid_refuses_unported_modes(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        model_selection.fit_grid(np.ones((4, 2, 4)), [1], [0], device="cpu", **kw)


def test_replicate_agreement_matches_jax():
    from desman_tpu.diagnostics import replicate_agreement

    rng = np.random.default_rng(5)
    taus = [rng.integers(0, 4, size=(60, 3)) for _ in range(4)]
    taus.append(taus[0][:, ::-1].copy())   # a relabelling: distance 0
    ours = diagnostics.replicate_agreement(taus)
    assert np.array_equal(ours, replicate_agreement(taus))
    assert ours[0, 4] == 0


# ---- the CLI subcommands on the CPU ----


@pytest.fixture(scope="module")
def pipeline_out(tmp_path_factory, pipeline_data):
    tmp = tmp_path_factory.mktemp("pipeline")
    counts = str(tmp / "counts.csv")
    io.write_counts_csv(counts, pipeline_data.data)
    config = tmp / "config.json"
    config.write_text(json.dumps({
        "counts": counts, "output_dir": str(tmp / "out"),
        "grid": {"g_min": 1, "g_max": 3, "seeds": [0, 1], "iterations": 60},
    }))
    rc = cli.main(["pipeline", str(config), "--device", "cpu"])
    return rc, str(tmp / "out"), counts


def test_pipeline_cli_selects_the_true_G(pipeline_out):
    rc, out, _ = pipeline_out
    assert rc == 0
    for f in ("tran_df.csv", "sel_var.csv", "p_df.csv", "q_df.csv",
              "collated_fits.csv", "best.txt", "pipeline_summary.json", "run_2_1"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "pipeline_summary.json")) as f:
        summary = json.load(f)
    assert summary["selected_G"] == 2 and summary["grid_runs"] == 6
    with open(os.path.join(out, "collated_fits.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["G"] for r in rows] == ["1", "1", "2", "2", "3", "3"]
    assert list(rows[0]) == ["G", "seed", "mean_deviance", "uncertainty", "run_dir"]


def test_resolvenhap_cli_picks_best_txt(pipeline_out, tmp_path, capsys):
    _, out, _ = pipeline_out
    picked = str(tmp_path / "picked.csv")
    copy = tmp_path / "chosen"
    rc = cli.main(["resolvenhap", os.path.join(out, "run_*"), "-o", picked,
                   "-c", str(copy)])
    assert rc == 0
    with open(picked) as f, open(os.path.join(out, "best.txt")) as g:
        assert f.read() == g.read()
    assert (copy / "Filtered_Tau_star.csv").exists() and (copy / "fit.txt").exists()
    # the JAX CLI picks the same run from the same dirs
    capsys.readouterr()
    assert jcli.main(["resolvenhap", os.path.join(out, "run_*")]) == 0
    with open(picked) as f:
        assert capsys.readouterr().out.splitlines() == f.read().splitlines()


def test_collate_cli_matches_the_jax_collate(pipeline_out, tmp_path):
    _, out, _ = pipeline_out
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "theirs.csv")
    assert cli.main(["collate", os.path.join(out, "run_*"), "-o", ours]) == 0
    assert jcli.main(["collate", os.path.join(out, "run_*"), "-o", theirs]) == 0

    def rows(path):
        with open(path) as f:
            return sorted(tuple(r.items()) for r in csv.DictReader(f))

    assert rows(ours) == rows(theirs)
    with open(ours) as f:
        assert [r["G"] for r in csv.DictReader(f)] == ["1", "1", "2", "2", "3", "3"]


def test_pipeline_refuses_the_genes_stage(pipeline_out, tmp_path):
    """The genes stage runs: it assigns the accessory
    genes to the selected run's strains as the JAX package's assign_genes
    does on the same gamma, with each sample's total coverage from all the
    input counts."""
    from desman_tpu.geneassign import assign_genes as jax_assign_genes
    from desman_tpu_torch.geneassign import sample_total_coverage, strain_coverage

    _, grid_out, counts = pipeline_out
    data = io.read_counts_csv(counts)
    with open(os.path.join(grid_out, "pipeline_summary.json")) as f:
        best = json.load(f)["best_run_dir"]
    gamma = io.read_gamma_csv(os.path.join(best, "Gamma_mean.csv"))
    cov = strain_coverage(gamma, sample_total_coverage(data.counts))
    rng = np.random.default_rng(3)
    etaG = rng.integers(0, 2, size=(30, gamma.shape[1]))
    etaG[etaG.sum(axis=1) == 0, 0] = 1
    x = rng.poisson(etaG @ cov).astype(np.float64)
    gene_cov = str(tmp_path / "gene_cov.csv")
    io.write_gene_table(gene_cov, [f"gene{d}" for d in range(30)],
                        ["n_positions", *data.samples],
                        [np.full(30, 50), *x.T], "gene")
    # the grid's run dirs are reused (elastic resume): only genes is new
    config = tmp_path / "config.json"
    config.write_text(json.dumps({
        "counts": counts, "output_dir": grid_out,
        "grid": {"g_min": 1, "g_max": 3, "seeds": [0, 1], "iterations": 60},
        "genes": {"coverage_csv": gene_cov}}))
    assert cli.main(["pipeline", str(config), "--device", "cpu"]) == 0
    with open(os.path.join(grid_out, "pipeline_summary.json")) as f:
        summary = json.load(f)
    assert summary["genes_assigned"] == 30 and summary["best_run_dir"] == best
    want = jax_assign_genes(x, cov)
    etaS = io.read_gene_cov_csv(os.path.join(grid_out, "geneassign_etaS_df.csv"))
    etaP = io.read_gene_cov_csv(os.path.join(grid_out, "geneassign_etaP_df.csv"))
    assert etaS.names == [f"gene{d}" for d in range(30)] and etaS.index_label == "gene"
    np.testing.assert_array_equal(etaS.values, np.asarray(want.eta_star))
    np.testing.assert_allclose(etaP.values, np.asarray(want.presence_prob),
                               rtol=1e-5, atol=1e-4)
    assert (etaS.values == etaG).mean() > 0.9


def test_desman_chains_cli_writes_the_best_chain(tmp_path):
    t = _counts(V=60, S=6, G=2, seed=4)
    counts = str(tmp_path / "counts.csv")
    io.write_counts_csv(counts, t.data)
    out = tmp_path / "out"
    rc = cli.main(["desman", counts, "-g", "2", "-i", "20", "-s", "5",
                   "--chains", "2", "--kernel", "cuda_topk", "--device", "cpu",
                   "-o", str(out)])
    assert rc == 0
    with open(out / "chains.json") as f:
        chains = json.load(f)
    assert chains["seeds"] == [5, 6]
    best = chains["seeds"].index(chains["best_seed"])
    assert chains["star_logliks"][best] == max(chains["star_logliks"])
    assert np.asarray(chains["tau_star_pairwise_snp"]).shape == (2, 2)
    assert np.isfinite(chains["loglik_split_rhat"]) and np.isfinite(chains["loglik_ess_bulk"])
    # the written outputs are the best seed's own chain
    cfg = sampler.SamplerConfig(G=2, burn=10, samples=10)
    one = sampler.run_chain(torch.as_tensor(t.data.counts), cfg,
                            torch.Generator().manual_seed(chains["best_seed"]),
                            kernel="cuda_topk")
    tau, _, _ = io.read_tau_star_csv(str(out / "Filtered_Tau_star.csv"))
    assert np.array_equal(tau, one.tau_star.numpy())
    np.testing.assert_allclose(np.loadtxt(out / "loglik_trace.csv", delimiter=","),
                               one.loglik_trace.numpy())
    with open(out / "metrics.json") as f:
        assert json.load(f)["seed"] == chains["best_seed"]
