"""Host modules of the PyTorch port against the JAX package: file formats
both ways, the synthetic generator, the likelihoods, diagnostics and
validation."""
import gzip
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import diagnostics as jdiag
from desman_tpu import io as jio
from desman_tpu import likelihood as jlik
from desman_tpu import synth as jsynth
from desman_tpu import validation as jval
from desman_tpu.utils import one_hot_tau as j_one_hot
from desman_tpu_torch import diagnostics, io, likelihood, synth, validation
from desman_tpu_torch.utils import one_hot_tau

from torch_helpers import TESTDATA


@pytest.fixture(scope="module")
def counts_pair():
    path = os.path.join(TESTDATA, "variant_counts.csv")
    return io.read_counts_csv(path), jio.read_counts_csv(path)


def _same_counts(a, b):
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.positions, b.positions)
    assert list(map(str, a.contigs)) == list(map(str, b.contigs))
    assert list(a.samples) == list(b.samples)


def test_counts_read_like_the_jax_reader(counts_pair):
    _same_counts(*counts_pair)


def test_counts_gz_read_like_the_jax_reader(counts_pair, tmp_path):
    gz = str(tmp_path / "counts.csv.gz")
    with open(os.path.join(TESTDATA, "variant_counts.csv"), "rb") as src, \
            gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    _same_counts(io.read_counts_csv(gz), jio.read_counts_csv(gz))
    _same_counts(io.read_counts_csv(gz), counts_pair[0])


def test_counts_written_by_each_read_by_the_other(counts_pair, tmp_path):
    ours, theirs = counts_pair
    sub = ours.select(np.arange(50))
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    io.write_counts_csv(a, sub)
    jio.write_counts_csv(b, theirs.select(np.arange(50)))
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    _same_counts(jio.read_counts_csv(a), sub)


def test_counts_header_errors(tmp_path):
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w") as f:
        f.write("Contig,Position,S1-A,S1-C,S1-G,S1-X\nc,1,1,2,3,4\n")
    with pytest.raises(ValueError, match="does not look like"):
        io.read_counts_csv(bad)
    with open(bad, "w") as f:
        f.write("Contig,Position,S1-A,S1-C,S1-G,S2-T\nc,1,1,2,3,4\n")
    with pytest.raises(ValueError, match="missing base column"):
        io.read_counts_csv(bad)


def _writers(rng):
    V, S, G = 7, 3, 2
    gamma = rng.dirichlet(np.ones(G), size=S).astype(np.float32)
    eta = synth.make_eta(0.01).astype(np.float32)
    tau = rng.integers(0, 4, size=(V, G))
    tau_mean = rng.dirichlet(np.ones(4), size=(V, G)).astype(np.float32)
    contigs = np.array(["c1"] * V, dtype=object)
    positions = np.arange(V)
    samples = [f"Sample{s}" for s in range(S)]
    return [
        ("Gamma.csv", lambda m, p: m.write_gamma_csv(p, gamma, samples),
         lambda p: jio.read_gamma_csv(p), gamma),
        ("Eta.csv", lambda m, p: m.write_eta_csv(p, eta),
         lambda p: jio.read_eta_csv(p), eta),
        ("Tau_star.csv",
         lambda m, p: m.write_tau_star_csv(p, tau, contigs, positions),
         lambda p: jio.read_tau_star_csv(p)[0], tau),
        ("Tau_mean.csv",
         lambda m, p: m.write_tau_mean_csv(p, tau_mean, contigs, positions),
         lambda p: jio.read_tau_mean_csv(p), tau_mean),
        ("fit.txt",
         lambda m, p: m.write_fit_txt(p, 2, V, S, 123.25, 120.5, -60.125),
         lambda p: np.array(list(jio.read_fit_txt(p).values()), np.float64),
         np.array([2, V, S, 123.25, 120.5, -60.125])),
    ]


@pytest.mark.parametrize("case", range(5))
def test_writers_match_the_jax_writers(case, tmp_path):
    name, write, jread, want = _writers(np.random.default_rng(3))[case]
    ours, theirs = str(tmp_path / f"o_{name}"), str(tmp_path / f"j_{name}")
    write(io, ours)
    write(jio, theirs)
    with open(ours) as fo, open(theirs) as fj:
        text_o, text_j = fo.read(), fj.read()
    assert text_o.splitlines()[0] == text_j.splitlines()[0]   # headers
    got = np.asarray(jread(ours), np.float64)
    np.testing.assert_allclose(got, np.asarray(jread(theirs), np.float64),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=0,
                               atol=1e-7)


def test_readers_read_the_jax_writers(tmp_path):
    rng = np.random.default_rng(4)
    gamma = rng.dirichlet(np.ones(3), size=5)
    eta = synth.make_eta(0.02)
    tau = rng.integers(0, 4, size=(9, 3)).astype(np.int32)
    jio.write_gamma_csv(str(tmp_path / "g.csv"), gamma)
    jio.write_eta_csv(str(tmp_path / "e.csv"), eta)
    jio.write_tau_star_csv(str(tmp_path / "t.csv"), tau, ["x"] * 9, np.arange(9))
    jio.write_fit_txt(str(tmp_path / "fit.txt"), 3, 9, 5, 1.5, 2.5, -3.5)
    np.testing.assert_allclose(io.read_gamma_csv(str(tmp_path / "g.csv")),
                               gamma, rtol=0, atol=1e-12)
    np.testing.assert_allclose(io.read_eta_csv(str(tmp_path / "e.csv")), eta,
                               rtol=0, atol=1e-12)
    t, c, p = io.read_tau_star_csv(str(tmp_path / "t.csv"))
    jt, jc, jp = jio.read_tau_star_csv(str(tmp_path / "t.csv"))
    np.testing.assert_array_equal(t, tau)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p, jp)
    assert io.read_fit_txt(str(tmp_path / "fit.txt")) == jio.read_fit_txt(
        str(tmp_path / "fit.txt"))
    # the filter's tran_df that the quickstart feeds to both packages
    # (pandas' fast float parser is within an ulp or two of exact)
    tran = os.path.join(TESTDATA, "true_eta.csv")
    np.testing.assert_allclose(io.read_eta_csv(tran), jio.read_eta_csv(tran),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synth_gives_the_jax_arrays(seed):
    kw = dict(V=60, S=5, G=3, coverage=30.0, seed=seed)
    a, b = synth.generate(**kw), jsynth.generate(**kw)
    np.testing.assert_array_equal(a.tau_idx, b.tau_idx)
    np.testing.assert_array_equal(a.gamma, b.gamma)
    np.testing.assert_array_equal(a.eta, b.eta)
    np.testing.assert_array_equal(a.data.counts, b.data.counts)
    c = synth.generate(**kw, max_alleles=2)
    d = jsynth.generate(**kw, max_alleles=2)
    np.testing.assert_array_equal(c.data.counts, d.data.counts)


@pytest.fixture(scope="module")
def model():
    t = synth.generate(V=80, S=9, G=4, coverage=40.0, seed=11)
    return t.data.counts, t.tau_idx, t.gamma, t.eta


def test_device_likelihoods_match_jax(model):
    counts, tau, gamma, eta = model
    n = torch.as_tensor(counts, dtype=torch.float32)
    oh = one_hot_tau(torch.as_tensor(tau))
    g32 = torch.as_tensor(gamma, dtype=torch.float32)
    e32 = torch.as_tensor(eta, dtype=torch.float32)
    jn = jnp.asarray(counts, jnp.float32)
    joh = j_one_hot(jnp.asarray(tau))
    jg = jnp.asarray(gamma, jnp.float32)
    je = jnp.asarray(eta, jnp.float32)
    pairs = [
        (likelihood.mixture(oh, g32), jlik.mixture(joh, jg)),
        (likelihood.probs(oh, g32, e32), jlik.probs(joh, jg, je)),
        (likelihood.log_likelihood(n, oh, g32, e32),
         jlik.log_likelihood(jn, joh, jg, je)),
        (likelihood.log_likelihood(n, oh, g32, e32, include_coeff=False),
         jlik.log_likelihood(jn, joh, jg, je, include_coeff=False)),
        (likelihood.per_sample_loglik(n, oh, g32, e32),
         jlik.per_sample_loglik(jn, joh, jg, je)),
    ]
    for ours, theirs in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5)


def test_host_f64_likelihoods_are_the_same(model):
    counts, tau, gamma, eta = model
    assert likelihood.log_likelihood_host_f64(counts, tau, gamma, eta) == \
        jlik.log_likelihood_host_f64(counts, tau, gamma, eta)
    assert likelihood.total_coeff_host_f64(counts) == \
        jlik.total_coeff_host_f64(counts)


def test_diagnostics_are_the_same():
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.normal(size=(3, 300)), axis=1)
    assert diagnostics.ess_bulk(x) == jdiag.ess_bulk(x)
    assert diagnostics.ess_bulk(x[:1]) == jdiag.ess_bulk(x[:1])
    assert diagnostics.split_rhat(x) == jdiag.split_rhat(x)
    draws = {"gamma": rng.random((40, 3, 2)), "eta": rng.random((40, 4, 4))}
    assert diagnostics.draws_diagnostics(draws) == jdiag.draws_diagnostics(draws)


def test_compare_tau_is_the_same():
    rng = np.random.default_rng(5)
    true = rng.integers(0, 4, size=(100, 4))
    pred = true[:, [2, 0, 3, 1]].copy()
    pred[rng.random(pred.shape) < 0.05] = 0
    a, b = validation.compare_tau(pred, true), jval.compare_tau(pred, true)
    assert (a.snp_errors, a.error_rate) == (b.snp_errors, b.error_rate)
    np.testing.assert_array_equal(a.per_strain_errors, b.per_strain_errors)
