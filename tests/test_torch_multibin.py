"""The port's multi-bin runs (``desman_tpu_torch.multibin``) against the JAX
package's (``desman_tpu.multibin``): the padding, the per-bin chains fed
JAX's streams (``ReplayNoise(fold_in(PRNGKey(seed), b))``, the key JAX's
``run_bins`` gives bin b), the accuracy gates of tests/test_multibin.py with
the port's own generators, bin b bitwise ``run_chain`` of its padded counts,
the file wrapper and the CLI; and each bin of a run against the benchmark's
plain float64 reference (``benchmark.reference.loglik``) on its own
unpadded rows.

Three bins of V = 60, 90 and 45 share S = 8 samples, as in
tests/test_multibin.py; padded to V = 90, two of them carry zero rows, and
no V is a multiple of 8. Tau may differ from JAX's only at float near-ties
(agreement >= 0.99); likelihoods agree to f32 rounding (rtol 1e-6).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import reference
from desman_tpu import multibin as jmb
from desman_tpu import sampler as js
from desman_tpu_torch import cli, convert, io, multibin, ops, sampler, synth
from desman_tpu_torch.likelihood import log_likelihood_host_f64
from desman_tpu_torch.utils import match_gamma_perm, snp_distance_perm

from torch_helpers import ReplayNoise, check_replayed_sweep, jax_state_numpy

SWEEPS = 10


@pytest.fixture(scope="module")
def bins():
    return [
        synth.generate(V=60, S=8, G=2, coverage=60.0, seed=11),
        synth.generate(V=90, S=8, G=3, coverage=60.0, seed=12),
        synth.generate(V=45, S=8, G=2, coverage=60.0, seed=13),
    ]


def _counts(bins):
    return [t.data.counts for t in bins]


def test_pad_bins_matches_jax(bins):
    ours, theirs = multibin.pad_bins(_counts(bins)), jmb.pad_bins(_counts(bins))
    assert ours.shape == (3, 90, 8, 4) and ours.dtype == theirs.dtype
    assert np.array_equal(ours, theirs)
    assert (ours[0, 60:] == 0).all() and (ours[2, 45:] == 0).all()


@pytest.mark.parametrize("bad", [
    [np.zeros((10, 4, 4), np.int32), np.zeros((10, 5, 4), np.int32)],
    [np.zeros((10, 4, 3), np.int32)],
    [],
], ids=["samples", "bases", "empty"])
def test_pad_bins_errors_match_jax(bad):
    with pytest.raises(ValueError) as theirs:
        jmb.pad_bins(bad)
    with pytest.raises(ValueError) as ours:
        multibin.pad_bins(bad)
    assert str(ours.value) == str(theirs.value)


def test_bins_replay_jax_run_bins(bins):
    """Each bin's port chain, started from JAX's start on the padded counts
    and fed bin b's JAX streams, takes JAX's decisions: from JAX's state at
    each sweep the port's sweep lands where JAX's does (tau to near-ties,
    the MH decisions on >= 9 of 10 sweeps a bin), and the port's own
    10-sweep chain ends with JAX run_bins' tau_star on >= 99% of the bin's
    positions."""
    cfg_kw = dict(G=3, burn=SWEEPS // 2, samples=SWEEPS // 2, nmf_iters=40)
    jcfg, pcfg = js.SamplerConfig(**cfg_kw), sampler.SamplerConfig(**cfg_kw)
    jres = jmb.run_bins(_counts(bins), jcfg, seed=0)
    padded = multibin.pad_bins(_counts(bins))
    jsweep = jax.jit(js.make_sweep_fn(jcfg))
    psweep = sampler.make_sweep_fn(pcfg)
    ks = ops.resolve("cuda")
    for b, t in enumerate(bins):
        V = t.data.V
        n_j = jnp.asarray(padded[b])
        n_p = torch.as_tensor(padded[b])
        key = jax.random.fold_in(jax.random.PRNGKey(0), b)
        jstate = js.init_state(n_j, jcfg, key)
        noise = ReplayNoise(jstate.key)
        # the port's own chain from JAX's start
        state, accum, trace = sampler.run_segment(
            n_p, pcfg, convert.state_from_numpy(jax_state_numpy(jstate)),
            sampler.init_accum(90, 8, 3, "cpu"), 0, SWEEPS, noise, ks)
        ours = sampler._result_from_accum(accum, pcfg, trace)
        agree = (ours.tau_star[:V].numpy() == np.asarray(jres[b].tau_star)).all(1)
        assert agree.mean() >= 0.99, (b, agree.mean())
        np.testing.assert_allclose(trace.numpy(), np.asarray(jres[b].loglik_trace),
                                   rtol=1e-5)
        # sweep by sweep from JAX's states
        jaccum = js.init_accum(90, 8, 3)
        same_decisions = 0
        for it in range(SWEEPS):
            jnew, jacc_new, jll = jsweep(n_j, jstate, jaccum, jnp.int32(it))
            pnew, pacc_new, pll = psweep(
                n_p, convert.state_from_numpy(jax_state_numpy(jstate)),
                convert.accum_from_numpy(jax_state_numpy(jaccum)), it, noise)
            same_decisions += check_replayed_sweep(
                it, jax_state_numpy(jstate), jax_state_numpy(jnew),
                convert.state_to_numpy(pnew), jll, pll, jacc_new, pacc_new)
            jstate, jaccum = jnew, jacc_new
        assert same_decisions >= SWEEPS - 1, (b, same_decisions)


def test_run_bins_recovers_each_bin(bins):
    """tests/test_multibin.py's gates, on the port's own generators."""
    cfg = sampler.SamplerConfig(G=3, burn=40, samples=40, nmf_iters=40)
    results = multibin.run_bins(_counts(bins), cfg, seed=0, device="cpu")
    assert len(results) == 3
    for t, r in zip(bins, results):
        assert r.tau_star.shape == (t.data.V, 3)
        assert r.tau_mean.shape == (t.data.V, 3, 4)
        dist = snp_distance_perm(t.tau_idx, r.tau_star.numpy())
        assert dist <= 2, f"bin SNP distance {dist}"
        mae, _ = match_gamma_perm(t.gamma, r.gamma_mean.numpy())
        # a G=3 fit of a G_true=2 bin splits one strain's mass
        assert mae < (0.05 if t.gamma.shape[1] == 3 else 0.2), mae


def test_bin_is_bitwise_run_chain_of_its_padded_counts(bins):
    """Bin b runs on a generator seeded from child b of
    SeedSequence(seed).spawn(B); its result is run_chain's on the padded
    counts with that generator, cut to the bin's V, and the padded rows
    leave the likelihood alone."""
    cfg = sampler.SamplerConfig(G=2, burn=6, samples=6, nmf_iters=20)
    results = multibin.run_bins(_counts(bins), cfg, seed=5, device="cpu")
    padded = torch.as_tensor(multibin.pad_bins(_counts(bins)))
    seeds = sampler.spawn_seeds(5, 3)
    assert len(set(seeds)) == 3
    for b, (t, r) in enumerate(zip(bins, results)):
        want = sampler.run_chain(padded[b], cfg,
                                 sampler.chain_generator(seeds[b], "cpu"))
        V = t.data.V
        for field, got, ref in zip(want._fields, r, want):
            if got is None:
                assert ref is None, field
                continue
            if field in ("tau_mean", "tau_star"):
                ref = ref[:V]
            assert torch.equal(got, ref), field
        # zero rows add nothing: the star state's loglik on the padded
        # counts is the bin's own, to f32 rounding
        star = [x.numpy() for x in (want.tau_star, want.gamma_star, want.eta_star)]
        whole = log_likelihood_host_f64(padded[b].numpy(), *star, include_coeff=False)
        own = log_likelihood_host_f64(t.data.counts, star[0][:V], *star[1:],
                                      include_coeff=False)
        np.testing.assert_allclose(whole, own, rtol=1e-12)
        np.testing.assert_allclose(float(r.star_loglik), own, rtol=1e-6)


def _write_bins(bins, tmp_path, names=None):
    files = []
    for i, t in enumerate(bins):
        f = str(tmp_path / (names[i] if names else f"bin{i}.csv"))
        os.makedirs(os.path.dirname(f), exist_ok=True)
        io.write_counts_csv(f, t.data)
        files.append(f)
    return files


def test_run_bins_files_writes_each_bin(bins, tmp_path):
    files = _write_bins(bins, tmp_path)
    outs = [str(tmp_path / f"out{i}") for i in range(3)]
    cfg = sampler.SamplerConfig(G=2, burn=10, samples=10, nmf_iters=30)
    results = multibin.run_bins_files(files, cfg, outs, seed=1, device="cpu")
    for t, r, out in zip(bins, results, outs):
        fit = io.read_fit_txt(os.path.join(out, "fit.txt"))
        assert fit["G"] == 2 and fit["V"] == t.data.V and fit["S"] == 8
        tau, contigs, positions = io.read_tau_star_csv(
            os.path.join(out, "Filtered_Tau_star.csv"))
        assert np.array_equal(tau, r.tau_star.numpy())
        assert np.array_equal(positions, t.data.positions)
        assert len(np.loadtxt(os.path.join(out, "loglik_trace.csv"))) == 20


def test_run_bins_files_errors_match_jax(bins, tmp_path):
    f0 = _write_bins(bins[:1], tmp_path)[0]
    other = synth.generate(V=30, S=8, G=2, coverage=50.0, seed=5)
    renamed = io.CountsData(counts=other.data.counts, contigs=other.data.contigs,
                            positions=other.data.positions,
                            samples=[f"x{i}" for i in range(8)])
    f1 = str(tmp_path / "b.csv")
    io.write_counts_csv(f1, renamed)
    cases = [([f0, f1], ["o0", "o1"], "sample columns differ"),
             ([f0, f0], ["o0", "o0"], "duplicate output dirs")]
    for files, outs, says in cases:
        outs = [str(tmp_path / o) for o in outs]
        with pytest.raises(ValueError) as theirs:
            jmb.run_bins_files(files, js.SamplerConfig(G=2, burn=2, samples=2), outs)
        with pytest.raises(ValueError) as ours:
            multibin.run_bins_files(files, sampler.SamplerConfig(G=2, burn=2, samples=2),
                                    outs, device="cpu")
        assert str(ours.value) == str(theirs.value) and says in str(ours.value)
    assert not os.path.exists(tmp_path / "o0")


def test_cli_keeps_colliding_basenames_apart(bins, tmp_path):
    """bin0/counts.csv and bin1/counts.csv get one directory each, named as
    the JAX CLI names them."""
    files = _write_bins(bins[:2], tmp_path, ["bin0/counts.csv", "bin1/counts.csv"])
    files.append(files[0])   # the same file twice: an index tells them apart
    stub = str(tmp_path / "runs") + os.sep
    os.makedirs(stub)
    assert cli.main(["multibin", *files, "-g", "2", "-o", stub, "-i", "10",
                     "--device", "cpu"]) == 0
    assert sorted(os.listdir(stub)) == ["bin0_counts", "bin0_counts_1", "bin1_counts"]
    for d, t in (("bin0_counts", bins[0]), ("bin1_counts", bins[1])):
        assert io.read_fit_txt(os.path.join(stub, d, "fit.txt"))["V"] == t.data.V


def test_cli_refuses_cuda_topk(bins, tmp_path, capsys):
    files = _write_bins(bins[:2], tmp_path)
    ops.reset_launches()
    rc = cli.main(["multibin", *files, "-g", "2", "-o", str(tmp_path / "o_"),
                   "--kernel", "cuda_topk", "--device", "cpu"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "cuda_topk binds to one counts tensor" in err and "use cuda or torch" in err
    assert not any(p.name.startswith("o_") for p in tmp_path.iterdir())
    assert ops.tau_sweep_topk.launches == 0 and ops.tau_sweep.launches == 0
    with pytest.raises(ValueError, match="bound to the counts"):
        multibin.run_bins(_counts(bins), sampler.SamplerConfig(G=2), kernel="cuda_topk",
                          device="cpu")


# ---- each bin against the plain float64 reference on its own rows ----

REF_V = (60, 140, 200)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """Three bins of different V (padded to 200) through run_bins_files:
    (bins, output dirs, run_bins' results)."""
    tmp = tmp_path_factory.mktemp("ref_bins")
    bins = [synth.generate(V=v, S=8, G=3, coverage=50.0, seed=31 + b)
            for b, v in enumerate(REF_V)]
    files = _write_bins(bins, tmp)
    outs = [str(tmp / f"out{b}") for b in range(len(bins))]
    cfg = sampler.SamplerConfig(G=3, burn=15, samples=15, nmf_iters=30)
    return bins, outs, multibin.run_bins_files(files, cfg, outs, seed=7, device="cpu")


@pytest.mark.parametrize("b", range(len(REF_V)))
def test_run_bins_star_loglik_is_the_reference_on_its_own_rows(ref_run, b):
    """The star loglik run_bins reports for bin b is the reference's at its
    star state over the bin's own V rows: the padded rows add nothing."""
    bins, _, results = ref_run
    r = results[b]
    assert r.tau_star.shape == (REF_V[b], 3) and r.tau_mean.shape == (REF_V[b], 3, 4)
    want = reference.loglik(bins[b].data.counts, r.tau_star.numpy(),
                            r.gamma_star.numpy(), r.eta_star.numpy())
    np.testing.assert_allclose(float(r.star_loglik), want, rtol=1e-5)


@pytest.mark.parametrize("b", range(len(REF_V)))
def test_written_star_loglik_is_the_reference_on_its_own_rows(ref_run, b):
    """What bin b's directory holds, as the benchmark's judge reads it: its
    fit.txt star loglik less the multinomial coefficients of its own rows
    is the reference's loglik at the written star state on those rows, and
    its tau has exactly the bin's V rows, its own positions in order."""
    bins, outs, _ = ref_run
    counts = bins[b].data.counts
    tau, _, positions = io.read_tau_star_csv(os.path.join(outs[b], "Filtered_Tau_star.csv"))
    assert tau.shape == (REF_V[b], 3)
    assert np.array_equal(positions, bins[b].data.positions)
    gamma = io.read_gamma_csv(os.path.join(outs[b], "Gamma_star.csv"))
    eta = io.read_eta_csv(os.path.join(outs[b], "Eta_star.csv"))
    fit = io.read_fit_txt(os.path.join(outs[b], "fit.txt"))
    assert fit["V"] == REF_V[b]
    want = reference.loglik(counts, tau, gamma, eta)
    np.testing.assert_allclose(fit["star_loglik"] - reference.coeff(counts), want,
                               rtol=1e-5)
