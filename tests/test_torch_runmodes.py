"""The run modes of the port against the JAX package's: the known-haplotype
start (``em_gamma``, ``init_state`` with tau only, ``load_tau_init``,
``-t``/``-f``), the per-row eta MH (replayed sweep by sweep on JAX's
streams) and stored draws (``store_samples``, ``--store_every``)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import io as jio
from desman_tpu import nmf as jnmf
from desman_tpu import run as jrun
from desman_tpu import sampler as js
from desman_tpu_torch import convert, io, nmf, run, sampler, synth
from desman_tpu_torch.utils import match_gamma_perm

from torch_helpers import (
    ReplayNoise, check_replayed_sweep, jax_state_numpy, to_torch,
)


# ---- the known-haplotype start ----


@pytest.mark.parametrize("eta_kind", ["default", "synth"])
def test_em_gamma_matches_jax(eta_kind):
    t = synth.generate(V=150, S=8, G=3, coverage=40.0, seed=11)
    eta = (synth.make_eta(0.01) if eta_kind == "default" else t.eta).astype(np.float32)
    ours = nmf.em_gamma(torch.as_tensor(t.data.counts, dtype=torch.float32),
                        to_torch(t.tau_idx, torch.int32), torch.as_tensor(eta))
    theirs = jnmf.em_gamma(jnp.asarray(t.data.counts, jnp.float32),
                           jnp.asarray(t.tau_idx), jnp.asarray(eta))
    assert ours.dtype == torch.float32 and ours.shape == (8, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-6)
    assert np.abs(ours.numpy() - t.gamma).mean() < 0.02


@pytest.mark.parametrize("with_eta", [False, True], ids=["default_eta", "eta_init"])
def test_init_state_with_tau_only_matches_jax(with_eta):
    t = synth.generate(V=90, S=6, G=3, coverage=40.0, seed=12)
    eta = t.eta.astype(np.float32) if with_eta else None
    j = jax_state_numpy(js.init_state(
        jnp.asarray(t.data.counts, jnp.float32), js.SamplerConfig(G=3),
        jax.random.PRNGKey(0), eta_init=None if eta is None else jnp.asarray(eta),
        tau_init=jnp.asarray(t.tau_idx)))
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    p = convert.state_to_numpy(sampler.init_state(
        torch.as_tensor(t.data.counts, dtype=torch.float32), sampler.SamplerConfig(G=3),
        gen, eta_init=None if eta is None else torch.as_tensor(eta),
        tau_init=to_torch(t.tau_idx)))
    assert torch.equal(gen.get_state(), before), "no NMF draws"
    np.testing.assert_array_equal(p["tau"], j["tau"])
    np.testing.assert_array_equal(p["eta"], j["eta"])
    np.testing.assert_allclose(p["gamma"], j["gamma"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(p["mix"], j["mix"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(p["loglik"], j["loglik"], rtol=1e-5)
    for k in ("kappa_gamma", "kappa_eta"):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-6)


def _shuffled_tau_csv(t, path, keep=None):
    idx = np.random.default_rng(0).permutation(t.data.V if keep is None else keep)
    io.write_tau_star_csv(path, t.tau_idx[idx], t.data.contigs[idx],
                          t.data.positions[idx])


def test_load_tau_init_aligns_like_jax(tmp_path):
    t = synth.generate(V=20, S=4, G=2, coverage=30.0, seed=1)
    path = str(tmp_path / "tau.csv")
    _shuffled_tau_csv(t, path)
    ours = run.load_tau_init(path, t.data)
    np.testing.assert_array_equal(ours, t.tau_idx)
    np.testing.assert_array_equal(ours, jrun.load_tau_init(path, t.data))


def test_load_tau_init_names_a_missing_position(tmp_path):
    t = synth.generate(V=20, S=4, G=2, coverage=30.0, seed=1)
    path = str(tmp_path / "tau.csv")
    _shuffled_tau_csv(t, path, keep=10)
    for load in (run.load_tau_init, jrun.load_tau_init):
        with pytest.raises(ValueError, match="missing position"):
            load(path, t.data)


@pytest.mark.parametrize("runner", ["run", "run_multi"])
def test_fix_tau_requires_tau_file(runner, tmp_path):
    t = synth.generate(V=20, S=4, G=2, coverage=30.0, seed=1)
    rc = run.RunConfig(G=2, iterations=4, out_dir=str(tmp_path / "o"), fix_tau=True)
    args = (2,) if runner == "run_multi" else ()
    with pytest.raises(ValueError, match="fix_tau requires tau_file"):
        getattr(run, runner)(t.data, rc, *args, device="cpu")


def test_fixed_tau_run_matches_jax(tmp_path):
    """desman -f on both packages: tau stays the file's, and gamma comes
    out within 0.02 of the truth without a permutation in both."""
    t = synth.generate(V=80, S=6, G=3, coverage=50.0, seed=13)
    tau_csv = str(tmp_path / "tau.csv")
    _shuffled_tau_csv(t, tau_csv)
    kw = dict(G=3, iterations=40, seed=0, tau_file=tau_csv, fix_tau=True)
    ours = run.run(t.data, run.RunConfig(out_dir=str(tmp_path / "o"), **kw),
                   device="cpu")
    theirs = jrun.run(t.data, jrun.RunConfig(out_dir=str(tmp_path / "j"), **kw))
    np.testing.assert_array_equal(ours.tau_star.numpy(), t.tau_idx)
    np.testing.assert_array_equal(np.asarray(theirs.tau_star), t.tau_idx)
    for res in (ours.gamma_mean.numpy(), np.asarray(theirs.gamma_mean)):
        assert np.abs(res - t.gamma).mean() < 0.02
    with open(tmp_path / "o" / "Filtered_Tau_star.csv") as f, \
            open(tmp_path / "j" / "Filtered_Tau_star.csv") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kernel", ["cuda", "cuda_resident"])
def test_tau_init_run_starts_from_the_file(kernel, tmp_path):
    """desman -t: the chain starts from the file's haplotypes (and samples
    them), with each kernel choice that takes it."""
    t = synth.generate(V=80, S=6, G=3, coverage=50.0, seed=13)
    tau_csv = str(tmp_path / "tau.csv")
    _shuffled_tau_csv(t, tau_csv)
    res = run.run(t.data, run.RunConfig(G=3, iterations=30, seed=0, tau_file=tau_csv,
                                        out_dir=str(tmp_path / "o")),
                  device="cpu", kernel=kernel)
    assert (res.tau_star.numpy() != t.tau_idx).mean() < 0.02
    gmae, _ = match_gamma_perm(t.gamma, res.gamma_mean.numpy())
    assert gmae < 0.02


# ---- per-row eta MH ----


def test_rows_eta_sweep_replays_jax():
    """eta_update='rows' (eta sampled), 10 sweeps, each from JAX's state
    and fed JAX's streams: JAX's decisions and values."""
    t = synth.generate(V=96, S=12, G=3, coverage=50.0, seed=21)
    kw = dict(G=3, nmf_iters=100, eta_update="rows")
    jcfg, pcfg = js.SamplerConfig(**kw), sampler.SamplerConfig(**kw)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    jstate = js.init_state(n_j, jcfg, jax.random.PRNGKey(4))
    jaccum = js.init_accum(96, 12, 3)
    jsweep = jax.jit(js.make_sweep_fn(jcfg))
    psweep = sampler.make_sweep_fn(pcfg)
    same, eta_moves = 0, 0
    for it in range(10):
        jnew, jacc_new, jll = jsweep(n_j, jstate, jaccum, jnp.int32(it))
        pstate = convert.state_from_numpy(jax_state_numpy(jstate))
        paccum = convert.accum_from_numpy(jax_state_numpy(jaccum))
        pnew, pacc_new, pll = psweep(n_p, pstate, paccum, it, ReplayNoise(jstate.key))
        same += check_replayed_sweep(
            it, jax_state_numpy(jstate), jax_state_numpy(jnew),
            convert.state_to_numpy(pnew), jll, pll, jacc_new, pacc_new)
        np.testing.assert_allclose(float(pacc_new.acc_eta), float(jacc_new.acc_eta))
        eta_moves += bool((np.asarray(jnew.eta) != np.asarray(jstate.eta)).any())
        jstate, jaccum = jnew, jacc_new
    assert same >= 9, same
    assert eta_moves > 0


@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_eta_step_matches_jax(beta):
    """One per-row step from the same state and keys, with the tempering
    beta parallel tempering passes."""
    t = synth.generate(V=60, S=5, G=2, coverage=40.0, seed=3)
    cfg_j, cfg_p = js.SamplerConfig(G=2), sampler.SamplerConfig(G=2)
    st = js.init_state(jnp.asarray(t.data.counts, jnp.float32), cfg_j,
                       jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(9)
    k_eta = jax.random.split(jax.random.fold_in(key, 0), 3)[2]
    kappa = 20.0 * float(st.kappa_eta)   # small steps: some rows accept
    jeta, jll, jacc = js.eta_step(cfg_j, jnp.asarray(t.data.counts, jnp.float32),
                                  st.mix, st.eta, st.loglik, k_eta, kappa=kappa,
                                  beta=beta)
    p = convert.state_from_numpy(jax_state_numpy(st))
    peta, pll, pacc = sampler.eta_step(
        cfg_p, torch.as_tensor(t.data.counts, dtype=torch.float32), p.mix, p.eta,
        p.loglik, torch.tensor(kappa), ReplayNoise(key), 0, beta=beta)
    assert float(pacc) == float(jacc) > 0
    np.testing.assert_allclose(peta.numpy(), np.asarray(jeta), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(pll), float(jll), rtol=1e-5)


def test_resident_path_still_refuses_sampled_rows():
    cfg = sampler.SamplerConfig(G=2, eta_update="rows")
    with pytest.raises(ValueError, match="eta_update='rows'"):
        sampler.make_sweep_fn(cfg, "cuda_resident")


# ---- stored draws ----


def _chain_states(n, cfg, seed):
    """Every sweep's state of a seeded chain, by hand from the sweep."""
    gen = torch.Generator().manual_seed(seed)
    state = sampler.init_state(n, cfg, gen)
    accum = sampler.init_accum(*n.shape[:2], cfg.G, n.device)
    sweep, noise = sampler.make_sweep_fn(cfg), sampler.TorchNoise(gen)
    states = []
    for it in range(cfg.total_sweeps):
        state, accum, _ = sweep(n, state, accum, it, noise)
        states.append(state)
    return states


@pytest.mark.parametrize("thin", [1, 3])
@pytest.mark.parametrize("eta_update", ["joint", "rows"])
def test_store_samples_keeps_the_trajectory(thin, eta_update):
    """Storing draws changes nothing of the chain (bitwise), and draw j is
    the state after sweep burn + (j+1)*thin - 1."""
    t = synth.generate(V=50, S=5, G=2, coverage=40.0, seed=14)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    base = sampler.SamplerConfig(G=2, burn=6, samples=12, nmf_iters=20,
                                 eta_update=eta_update)
    stored = dataclasses.replace(base, store_samples=True, store_thin=thin)
    a = sampler.run_chain(n, base, torch.Generator().manual_seed(5))
    b = sampler.run_chain(n, stored, torch.Generator().manual_seed(5))
    for f in a._fields:
        if getattr(a, f) is not None:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.tau_samples is None and b.tau_samples.shape == (12 // thin, 50, 2)
    states = _chain_states(n, stored, 5)
    for j in range(12 // thin):
        st = states[base.burn + (j + 1) * thin - 1]
        assert torch.equal(b.tau_samples[j], st.tau.to(torch.int8))
        assert torch.equal(b.gamma_samples[j], st.gamma)
        assert torch.equal(b.eta_samples[j], st.eta)


def test_store_thin_must_divide_samples():
    cfg = sampler.SamplerConfig(G=2, burn=2, samples=5, store_samples=True,
                                store_thin=2, nmf_iters=5)
    with pytest.raises(ValueError, match="store_thin=2 must divide samples=5"):
        sampler.run_chain(torch.ones(10, 3, 4), cfg, torch.Generator())


def test_sampler_config_store_every_error_matches_jax():
    rc = dict(G=2, iterations=30, store_every=4)
    with pytest.raises(ValueError) as ours:
        run.sampler_config(run.RunConfig(**rc))
    with pytest.raises(ValueError) as theirs:
        jrun.sampler_config(jrun.RunConfig(**rc))
    assert str(ours.value) == str(theirs.value)
    cfg = run.sampler_config(run.RunConfig(G=2, iterations=30, store_every=5))
    assert cfg.store_samples and cfg.store_thin == 5


def test_run_multi_writes_the_best_chains_draws(tmp_path):
    """--chains with --store_every: draws.npz holds the best chain's draws,
    bitwise a single run of that chain's seed."""
    import json

    t = synth.generate(V=50, S=5, G=2, coverage=40.0, seed=15)
    rc = run.RunConfig(G=2, iterations=20, seed=3, store_every=2,
                       out_dir=str(tmp_path / "multi"))
    best = run.run_multi(t.data, rc, 3, device="cpu")
    assert best.tau_samples.shape == (5, 50, 2)
    draws = jio.read_draws(str(tmp_path / "multi" / "draws.npz"))
    np.testing.assert_array_equal(draws["gamma"], best.gamma_samples.numpy())
    np.testing.assert_array_equal(draws["tau"], best.tau_samples.numpy())
    assert (draws["burn"], draws["thin"]) == (10, 2)
    with open(tmp_path / "multi" / "metrics.json") as f:
        metrics = json.load(f)
    assert "gamma_ess_min" in metrics
    single = run.run(t.data, dataclasses.replace(
        rc, seed=metrics["seed"], out_dir=str(tmp_path / "one")), device="cpu")
    for f in ("tau_samples", "gamma_samples", "eta_samples"):
        assert torch.equal(getattr(single, f), getattr(best, f)), f


def test_result_round_trips_with_and_without_draws():
    t = synth.generate(V=30, S=4, G=2, coverage=40.0, seed=16)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    for store in (False, True):
        cfg = sampler.SamplerConfig(G=2, burn=2, samples=4, nmf_iters=5,
                                    store_samples=store, store_thin=2)
        res = sampler.run_chain(n, cfg, torch.Generator().manual_seed(0))
        d = convert.result_to_numpy(res)
        assert (d["tau_samples"] is None) == (not store)
        back = convert.result_from_numpy(d)
        for f in res._fields:
            a, b = getattr(res, f), getattr(back, f)
            assert (a is None and b is None) or torch.equal(a, b), f
        if store:
            assert back.tau_samples.dtype == torch.int8
    # a JAX-style mapping whose PT swap rate is None, and one with a rate
    d["pt_swap_accept"] = None
    assert convert.result_from_numpy(d).eta_samples.shape == (2, 4, 4)
    assert convert.result_from_numpy(d).pt_swap_accept is None
    pt = sampler.run_chain_pt(n, cfg, 0, n_replicas=2)
    back = convert.result_from_numpy(convert.result_to_numpy(pt))
    assert back.pt_swap_accept.dtype == torch.float32
    assert torch.equal(back.pt_swap_accept, pt.pt_swap_accept)
