"""The port's sampler against the JAX package's: the NMF start, one sweep at
a time fed JAX's exact random streams (replay), recovery and exactness with
its own generator, and determinism."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import nmf as jnmf
from desman_tpu import sampler as js
from desman_tpu.geneassign import assign_gene_tau
from desman_tpu_torch import convert, nmf, sampler, synth
from desman_tpu_torch.utils import snp_distance_perm

from torch_helpers import (
    ReplayNoise, check_replayed_sweep, jax_state_numpy, to_torch,
)


def test_nmf_updates_match_jax():
    t = synth.generate(V=120, S=10, G=3, coverage=40.0, seed=3)
    counts = t.data.counts.astype(np.float32)
    V, S, _ = counts.shape
    rng = np.random.default_rng(0)
    W0 = rng.uniform(0.1, 1.0, size=(V * 4, 3)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, size=(3, S)).astype(np.float32)
    freq = counts / np.maximum(counts.sum(axis=2, keepdims=True), 1.0)
    F = freq.transpose(0, 2, 1).reshape(V * 4, S)

    W, H = nmf._kl_updates(torch.as_tensor(F), torch.as_tensor(W0),
                           torch.as_tensor(H0), 50)
    jW, jH = jnmf._kl_updates(jnp.asarray(F), jnp.asarray(W0), jnp.asarray(H0),
                              50)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-3, atol=1e-6)

    tau, gamma = nmf.nmf_init(torch.as_tensor(counts), 3, torch.Generator(),
                              iters=50, W0=torch.as_tensor(W0),
                              H0=torch.as_tensor(H0))
    jtau = np.asarray(jW).reshape(V, 4, 3).transpose(0, 2, 1).argmax(-1)
    assert (tau.numpy() == jtau).mean() >= 0.99
    np.testing.assert_allclose(gamma.sum(1).numpy(), 1.0, rtol=1e-6)


def _replay_case(fix_eta):
    t = synth.generate(V=96, S=12, G=3, coverage=50.0, seed=21)
    cfg_kw = dict(G=3, fix_eta=fix_eta, nmf_iters=100)
    return t, js.SamplerConfig(**cfg_kw), sampler.SamplerConfig(**cfg_kw)


@pytest.mark.parametrize("fix_eta", [False, True], ids=["joint_eta", "fix_eta"])
def test_sweep_replays_the_jax_sweep(fix_eta):
    """From one JAX state per sweep, the port's sweep fed JAX's streams
    lands where JAX's sweep lands: same tau (bar float near-ties), same MH
    decisions, gamma/eta/loglik to f32 rounding."""
    t, jcfg, pcfg = _replay_case(fix_eta)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    eta0 = jnp.asarray(t.eta, jnp.float32) if fix_eta else None
    jstate = js.init_state(n_j, jcfg, jax.random.PRNGKey(4), eta_init=eta0)
    jaccum = js.init_accum(96, 12, 3)
    jsweep = jax.jit(js.make_sweep_fn(jcfg))
    psweep = sampler.make_sweep_fn(pcfg)

    same_decisions = 0
    for it in range(10):
        jnew, jacc_new, jll = jsweep(n_j, jstate, jaccum, jnp.int32(it))
        pstate = convert.state_from_numpy(jax_state_numpy(jstate))
        paccum = convert.accum_from_numpy(jax_state_numpy(jaccum))
        pnew, pacc_new, pll = psweep(n_p, pstate, paccum, it,
                                     ReplayNoise(jstate.key))
        same_decisions += check_replayed_sweep(
            it, jax_state_numpy(jstate), jax_state_numpy(jnew),
            convert.state_to_numpy(pnew), jll, pll, jacc_new, pacc_new)
        jstate, jaccum = jnew, jacc_new
    assert same_decisions >= 9, same_decisions


def test_chain_recovers_truth():
    t = synth.generate(V=96, S=10, G=2, coverage=60.0, seed=5)
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=2, burn=30, samples=30, nmf_iters=100)
    res = sampler.run_chain(n, cfg, torch.Generator().manual_seed(0),
                            eta_init=torch.as_tensor(t.eta))
    assert snp_distance_perm(t.tau_idx, res.tau_star.numpy()) <= 4
    assert torch.isfinite(res.loglik_trace).all()
    assert res.loglik_trace.shape == (60,)


def test_gibbs_matches_exact_posterior():
    """With gamma/eta frozen, the tau chain's posterior mean matches the
    exact per-position posterior from enumerating all 4^G assignments."""
    t = synth.generate(V=24, S=3, G=2, coverage=6.0, seed=42)
    _, exact_mean = assign_gene_tau(t.data.counts, t.gamma, t.eta)
    cfg = sampler.SamplerConfig(
        G=2, burn=500, samples=4000, fix_gamma=True, fix_eta=True,
        anneal_temp0=1.0, adapt_kappa=False, nmf_iters=10)
    res = sampler.run_chain(
        torch.as_tensor(t.data.counts), cfg, torch.Generator().manual_seed(0),
        eta_init=torch.as_tensor(t.eta), gamma_init=torch.as_tensor(t.gamma))
    err = np.abs(res.tau_mean.numpy() - np.asarray(exact_mean))
    # MC error with 4000 draws of a {0,1} indicator ~ 0.008 sd; allow 5 sd
    assert err.max() < 0.05, err.max()
    assert err.mean() < 0.01, err.mean()
    np.testing.assert_allclose(res.gamma_star.numpy(), t.gamma, atol=1e-6)


def test_same_seed_same_chain():
    t = synth.generate(V=60, S=6, G=3, coverage=40.0, seed=8)
    cfg = sampler.SamplerConfig(G=3, burn=10, samples=10, nmf_iters=30)
    a, b = (convert.result_to_numpy(sampler.run_chain(
        torch.as_tensor(t.data.counts), cfg, torch.Generator().manual_seed(3)))
        for _ in range(2))
    for k, v in a.items():
        assert np.array_equal(v, b[k]), k
    c = convert.result_to_numpy(sampler.run_chain(
        torch.as_tensor(t.data.counts), cfg, torch.Generator().manual_seed(4)))
    assert not np.array_equal(a["loglik_trace"], c["loglik_trace"])


def test_state_round_trips_through_numpy():
    t, jcfg, _ = _replay_case(False)
    jstate = js.init_state(jnp.asarray(t.data.counts, jnp.float32), jcfg,
                           jax.random.PRNGKey(0))
    d = jax_state_numpy(jstate)
    st = convert.state_from_numpy(d)
    assert st.tau.dtype == torch.int32 and st.mix.dtype == torch.float32
    back = convert.state_to_numpy(st)
    assert set(back) == set(d) - {"key"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, d[k])
    acc = convert.accum_to_numpy(convert.accum_from_numpy(
        jax_state_numpy(js.init_accum(96, 12, 3))))
    assert acc["star_loglik"] == -np.inf and acc["star_tau"].dtype == np.int32


@pytest.mark.parametrize("change,match", [
    (dict(store_samples=True), "store_samples"),
    (dict(eta_update="rows"), "rows"),
])
def test_unported_modes_raise(change, match):
    """store_samples and eta_update='rows' run: the chain is finite, rows
    updates eta, and stored draws have their shapes (`match` names the
    mode)."""
    t = synth.generate(V=40, S=5, G=2, coverage=40.0, seed=2)
    cfg = dataclasses.replace(sampler.SamplerConfig(G=2, burn=4, samples=4,
                                                    nmf_iters=5), **change)
    res = sampler.run_chain(torch.as_tensor(t.data.counts), cfg,
                            torch.Generator().manual_seed(0))
    assert torch.isfinite(res.loglik_trace).all()
    if match == "store_samples":
        assert res.tau_samples.shape == (4, 40, 2)
        assert res.tau_samples.dtype == torch.int8
        assert res.gamma_samples.shape == (4, 5, 2) and res.eta_samples.shape == (4, 4, 4)
    else:
        assert res.tau_samples is None and res.eta_samples is None
        assert float(res.accept_eta) > 0


def test_known_haplotype_start_raises():
    """tau_init without gamma_init starts gamma from em_gamma and spends
    no generator draw on NMF."""
    t = synth.generate(V=40, S=5, G=2, coverage=40.0, seed=2)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    cfg = sampler.SamplerConfig(G=2, burn=2, samples=2, nmf_iters=5, fix_tau=True)
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    st = sampler.init_state(n, cfg, gen, tau_init=to_torch(t.tau_idx))
    assert torch.equal(gen.get_state(), before)
    assert torch.equal(st.tau, to_torch(t.tau_idx, torch.int32))
    assert np.abs(st.gamma.numpy() - t.gamma).mean() < 0.02
    res = sampler.run_chain(n, cfg, gen, tau_init=to_torch(t.tau_idx))
    assert torch.equal(res.tau_star, st.tau)


def test_init_state_matches_jax_given_the_same_start():
    """With tau and gamma given, the initial mixture, loglik and the kappa
    warm start match the JAX init to f32 rounding."""
    t = synth.generate(V=70, S=7, G=3, coverage=30.0, seed=6)
    cfg_j = js.SamplerConfig(G=3)
    cfg_p = sampler.SamplerConfig(G=3)
    j = jax_state_numpy(js.init_state(
        jnp.asarray(t.data.counts, jnp.float32), cfg_j, jax.random.PRNGKey(0),
        tau_init=jnp.asarray(t.tau_idx), gamma_init=jnp.asarray(t.gamma)))
    p = convert.state_to_numpy(sampler.init_state(
        torch.as_tensor(t.data.counts, dtype=torch.float32), cfg_p,
        torch.Generator(), tau_init=to_torch(t.tau_idx),
        gamma_init=to_torch(t.gamma)))
    for k in ("tau", "gamma", "eta"):
        np.testing.assert_array_equal(p[k], j[k])
    for k in ("mix", "loglik", "kappa_gamma", "kappa_eta"):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-6)
