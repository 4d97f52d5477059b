"""Parallel tempering in the port (desman_tpu_torch.sampler's PT ensemble)
on the CPU, against the JAX package: one PT step at a time fed JAX's exact
streams (each replica's ReplayNoise, the exchange's uniforms), the tempered
MH steps one by one, the cold rung against the enumerated posterior, the
mode-crossing case, the ensemble's invariants, run_chains_pt and the cold
rung's stored draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import sampler as js
from desman_tpu_torch import convert, ops, sampler, synth
from desman_tpu_torch.geneassign import assign_gene_tau
from desman_tpu_torch.utils import snp_distance_perm

from torch_helpers import (
    ReplayExchange, ReplayNoise, check_replayed_sweep, jax_state_numpy, stack, to_jax,
    to_torch, unstack,
)

R = 4


def _replica(tree, i):
    return {k: np.asarray(v)[i] for k, v in tree._asdict().items()}


def _same(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


# ---- replay of JAX's PT step ----


def test_pt_step_replays_the_jax_step():
    """From JAX's ensemble before each of 10 sweeps (V=200 S=8 G=3 R=4,
    burn 5: adapting and accumulating sweeps both), the port's PT step fed
    each replica's JAX stream and JAX's exchange uniforms takes JAX's
    exchange decisions on every sweep: the rung permutation, n_acc and
    n_heads equal, cold_ll to rtol 1e-5. Every replica passes
    check_replayed_sweep's gates and the accumulators match to rtol 1e-5.
    Its MH decisions agree on all four replicas in at least 9 of the 10
    sweeps: on this input sweep 4's T=8 replica differs in its eta step,
    where the Dirichlet log-densities at kappa_eta = 5.6e4 take lgamma of
    5.6e5, whose f32 ulp (0.0625) XLA's and torch's lgamma round apart,
    moving the log ratio by about 0.25 nats."""
    t = synth.generate(V=200, S=8, G=3, coverage=40.0, seed=11)
    kw = dict(G=3, burn=5, samples=5, nmf_iters=30)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    key = jax.random.PRNGKey(5)
    jcfg, pcfg = js.SamplerConfig(**kw), sampler.SamplerConfig(**kw)
    carry = jax.jit(js.pt_init, static_argnums=(1, 3))(n_j, jcfg, key, R)
    jstep = jax.jit(js.make_pt_step(n_j, jcfg, key, R, 8.0))
    pstep = sampler.make_pt_step(n_p, pcfg, R, 8.0, "cuda")
    exchange = [ReplayExchange(key)]
    agreed = 0
    for it in range(10):
        jst, jac, jrung = carry
        carry, (jcold, jnacc, jnheads) = jstep(carry, jnp.int32(it))
        jst2, jac2, jrung2 = carry
        state = convert.state_from_numpy(jax_state_numpy(jst))
        accum = convert.accum_from_numpy(jax_state_numpy(jac))
        noise = sampler.ChainNoise(ReplayNoise(jst.key[i]) for i in range(R))
        pst, pac, prung, pcold, pnacc, pnheads = pstep(
            state, accum, torch.as_tensor(np.array(jrung), dtype=torch.int64),
            it, noise, exchange)
        pst, pac = unstack(pst), unstack(pac)
        np.testing.assert_array_equal(prung.numpy(), np.asarray(jrung2))
        assert float(pnacc) == float(jnacc) and pnheads == float(jnheads)
        np.testing.assert_allclose(float(pcold), float(jcold), rtol=1e-5)
        ok = True
        for i in range(R):
            want = _replica(jst2, i)
            ok &= check_replayed_sweep(
                it, _replica(jst, i), want, convert.state_to_numpy(pst[i]),
                want["loglik"], pst[i].loglik, jax.tree_util.tree_map(
                    lambda x: x[i], jac2), pac[i])
            for k, v in convert.accum_to_numpy(pac[i]).items():
                np.testing.assert_allclose(v, _replica(jac2, i)[k], rtol=1e-5,
                                           err_msg=f"sweep {it} replica {i}: {k}")
        agreed += ok
    assert agreed >= 9, agreed


# ---- the tempered MH steps (beta = 0.5) against JAX's ----

BETA = 0.5


@pytest.fixture(scope="module")
def tempered_case():
    """A port state and the JAX streams of one chain key."""
    t = synth.generate(V=150, S=10, G=3, coverage=40.0, seed=12)
    kw = dict(G=3, nmf_iters=30)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    state = sampler.init_state(n, sampler.SamplerConfig(**kw),
                               sampler.chain_generator(2, "cpu"))
    return (t, js.SamplerConfig(**kw), sampler.SamplerConfig(**kw), state,
            ReplayNoise(jax.random.PRNGKey(2)))


def test_tempered_gamma_step_matches_jax(tempered_case):
    t, jcfg, pcfg, st, noise = tempered_case
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    accepts = []
    for it in range(4):
        k_gamma = noise._keys(it)[1]
        jg, jmix, jacc, jll = jax.jit(js.gamma_step, static_argnums=0)(
            jcfg, to_jax(n), to_jax(st.tau), to_jax(st.mix), to_jax(st.gamma),
            to_jax(st.eta), k_gamma, kappa=to_jax(st.kappa_gamma), beta=BETA)
        pg, pmix, pacc, pll = sampler.gamma_step(
            pcfg, n, st.tau, st.mix, st.gamma, st.eta, st.kappa_gamma, noise, it,
            beta=torch.tensor(BETA))
        assert float(pacc) == float(jacc)
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5)
        np.testing.assert_allclose(pmix.numpy(), np.asarray(jmix), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(pll), float(jll), rtol=1e-5)
        accepts.append(float(pacc))
    # the tempered ratio accepts more than the cold one on the same noise
    cold = [float(sampler.gamma_step(pcfg, n, st.tau, st.mix, st.gamma, st.eta,
                                     st.kappa_gamma, noise, it)[2]) for it in range(4)]
    assert 0 < sum(accepts) and sum(cold) <= sum(accepts)


def test_tempered_eta_step_matches_jax(tempered_case):
    t, jcfg, pcfg, st, noise = tempered_case
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    for it in range(4):
        k_eta = noise._keys(it)[2]
        je, jll, jacc = jax.jit(js.eta_step_joint, static_argnums=0)(
            jcfg, to_jax(n), to_jax(st.mix), to_jax(st.eta), to_jax(st.loglik), k_eta,
            kappa=to_jax(st.kappa_eta), beta=BETA)
        pe, pll, pacc = sampler.eta_step_joint(
            pcfg, n, st.mix, st.eta, st.loglik, st.kappa_eta, noise, it,
            beta=torch.tensor(BETA))
        assert float(pacc) == float(jacc)
        np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-5)
        np.testing.assert_allclose(float(pll), float(jll), rtol=1e-5)


def test_tempered_swap_matches_jax(tempered_case):
    """The port's swap at beta compares logu / beta < dll (the Pallas
    swap's threshold), JAX's XLA swap logu < beta * dll: the same decision
    but at float near-ties."""
    t, jcfg, pcfg, st, noise = tempered_case
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    V = n.shape[0]
    for it in range(4):
        k_swap = jax.random.fold_in(noise._keys(it)[0], 12345)
        jtau, jmix = jax.jit(js.tau_swap_move)(to_jax(n), to_jax(st.tau), to_jax(st.mix),
                                      to_jax(st.gamma), to_jax(st.eta), k_swap,
                                      beta=BETA)
        g, h, logu = noise.swap(it, V, 3)
        ptau, pmix = ops.swap(n, st.tau, st.mix, st.gamma, st.eta, g, h,
                              logu / torch.tensor(BETA))
        same = (ptau.numpy() == np.asarray(jtau)).all(axis=1)
        assert same.mean() >= 0.99
        np.testing.assert_allclose(pmix.numpy()[same], np.asarray(jmix)[same],
                                   rtol=1e-5, atol=1e-6)


# ---- the cold rung's target ----


def test_pt_matches_exact_posterior():
    """With gamma/eta frozen (tests/test_pt.py's setup, 2000 sampling
    sweeps), the cold rung's tau posterior mean matches the enumerated
    posterior within JAX's tolerance: max 0.05, mean 0.01."""
    t = synth.generate(V=24, S=3, G=2, coverage=6.0, seed=42)
    _, exact = assign_gene_tau(t.data.counts, t.gamma, t.eta, device="cpu")
    cfg = sampler.SamplerConfig(G=2, burn=200, samples=2000, fix_gamma=True,
                                fix_eta=True, anneal_temp0=1.0, adapt_kappa=False,
                                nmf_iters=10)
    res = sampler.run_chain_pt(
        torch.as_tensor(t.data.counts), cfg, 0, n_replicas=3, max_temp=4.0,
        eta_init=torch.as_tensor(t.eta), gamma_init=torch.as_tensor(t.gamma),
        kernel="cuda")
    err = np.abs(res.tau_mean.numpy() - np.asarray(exact))
    assert err.max() < 0.05, err.max()
    assert err.mean() < 0.01, err.mean()
    assert 0.0 < float(res.pt_swap_accept) <= 1.0


def test_pt_crosses_modes_plain_gibbs_cannot():
    """tests/test_pt.py's case: started half label-swapped with the swap
    move off, plain Gibbs stays pinned; PT's hot rungs cross the
    both-strains-same-base valley and its star ends within 2 SNPs of the
    truth, well above plain's."""
    rng = np.random.default_rng(3)
    V, S, G = 40, 4, 2
    tau_idx = rng.integers(0, 4, size=(V, G))
    same = tau_idx[:, 0] == tau_idx[:, 1]
    tau_idx[same, 1] = (tau_idx[same, 0] + 1) % 4
    gamma = np.tile(np.array([0.8, 0.2]), (S, 1))
    eta = np.full((4, 4), 0.01 / 3) + np.eye(4) * (0.99 - 0.01 / 3)
    probs = np.einsum("vsa,ab->vsb",
                      np.einsum("vga,sg->vsa", np.eye(4)[tau_idx], gamma), eta)
    counts = torch.as_tensor(rng.poisson(5.0 * probs), dtype=torch.float32)
    tau0 = tau_idx.copy()
    tau0[V // 2:] = tau0[V // 2:, ::-1]
    common = dict(eta_init=to_torch(eta, torch.float32),
                  gamma_init=to_torch(gamma, torch.float32),
                  tau_init=to_torch(tau0, torch.int32))
    cfg = sampler.SamplerConfig(G=2, burn=200, samples=200, nmf_iters=0,
                                anneal_temp0=1.0, swap_moves=False,
                                fix_gamma=True, fix_eta=True)
    plain = sampler.run_chain(counts, cfg, sampler.chain_generator(0, "cpu"), **common)
    pt = sampler.run_chain_pt(counts, cfg, 0, n_replicas=6, max_temp=16.0, **common)
    d_plain = snp_distance_perm(tau_idx, plain.tau_star.numpy())
    d_pt = snp_distance_perm(tau_idx, pt.tau_star.numpy())
    assert d_pt <= 2, (d_pt, d_plain)
    assert d_plain > d_pt, (d_plain, d_pt)
    assert float(pt.star_loglik) > float(plain.star_loglik) + 5.0


# ---- the ensemble's invariants ----


@pytest.fixture(scope="module")
def frozen():
    """Four replicas whose sweeps change nothing (tau, gamma and eta fixed)
    and whose logliks rise with the rung, so that every proposed exchange
    is accepted; distinct kappas a replica."""
    t = synth.generate(V=50, S=5, G=2, coverage=30.0, seed=13)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    cfg = sampler.SamplerConfig(G=2, burn=0, samples=4, nmf_iters=5, fix_tau=True,
                                fix_gamma=True, fix_eta=True, adapt_kappa=False)
    gens = [sampler.chain_generator(s, "cpu") for s in range(8)]
    states = sorted((sampler.init_state(n, cfg, g) for g in gens),
                    key=lambda s: float(s.loglik))[::2]
    assert len({float(s.loglik) for s in states}) == 4
    states = [s._replace(kappa_gamma=torch.tensor(100.0 * (i + 1)),
                         kappa_eta=torch.tensor(1000.0 * (i + 1)))
              for i, s in enumerate(states)]
    accums = [sampler.init_accum(50, 5, 2, "cpu") for _ in range(4)]
    noises = [sampler.TorchNoise(g) for g in gens[:4]]
    return n, cfg, states, accums, noises


def _ensemble(states, accums, noises):
    """The replicas' lists as the PT step takes them: on a leading axis."""
    return (stack(states), stack(accums),
            sampler.ChainNoise(noises))


class Accept:
    """An exchange source whose every uniform accepts a delta >= -27."""

    def exchange_u(self, it, R):
        return torch.zeros(R)


def test_hot_replicas_keep_their_accumulators(frozen):
    """(a) Only the replica on rung 0 accumulates; the others keep their
    pre-sweep accumulators, star included."""
    n, cfg, states, accums, noises = frozen
    step = sampler.make_pt_step(n, cfg, 4, 8.0, "cuda")
    st, ac, noise = _ensemble(states, accums, noises)
    _, new, _, _, _, _ = step(st, ac, torch.tensor([2, 0, 3, 1]), 0, noise, [Accept()])
    new = unstack(new)
    assert float(new[1].n_samples) == 1.0
    assert float(new[1].star_loglik) == float(states[1].loglik)
    assert torch.equal(new[1].star_tau, states[1].tau)
    for i in (0, 2, 3):
        assert _same(new[i], accums[i]), i


def test_exchange_moves_rungs_kappas_and_records_the_pre_exchange_cold(frozen):
    """(b) cold_ll is the loglik of the replica cold during the sweep;
    (d) the kappas stay with the rung; (e) heads alternate parity: sweep 0
    exchanges rungs (0,1) and (2,3), sweep 1 rungs (1,2)."""
    n, cfg, states, accums, noises = frozen
    step = sampler.make_pt_step(n, cfg, 4, 8.0, "cuda")
    rung = torch.arange(4)
    kg = [float(s.kappa_gamma) for s in states]
    st0, ac, noise = _ensemble(states, accums, noises)
    st, _, rung1, cold, n_acc, heads = step(st0, ac, rung, 0, noise, [Accept()])
    assert rung1.tolist() == [1, 0, 3, 2] and (float(n_acc), heads) == (2.0, 2)
    assert float(cold) == float(states[0].loglik)
    # rung r keeps the kappa it had: replica 0, now on rung 1, has rung 1's
    assert st.kappa_gamma.tolist() == [kg[1], kg[0], kg[3], kg[2]]
    assert st.kappa_eta.tolist() == [2000.0, 1000.0, 4000.0, 3000.0]
    st, _, rung2, cold, n_acc, heads = step(st, ac, rung1, 1, noise, [Accept()])
    assert rung2.tolist() == [2, 0, 3, 1] and (float(n_acc), heads) == (1.0, 1)
    assert float(cold) == float(states[1].loglik)
    by_rung = [float(st.kappa_gamma[int(i)]) for i in torch.argsort(rung2)]
    assert by_rung == kg


def test_stored_draw_is_the_post_exchange_cold_replica(frozen):
    """(c) A stored draw comes from the replica on rung 0 after the
    sweep's exchange."""
    n, cfg, states, accums, noises = frozen
    cfg = dataclasses.replace(cfg, store_samples=True, store_thin=1)
    st, ac, noise = _ensemble(states, accums, noises)
    out = sampler.run_pt_segment(n, cfg, st, ac, torch.arange(4), 0, 1,
                                 noise, [Accept()], 8.0, "cuda", store=True)
    assert out[2].tolist() == [1, 0, 3, 2]
    tau_s, gamma_s, eta_s = out[6]
    assert torch.equal(tau_s[0], states[1].tau.to(torch.int8))
    assert not torch.equal(tau_s[0], states[0].tau.to(torch.int8))
    assert torch.equal(gamma_s[0], states[1].gamma)
    assert float(out[3][0]) == float(states[0].loglik)   # the trace: (b)


def test_swap_rate_is_per_proposal():
    """(e) With R=2 only even sweeps propose: 10 sweeps of exchanges that
    always accept give a rate of 1, not 1/2."""
    t = synth.generate(V=30, S=4, G=2, coverage=30.0, seed=14)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    cfg = sampler.SamplerConfig(G=2, burn=0, samples=10, nmf_iters=5, fix_tau=True,
                                fix_gamma=True, fix_eta=True)
    st = sampler.init_state(n, cfg, sampler.chain_generator(0, "cpu"))
    out = sampler.run_pt_segment(
        n, cfg, stack([st, st]), sampler.init_accum(30, 4, 2, "cpu", chains=2),
        torch.arange(2), 0, 10, sampler.ChainNoise(
            sampler.TorchNoise(sampler.chain_generator(i, "cpu")) for i in (1, 2)),
        [Accept()], 8.0, "cuda")
    assert (float(out[4]), out[5]) == (5.0, 5)
    assert float(sampler.pt_swap_rate(out[4], out[5])) == 1.0


@pytest.fixture(scope="module")
def small():
    t = synth.generate(V=60, S=6, G=2, coverage=40.0, seed=1)
    return t, torch.as_tensor(t.data.counts)


def test_one_replica_is_run_chain(small):
    """(f) R < 2 falls back to run_chain from a generator seeded `seed`."""
    _, n = small
    cfg = sampler.SamplerConfig(G=2, burn=6, samples=6, nmf_iters=10)
    ref = sampler.run_chain(n, cfg, sampler.chain_generator(3, "cpu"))
    for R_ in (0, 1):
        got = sampler.run_chain_pt(n, cfg, 3, n_replicas=R_)
        assert got.pt_swap_accept is None and _same(ref, got)


def test_seeds_are_distinct_across_chains():
    seeds = [s for c in range(4) for s in sampler.pt_seeds(c, 4)]
    assert len(set(seeds)) == len(seeds) == 20
    assert sampler.pt_seeds(7, 3) == sampler.pt_seeds(7, 3)


def test_run_chains_pt_is_each_seeds_run_chain_pt(small):
    _, n = small
    cfg = sampler.SamplerConfig(G=2, burn=5, samples=5, nmf_iters=10)
    res = sampler.run_chains_pt(n, cfg, [4, 9], n_replicas=3, max_temp=4.0)
    assert res.pt_swap_accept.shape == (2,)
    for i, seed in enumerate((4, 9)):
        one = sampler.run_chain_pt(n, cfg, seed, n_replicas=3, max_temp=4.0)
        assert _same(sampler.chain_result(res, i), one), seed


def test_stored_cold_draws_leave_the_trajectory_alone(small):
    t, n = small
    kw = dict(G=2, burn=10, samples=12, nmf_iters=10)
    stored = sampler.run_chain_pt(
        n, sampler.SamplerConfig(**kw, store_samples=True, store_thin=3), 4,
        n_replicas=3)
    assert stored.tau_samples.shape == (4, 60, 2)
    assert stored.tau_samples.dtype == torch.int8
    assert stored.gamma_samples.shape == (4, 6, 2) and stored.eta_samples.shape == (4, 4, 4)
    np.testing.assert_allclose(stored.gamma_samples.sum(-1).numpy(), 1.0, rtol=1e-5)
    ref = sampler.run_chain_pt(n, sampler.SamplerConfig(**kw), 4, n_replicas=3)
    for f in ref._fields:
        if f not in sampler.DRAW_FIELDS:
            assert torch.equal(getattr(ref, f), getattr(stored, f)), f
    with pytest.raises(ValueError, match="must divide"):
        sampler.run_chain_pt(n, sampler.SamplerConfig(**kw, store_samples=True,
                                                      store_thin=5), 4)


def test_resident_kernel_refuses_pt(small):
    _, n = small
    cfg = sampler.SamplerConfig(G=2, burn=2, samples=2, nmf_iters=5)
    with pytest.raises(ValueError, match="pt/checkpoint need the composable 'cuda'"):
        sampler.run_chain_pt(n, cfg, 0, n_replicas=2, kernel="cuda_resident")
    sweep = sampler.make_sweep_fn(cfg, "cuda_resident")
    st = sampler.init_state(n.float(), cfg, sampler.chain_generator(0, "cpu"))
    with pytest.raises(ValueError, match="plain/--chains runs only"):
        sweep(n.float(), st, sampler.init_accum(60, 6, 2, "cpu"), 0,
              sampler.TorchNoise(sampler.chain_generator(0, "cpu")), beta=0.5)
