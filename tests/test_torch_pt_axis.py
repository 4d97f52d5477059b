"""Parallel tempering on the port's chain axis: the R replicas of an
ensemble sweep as one state with a leading [R] axis (``make_pt_step``), and
``run_chains_pt``'s C runs as one [C*R] axis.

- Replay: from JAX's ensemble before each of 10 sweeps (V=96 S=12 G=3
  R=3), the batched step fed each replica's JAX streams (a ``ChainNoise``
  of ``ReplayNoise``s) and JAX's exchange uniforms takes every exchange
  decision JAX's vmapped ``make_pt_step`` takes, and every MH decision
  JAX's takes but eta decisions within ETA_NEAR_TIE nats of their
  threshold, where the port's must be the one the same terms take in
  float64. At kappa_eta near 6e4 the eta log ratio is the difference of
  terms near 1e6 (the Dirichlet log-densities' lgamma, the likelihood
  sums), whose f32 roundings in XLA and in torch differ by up to about
  0.25 nats. On this input replica 2 (T from 2.8 to 8) meets two, at
  0.16 and 0.24 nats, and float64 takes the port's side of both: 8 of
  its 10 sweeps agree with JAX's in full.
- Bitwise: replica r of the batched step is the in-turn oracle written
  here (``make_sweep_fn`` with temp=temps[r], beta=betas[r] on replica r's
  state, then the exchange), every field with ``torch.equal``; run c of
  ``run_chains_pt`` is ``run_chain_pt`` of seed c; a PT snapshot written by
  the code before the chain axis (tests/data, made by its
  ``run_chain_pt_checkpointed`` interrupted at sweep 14) and a JAX
  ``save_pt`` snapshot resume to what the in-turn step gives.
"""
import dataclasses
import os
import shutil
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import checkpoint as jck
from desman_tpu import sampler as js
from desman_tpu_torch import checkpoint, convert, ops, sampler, synth
from desman_tpu_torch.utils import safe_log

from torch_helpers import (
    ReplayExchange, ReplayNoise, check_replayed_sweep, jax_state_numpy, stack, unstack,
)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# how near its threshold an eta MH decision may sit and still differ from
# JAX's (the lgamma rounding above)
ETA_NEAR_TIE = 0.5


def _same(a, b, what=""):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), (what, name)
        assert x is None or torch.equal(x, y), (what, name)


def in_turn_step(n, cfg, R, max_temp, kernel):
    """The PT step with the replicas one after another: each replica's own
    sweep (``make_sweep_fn``) at its rung's temps[r] and betas[r] (0-d),
    its accumulators kept unless it held rung 0, then the exchange of
    adjacent rungs. Lists of one state, accum and noise source a replica."""
    sweep = sampler.make_sweep_fn(cfg, kernel)
    ladder = sampler.pt_ladder(R, max_temp, n.device)
    beta_ladder = 1.0 / ladder
    dbeta = beta_ladder - torch.roll(beta_ladder, -1)
    idx = torch.arange(R)
    heads = [((idx % 2) == p) & (idx + 1 < R) for p in (0, 1)]

    def step(states, accums, rung, it, noises, exchange):
        temps = ladder.index_select(0, rung)
        betas = 1.0 / temps
        is_cold = rung == 0
        new_states, new_accums, lls = [], [], []
        for r in range(R):
            st, ac, ll = sweep(n, states[r], accums[r], it, noises[r],
                               temp=temps[r], beta=betas[r])
            new_states.append(st)
            new_accums.append(sampler.SamplerAccum(*(
                o if x is o else torch.where(is_cold[r], x, o)
                for x, o in zip(ac, accums[r]))))
            lls.append(ll)
        lls = torch.stack(lls)
        kg = torch.stack([s.kappa_gamma for s in new_states])
        ke = torch.stack([s.kappa_eta for s in new_states])
        order = torch.argsort(rung)
        ll_by_rung = lls.index_select(0, order)
        delta = dbeta * (torch.roll(ll_by_rung, -1) - ll_by_rung)
        acc = heads[it % 2] & (safe_log(exchange.exchange_u(it, R)) < delta)
        acc_prev = torch.cat([torch.zeros(1, dtype=torch.bool), acc[:-1]])
        rung_perm = torch.where(acc, idx + 1, torch.where(acc_prev, idx - 1, idx))
        new_rung = rung_perm.index_select(0, rung)
        src = order.index_select(0, new_rung)
        kg, ke = kg.index_select(0, src), ke.index_select(0, src)
        new_states = [s._replace(kappa_gamma=kg[i], kappa_eta=ke[i])
                      for i, s in enumerate(new_states)]
        cold = torch.sum(torch.where(is_cold, lls, 0.0))
        return new_states, new_accums, new_rung, cold, torch.sum(acc.to(torch.float32))

    return step


def _eta_margin(cfg, n, old, got, key, it, beta, dtype=torch.float32):
    """log u - log ratio of one replica's joint eta step from the port's own
    terms (its mixture after the gamma step, its proposal from the JAX
    stream of `key`): how far the decision sat from its threshold, in the
    sampler's f32 or, with dtype=torch.float64, from the same terms in
    float64 (the decision exact arithmetic takes)."""
    noise = ReplayNoise(key)
    eta, kappa = torch.as_tensor(np.array(old["eta"])), torch.as_tensor(np.array(old["kappa_eta"]))
    mix = torch.as_tensor(np.array(got["mix"]))
    prop, a_fwd, a_rev = sampler._eta_proposal(cfg, eta, kappa, noise, it)
    n, mix, eta, prop, a_fwd, a_rev = (x.to(dtype) for x in (n, mix, eta, prop, a_fwd, a_rev))
    dll = sampler._loglik(n, mix, prop) - sampler._loglik(n, mix, eta)
    prior = sampler._eta_prior(cfg, "cpu").to(dtype)
    ratio = (float(beta) * dll + torch.sum((prior - 1.0) * (safe_log(prop) - safe_log(eta)))
             + torch.sum(sampler._dirichlet_logpdf(eta, a_rev))
             - torch.sum(sampler._dirichlet_logpdf(prop, a_fwd)))
    return float(safe_log(noise.eta_u(it).to(dtype)) - ratio)


def _case(biallelic=False, V=60, S=6, G=3, seed=1):
    kw = dict(error_rate=0.0, max_alleles=2) if biallelic else {}
    t = synth.generate(V=V, S=S, G=G, coverage=40.0, seed=seed, **kw)
    return torch.as_tensor(t.data.counts, dtype=torch.float32)


# ---- replay of JAX's vmapped PT step ----


def test_batched_pt_step_replays_the_vmapped_jax_step():
    R = 3
    t = synth.generate(V=96, S=12, G=3, coverage=50.0, seed=21)
    kw = dict(G=3, burn=5, samples=5, nmf_iters=50)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    key = jax.random.PRNGKey(7)
    jcfg, pcfg = js.SamplerConfig(**kw), sampler.SamplerConfig(**kw)
    carry = jax.jit(js.pt_init, static_argnums=(1, 3))(n_j, jcfg, key, R)
    jstep = jax.jit(js.make_pt_step(n_j, jcfg, key, R, 8.0))
    pstep = sampler.make_pt_step(n_p, pcfg, R, 8.0, "cuda")
    exchange = [ReplayExchange(key)]
    agreed, settled = np.zeros(R, int), np.zeros(R, int)
    exchanges = 0
    ladder = sampler.pt_ladder(R, 8.0, "cpu")
    for it in range(10):
        jst, jac, jrung = carry
        carry, (jcold, jnacc, jnheads) = jstep(carry, jnp.int32(it))
        jst2, jac2, jrung2 = carry
        state = convert.state_from_numpy(jax_state_numpy(jst))
        accum = convert.accum_from_numpy(jax_state_numpy(jac))
        noise = sampler.ChainNoise(ReplayNoise(jst.key[r]) for r in range(R))
        pst, pac, prung, pcold, pnacc, pnheads = pstep(
            state, accum, torch.as_tensor(np.array(jrung), dtype=torch.int64), it,
            noise, exchange)
        assert pst.tau.shape == (R, 96, 3) and pac.star_loglik.shape == (R,)
        exchanges += (np.array_equal(prung.numpy(), np.asarray(jrung2))
                      and float(pnacc) == float(jnacc) and pnheads == float(jnheads))
        np.testing.assert_allclose(float(pcold), float(jcold), rtol=1e-5)
        old, want = jax_state_numpy(jst), jax_state_numpy(jst2)
        got, pacs = convert.state_to_numpy(pst), unstack(pac)
        for r in range(R):
            o, w, g = ({k: v[r] for k, v in d.items()} for d in (old, want, got))
            ok = check_replayed_sweep(it, o, w, g, want["loglik"][r], pst.loglik[r],
                                      jax.tree_util.tree_map(lambda x: x[r], jac2),
                                      pacs[r])
            agreed[r] += ok
            if not ok:   # the gamma decisions are JAX's; eta's sat at a near-tie
                assert np.array_equal((w["gamma"] != o["gamma"]).any(1),
                                      (g["gamma"] != o["gamma"]).any(1)), (it, r)
                beta = 1.0 / ladder[int(np.asarray(jrung)[r])]
                margin = _eta_margin(pcfg, n_p, o, g, jst.key[r], it, beta)
                exact = _eta_margin(pcfg, n_p, o, g, jst.key[r], it, beta, torch.float64)
                assert abs(margin) < ETA_NEAR_TIE, (it, r, margin)
                # the port's decision is the one exact arithmetic takes
                assert (margin < 0) == (exact < 0), (it, r, margin, exact)
                settled[r] += 1
    assert exchanges == 10, exchanges
    assert (agreed + settled == 10).all() and (agreed >= 8).all(), (agreed, settled)


# ---- replica r bitwise the in-turn step ----


@pytest.mark.parametrize("mode", ["cuda", "cuda_topk", "torch", "rows", "fix_eta"])
def test_pt_replica_is_the_in_turn_replica(mode):
    """12 ensemble sweeps (burn 6: adapting and accumulating), R=4, every
    exchange source its own: after each sweep every replica's state and
    accumulators, the rung, cold_ll and n_acc equal the in-turn oracle's."""
    R = 4
    n = _case(biallelic=mode == "cuda_topk")
    kw = dict(G=3, burn=6, samples=6, nmf_iters=20)
    if mode == "rows":
        kw["eta_update"] = "rows"
    if mode == "fix_eta":
        kw["fix_eta"] = True
    cfg = sampler.SamplerConfig(**kw)
    ks = ops.resolve("cuda" if mode in ("rows", "fix_eta") else mode, n)
    gens_a = sampler.pt_generators(9, R, "cpu")
    state, accum, rung = sampler.pt_init(n, cfg, gens_a[:R])
    states, accums = unstack(state), unstack(accum)
    # the oracle's generators: copies of the batched run's past its start
    gens_b = [sampler.chain_generator(0, "cpu") for _ in range(R + 1)]
    for a, b in zip(gens_a, gens_b):
        b.set_state(a.get_state())
    noise, exchange = sampler.pt_noises(gens_a)
    noises_b = [sampler.TorchNoise(g) for g in gens_b[:R]]
    exchange_b = sampler.ExchangeNoise(gens_b[R])
    step = sampler.make_pt_step(n, cfg, R, 4.0, ks)
    oracle = in_turn_step(n, cfg, R, 4.0, ks)
    rung_b = rung.clone()
    for it in range(cfg.total_sweeps):
        state, accum, rung, cold, n_acc, heads = step(state, accum, rung, it, noise,
                                                      exchange)
        states, accums, rung_b, cold_b, n_acc_b = oracle(states, accums, rung_b, it,
                                                         noises_b, exchange_b)
        assert torch.equal(rung, rung_b) and torch.equal(cold, cold_b), it
        assert torch.equal(n_acc, n_acc_b), it
        for r, (s, a) in enumerate(zip(unstack(state),
                                       unstack(accum))):
            _same(s, states[r], (it, r))
            _same(a, accums[r], (it, r))


def test_an_ensemble_sweep_calls_each_kernel_once():
    """One ensemble sweep of R replicas calls the tau and swap wrappers
    once each; C runs of R replicas too."""
    n = _case()
    cfg = sampler.SamplerConfig(G=3, burn=3, samples=3, nmf_iters=20)
    calls = Counter()
    ks = ops.resolve("cuda", n)

    def wrap(name, fn):
        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return counted

    ks = ks._replace(tau_sweep=wrap("tau", ks.tau_sweep), swap=wrap("swap", ks.swap))
    res = sampler.run_chain_pt(n, cfg, 2, n_replicas=4, kernel=ks)
    assert calls == {"tau": 6, "swap": 6} and res.loglik_trace.shape == (6,)
    calls.clear()
    res = sampler.run_chains_pt(n, cfg, [2, 3], n_replicas=4, kernel=ks)
    assert calls == {"tau": 6, "swap": 6} and res.loglik_trace.shape == (2, 6)


# ---- run_chains_pt: C runs on one [C*R] axis ----


@pytest.mark.parametrize("R,store,rows", [(3, False, False), (4, True, False),
                                          (2, False, True)],
                         ids=["R3", "R4_store", "R2_rows"])
def test_run_chains_pt_is_run_chain_pt_of_each_seed(R, store, rows):
    n = _case(G=2)
    kw = dict(G=2, burn=6, samples=6, nmf_iters=20)
    if store:
        kw.update(store_samples=True, store_thin=2)
    if rows:
        kw["eta_update"] = "rows"
    cfg = sampler.SamplerConfig(**kw)
    seeds = [4, 9, 1]
    res = sampler.run_chains_pt(n, cfg, seeds, n_replicas=R, max_temp=4.0)
    assert res.pt_swap_accept.shape == (3,) and res.loglik_trace.shape == (3, 12)
    if store:
        assert res.tau_samples.shape == (3, 3, 60, 2)
    for i, seed in enumerate(seeds):
        one = sampler.run_chain_pt(n, cfg, seed, n_replicas=R, max_temp=4.0)
        _same(sampler.chain_result(res, i), one, seed)


def test_run_chains_pt_of_one_replica_is_run_chains():
    n = _case(G=2)
    cfg = sampler.SamplerConfig(G=2, burn=4, samples=4, nmf_iters=20)
    _same(sampler.run_chains_pt(n, cfg, [1, 2], n_replicas=1),
          sampler.run_chains(n, cfg, [1, 2]))


def test_pt_merge_runs_is_each_runs_merge():
    """pt_merge_runs of C runs on a [C*R] axis: run c's merge of its own
    replicas' accumulators, whatever the slice's offset."""
    n = _case(G=2)
    cfg = sampler.SamplerConfig(G=2, burn=2, samples=6, nmf_iters=20)
    gens = [sampler.chain_generator(s, "cpu") for s in range(6)]
    state, accum, _ = sampler.pt_init(n, cfg, gens)
    step = sampler.make_sweep_fn(cfg, "cuda")
    noise = sampler.ChainNoise(sampler.TorchNoise(g) for g in gens)
    for it in range(cfg.total_sweeps):
        state, accum, _ = step(n, state, accum, it, noise)
    merged = sampler.pt_merge_runs(accum, 2)
    for c in range(2):
        one = sampler.pt_merge_accums(stack(unstack(accum)[3 * c:3 * c + 3]))
        _same(sampler.SamplerAccum(*(x[c] for x in merged)), one, c)


# ---- PT snapshots across the change ----

CFG = sampler.SamplerConfig(G=2, burn=10, samples=10, nmf_iters=20)
SNAPSHOTS = {"plain": CFG,
             "store": dataclasses.replace(CFG, store_samples=True, store_thin=2)}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_a_snapshot_from_before_the_chain_axis_resumes_bitwise(name, tmp_path):
    """tests/data/pt_snapshot_<name>.npz: run_chain_pt_checkpointed of
    synth V=60 S=6 G=2 (seed 1), seed 5, R=3, max_temp 4, a snapshot every
    7 sweeps, stopped after sweep 14 (in the file format of the code before
    the chain axis, unchanged since; rewritten when the sweep's bits last
    changed, by its gamma and eta passes on the gamma_ll and apply/eta
    wrappers). Resumed here, the run is run_chain_pt's result, and its last
    snapshot holds the arrays of an uninterrupted checkpointed run's."""
    cfg = SNAPSHOTS[name]
    counts = torch.as_tensor(synth.generate(V=60, S=6, G=2, coverage=40.0,
                                            seed=1).data.counts)
    ck = str(tmp_path / "resumed.npz")
    shutil.copy(os.path.join(DATA, f"pt_snapshot_{name}.npz"), ck)
    assert checkpoint.load_pt(ck)[3] == 14
    got = checkpoint.run_chain_pt_checkpointed(counts, cfg, 5, ck, checkpoint_every=7,
                                               n_replicas=3, max_temp=4.0)
    _same(got, sampler.run_chain_pt(counts, cfg, 5, n_replicas=3, max_temp=4.0))
    whole = str(tmp_path / "whole.npz")
    checkpoint.run_chain_pt_checkpointed(counts, cfg, 5, whole, checkpoint_every=7,
                                         n_replicas=3, max_temp=4.0)
    with np.load(ck) as a, np.load(whole) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(ck, "rb") as a, open(whole, "rb") as b:
        assert a.read() == b.read()


def test_a_jax_snapshot_resumes_as_the_in_turn_step(tmp_path):
    """A JAX ensemble advanced 3 sweeps and saved by JAX's save_pt, read by
    convert.pt_snapshot_from_jax_npz onto the replica axis: 3 more sweeps
    of run_pt_segment fed JAX's streams are bitwise the in-turn oracle's
    from the same snapshot and streams, and take JAX's exchanges."""
    t = synth.generate(V=96, S=8, G=3, coverage=40.0, seed=3)
    kw = dict(G=3, burn=2, samples=6, nmf_iters=30)
    jcfg, pcfg = js.SamplerConfig(**kw), sampler.SamplerConfig(**kw)
    n = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    key = jax.random.PRNGKey(8)
    pst0, pac0, _ = sampler.pt_init(n_p, pcfg, sampler.pt_generators(8, 3, "cpu")[:3])
    states = js.SamplerState(key=jax.random.split(key, 3), **{
        k: jnp.asarray(v) for k, v in convert.state_to_numpy(pst0).items()})
    accums = js.SamplerAccum(**{
        k: jnp.asarray(v) for k, v in convert.accum_to_numpy(pac0).items()})
    states, accums, rung, _, a, h = jck.run_pt_segment(n, jcfg, key, states, accums,
                                                      jnp.arange(3), 0, 3, 4.0)
    path = str(tmp_path / "snap.npz")
    jck.save_pt(path, states, accums, rung, 3, np.zeros(3, np.float32), float(a),
                float(h))
    pst, pac, prung, it, _, _, _ = convert.pt_snapshot_from_jax_npz(path)
    with np.load(path) as z:
        keys = list(z["state_key"])
    jnew = jck.run_pt_segment(n, jcfg, key, states, accums, rung, 3, 3, 4.0)
    out = sampler.run_pt_segment(n_p, pcfg, pst, pac, prung, it, 3,
                                 sampler.ChainNoise(ReplayNoise(k) for k in keys),
                                 [ReplayExchange(key)], 4.0, "cuda")
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jnew[2]))
    oracle = in_turn_step(n_p, pcfg, 3, 4.0, ops.resolve("cuda", n_p))
    states_b, accums_b = unstack(pst), unstack(pac)
    rung_b, noises_b = prung, [ReplayNoise(k) for k in keys]
    trace = []
    for i in range(3):
        states_b, accums_b, rung_b, cold, _ = oracle(states_b, accums_b, rung_b, it + i,
                                                     noises_b, ReplayExchange(key))
        trace.append(cold)
    assert torch.equal(out[2], rung_b) and torch.equal(out[3], torch.stack(trace))
    for r, (s, ac) in enumerate(zip(unstack(out[0]),
                                    unstack(out[1]))):
        _same(s, states_b[r], r)
        _same(ac, accums_b[r], r)

