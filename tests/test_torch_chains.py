"""The port's chain axis in the sampler: a sweep of C chains held as one
state with a leading [C] axis (``run_chains``), against the JAX package's
vmapped sweep fed the same streams, and against ``run_chain`` of each seed
bit for bit; the stacked noise (``ChainNoise``), the launches a batched
sweep makes, and the JAX package's [C]-leading states read by ``convert``.

Replay (10 sweeps from JAX's vmapped state, one JAX key a chain): every
chain's tau agrees with JAX's on >= 99% of positions (float near-ties of
the Gumbel-argmax) and its gamma/eta MH decisions agree on >= 9 of the 10
sweeps, the bar the one-chain replays of tests/test_torch_sampler.py and
tests/test_torch_topk.py hold (a decision may flip where the f32 log-ratio
sits at the uniform's threshold, ROADMAP section 3).
"""
from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import checkpoint as jckpt
from desman_tpu import sampler as js
from desman_tpu.ops import tau_topk as jt
from desman_tpu_torch import convert, ops, sampler, synth

from torch_helpers import ReplayNoise, check_replayed_sweep, jax_state_numpy

C = 3


def _replay_case(biallelic: bool):
    kw = dict(error_rate=0.0, max_alleles=2) if biallelic else {}
    return synth.generate(V=96, S=12, G=3, coverage=50.0, seed=21, **kw)


def _chain(d: dict, c: int) -> dict:
    return {k: v[c] for k, v in d.items()}


@pytest.mark.parametrize("kernel", ["cuda", "cuda_topk"])
def test_batched_sweep_replays_the_vmapped_jax_sweep(kernel):
    """From JAX's vmapped state at each of 10 sweeps, the port's batched
    sweep fed each chain's JAX streams (``ChainNoise`` of one ReplayNoise a
    chain) lands where JAX's vmapped sweep lands, chain by chain."""
    t = _replay_case(kernel == "cuda_topk")
    cfg_kw = dict(G=3, nmf_iters=100)
    jcfg, pcfg = js.SamplerConfig(**cfg_kw), sampler.SamplerConfig(**cfg_kw)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    keys = jnp.stack([jax.random.PRNGKey(4 + c) for c in range(C)])
    jstate, jaccum = jckpt.init_chains(n_j, jcfg, keys)
    tau_sweep = ({} if kernel == "cuda" else
                 dict(tau_sweep=jt.make_tau_sweep_topk(t.data.counts, interpret=True)))
    jsweep = jax.jit(jax.vmap(js.make_sweep_fn(jcfg, **tau_sweep),
                              in_axes=(None, 0, 0, None)))
    psweep = sampler.make_sweep_fn(pcfg, ops.resolve(kernel, n_p))

    same = np.zeros(C, int)
    for it in range(10):
        jnew, jacc_new, jll = jsweep(n_j, jstate, jaccum, jnp.int32(it))
        old, want = jax_state_numpy(jstate), jax_state_numpy(jnew)
        pstate = convert.state_from_numpy(old)
        paccum = convert.accum_from_numpy(jax_state_numpy(jaccum))
        assert pstate.tau.shape == (C, 96, 3) and paccum.sum_tau.shape == (C, 96, 3, 4)
        noise = sampler.ChainNoise(ReplayNoise(jstate.key[c]) for c in range(C))
        pnew, pacc_new, pll = psweep(n_p, pstate, paccum, it, noise)
        got = convert.state_to_numpy(pnew)
        for c in range(C):
            same[c] += check_replayed_sweep(
                it, _chain(old, c), _chain(want, c), _chain(got, c), jll[c], pll[c],
                SimpleNamespace(star_loglik=jacc_new.star_loglik[c]),
                SimpleNamespace(star_loglik=pacc_new.star_loglik[c]))
        jstate, jaccum = jnew, jacc_new
    assert (same >= 9).all(), same


def _counts(biallelic=True, V=40, S=5, G=2, seed=1):
    kw = dict(error_rate=0.0, max_alleles=2) if biallelic else {}
    return synth.generate(V=V, S=S, G=G, coverage=40.0, seed=seed, **kw)


def _same_runs(n, cfg, seeds, kernel, **init):
    """run_chains against run_chain of each seed, every field bit for bit."""
    res = sampler.run_chains(n, cfg, seeds, kernel=kernel, **init)
    assert res.loglik_trace.shape == (len(seeds), cfg.total_sweeps)
    for i, seed in enumerate(seeds):
        one = sampler.run_chain(n, cfg, sampler.chain_generator(seed, "cpu"),
                                kernel=kernel, **init)
        for name, a, b in zip(one._fields, res, one):
            assert (a is None) == (b is None), name
            assert b is None or torch.equal(a[i], b), (seed, name)
    return res


STORE = dict(G=2, burn=4, samples=6, nmf_iters=20, store_samples=True, store_thin=2)


@pytest.mark.parametrize("store", [False, True], ids=["plain", "store"])
@pytest.mark.parametrize("kernel", ["cuda", "cuda_topk", "torch"])
def test_run_chains_is_run_chain_of_each_seed(kernel, store):
    t = _counts()
    cfg = sampler.SamplerConfig(**(STORE if store else
                                   dict(G=2, burn=5, samples=5, nmf_iters=20)))
    res = _same_runs(torch.as_tensor(t.data.counts), cfg, [3, 7, 0], kernel)
    if store:
        assert res.tau_samples.shape == (3, 3, 40, 2)
    assert not torch.equal(res.loglik_trace[0], res.loglik_trace[1])


@pytest.mark.parametrize("mode", ["rows", "fix_gamma", "fix_eta", "fix_tau", "one_strain",
                                  "no_swap", "no_anneal"])
def test_run_chains_is_run_chain_of_each_seed_in_every_mode(mode):
    """The run modes' branches over the chain axis: per-row eta steps, a
    frozen gamma, eta or tau, one strain (no pair to swap), swap moves off
    and no anneal."""
    t = _counts(biallelic=False, G=3)
    n = torch.as_tensor(t.data.counts)
    kw = dict(G=3, burn=5, samples=5, nmf_iters=20)
    init = {}
    if mode == "rows":
        kw["eta_update"] = "rows"
    elif mode == "fix_gamma":
        kw["fix_gamma"] = True
    elif mode == "fix_eta":
        kw["fix_eta"] = True
        init["eta_init"] = torch.as_tensor(t.eta, dtype=torch.float32)
    elif mode == "fix_tau":
        kw["fix_tau"] = True
        init["tau_init"] = torch.as_tensor(t.tau_idx)
    elif mode == "one_strain":
        kw["G"] = 1
    elif mode == "no_swap":
        kw["swap_moves"] = False
    else:
        kw["anneal_temp0"] = 1.0
    _same_runs(n, sampler.SamplerConfig(**kw), [0, 5], "cuda", **init)


def _counting(ks, calls):
    def wrap(name, fn):
        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return counted
    return ks._replace(tau_sweep=wrap("tau", ks.tau_sweep), swap=wrap("swap", ks.swap))


@pytest.mark.parametrize("kernel", ["cuda", "cuda_topk"])
def test_a_batched_sweep_calls_each_kernel_once(kernel):
    """A sweep of C chains calls the tau (top-2) and swap wrappers once
    each, with every chain's state; a run of C chains and 10 sweeps ten
    times each."""
    t = _counts()
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    cfg = sampler.SamplerConfig(G=2, burn=5, samples=5, nmf_iters=20)
    calls = Counter()
    ks = _counting(ops.resolve(kernel, n), calls)
    gens = [sampler.chain_generator(s, "cpu") for s in range(C)]
    state = sampler.init_states(n, cfg, gens)
    accum = sampler.init_accum(40, 5, 2, "cpu", chains=C)
    sweep = sampler.make_sweep_fn(cfg, ks)
    new, _, ll = sweep(n, state, accum, 0, sampler.ChainNoise(
        sampler.TorchNoise(g) for g in gens))
    assert calls == {"tau": 1, "swap": 1} and ll.shape == (C,)
    assert new.tau.shape == (C, 40, 2) and new.kappa_gamma.shape == (C,)
    calls.clear()
    sampler.run_chains(n, cfg, [0, 1, 2, 3], kernel=ks)
    assert calls == {"tau": 10, "swap": 10}


def test_chain_noise_draws_each_chain_from_its_own_generator():
    """ChainNoise of TorchNoise sources: slice c of every draw is what
    chain c's TorchNoise alone draws, in the same order; a source of
    another kind is stacked as it draws."""
    seeds = [11, 12, 13]
    solo = [sampler.TorchNoise(sampler.chain_generator(s, "cpu")) for s in seeds]
    stacked = sampler.ChainNoise(sampler.TorchNoise(sampler.chain_generator(s, "cpu"))
                                 for s in seeds)
    assert stacked.generators is not None
    alpha = torch.rand(C, 5, 3) + 0.5
    alpha_eta = torch.rand(C, 4, 4) + 0.5
    draws = [
        lambda s, c: s.gumbel(0, 7, 3), lambda s, c: s.swap(0, 7, 3),
        lambda s, c: s.swap(0, 7, 1), lambda s, c: s.gamma_u(0, 5),
        lambda s, c: s.eta_u(0), lambda s, c: s.eta_row_u(0, 2),
    ]
    for draw in draws:
        got = draw(stacked, None)
        want = [draw(s, c) for c, s in enumerate(solo)]
        if isinstance(got, tuple):
            for g, w in zip(got, zip(*want)):
                assert torch.equal(g, torch.stack(w))
        else:
            assert torch.equal(got, torch.stack(want))
    assert torch.equal(stacked.gamma_prop(0, alpha),
                       torch.stack([s.gamma_prop(0, alpha[c]) for c, s in enumerate(solo)]))
    assert torch.equal(stacked.eta_prop(0, alpha_eta),
                       torch.stack([s.eta_prop(0, alpha_eta[c]) for c, s in enumerate(solo)]))
    assert torch.equal(stacked.eta_row_prop(0, 1, alpha_eta[:, 1]), torch.stack(
        [s.eta_row_prop(0, 1, alpha_eta[c, 1]) for c, s in enumerate(solo)]))
    # the generic path: sources that are not TorchNoise
    replay = sampler.ChainNoise(ReplayNoise(jax.random.PRNGKey(c)) for c in range(2))
    assert replay.generators is None
    assert torch.equal(replay.gumbel(3, 5, 2)[1], ReplayNoise(jax.random.PRNGKey(1))
                       .gumbel(3, 5, 2))


def test_one_chain_stacks_as_a_view():
    x = torch.arange(4.0)
    assert sampler._stacked([x]).data_ptr() == x.data_ptr()
    assert sampler._each(None, torch.sum, x) == torch.sum(x)
    got = sampler._each(2, torch.sum, torch.stack([x, 2 * x]))
    assert torch.equal(got, torch.tensor([6.0, 12.0]))


def test_check_finite_names_a_bad_chain_field():
    t = _counts()
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    cfg = sampler.SamplerConfig(G=2, nmf_iters=20)
    state = sampler.init_states(n, cfg, [sampler.chain_generator(s, "cpu")
                                         for s in range(C)])
    sampler.check_finite(0, [state])
    gamma = state.gamma.clone()
    gamma[2, 1, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="sweep 5: non-finite gamma"):
        sampler.check_finite(5, [state._replace(gamma=gamma)])


def _resident_batched_sweep(G):
    """A batched resident sweep of C chains calls each of its kernels'
    wrappers once (fused_sweep and gamma_apply_eta; with one strain
    tau_sweep, gamma_ll and the apply), and on the plain path's counters
    (CPU tensors) no kernel launches."""
    t = _counts(biallelic=False, G=max(G, 2))
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    cfg = sampler.SamplerConfig(G=G, burn=2, samples=2, nmf_iters=20)
    gens = [sampler.chain_generator(s, "cpu") for s in range(C)]
    state = sampler.init_states(n, cfg, gens)
    calls = Counter()
    ks = ops.resolve("cuda_resident")

    def wrap(name):
        fn = getattr(ks, name)

        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return counted

    ks = ks._replace(**{f: wrap(f) for f in ("tau_sweep", "swap", "gamma_ll",
                                             "gamma_apply_eta", "fused_sweep")})
    ops.reset_launches()
    sweep = sampler.make_sweep_fn(cfg, ks)
    new, acc, ll = sweep(n, state, sampler.init_accum(40, 5, G, "cpu", chains=C), 0,
                         sampler.ChainNoise(sampler.TorchNoise(g) for g in gens))
    want = ({"fused_sweep": 1, "gamma_apply_eta": 1} if G > 1 else
            {"tau_sweep": 1, "gamma_ll": 1, "gamma_apply_eta": 1})
    assert calls == want and ll.shape == (C,) and new.tau.shape == (C, 40, G)
    assert all(w.launches == 0 and w.chain_launches == 0 for w in ops.CHAIN_AXIS)


def test_resident_kernels_take_one_chain():
    """The resident kernels take a chain axis (a batched state is no longer
    refused): one call of fused_sweep and of gamma_apply_eta a sweep of C
    chains."""
    _resident_batched_sweep(2)


def test_resident_one_strain_sweep_takes_the_chain_axis():
    """With one strain (no swap to fuse): one call each of tau_sweep,
    gamma_ll and gamma_apply_eta a sweep of C chains."""
    _resident_batched_sweep(1)


def test_init_states_and_accum_stack_the_chains():
    t = _counts()
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    cfg = sampler.SamplerConfig(G=2, nmf_iters=20)
    state = sampler.init_states(n, cfg, [sampler.chain_generator(s, "cpu")
                                         for s in (4, 9)])
    for c, s in enumerate((4, 9)):
        one = sampler.init_state(n, cfg, sampler.chain_generator(s, "cpu"))
        assert all(torch.equal(a[c], b) for a, b in zip(state, one))
    acc = sampler.init_accum(40, 5, 2, "cpu", chains=2)
    one = sampler.init_accum(40, 5, 2, "cpu")
    assert all(torch.equal(a[c], b) for a, b in zip(acc, one) for c in range(2))


def test_convert_reads_the_jax_chains_state():
    """The JAX package's [C]-leading states (``checkpoint.init_chains``; the
    resident base-major mixture with pad rows, given V) come back with the
    chain axis, chain c the conversion of chain c alone."""
    t = _counts(V=44, S=6)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    jcfg = js.SamplerConfig(G=2, nmf_iters=20)
    states, accums = jckpt.init_chains(n_j, jcfg, jnp.stack(
        [jax.random.PRNGKey(c) for c in range(C)]))
    d = jax_state_numpy(states)
    got = convert.state_from_numpy(d)
    acc = convert.accum_from_numpy(jax_state_numpy(accums))
    assert got.mix.shape == (C, 44, 6, 4) and acc.star_tau.shape == (C, 44, 2)
    for c in range(C):
        one = convert.state_from_numpy(_chain(d, c))
        assert all(torch.equal(a[c], b) for a, b in zip(got, one))
    # base-major [C, Vp, 4S] with 4 pad rows
    bm = np.concatenate([d["mix"].transpose(0, 1, 3, 2).reshape(C, 44, 24),
                         np.ones((C, 4, 24), np.float32)], axis=1)
    tau = np.concatenate([d["tau"], np.zeros((C, 4, 2), np.int32)], axis=1)
    res = convert.state_from_numpy(dict(d, mix=bm, tau=tau), V=44)
    assert torch.equal(res.mix, got.mix) and torch.equal(res.tau, got.tau)
    with pytest.raises(ValueError, match="needs V"):
        convert.state_from_numpy(dict(_chain(d, 0), mix=bm[0], tau=tau[0]))
