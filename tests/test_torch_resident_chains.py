"""The resident path on the port's chain axis: ``cuda_resident`` chains
swept as one state with a leading [C] axis, and the chain axis of the
resident kernels' plain versions (gamma_ll, gamma_apply_eta, fused_sweep).

- Replay: from JAX's state before each of 10 sweeps, the batched resident
  sweep of 3 chains fed each chain's JAX streams (``ChainNoise`` of
  ``ReplayNoise``s) lands where the JAX package's resident sweep under
  ``jax.vmap`` lands (the sweep ``run_chains_resident`` vmaps; Pallas in
  interpret mode, V=96 S=12: no JAX pad rows), every chain taking JAX's
  MH decisions on all 10 sweeps.
- The plain versions over [C] against ``jax.vmap`` of the Pallas kernels
  (per-sample loglik sums to rtol 1e-5, tau agreement >= 0.99 at float
  near-ties), and chain c bit for bit the one-chain call, on shared counts
  and on each chain's own.
- Bitwise: resident ``run_chains`` chain c is the resident ``run_chain``
  of its seed (every field, ``torch.equal``), on shared counts and on
  each chain's own (``multibin``'s bins).
"""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import sampler as js
from desman_tpu.ops.fused_sweep import fused_sweep as jax_fused_sweep
from desman_tpu.ops.gamma_pallas import gamma_apply_eta_bmajor, gamma_ll_bmajor
from desman_tpu.ops.tau_pallas import from_bmajor, to_bmajor
from desman_tpu.resident import make_resident_sweep
from desman_tpu_torch import cli, convert, io, multibin, ops, sampler, synth
from desman_tpu_torch.likelihood import mixture
from desman_tpu_torch.utils import one_hot_tau

from torch_helpers import (
    ReplayNoise, check_replayed_sweep, jax_state_numpy, to_jax, to_torch,
)

C = 3
LL_RTOL = 1e-5


def _chain(d: dict, c: int) -> dict:
    return {k: v[c] for k, v in d.items()}


def _same(a, b, what=""):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), (what, name)
        assert x is None or torch.equal(x, y), (what, name)


# ---- replay of the vmapped JAX resident sweep ----


@pytest.mark.parametrize("G,fix_eta", [(3, False), (3, True), (1, False)],
                         ids=["joint_eta", "fix_eta", "one_strain"])
def test_batched_resident_sweep_replays_the_vmapped_jax_sweep(G, fix_eta):
    V, S = 96, 12
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=21)
    cfg_kw = dict(G=G, fix_eta=fix_eta, nmf_iters=100)
    jcfg, pcfg = js.SamplerConfig(**cfg_kw), sampler.SamplerConfig(**cfg_kw)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    eta0 = jnp.asarray(t.eta, jnp.float32) if fix_eta else None
    keys = jnp.stack([jax.random.PRNGKey(4 + c) for c in range(C)])
    jstate = jax.vmap(lambda k: js.init_state(n_j, jcfg, k, eta_init=eta0))(keys)
    jstate = jstate._replace(mix=jax.vmap(to_bmajor)(jstate.mix))
    jaccum = jax.tree_util.tree_map(lambda x: jnp.stack([x] * C), js.init_accum(V, S, G))
    jsweep = jax.jit(jax.vmap(make_resident_sweep(jcfg, to_bmajor(n_j), V, True),
                              in_axes=(0, 0, None)))
    psweep = sampler.make_sweep_fn(pcfg, kernel="cuda_resident")

    same = np.zeros(C, int)
    for it in range(10):
        jnew, jacc_new, jll = jsweep(jstate, jaccum, jnp.int32(it))
        pstate = convert.state_from_numpy(jax_state_numpy(jstate), V=V)
        paccum = convert.accum_from_numpy(jax_state_numpy(jaccum))
        assert pstate.mix.shape == (C, V, S, 4)
        noise = sampler.ChainNoise(ReplayNoise(jstate.key[c]) for c in range(C))
        pnew, pacc_new, pll = psweep(n_p, pstate, paccum, it, noise)
        old = convert.state_to_numpy(pstate)
        want = convert.state_to_numpy(convert.state_from_numpy(jax_state_numpy(jnew), V=V))
        got = convert.state_to_numpy(pnew)
        for c in range(C):
            same[c] += check_replayed_sweep(
                it, _chain(old, c), _chain(want, c), _chain(got, c), jll[c], pll[c],
                SimpleNamespace(star_loglik=jacc_new.star_loglik[c]),
                SimpleNamespace(star_loglik=pacc_new.star_loglik[c]))
        jstate, jaccum = jnew, jacc_new
    assert (same == 10).all(), same


# ---- the kernels' plain versions over a chain axis ----


def _chain_inputs(V, S, G, seed, own_counts=False):
    """C chains' inputs of the resident kernels, each chain's from numpy's
    default_rng(seed + c): tau, its mixture, gamma, eta, noise, a swap pair
    of its own, a gamma proposal, accepts and an eta proposal; counts shared
    ([V,S,4]) or each chain's own ([C,V,S,4], synth seeds seed + c)."""
    f32 = torch.float32
    out, counts = [], []
    for c in range(C):
        t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed + (c if own_counts else 0))
        rng = np.random.default_rng(seed + c)
        tau = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32)
        gamma = torch.as_tensor(rng.dirichlet(np.ones(G), size=S), dtype=f32)
        eta = synth.make_eta(0.01) * (1.0 + 0.1 * rng.random((4, 4)))
        counts.append(torch.as_tensor(t.data.counts, dtype=f32))
        out.append(dict(
            tau=tau, mix=mixture(one_hot_tau(tau), gamma), gamma=gamma,
            eta=torch.as_tensor(eta / eta.sum(1, keepdims=True), dtype=f32),
            gz=torch.as_tensor(rng.gumbel(size=(V, G, 4)), dtype=f32),
            g=torch.tensor(c % G, dtype=torch.int32),
            h=torch.tensor((c + 1) % G, dtype=torch.int32),
            logu=torch.as_tensor(np.log(rng.uniform(size=V)), dtype=f32),
            gp=torch.as_tensor(rng.dirichlet(np.ones(G), size=S), dtype=f32),
            accept=torch.as_tensor(rng.random(S) < 0.5),
            eta_prop=torch.as_tensor(synth.make_eta(0.02 + 0.01 * c), dtype=f32)))
    d = {k: torch.stack([x[k] for x in out]) for k in out[0]}
    d["n"] = torch.stack(counts) if own_counts else counts[0]
    return d


ARGS = {
    "gamma_ll": ("n", "mix", "tau", "gp", "eta"),
    "gamma_apply_eta": ("n", "mix", "tau", "gp", "accept", "eta_prop"),
    "fused_sweep": ("n", "tau", "mix", "gamma", "eta", "gz", "g", "h", "logu", "gp"),
}


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("own_counts", [False, True], ids=["shared", "own_counts"])
@pytest.mark.parametrize("kernel", sorted(ARGS))
def test_resident_plain_over_chains_is_each_chains_call(kernel, own_counts):
    """Chain c of the plain version over [C] (the CPU wrapper) is the
    one-chain call on chain c's inputs, bit for bit."""
    d = _chain_inputs(40, 7, 3, seed=5, own_counts=own_counts)
    fn = getattr(ops, kernel)
    got = _outputs(fn(*(d[k] for k in ARGS[kernel])))
    assert got[0].shape[0] == C
    for c in range(C):
        one = _outputs(fn(*(d[k] if k == "n" and d[k].dim() == 3 else d[k][c]
                            for k in ARGS[kernel])))
        assert all(torch.equal(a[c], b) for a, b in zip(got, one)), c
    assert ops.gamma_ll.launches == ops.fused_sweep.launches == 0   # CPU: plain


@pytest.mark.parametrize("with_old", [True, False])
def test_gamma_ll_plain_over_chains_matches_vmapped_pallas(with_old):
    V, S, G = 64, 8, 3
    d = _chain_inputs(V, S, G, seed=11)
    ll_p = ops.gamma_ll(*(d[k] for k in ARGS["gamma_ll"]), with_old=with_old)
    ll_j = jax.vmap(lambda m, t, gp, e: gamma_ll_bmajor(
        to_bmajor(to_jax(d["n"])), m, t, gp, e, interpret=True, with_old=with_old))(
        jax.vmap(to_bmajor)(to_jax(d["mix"])), to_jax(d["tau"]), to_jax(d["gp"]),
        to_jax(d["eta"]))
    assert ll_p.shape == (C, 2, S)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=LL_RTOL)


@pytest.mark.parametrize("with_eta", [True, False])
def test_gamma_apply_eta_plain_over_chains_matches_vmapped_pallas(with_eta):
    V, S, G = 64, 8, 2
    d = _chain_inputs(V, S, G, seed=12)
    mix_p, ll_p = ops.gamma_apply_eta(*(d[k] for k in ARGS["gamma_apply_eta"]),
                                      with_eta=with_eta)
    mix_j, ll_j = jax.vmap(lambda m, t, gp, a, e: gamma_apply_eta_bmajor(
        to_bmajor(to_jax(d["n"])), m, t, gp, a, e, interpret=True, with_eta=with_eta))(
        jax.vmap(to_bmajor)(to_jax(d["mix"])), to_jax(d["tau"]), to_jax(d["gp"]),
        to_jax(d["accept"]), to_jax(d["eta_prop"]))
    mix_j = jax.vmap(lambda m: from_bmajor(m, S))(mix_j)
    np.testing.assert_allclose(mix_p.numpy(), np.asarray(mix_j), rtol=1e-5, atol=1e-7)
    if with_eta:
        np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=LL_RTOL)
    else:
        assert torch.equal(ll_p, torch.zeros(C, S))


def test_fused_sweep_plain_over_chains_matches_vmapped_pallas():
    V, S, G = 64, 8, 4
    d = _chain_inputs(V, S, G, seed=13)
    tau_p, mix_p, ll_p = ops.fused_sweep(*(d[k] for k in ARGS["fused_sweep"]))
    tau_j, mix_j, ll_j = jax.vmap(lambda t, m, gam, e, gz, g, h, lu, gp: jax_fused_sweep(
        to_bmajor(to_jax(d["n"])), t, m, gam, e, gz, g, h, lu, gp, interpret=True))(
        to_jax(d["tau"]), jax.vmap(to_bmajor)(to_jax(d["mix"])), to_jax(d["gamma"]),
        to_jax(d["eta"]), to_jax(d["gz"]).reshape(C, V, G * 4), to_jax(d["g"]),
        to_jax(d["h"]), to_jax(d["logu"]), to_jax(d["gp"]))
    mix_j = to_torch(jax.vmap(lambda m: from_bmajor(m, S))(mix_j))
    tau_j = to_torch(tau_j)
    for c in range(C):
        same = (tau_p[c] == tau_j[c]).all(dim=1)
        assert same.float().mean().item() >= 0.99, c
        np.testing.assert_allclose(mix_p[c][same].numpy(), mix_j[c][same].numpy(),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=LL_RTOL)


@pytest.mark.parametrize("kernel,field,bad,match", [
    ("gamma_ll", "gp", lambda x: x[0], "gamma_prop"),
    ("gamma_ll", "eta", lambda x: x[:2], "eta"),
    ("gamma_apply_eta", "accept", lambda x: x[0], "accept"),
    ("fused_sweep", "g", lambda x: x[0], "g"),
    ("fused_sweep", "logu", lambda x: x[:, :5], "logu"),
    ("fused_sweep", "n", lambda x: x.expand(2, *x.shape).contiguous(), "n"),
])
def test_resident_wrappers_refuse_a_chain_axis_they_cannot_take(kernel, field, bad, match):
    d = _chain_inputs(40, 7, 3, seed=5)
    d[field] = bad(d[field])
    with pytest.raises(ValueError, match=match):
        getattr(ops, kernel)(*(d[k] for k in ARGS[kernel]))


# ---- resident chains bitwise their own runs ----


@pytest.mark.parametrize("mode", ["plain", "fix_eta", "one_strain", "no_swap", "no_anneal"])
def test_resident_run_chains_is_run_chain_of_each_seed(mode):
    t = synth.generate(V=40, S=5, G=3, coverage=40.0, seed=2)
    n = torch.as_tensor(t.data.counts)
    kw = dict(G=3, burn=5, samples=5, nmf_iters=20)
    init = {}
    if mode == "fix_eta":
        kw["fix_eta"] = True
        init["eta_init"] = torch.as_tensor(t.eta, dtype=torch.float32)
    elif mode == "one_strain":
        kw["G"] = 1
    elif mode == "no_swap":
        kw["swap_moves"] = False
    elif mode == "no_anneal":
        kw["anneal_temp0"] = 1.0
    cfg = sampler.SamplerConfig(**kw)
    seeds = [3, 7, 0]
    res = sampler.run_chains(n, cfg, seeds, kernel="cuda_resident", **init)
    assert res.loglik_trace.shape == (3, 10)
    for i, seed in enumerate(seeds):
        one = sampler.run_chain(n, cfg, sampler.chain_generator(seed, "cpu"),
                                kernel="cuda_resident", **init)
        _same(sampler.chain_result(res, i), one, seed)


@pytest.mark.parametrize("kernel", ["cuda_resident", "cuda"])
def test_chains_on_their_own_counts_are_run_chain_of_each(kernel):
    """run_chains on [C,V,S,4] counts (the bins' layout): chain c is
    run_chain of n[c] with its seed's generator, every field."""
    n = torch.stack([torch.as_tensor(synth.generate(V=48, S=6, G=2, coverage=40.0,
                                                    seed=s).data.counts,
                                     dtype=torch.float32) for s in (1, 2, 3)])
    cfg = sampler.SamplerConfig(G=2, burn=4, samples=4, nmf_iters=20)
    res = sampler.run_chains(n, cfg, [5, 6, 7], kernel=kernel)
    for c, seed in enumerate((5, 6, 7)):
        one = sampler.run_chain(n[c], cfg, sampler.chain_generator(seed, "cpu"),
                                kernel=kernel)
        _same(sampler.chain_result(res, c), one, c)


def test_resident_bins_are_run_chain_of_their_padded_counts():
    """multibin.run_bins with cuda_resident: bin b is the resident
    run_chain of pad_bins(...)[b] on child b of spawn_seeds(seed, B), cut
    back to its V."""
    bins = [synth.generate(V=V, S=6, G=2, coverage=40.0, seed=s).data.counts
            for V, s in ((30, 1), (45, 2), (20, 3))]
    cfg = sampler.SamplerConfig(G=2, burn=4, samples=4, nmf_iters=20)
    got = multibin.run_bins(bins, cfg, seed=4, kernel="cuda_resident", device="cpu")
    padded = torch.as_tensor(multibin.pad_bins(bins))
    for b, (res, s) in enumerate(zip(got, sampler.spawn_seeds(4, 3))):
        one = sampler.run_chain(padded[b], cfg, sampler.chain_generator(s, "cpu"),
                                kernel="cuda_resident")
        V = bins[b].shape[0]
        _same(res, one._replace(tau_mean=one.tau_mean[:V], tau_star=one.tau_star[:V]), b)


def test_desman_chains_cli_takes_the_resident_chain_axis(tmp_path):
    """`desman --chains 2 --kernel cuda_resident` (run_multi through
    run_chains on the axis): the written outputs are the best seed's own
    resident chain, bit for bit."""
    t = synth.generate(V=60, S=6, G=2, coverage=40.0, seed=4)
    counts = str(tmp_path / "counts.csv")
    io.write_counts_csv(counts, t.data)
    out = tmp_path / "out"
    assert cli.main(["desman", counts, "-g", "2", "-i", "20", "-s", "5", "--chains", "2",
                     "--kernel", "cuda_resident", "--device", "cpu", "-o", str(out)]) == 0
    with open(out / "chains.json") as f:
        chains = json.load(f)
    assert chains["seeds"] == [5, 6]
    one = sampler.run_chain(torch.as_tensor(t.data.counts),
                            sampler.SamplerConfig(G=2, burn=10, samples=10),
                            sampler.chain_generator(chains["best_seed"], "cpu"),
                            kernel="cuda_resident")
    tau, _, _ = io.read_tau_star_csv(str(out / "Filtered_Tau_star.csv"))
    assert np.array_equal(tau, one.tau_star.numpy())
    np.testing.assert_array_equal(np.loadtxt(out / "loglik_trace.csv", delimiter=","),
                                  one.loglik_trace.numpy().astype(np.float64))
