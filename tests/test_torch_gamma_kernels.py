"""The plain versions of the resident sweep's kernels against the JAX
package's Pallas kernels (interpret mode on the CPU), fed the same inputs:
the swap's emit_ll, the gamma-MH loglik pair, the gamma apply + eta loglik,
and the fused front half.

The per-sample loglik sums are held to rtol 1e-5: the port sums each
position's four bases first and then the positions, the Pallas kernels the
positions first and then the four base blocks (f32 reduction order). Tau
may differ only at float near-ties (agreement >= 0.99).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu.ops.fused_sweep import fused_sweep as jax_fused_sweep
from desman_tpu.ops.gamma_pallas import gamma_apply_eta_bmajor, gamma_ll_bmajor
from desman_tpu.ops.swap_pallas import swap_bmajor
from desman_tpu.ops.tau_pallas import from_bmajor, to_bmajor
from desman_tpu_torch import ops, synth
from desman_tpu_torch.likelihood import mixture
from desman_tpu_torch.utils import one_hot_tau

from torch_helpers import to_jax, to_torch

LL_RTOL = 1e-5


def _inputs(V, S, G, seed):
    """Counts, a random tau and its mixture, noise, a swap and a gamma
    proposal, all made with numpy from `seed`."""
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed)
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    tau = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32)
    gamma = torch.as_tensor(t.gamma, dtype=f32)
    return dict(
        n=torch.as_tensor(t.data.counts, dtype=f32), tau=tau,
        mix=mixture(one_hot_tau(tau), gamma), gamma=gamma,
        eta=torch.as_tensor(t.eta, dtype=f32),
        gz=torch.as_tensor(rng.gumbel(size=(V, G, 4)), dtype=f32),
        g=torch.tensor(0, dtype=torch.int32),
        h=torch.tensor(G - 1, dtype=torch.int32),
        logu=torch.as_tensor(np.log(rng.uniform(size=V)), dtype=f32),
        gamma_prop=torch.as_tensor(rng.dirichlet(np.ones(G), size=S), dtype=f32),
        accept=torch.as_tensor(rng.random(S) < 0.5),
        eta_prop=torch.as_tensor(synth.make_eta(0.02), dtype=f32))


def _bm(x):
    return to_bmajor(to_jax(x))


@pytest.mark.parametrize("V,S,G", [(96, 12, 3), (64, 8, 4)])
def test_swap_emit_ll_plain_matches_pallas(V, S, G):
    d = _inputs(V, S, G, seed=V + S)
    # the true haplotypes with the pair exchanged at half the positions, so
    # both the accept and the reject branch of t_fin run
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=V + S)
    tau = t.tau_idx.copy()
    flip = np.random.default_rng(1).random(V) < 0.5
    tau[flip, 0], tau[flip, G - 1] = t.tau_idx[flip, G - 1], t.tau_idx[flip, 0]
    tau = torch.as_tensor(tau, dtype=torch.int32)
    mix = mixture(one_hot_tau(tau), d["gamma"])
    tau_p, mix_p, ll_p = ops.swap_reference(
        d["n"], tau, mix, d["gamma"], d["eta"], d["g"], d["h"], d["logu"],
        emit_ll=True)
    tau_j, mix_j, ll_j = swap_bmajor(
        _bm(d["n"]), to_jax(tau), _bm(mix), to_jax(d["gamma"]), to_jax(d["eta"]),
        jnp.int32(0), jnp.int32(G - 1), to_jax(d["logu"]), interpret=True,
        emit_ll=True)
    assert torch.equal(tau_p, to_torch(tau_j))
    moved = (tau_p != tau).any(dim=1)
    assert 0 < moved.float().mean().item() < 1
    np.testing.assert_allclose(mix_p.numpy(), np.asarray(from_bmajor(mix_j, S)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=LL_RTOL)
    # without emit_ll, the same move
    tau_0, mix_0 = ops.swap_reference(d["n"], tau, mix, d["gamma"], d["eta"],
                                      d["g"], d["h"], d["logu"])
    assert torch.equal(tau_0, tau_p) and torch.equal(mix_0, mix_p)


@pytest.mark.parametrize("with_old", [True, False])
@pytest.mark.parametrize("V,S,G", [(96, 12, 3), (64, 8, 2), (80, 5, 4)])
def test_gamma_ll_plain_matches_pallas(V, S, G, with_old):
    d = _inputs(V, S, G, seed=3 * V + G)
    ll_p = ops.gamma_ll_reference(d["n"], d["mix"], d["tau"], d["gamma_prop"],
                                  d["eta"], with_old=with_old)
    ll_j = gamma_ll_bmajor(_bm(d["n"]), _bm(d["mix"]), to_jax(d["tau"]),
                           to_jax(d["gamma_prop"]), to_jax(d["eta"]),
                           interpret=True, with_old=with_old)
    assert ll_p.shape == (2, S)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=LL_RTOL)
    if not with_old:
        assert torch.equal(ll_p[0], torch.zeros(S))


@pytest.mark.parametrize("with_eta", [True, False])
@pytest.mark.parametrize("V,S,G", [(64, 8, 2), (96, 12, 3)])
def test_gamma_apply_eta_plain_matches_pallas(V, S, G, with_eta):
    d = _inputs(V, S, G, seed=V + 7)
    args = (d["n"], d["mix"], d["tau"], d["gamma_prop"], d["accept"],
            d["eta_prop"])
    mix_p, ll_p = ops.gamma_apply_eta_reference(*args, with_eta=with_eta)
    mix_j, ll_j = gamma_apply_eta_bmajor(
        _bm(d["n"]), _bm(d["mix"]), to_jax(d["tau"]), to_jax(d["gamma_prop"]),
        to_jax(d["accept"]), to_jax(d["eta_prop"]), interpret=True,
        with_eta=with_eta)
    np.testing.assert_allclose(mix_p.numpy(), np.asarray(from_bmajor(mix_j, S)),
                               rtol=1e-5, atol=1e-7)
    # accepted samples carry the proposal mixture, the others the old one
    acc = d["accept"]
    mp = mixture(one_hot_tau(d["tau"]), d["gamma_prop"])
    np.testing.assert_allclose(mix_p[:, acc].numpy(), mp[:, acc].numpy(),
                               rtol=1e-5, atol=1e-7)
    assert torch.equal(mix_p[:, ~acc], d["mix"][:, ~acc])
    if with_eta:
        np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=LL_RTOL)
    else:
        assert torch.equal(ll_p, torch.zeros(S))


@pytest.mark.parametrize("V,S,G", [(96, 12, 3), (64, 8, 4)])
def test_fused_sweep_plain_matches_pallas(V, S, G):
    d = _inputs(V, S, G, seed=V * G)
    tau_p, mix_p, ll_p = ops.fused_sweep_reference(
        d["n"], d["tau"], d["mix"], d["gamma"], d["eta"], d["gz"], d["g"],
        d["h"], d["logu"], d["gamma_prop"])
    tau_j, mix_j, ll_j = jax_fused_sweep(
        _bm(d["n"]), to_jax(d["tau"]), _bm(d["mix"]), to_jax(d["gamma"]),
        to_jax(d["eta"]), to_jax(d["gz"]).reshape(V, G * 4), jnp.int32(0),
        jnp.int32(G - 1), to_jax(d["logu"]), to_jax(d["gamma_prop"]),
        interpret=True)
    same = (tau_p == to_torch(tau_j)).all(dim=1)
    assert same.float().mean().item() >= 0.99
    np.testing.assert_allclose(mix_p[same].numpy(),
                               np.asarray(from_bmajor(mix_j, S))[same.numpy()],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=LL_RTOL)


def test_cpu_wrappers_take_the_plain_versions():
    d = _inputs(40, 6, 3, seed=12)
    fused = [d[k] for k in ("n", "tau", "mix", "gamma", "eta", "gz", "g", "h",
                            "logu", "gamma_prop")]
    ops.reset_launches()
    pairs = [
        (ops.swap(d["n"], d["tau"], d["mix"], d["gamma"], d["eta"], d["g"],
                  d["h"], d["logu"], emit_ll=True),
         ops.swap_reference(d["n"], d["tau"], d["mix"], d["gamma"], d["eta"],
                            d["g"], d["h"], d["logu"], emit_ll=True)),
        ((ops.gamma_ll(d["n"], d["mix"], d["tau"], d["gamma_prop"], d["eta"]),),
         (ops.gamma_ll_reference(d["n"], d["mix"], d["tau"], d["gamma_prop"],
                                 d["eta"]),)),
        (ops.gamma_apply_eta(d["n"], d["mix"], d["tau"], d["gamma_prop"],
                             d["accept"], d["eta_prop"]),
         ops.gamma_apply_eta_reference(d["n"], d["mix"], d["tau"],
                                       d["gamma_prop"], d["accept"],
                                       d["eta_prop"])),
        (ops.fused_sweep(*fused), ops.fused_sweep_reference(*fused)),
    ]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # no kernel ran, so nothing was counted
    counts = [ops.tau_sweep.launches, ops.swap.launches, ops.gamma_ll.launches,
              ops.gamma_apply_eta.launches, ops.fused_sweep.launches]
    assert counts == [0] * 5


@pytest.mark.parametrize("call,name,value,err", [
    ("gamma_ll", "gamma_prop", torch.zeros(6, 2), ValueError),
    ("gamma_ll", "tau", torch.zeros(40, 3, dtype=torch.int64), TypeError),
    ("gamma_apply_eta", "accept", torch.zeros(6), TypeError),
    ("gamma_apply_eta", "accept", torch.zeros(5, dtype=torch.bool), ValueError),
    ("fused_sweep", "gamma_prop", torch.zeros(6, 3, dtype=torch.float64),
     TypeError),
    ("fused_sweep", "logu", torch.zeros(40, 1), ValueError),
])
def test_wrappers_raise_on_what_the_kernels_cannot_take(call, name, value, err):
    d = _inputs(40, 6, 3, seed=13)
    params = {
        "gamma_ll": ("n", "mix", "tau", "gamma_prop", "eta"),
        "gamma_apply_eta": ("n", "mix", "tau", "gamma_prop", "accept",
                            "eta_prop"),
        "fused_sweep": ("n", "tau", "mix", "gamma", "eta", "gz", "g", "h",
                        "logu", "gamma_prop"),
    }[call]
    args = [value if p == name else d[p] for p in params]
    with pytest.raises(err, match=name):
        getattr(ops, call)(*args)
