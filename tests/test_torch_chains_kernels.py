"""The chain axis of the port's tau, swap and top-2 kernels: their plain
versions over a leading [C] axis against the JAX package's Pallas kernels
under ``jax.vmap`` (interpret mode on the CPU), the wrappers' checks and
launch plan over chains, and kernel_bench's inputs and bounds at C.

Each chain has its own tau, mixture, gamma, eta and noise, made with numpy
from a seed, on counts the chains share. Tau may differ from JAX only at
float near-ties of the Gumbel-argmax (agreement >= 0.99 a chain); where
tau agrees the mixture agrees to rtol 1e-6 (atol 1e-6 for the entries the
strain updates cancel to about zero).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu.ops import tau_topk as jt
from desman_tpu.ops.swap_pallas import swap_bmajor
from desman_tpu.ops.tau_pallas import from_bmajor, tau_sweep_pallas_from_gz, to_bmajor
from desman_tpu_torch import convert, ops, sampler, synth
from desman_tpu_torch.likelihood import mixture
from desman_tpu_torch.ops import _build, tau_kernel
from desman_tpu_torch.utils import one_hot_tau

from torch_helpers import to_jax, to_torch


def _chains(t, C, seed):
    """C chains' (tau [C,V,G], mix, gamma, eta, gz) on the counts of t."""
    V, S, _ = t.data.counts.shape
    G = t.tau_idx.shape[1]
    out = []
    for c in range(C):
        rng = np.random.default_rng(seed + c)
        tau = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32)
        gamma = torch.as_tensor(rng.dirichlet(np.ones(G), size=S), dtype=torch.float32)
        eta = synth.make_eta(0.01) * (1.0 + 0.1 * rng.random((4, 4)))
        eta = torch.as_tensor(eta / eta.sum(1, keepdims=True), dtype=torch.float32)
        gz = torch.as_tensor(3.0 * rng.gumbel(size=(V, G, 4)), dtype=torch.float32)
        out.append((tau, mixture(one_hot_tau(tau), gamma), gamma, eta, gz))
    return tuple(torch.stack(x) for x in zip(*out))


def _agree_and_close(tau_a, mix_a, tau_b, mix_b):
    for c in range(tau_a.shape[0]):
        same = (tau_a[c] == tau_b[c]).all(dim=1)
        assert same.float().mean().item() >= 0.99, (c, same.float().mean().item())
        np.testing.assert_allclose(mix_a[c][same].numpy(), mix_b[c][same].numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("C", [1, 2, 3])
def test_tau_plain_over_chains_matches_vmapped_pallas(C):
    t = synth.generate(V=64, S=8, G=3, coverage=50.0, seed=C)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    tau, mix, gamma, eta, gz = _chains(t, C, seed=10 * C)
    tau_p, mix_p = ops.tau_sweep(n, tau, mix, gamma, eta, gz)   # the CPU wrapper
    V, G = tau.shape[1:]
    tau_j, mix_j = jax.vmap(lambda *a: tau_sweep_pallas_from_gz(
        to_jax(n), *a, interpret=True))(
        to_jax(tau), to_jax(mix), to_jax(gamma), to_jax(eta),
        to_jax(gz).reshape(C, V, G * 4))
    _agree_and_close(tau_p, mix_p, to_torch(tau_j), to_torch(mix_j))
    for c in range(C):   # chain c is the one-chain sweep of its inputs, bit for bit
        one = ops.tau_sweep(n, tau[c], mix[c], gamma[c], eta[c], gz[c])
        assert torch.equal(one[0], tau_p[c]) and torch.equal(one[1], mix_p[c])


@pytest.mark.parametrize("C", [1, 2, 3])
def test_swap_plain_over_chains_matches_vmapped_pallas(C):
    V, S, G = 64, 8, 3
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=C + 3)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    rng = np.random.default_rng(C)
    taus, gammas, etas, gs, hs, logus = [], [], [], [], [], []
    for c in range(C):
        g, h = c % G, (c + 1) % G   # the true strains g, h exchanged at half the rows
        tau = t.tau_idx.copy()
        flip = rng.random(V) < 0.5
        tau[flip, g], tau[flip, h] = t.tau_idx[flip, h], t.tau_idx[flip, g]
        taus.append(tau)
        gammas.append(t.gamma * (1.0 + 0.05 * rng.random((S, G))))
        etas.append(t.eta)
        gs.append(g)
        hs.append(h)
        logus.append(np.log(rng.uniform(size=V)))
    tau = torch.as_tensor(np.stack(taus), dtype=torch.int32)
    gamma = torch.as_tensor(np.stack(gammas), dtype=torch.float32)
    gamma = gamma / gamma.sum(-1, keepdim=True)
    eta = torch.as_tensor(np.stack(etas), dtype=torch.float32)
    mix = torch.stack([mixture(one_hot_tau(tau[c]), gamma[c]) for c in range(C)])
    g = torch.tensor(gs, dtype=torch.int32)
    h = torch.tensor(hs, dtype=torch.int32)
    logu = torch.as_tensor(np.stack(logus), dtype=torch.float32)
    tau_p, mix_p = ops.swap(n, tau, mix, gamma, eta, g, h, logu)
    n_bm = to_bmajor(to_jax(n))
    tau_j, mix_j = jax.vmap(lambda tau, mix, gamma, eta, g, h, logu: swap_bmajor(
        n_bm, tau, to_bmajor(mix), gamma, eta, g, h, logu, interpret=True))(
        to_jax(tau), to_jax(mix), to_jax(gamma), to_jax(eta), to_jax(g), to_jax(h),
        to_jax(logu))
    mix_j = jax.vmap(lambda m: from_bmajor(m, S))(mix_j)
    _agree_and_close(tau_p, mix_p, to_torch(tau_j), to_torch(mix_j))
    for c in range(C):
        moved = (tau_p[c] != tau[c]).any(dim=1)
        assert moved.any() and not torch.equal(tau_p[c], tau[c])
        one = ops.swap(n, tau[c], mix[c], gamma[c], eta[c], g[c], h[c], logu[c])
        assert torch.equal(one[0], tau_p[c]) and torch.equal(one[1], mix_p[c])


@pytest.mark.parametrize("C", [1, 2, 3])
def test_topk_plain_over_chains_matches_vmapped_pallas(C):
    V, S, G = 64, 8, 3
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=C + 6, error_rate=0.0,
                       max_alleles=2)
    tau, mix, gamma, eta, gz = _chains(t, C, seed=20 * C)
    n_val, b_idx, n_bm = jt.compress_parts(t.data.counts)
    layout = convert.topk_layout_from_numpy(n_val, b_idx)
    tau_p, mix_p = ops.tau_sweep_topk(layout.n_val, layout.b_idx, tau, mix, gamma, eta,
                                      gz)
    tau_j, mix_j = jax.vmap(lambda tau, mix, gamma, eta, gz: jt.tau_sweep_topk_from_parts(
        jnp.asarray(n_val), jnp.asarray(b_idx), jnp.asarray(n_bm), tau, mix, gamma, eta,
        gz, swap_proposal=None, interpret=True))(
        to_jax(tau), to_jax(mix), to_jax(gamma), to_jax(eta),
        to_jax(gz).reshape(C, V, G * 4))
    _agree_and_close(tau_p, mix_p, to_torch(tau_j), to_torch(mix_j))
    for c in range(C):
        one = ops.tau_sweep_topk(layout.n_val, layout.b_idx, tau[c], mix[c], gamma[c],
                                 eta[c], gz[c])
        assert torch.equal(one[0], tau_p[c]) and torch.equal(one[1], mix_p[c])


def test_each_chain_may_bring_its_own_counts():
    """Counts with a chain axis ([C,V,S,4]; the top-2 layout [C,V,S,2]) are
    chain c's counts: the same bits as the shared counts where they are
    the same, and chain c's sweep on its own counts where they differ."""
    t = synth.generate(V=40, S=6, G=2, coverage=40.0, seed=1, error_rate=0.0,
                       max_alleles=2)
    u = synth.generate(V=40, S=6, G=2, coverage=40.0, seed=2, error_rate=0.0,
                       max_alleles=2)
    n = torch.as_tensor(np.stack([t.data.counts, u.data.counts]), dtype=torch.float32)
    tau, mix, gamma, eta, gz = _chains(t, 2, seed=5)
    got = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    for c in range(2):
        one = ops.tau_sweep(n[c], tau[c], mix[c], gamma[c], eta[c], gz[c])
        assert torch.equal(one[0], got[0][c]) and torch.equal(one[1], got[1][c])
    shared = ops.tau_sweep(n[0], tau, mix, gamma, eta, gz)
    assert torch.equal(shared[0][0], got[0][0]) and not torch.equal(shared[1], got[1])
    lay = [ops.tau_topk.topk_layout(x.data.counts, "cpu") for x in (t, u)]
    n_val = torch.stack([x.n_val for x in lay])
    b_idx = torch.stack([x.b_idx for x in lay])
    got = ops.tau_sweep_topk(n_val, b_idx, tau, mix, gamma, eta, gz)
    for c in range(2):
        one = ops.tau_sweep_topk(n_val[c], b_idx[c], tau[c], mix[c], gamma[c], eta[c],
                                 gz[c])
        assert torch.equal(one[0], got[0][c]) and torch.equal(one[1], got[1][c])


def _chain_args(C=3, V=30, S=5, G=3):
    t = synth.generate(V=V, S=S, G=G, coverage=40.0, seed=0)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    tau, mix, gamma, eta, gz = _chains(t, C, seed=0)
    g = torch.zeros(C, dtype=torch.int32)
    h = torch.ones(C, dtype=torch.int32)
    logu = torch.zeros((C, V))
    return n, tau, mix, gamma, eta, gz, g, h, logu


@pytest.mark.parametrize("field,bad,match", [
    ("gamma", lambda a: a[0], "gamma: expected shape"),
    ("eta", lambda a: a[:2], "eta: expected shape"),
    ("gz", lambda a: a[0], "gz: expected shape"),
    ("n", lambda a: a.expand(2, *a.shape).contiguous(), "n: expected shape"),
])
def test_tau_wrapper_refuses_a_chain_axis_it_cannot_take(field, bad, match):
    n, tau, mix, gamma, eta, gz, *_ = _chain_args()
    args = dict(n=n, tau=tau, mix=mix, gamma=gamma, eta=eta, gz=gz)
    args[field] = bad(args[field])
    with pytest.raises(ValueError, match=match):
        ops.tau_sweep(**args)


@pytest.mark.parametrize("field,bad,match", [
    ("g", lambda a: a[0], "g: expected shape"),
    ("h", lambda a: a[:1], "h: expected shape"),
    ("logu", lambda a: a[0], "logu: expected shape"),
    ("mix", lambda a: a[0], "mix: expected shape"),
])
def test_swap_wrapper_refuses_a_chain_axis_it_cannot_take(field, bad, match):
    n, tau, mix, gamma, eta, _, g, h, logu = _chain_args()
    args = dict(n=n, tau=tau, mix=mix, gamma=gamma, eta=eta, g=g, h=h, logu=logu)
    args[field] = bad(args[field])
    with pytest.raises(ValueError, match=match):
        ops.swap(**args)


def test_swap_emit_ll_takes_one_chain():
    n, tau, mix, gamma, eta, _, g, h, logu = _chain_args()
    for fn in (ops.swap, ops.swap_reference):
        with pytest.raises(ValueError, match="emit_ll takes one chain"):
            fn(n, tau, mix, gamma, eta, g, h, logu, emit_ll=True)


def test_topk_wrapper_refuses_a_layout_of_odd_chain_stride():
    """A chain's [V,S,2] layout of odd V*S cells would not start on 16 bytes
    (the kernel's bulk copies): the wrapper refuses it on every device."""
    t = synth.generate(V=5, S=3, G=2, coverage=40.0, seed=0, error_rate=0.0,
                       max_alleles=2)
    lay = ops.tau_topk.topk_layout(t.data.counts, "cpu")
    tau, mix, gamma, eta, gz = _chains(t, 2, seed=0)
    two = [x.expand(2, *x.shape).contiguous() for x in lay]
    with pytest.raises(ValueError, match="odd V"):
        ops.tau_sweep_topk(*two, tau, mix, gamma, eta, gz)


def test_cpu_chain_wrappers_launch_nothing():
    """On CPU tensors the chain-axis wrappers take their plain versions and
    count neither a launch nor a chain; reset_launches zeroes both counts."""
    n, tau, mix, gamma, eta, gz, g, h, logu = _chain_args()
    ops.tau_sweep.chain_launches = ops.swap.chain_launches = 7
    ops.reset_launches()
    ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    ops.swap(n, tau, mix, gamma, eta, g, h, logu)
    assert all(w.launches == 0 and w.chain_launches == 0 for w in ops.CHAIN_AXIS)
    assert set(ops.CHAIN_AXIS) == {ops.tau_sweep, ops.swap, ops.tau_sweep_topk,
                                   ops.gamma_ll, ops.gamma_apply_eta, ops.fused_sweep}


def test_resident_grid_splits_the_blocks_over_the_chains(monkeypatch):
    """A chain-axis launch: the card's resident blocks split evenly over the
    chains (grid rows), at least one a chain, no more than a chain's tiles,
    capped by max_blocks; one chain is the one-chain grid."""
    card = (48, 0, 5, 132)   # 660 resident blocks
    monkeypatch.setattr(tau_kernel, "_info", lambda kernel, S, G, device: (
        tau_kernel.plan(kernel, S, G), card))
    grid = tau_kernel.resident_grid
    assert grid("tau_sweep", 10_000, 64, 8, 0) == grid("tau_sweep", 10_000, 64, 8, 0,
                                                        chains=1)
    assert grid("tau_sweep", 10_000, 64, 8, 0, chains=5)[1] == 132
    assert grid("tau_sweep", 10_000, 64, 8, 0, chains=40)[1] == 16
    assert grid("tau_sweep_topk", 10_000, 64, 8, 0, chains=1000)[1] == 1
    assert grid("tau_sweep", 100, 64, 8, 0, chains=5)[1] == 13
    assert grid("tau_sweep", 10_000, 64, 8, 0, max_blocks=7, chains=5)[1] == 7


def test_per_chain_stacks_each_chain_of_a_plain_version():
    calls = []

    def fn(n, x):
        calls.append((n.shape, x.shape))
        return x + n.sum(), x * 2

    n = torch.ones(4, 3, 2)
    x = torch.arange(6.0).reshape(2, 3)
    a, b = _build.per_chain(fn, (n,), x)
    assert torch.equal(a, x + 24.0) and torch.equal(b, x * 2)
    assert calls == [((4, 3, 2), (3,))] * 2
    a, _ = _build.per_chain(fn, (torch.ones(2, 4, 3, 2) * torch.tensor([1.0, 2.0])[
        :, None, None, None],), x)
    assert torch.equal(a, x + torch.tensor([[24.0], [48.0]]))


def test_kernel_bench_counts_the_shared_counts_once():
    """The bound of C chains in one launch: the counts' bytes once, every
    other byte and every log C times; C = 1 is the one-chain bound."""
    from desman_tpu_torch import kernel_bench as kb

    V, S, G = kb.METRIC
    for name in kb.CHAIN_AXIS:
        logs1, bytes1 = kb.kernel_work(name, V, S, G)
        logs5, bytes5 = kb.kernel_work(name, V, S, G, 5)
        counts = 16 * V * S   # n [V,S,4] f32, or n_val and b_idx [V,S,2] each 8 B a cell
        assert logs5 == 5 * logs1 and bytes5 == counts + 5 * (bytes1 - counts)
        assert kb.bound(name, V, S, G, 1) == kb.bound(name, V, S, G)
        assert kb.bound(name, V, S, G, 40)["bound_ms"] > kb.bound(name, V, S, G, 5)[
            "bound_ms"]


@pytest.mark.parametrize("topk", [False, True])
def test_kernel_bench_chain_inputs(topk):
    """Chain 0 of kernel_bench.chain_inputs is the one-chain inputs (so its
    outputs carry the digests); the others differ, on the same counts, with
    gamma and eta rows on the simplex; chain_calls' launch is each chain's
    call on the CPU, bit for bit."""
    from desman_tpu_torch import kernel_bench as kb

    d = kb.chain_inputs(40, 12, 3, 3, topk)
    first = kb.topk_inputs(40, 12, 3) if topk else kb.phase3_inputs(40, 12, 3)
    for k in ("tau", "mix", "gamma", "eta", "gz"):
        assert d[k].shape[0] == 3 and torch.equal(d[k][0], first[k]), k
        assert not torch.equal(d[k][1], d[k][2]), k
    np.testing.assert_allclose(d["gamma"].sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(d["eta"].sum(-1).numpy(), 1.0, rtol=1e-6)
    for c in range(3):
        np.testing.assert_allclose(
            d["mix"][c].numpy(), mixture(one_hot_tau(d["tau"][c]), d["gamma"][c]).numpy(),
            rtol=1e-6, atol=1e-7)
    for name in (("tau_sweep_topk",) if topk else
                 ("tau_sweep", "swap", "gamma_ll", "gamma_apply_eta", "fused_sweep")):
        batched, one = kb.chain_calls(ops, name, d)
        got = batched()
        got = got if isinstance(got, tuple) else (got,)   # gamma_ll: one output
        for c in range(3):
            solo = one(c)
            solo = solo if isinstance(solo, tuple) else (solo,)
            assert all(torch.equal(a[c], b) for a, b in zip(got, solo)), (name, c)


def test_kernel_bench_paths_take_each_trees_modules():
    """measure_paths drives each tree's own sampler, multibin and
    profile_sweep: tree_module resolves a module in the package of the ops
    module it is given (here this checkout loaded again under another
    name)."""
    from desman_tpu_torch import kernel_bench as kb
    from desman_tpu_torch import multibin, profile_sweep

    root = Path(__file__).resolve().parents[1]
    other = kb.load_ops(root, "desman_tpu_torch_paths_under_test")
    assert kb.tree_module(ops, "multibin") is multibin
    assert kb.tree_module(ops, "profile_sweep") is profile_sweep
    theirs = kb.tree_module(other, "sampler")
    assert theirs.__name__ == "desman_tpu_torch_paths_under_test.sampler"
    assert theirs.run_chains is not sampler.run_chains
