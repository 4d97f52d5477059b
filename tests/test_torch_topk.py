"""The port's top-2 tau sweep (``--kernel cuda_topk``) against the JAX
package's (``desman_tpu.ops.tau_topk``): the compressed layout, the plain
version against the Pallas kernel in interpret mode and against the port's
full sweep, a 10-sweep replay of JAX's topk chain, and the refusals.

Inputs are made with numpy from a seed: biallelic, error-free counts, where
every (position, sample) cell observes at most two bases. Tau may differ
only at float near-ties of the Gumbel-argmax (agreement >= 0.99); the
mixture agrees to rtol 1e-5 on positions whose tau agrees (f32 sums over
2S slots in another order). V=96 is one JAX tile without pad rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import sampler as js
from desman_tpu.ops import tau_topk as jt
from desman_tpu_torch import cli, convert, io, ops, run, sampler, synth
from desman_tpu_torch.likelihood import mixture
from desman_tpu_torch.utils import one_hot_tau, snp_distance_perm

from torch_helpers import (
    TESTDATA, ReplayNoise, check_replayed_sweep, jax_state_numpy, to_jax,
    to_torch,
)


def _biallelic(V=96, S=12, G=3, seed=0):
    return synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed,
                          error_rate=0.0, max_alleles=2)


def _sweep_inputs(t, G, seed):
    """A random start on the counts of t, a non-trivial eta (with the data's
    identity eta most logs would sit at the 1e-12 floor) and tempered
    Gumbel noise."""
    V, S, _ = t.data.counts.shape
    rng = np.random.default_rng(seed)
    tau = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32)
    gamma = torch.as_tensor(t.gamma, dtype=torch.float32)
    eta = torch.as_tensor(synth.make_eta(0.01), dtype=torch.float32)
    mix = mixture(one_hot_tau(tau), gamma)
    gz = torch.as_tensor(3.0 * rng.gumbel(size=(V, G, 4)), dtype=torch.float32)
    return tau, mix, gamma, eta, gz


def _agree_and_close(tau_a, mix_a, tau_b, mix_b):
    same = (tau_a == tau_b).all(dim=1)
    assert same.float().mean().item() >= 0.99, same.float().mean().item()
    np.testing.assert_allclose(mix_a[same].numpy(), mix_b[same].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("V,S,G,seed", [(96, 12, 3, 0), (77, 6, 5, 1), (40, 1, 2, 2)])
def test_compress_counts_matches_jax(V, S, G, seed):
    counts = _biallelic(V, S, G, seed).data.counts
    ours, theirs = ops.compress_counts(counts), jt.compress_counts(counts)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_compress_counts_refuses_dense_counts_as_jax_does():
    counts = synth.generate(V=64, S=8, G=6, coverage=80.0, seed=0).data.counts
    with pytest.raises(ValueError) as theirs:
        jt.compress_counts(counts)
    with pytest.raises(ops.TopkInapplicable) as ours:
        ops.compress_counts(counts)
    assert str(ours.value) == str(theirs.value)
    assert ">2 observed bases" in str(ours.value)


def test_layout_holds_the_counts_in_base_order():
    counts = _biallelic(V=50, S=7, seed=3).data.counts
    layout = convert.topk_layout_from_numpy(*jt.compress_counts(counts))
    n_val, b_idx = layout.n_val.numpy(), layout.b_idx.numpy()
    assert n_val.shape == b_idx.shape == (50, 7, 2)
    assert (b_idx[..., 0] <= b_idx[..., 1]).all()
    back = np.zeros(counts.shape, np.float32)
    for k in range(2):
        np.add.at(back, (*np.indices(b_idx.shape[:2]), b_idx[..., k]), n_val[..., k])
    assert np.array_equal(back, counts.astype(np.float32))
    # the port's own layout is the same
    mine = ops.tau_topk.topk_layout(counts, "cpu")
    assert torch.equal(mine.n_val, layout.n_val) and torch.equal(mine.b_idx, layout.b_idx)


@pytest.mark.parametrize("V,S,G", [(96, 12, 3), (77, 6, 2), (64, 8, 4)])
def test_topk_plain_matches_pallas(V, S, G):
    t = _biallelic(V, S, G, seed=V + G)
    tau, mix, gamma, eta, gz = _sweep_inputs(t, G, seed=V)
    n_val, b_idx, n_bm = jt.compress_parts(t.data.counts)
    layout = convert.topk_layout_from_numpy(n_val, b_idx)
    tau_p, mix_p = ops.tau_sweep_topk(layout.n_val, layout.b_idx, tau, mix, gamma,
                                      eta, gz)
    tau_j, mix_j = jt.tau_sweep_topk_from_parts(
        jnp.asarray(n_val), jnp.asarray(b_idx), jnp.asarray(n_bm), to_jax(tau),
        to_jax(mix), to_jax(gamma), to_jax(eta), to_jax(gz).reshape(V, G * 4),
        swap_proposal=None, interpret=True)
    _agree_and_close(tau_p, mix_p, to_torch(tau_j), to_torch(mix_j))
    np.testing.assert_allclose(mix_p.numpy(),
                               mixture(one_hot_tau(tau_p), gamma).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(mix, mixture(one_hot_tau(tau), gamma))  # inputs kept


@pytest.mark.parametrize("V,S,G", [(96, 12, 3), (33, 1, 1), (50, 40, 6)])
def test_topk_plain_matches_the_full_sweep(V, S, G):
    t = _biallelic(V, S, G, seed=G)
    tau, mix, gamma, eta, gz = _sweep_inputs(t, G, seed=S)
    layout = ops.tau_topk.topk_layout(t.data.counts, "cpu")
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    got = ops.tau_sweep_topk(layout.n_val, layout.b_idx, tau, mix, gamma, eta, gz)
    want = ops.tau_sweep_reference(n, tau, mix, gamma, eta, gz)
    _agree_and_close(*got, *want)


def test_topk_chain_replays_the_jax_topk_chain():
    """From JAX's state at each sweep of its topk chain, the port's
    cuda_topk sweep fed JAX's streams lands where JAX's lands."""
    t = _biallelic(seed=21)
    cfg_kw = dict(G=3, nmf_iters=100)
    jcfg, pcfg = js.SamplerConfig(**cfg_kw), sampler.SamplerConfig(**cfg_kw)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    jstate = js.init_state(n_j, jcfg, jax.random.PRNGKey(4))
    jaccum = js.init_accum(96, 12, 3)
    jsweep = jax.jit(js.make_sweep_fn(
        jcfg, tau_sweep=jt.make_tau_sweep_topk(t.data.counts, interpret=True)))
    psweep = sampler.make_sweep_fn(pcfg, ops.resolve("cuda_topk", n_p))

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


def test_cuda_topk_chain_agrees_with_the_cuda_chain():
    """One seed, the same draws: on the CPU the two plain sweeps sum in
    another order, so the chains agree up to float near-ties."""
    t = _biallelic(V=80, S=10, G=3, seed=2)
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=3, burn=40, samples=40, nmf_iters=100)
    runs = {k: sampler.run_chain(n, cfg, torch.Generator().manual_seed(0),
                                 kernel=k) for k in ("cuda_topk", "cuda")}
    assert snp_distance_perm(t.tau_idx, runs["cuda_topk"].tau_star.numpy()) == 0
    assert torch.equal(runs["cuda_topk"].tau_star, runs["cuda"].tau_star)
    np.testing.assert_allclose(runs["cuda_topk"].loglik_trace.numpy(),
                               runs["cuda"].loglik_trace.numpy(), rtol=1e-5)


def test_bound_sweep_and_resolve_refuse_other_counts():
    t = _biallelic(V=20, S=4, G=2)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    with pytest.raises(ValueError, match="bound to the counts"):
        ops.resolve("cuda_topk")
    ks = ops.resolve("cuda_topk", n)
    tau, mix, gamma, eta, gz = _sweep_inputs(t, 2, seed=0)
    with pytest.raises(ValueError, match="bound to counts"):
        ks.tau_sweep(n[:10], tau[:10], mix[:10], gamma, eta, gz[:10])
    with pytest.raises(TypeError, match="b_idx"):
        ops.tau_sweep_topk(*ops.tau_topk.topk_layout(t.data.counts, "cpu")[:1],
                           torch.zeros(20, 4, 2), tau, mix, gamma, eta, gz)


def test_run_refuses_dense_counts_before_the_first_sweep(tmp_path):
    data = io.read_counts_csv(f"{TESTDATA}/variant_counts.csv")
    out = tmp_path / "out"
    with pytest.raises(ops.TopkInapplicable, match=">2 observed bases"):
        run.run(data, run.RunConfig(G=3, iterations=4, out_dir=str(out)),
                device="cpu", kernel="cuda_topk")
    assert not out.exists()


def test_cli_refuses_dense_counts_with_the_reason(tmp_path, capsys):
    ops.reset_launches()
    rc = cli.main(["desman", f"{TESTDATA}/variant_counts.csv", "-g", "3", "-i", "4",
                   "--kernel", "cuda_topk", "--device", "cpu",
                   "-o", str(tmp_path / "out")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "cuda_topk" in err and ">2 observed bases" in err
    assert not (tmp_path / "out").exists()
