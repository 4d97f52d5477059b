"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. The tests
directory's conftest imports jax, which a GPU installation of the port need
not have, so run them there without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from a seed and fed to both versions; the noise
is shared, so tau may differ only at float near-ties.
"""
import numpy as np
import pytest
import torch

from desman_tpu_torch import ops, synth
from desman_tpu_torch.likelihood import mixture
from desman_tpu_torch.utils import one_hot_tau

pytestmark = pytest.mark.cuda

# (V, S, G): ragged V, S below / above / at a multiple of the warp, G = 1
SHAPES = [(77, 12, 3), (96, 40, 5), (1000, 64, 8), (33, 1, 1), (64, 33, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(V, S, G, seed, device):
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed)
    rng = np.random.default_rng(seed)
    tau = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32)
    gamma = torch.as_tensor(t.gamma, dtype=torch.float32)
    eta = torch.as_tensor(t.eta, dtype=torch.float32)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    mix = mixture(one_hot_tau(tau), gamma)
    gz = torch.as_tensor(rng.gumbel(size=(V, G, 4)), dtype=torch.float32)
    return [x.to(device) for x in (n, tau, mix, gamma, eta, gz)]


@pytest.mark.parametrize("V,S,G", SHAPES)
def test_tau_kernel_matches_plain(cuda, V, S, G):
    n, tau, mix, gamma, eta, gz = _inputs(V, S, G, 0, cuda)
    before = ops.tau_sweep.launches
    tau_k, mix_k = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    torch.cuda.synchronize()
    assert ops.tau_sweep.launches == before + 1
    tau_p, mix_p = ops.tau_sweep_reference(n, tau, mix, gamma, eta, gz)
    same = (tau_k == tau_p).all(dim=1)
    assert same.float().mean().item() >= 0.99
    torch.testing.assert_close(mix_k[same], mix_p[same], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mix_k, mixture(one_hot_tau(tau_k), gamma),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("V,S,G", SHAPES)
def test_swap_kernel_matches_plain(cuda, V, S, G):
    n, tau, mix, gamma, eta, _ = _inputs(V, S, G, 1, cuda)
    rng = np.random.default_rng(7)
    logu = torch.as_tensor(np.log(rng.uniform(size=V)), dtype=torch.float32,
                           device=cuda)
    pairs = [(0, 0)] if G == 1 else [(0, G - 1), (G - 1, 0), (G // 2, 0)]
    for g, h in pairs:
        gt = torch.tensor(g, dtype=torch.int32, device=cuda)
        ht = torch.tensor(h, dtype=torch.int32, device=cuda)
        tau_k, mix_k = ops.swap(n, tau, mix, gamma, eta, gt, ht, logu)
        tau_p, mix_p = ops.swap_reference(n, tau, mix, gamma, eta, gt, ht, logu)
        torch.cuda.synchronize()
        same = (tau_k == tau_p).all(dim=1)
        assert same.float().mean().item() >= 0.99
        torch.testing.assert_close(mix_k[same], mix_p[same], rtol=1e-5,
                                   atol=1e-6)
        if g == h:  # never accepts
            assert torch.equal(tau_k, tau) and torch.equal(mix_k, mix)


def _resident_inputs(V, S, G, seed, device):
    """The tau-sweep inputs plus a swap proposal and a gamma proposal."""
    n, tau, mix, gamma, eta, gz = _inputs(V, S, G, seed, device)
    rng = np.random.default_rng(seed + 100)
    g, h = (0, 0) if G == 1 else (G - 1, 0)
    logu = torch.as_tensor(np.log(rng.uniform(size=V)), dtype=torch.float32)
    gp = torch.as_tensor(rng.dirichlet(np.ones(G), size=S), dtype=torch.float32)
    extra = (torch.tensor(g, dtype=torch.int32), torch.tensor(h, dtype=torch.int32),
             logu, gp)
    return (n, tau, mix, gamma, eta, gz) + tuple(x.to(device) for x in extra)


def _assert_ll_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("V,S,G", SHAPES)
def test_swap_emit_ll_matches_plain(cuda, V, S, G):
    n, tau, mix, gamma, eta, _, g, h, logu, _ = _resident_inputs(V, S, G, 3, cuda)
    tau_k, mix_k, ll_k = ops.swap(n, tau, mix, gamma, eta, g, h, logu, emit_ll=True)
    tau_p, mix_p, ll_p = ops.swap_reference(n, tau, mix, gamma, eta, g, h, logu,
                                            emit_ll=True)
    tau_0, mix_0 = ops.swap(n, tau, mix, gamma, eta, g, h, logu)
    torch.cuda.synchronize()
    same = (tau_k == tau_p).all(dim=1)
    assert same.float().mean().item() >= 0.99
    torch.testing.assert_close(mix_k[same], mix_p[same], rtol=1e-5, atol=1e-6)
    if bool(same.all()):
        _assert_ll_close(ll_k, ll_p)
    # emit_ll=False makes the same move
    assert (tau_0 == tau_k).all(dim=1).float().mean().item() >= 0.99


@pytest.mark.parametrize("with_old", [True, False])
@pytest.mark.parametrize("V,S,G", SHAPES)
def test_gamma_ll_kernel_matches_plain(cuda, V, S, G, with_old):
    n, tau, mix, _, eta, _, _, _, _, gp = _resident_inputs(V, S, G, 4, cuda)
    before = ops.gamma_ll.launches
    ll_k = ops.gamma_ll(n, mix, tau, gp, eta, with_old=with_old)
    torch.cuda.synchronize()
    assert ops.gamma_ll.launches == before + 1
    _assert_ll_close(ll_k, ops.gamma_ll_reference(n, mix, tau, gp, eta, with_old))
    if not with_old:
        assert torch.equal(ll_k[0], torch.zeros_like(ll_k[0]))


@pytest.mark.parametrize("with_eta", [True, False])
@pytest.mark.parametrize("V,S,G", SHAPES)
def test_gamma_apply_eta_kernel_matches_plain(cuda, V, S, G, with_eta):
    n, tau, mix, _, eta, _, _, _, _, gp = _resident_inputs(V, S, G, 5, cuda)
    accept = torch.as_tensor(np.random.default_rng(V).random(S) < 0.5, device=cuda)
    eta_prop = eta.flip(0).contiguous()
    mix_k, ll_k = ops.gamma_apply_eta(n, mix, tau, gp, accept, eta_prop, with_eta)
    mix_p, ll_p = ops.gamma_apply_eta_reference(n, mix, tau, gp, accept, eta_prop,
                                                with_eta)
    torch.cuda.synchronize()
    torch.testing.assert_close(mix_k, mix_p, rtol=1e-5, atol=1e-7)
    if with_eta:
        _assert_ll_close(ll_k, ll_p)
    else:
        assert torch.equal(ll_k, torch.zeros_like(ll_k))


def _staged(n, tau, mix, gamma, eta, gz, g, h, logu, gp):
    t, m = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    t, m, ll_old = ops.swap(n, t, m, gamma, eta, g, h, logu, emit_ll=True)
    return t, m, ll_old, ops.gamma_ll(n, m, t, gp, eta, with_old=False)


@pytest.mark.parametrize("V,S,G", [s for s in SHAPES if s[2] > 1])
def test_fused_sweep_is_bitwise_the_staged_kernels(cuda, V, S, G):
    args = _resident_inputs(V, S, G, 6, cuda)
    tau_f, mix_f, ll_f = ops.fused_sweep(*args)
    tau_s, mix_s, ll_old, ll2 = _staged(*args)
    torch.cuda.synchronize()
    assert torch.equal(tau_f, tau_s)
    assert torch.equal(mix_f, mix_s)
    assert torch.equal(ll_f[0], ll_old)
    assert torch.equal(ll_f[1], ll2[1])
    # and against the plain versions
    tau_p, mix_p, ll_p = ops.fused_sweep_reference(*args)
    same = (tau_f == tau_p).all(dim=1)
    assert same.float().mean().item() >= 0.99
    torch.testing.assert_close(mix_f[same], mix_p[same], rtol=1e-4, atol=1e-5)
    if bool(same.all()):
        _assert_ll_close(ll_f, ll_p)


def test_kernels_are_bitwise_repeatable(cuda):
    args = _resident_inputs(1000, 64, 8, 7, cuda)
    n, tau, mix, gamma, eta, gz, g, h, logu, gp = args
    accept = torch.arange(64, device=cuda) % 3 == 0
    runs = [(ops.fused_sweep(*args),
             ops.gamma_ll(n, mix, tau, gp, eta),
             ops.gamma_apply_eta(n, mix, tau, gp, accept, eta),
             ops.swap(n, tau, mix, gamma, eta, g, h, logu, emit_ll=True))
            for _ in range(2)]
    torch.cuda.synchronize()
    flat = [[x for out in run for x in (out if isinstance(out, tuple) else (out,))]
            for run in runs]
    for a, b in zip(*flat):
        assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    n, tau, mix, gamma, eta, gz = _inputs(16, 4, 2, 2, cuda)
    with pytest.raises(ValueError, match="gz"):
        ops.tau_sweep(n, tau, mix, gamma, eta, gz.cpu())
    # contiguous, but one float past a 16-byte boundary: no float4 loads
    shifted = n.reshape(-1)[1:65].reshape(4, 4, 4)
    with pytest.raises(ValueError, match="16-byte"):
        ops.tau_sweep(shifted, tau[:4], mix[:4], gamma, eta, gz[:4])


def test_sampler_runs_through_kernels(cuda):
    from desman_tpu_torch.sampler import SamplerConfig, run_chain

    t = synth.generate(V=200, S=8, G=3, coverage=60.0, seed=5)
    n = torch.as_tensor(t.data.counts, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    ops.reset_launches()
    res = run_chain(n, SamplerConfig(G=3, burn=30, samples=30, nmf_iters=100),
                    gen, eta_init=torch.as_tensor(t.eta, device=cuda))
    torch.cuda.synchronize()
    assert ops.tau_sweep.launches == 60 and ops.swap.launches == 60
    assert torch.isfinite(res.loglik_trace).all()
    from desman_tpu_torch.utils import snp_distance_perm

    assert snp_distance_perm(t.tau_idx, res.tau_star.cpu().numpy()) <= 4


def test_resident_sampler_runs_through_its_kernels(cuda):
    from desman_tpu_torch.sampler import SamplerConfig, run_chain
    from desman_tpu_torch.utils import snp_distance_perm

    t = synth.generate(V=200, S=8, G=3, coverage=60.0, seed=5)
    n = torch.as_tensor(t.data.counts, device=cuda)
    cfg = SamplerConfig(G=3, burn=30, samples=30, nmf_iters=100)
    results = []
    for _ in range(2):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        ops.reset_launches()
        results.append(run_chain(n, cfg, gen, kernel="cuda_resident"))
        torch.cuda.synchronize()
        assert (ops.fused_sweep.launches, ops.gamma_apply_eta.launches) == (60, 60)
        assert (ops.tau_sweep.launches, ops.swap.launches,
                ops.gamma_ll.launches) == (0, 0, 0)
    a, b = results
    for x, y in zip(a, b):   # same seed, same bits: no atomics anywhere
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.isfinite(a.loglik_trace).all()
    assert snp_distance_perm(t.tau_idx, a.tau_star.cpu().numpy()) <= 4


def test_resident_one_strain_takes_gamma_ll(cuda):
    from desman_tpu_torch.sampler import SamplerConfig, run_chain

    t = synth.generate(V=150, S=6, G=1, coverage=40.0, seed=2)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    ops.reset_launches()
    res = run_chain(torch.as_tensor(t.data.counts, device=cuda),
                    SamplerConfig(G=1, burn=5, samples=5, nmf_iters=20), gen,
                    kernel="cuda_resident")
    torch.cuda.synchronize()
    assert (ops.tau_sweep.launches, ops.gamma_ll.launches,
            ops.gamma_apply_eta.launches, ops.fused_sweep.launches) == (10, 10, 10, 0)
    assert torch.isfinite(res.loglik_trace).all()


# ---- the top-2 tau kernel (cuda_topk) and independent chains ----

TOPK_SHAPES = [(77, 12, 3), (96, 40, 5), (1000, 64, 8), (33, 1, 1), (64, 33, 2)]


def _topk_inputs(V, S, G, seed, device):
    """Biallelic, error-free counts (at most two observed bases per cell),
    with a non-trivial eta, and the top-2 layout of the counts."""
    from desman_tpu_torch.ops.tau_topk import topk_layout

    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed, error_rate=0.0,
                       max_alleles=2)
    rng = np.random.default_rng(seed)
    tau = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32)
    gamma = torch.as_tensor(t.gamma, dtype=torch.float32)
    eta = torch.as_tensor(synth.make_eta(0.01), dtype=torch.float32)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    mix = mixture(one_hot_tau(tau), gamma)
    gz = torch.as_tensor(rng.gumbel(size=(V, G, 4)), dtype=torch.float32)
    layout = topk_layout(t.data.counts, device)
    return (layout.n_val, layout.b_idx), [x.to(device) for x in (n, tau, mix, gamma, eta, gz)]


@pytest.mark.parametrize("V,S,G", TOPK_SHAPES)
def test_topk_kernel_matches_plain_and_the_tau_kernel(cuda, V, S, G):
    (n_val, b_idx), (n, tau, mix, gamma, eta, gz) = _topk_inputs(V, S, G, 8, cuda)
    before = ops.tau_sweep_topk.launches
    tau_k, mix_k = ops.tau_sweep_topk(n_val, b_idx, tau, mix, gamma, eta, gz)
    tau_f, mix_f = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    again = ops.tau_sweep_topk(n_val, b_idx, tau, mix, gamma, eta, gz)
    torch.cuda.synchronize()
    assert ops.tau_sweep_topk.launches == before + 2
    tau_p, mix_p = ops.tau_sweep_topk_reference(n_val, b_idx, tau, mix, gamma, eta, gz)
    same = (tau_k == tau_p).all(dim=1)
    assert same.float().mean().item() >= 0.99
    torch.testing.assert_close(mix_k[same], mix_p[same], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mix_k, mixture(one_hot_tau(tau_k), gamma),
                               rtol=1e-5, atol=1e-6)
    # bitwise the full tau kernel on <=2-base counts, and itself
    assert torch.equal(tau_k, tau_f) and torch.equal(mix_k, mix_f)
    assert torch.equal(again[0], tau_k) and torch.equal(again[1], mix_k)


def test_topk_chain_is_bitwise_the_cuda_chain(cuda):
    from desman_tpu_torch.sampler import SamplerConfig, run_chain

    t = synth.generate(V=300, S=12, G=4, coverage=50.0, seed=3, error_rate=0.0,
                       max_alleles=2)
    n = torch.as_tensor(t.data.counts, device=cuda)
    cfg = SamplerConfig(G=4, burn=30, samples=30, nmf_iters=100)
    results = {}
    for kernel in ("cuda_topk", "cuda"):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        ops.reset_launches()
        results[kernel] = run_chain(n, cfg, gen, kernel=kernel)
        torch.cuda.synchronize()
        launched = (ops.tau_sweep_topk.launches, ops.tau_sweep.launches)
        assert launched == ((60, 0) if kernel == "cuda_topk" else (0, 60))
        assert ops.swap.launches == 60
    for name, a, b in zip(results["cuda"]._fields, results["cuda_topk"],
                          results["cuda"]):
        assert (a is None and b is None) or torch.equal(a, b), name


def test_run_chains_on_the_card(cuda):
    from desman_tpu_torch.sampler import SamplerConfig, run_chain, run_chains

    t = synth.generate(V=200, S=8, G=3, coverage=60.0, seed=5)
    n = torch.as_tensor(t.data.counts, device=cuda)
    cfg = SamplerConfig(G=3, burn=10, samples=10, nmf_iters=50)
    ops.reset_launches()
    res = run_chains(n, cfg, [0, 1], kernel="cuda_resident")
    torch.cuda.synchronize()
    assert ops.fused_sweep.launches == 40
    assert res.loglik_trace.shape == (2, 20) and res.loglik_trace.is_cuda
    for i, seed in enumerate((0, 1)):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(seed)
        one = run_chain(n, cfg, gen, kernel="cuda_resident")
        for name, a, b in zip(one._fields, res, one):
            assert (a is None and b is None) or torch.equal(a[i], b), (seed, name)


def test_topk_refuses_dense_counts_on_the_card(cuda):
    t = synth.generate(V=64, S=8, G=6, coverage=80.0, seed=0)
    with pytest.raises(ops.TopkInapplicable, match=">2 observed bases"):
        ops.resolve("cuda_topk", torch.as_tensor(t.data.counts, device=cuda))


# ---- the run modes and GeneAssign on the card ----


def test_assign_gene_tau_gibbs_runs_the_tau_kernel(cuda):
    """The annealed path (4^8 > state_cap) through the tau kernel and
    through its plain version, from one generator seed: the kernel launches
    once per sweep, and the two error rates against the truth agree within
    0.5 points (a near-tie flip changes that position's later draws only)."""
    from desman_tpu_torch.geneassign import assign_gene_tau

    t = synth.generate(V=600, S=32, G=8, coverage=50.0, seed=4)
    rates = {}
    for kernel in ("cuda", "torch"):
        ops.reset_launches()
        star, mean = assign_gene_tau(t.data.counts, t.gamma, t.eta, sweeps=50,
                                     device=cuda, kernel=kernel)
        torch.cuda.synchronize()
        assert ops.tau_sweep.launches == (50 if kernel == "cuda" else 0)
        assert star.is_cuda and torch.isfinite(mean).all()
        rates[kernel] = (star.cpu().numpy() != t.tau_idx).mean()
    assert abs(rates["cuda"] - rates["torch"]) <= 0.005, rates


def test_store_every_chain_is_bitwise_the_chain_without(cuda):
    import dataclasses

    from desman_tpu_torch.sampler import SamplerConfig, run_chain

    t = synth.generate(V=300, S=8, G=3, coverage=60.0, seed=6)
    n = torch.as_tensor(t.data.counts, device=cuda)
    base = SamplerConfig(G=3, burn=20, samples=20, nmf_iters=50)
    results = []
    for cfg in (base, dataclasses.replace(base, store_samples=True, store_thin=4)):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        ops.reset_launches()
        results.append(run_chain(n, cfg, gen))
        torch.cuda.synchronize()
        assert ops.tau_sweep.launches == 40 and ops.swap.launches == 40
    plain, stored = results
    for name, a, b in zip(plain._fields, plain, stored):
        if a is not None:
            assert torch.equal(a, b), name
    assert stored.tau_samples.shape == (5, 300, 3) and stored.tau_samples.is_cuda
    assert stored.tau_samples.dtype == torch.int8
