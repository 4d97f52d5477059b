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
