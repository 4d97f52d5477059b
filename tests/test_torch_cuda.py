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
# the row-resident tau and fused kernels also at: a staged tile above 48 KB
# of shared memory, the rows in device memory, and 250 tiles of S=96 G=16
# (test_resident_kernels_are_bitwise_repeatable caps the grid, so that a
# block walks many tiles)
RESIDENT_SHAPES = SHAPES + [(64, 600, 4), (64, 1000, 4), (2000, 96, 16)]


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


@pytest.mark.parametrize("V,S,G", RESIDENT_SHAPES)
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


@pytest.mark.parametrize("V,S,G", [s for s in RESIDENT_SHAPES if s[2] > 1])
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


@pytest.mark.parametrize("V,S,G", RESIDENT_SHAPES)
def test_resident_kernels_are_bitwise_repeatable(cuda, V, S, G):
    """The tau and fused kernels give the same bits from run to run and
    whatever the persistent grid: sized by occupancy, one block walking
    every tile, 7 blocks."""
    from desman_tpu_torch.ops import _build
    from desman_tpu_torch.ops.fused_sweep import launch as fused_launch
    from desman_tpu_torch.ops.tau_kernel import launch as tau_launch, tile_plan

    assert tile_plan(S, G).buffers == (0 if S >= 1000 else 1)
    args = _resident_inputs(V, S, G, 9, cuda)
    tau_runs = [ops.tau_sweep(*args[:6]) for _ in range(2)]
    fused_runs = [ops.fused_sweep(*args) for _ in range(2)]
    lib = _build.load_library()
    n, tau, mix = args[:3]
    for m in (1, 7):
        outs = (torch.empty_like(tau), torch.empty_like(mix))
        tau_launch(lib, *args[:6], *outs, max_blocks=m)
        tau_runs.append(outs)
        outs = (torch.empty_like(tau), torch.empty_like(mix),
                _build.partial_scratch(lib, V, 2, S, cuda),
                torch.empty((2, S), dtype=torch.float32, device=cuda))
        fused_launch(lib, *args, *outs, max_blocks=m)
        fused_runs.append((outs[0], outs[1], outs[3]))
    torch.cuda.synchronize()
    for runs in (tau_runs, fused_runs):
        for run in runs[1:]:
            for a, b in zip(runs[0], run):
                assert torch.equal(a, b)


def test_resident_kernels_alternate_shared_memory_plans(cuda):
    """Plans above 48 KB of shared memory in turn (S=600: about 164 KB,
    S=443: about 121 KB in the tau kernel) each launch and give the bits
    of their first launch."""
    first = {}
    for S in (600, 443, 600, 443):
        args = _resident_inputs(64, S, 4, 10, cuda)
        outs = (*ops.tau_sweep(*args[:6]), *ops.fused_sweep(*args))
        torch.cuda.synchronize()
        for a, b in zip(first.setdefault(S, outs), outs):
            assert torch.equal(a, b)


def test_resident_kernels_fit_the_card(cuda):
    """Every tile plan launches: at least one resident block a SM."""
    from desman_tpu_torch.ops.tau_kernel import kernel_info

    for S, G in ((1, 1), (64, 1), (64, 8), (96, 16), (443, 8), (600, 4), (700, 8),
                 (800, 8), (1000, 4), (4000, 4)):
        for kernel in ("tau_sweep", "fused_sweep", "tau_sweep_topk"):
            info = kernel_info(kernel, S, G)
            assert info["blocks_per_sm"] >= 1, (S, G, info)


# ragged V, odd S, G = 1 (the resident path's shape), rows too wide for a
# block's shared memory
LOGLIK_SHAPES = SHAPES + [(2000, 96, 16), (64, 700, 8), (64, 1000, 4), (10_001, 64, 1),
                          (25_000, 33, 3), (30_001, 64, 8)]


@pytest.mark.parametrize("V,S,G", LOGLIK_SHAPES)
def test_gamma_ll_is_bitwise_repeatable(cuda, V, S, G):
    """gamma_ll gives the same bits from run to run, also into scratch
    that holds NaN from an earlier call (every partial row is written
    before it is summed), and agrees with its plain version."""
    from desman_tpu_torch.ops import _build
    from desman_tpu_torch.ops.gamma_kernel import launch

    n, tau, mix, _, eta, _, _, _, _, gp = _resident_inputs(V, S, G, 11, cuda)
    lib = _build.load_library()
    for with_old in (True, False):
        runs = [ops.gamma_ll(n, mix, tau, gp, eta, with_old=with_old) for _ in range(2)]
        partial = _build.partial_scratch(lib, V, 2, S, cuda).fill_(float("nan"))
        ll = torch.full((2, S), float("nan"), dtype=torch.float32, device=cuda)
        launch(lib, n, mix, tau, gp, eta, partial, ll, with_old)
        runs.append(ll)
        torch.cuda.synchronize()
        for run in runs[1:]:
            assert torch.equal(runs[0], run)
        _assert_ll_close(runs[0], ops.gamma_ll_reference(n, mix, tau, gp, eta, with_old))


# V past 8 * SMs x resident blocks, ragged V with one row of odd S in the
# last tile (the n_val/b_idx tail), odd S, the rows in device memory
TOPK_GRID_SHAPES = [(9, 63, 8), (10_001, 64, 8), (1001, 63, 5), (64, 1000, 4), (33, 1, 1)]


@pytest.mark.parametrize("V,S,G", TOPK_GRID_SHAPES)
def test_topk_kernel_is_bitwise_the_tau_kernel_on_every_grid(cuda, V, S, G):
    """The row-resident top-2 kernel on <=2-base counts is bitwise the tau
    kernel, and itself from run to run and whatever the persistent grid."""
    from desman_tpu_torch.ops import _build
    from desman_tpu_torch.ops.tau_kernel import tile_plan
    from desman_tpu_torch.ops.tau_topk import launch

    assert tile_plan(S, G, topk=True).buffers == (0 if S >= 1000 else 1)
    (n_val, b_idx), (n, tau, mix, gamma, eta, gz) = _topk_inputs(V, S, G, 12, cuda)
    want = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    runs = [ops.tau_sweep_topk(n_val, b_idx, tau, mix, gamma, eta, gz) for _ in range(2)]
    lib = _build.load_library()
    for m in (1, 7):
        outs = (torch.empty_like(tau), torch.empty_like(mix))
        launch(lib, n_val, b_idx, tau, mix, gamma, eta, gz, *outs, max_blocks=m)
        runs.append(outs)
    torch.cuda.synchronize()
    for run in runs:
        assert torch.equal(run[0], want[0]) and torch.equal(run[1], want[1])


def test_slot_kernels_past_shared_memory(cuda):
    """S=4000: a block's [2,8,S] slots (256000 bytes) exceed its shared
    memory, so the four kernels that use them keep them in device memory:
    the fused kernel stays bitwise the staged chain, and swap(emit_ll),
    gamma_ll and gamma_apply_eta agree with their plain versions."""
    from desman_tpu_torch.ops._build import slots_in_device_memory
    from desman_tpu_torch.ops.tau_kernel import tile_plan

    V, S, G = 64, 4000, 4
    assert tile_plan(S, G, fused=True).device_slots == 1
    assert slots_in_device_memory(S)
    args = _resident_inputs(V, S, G, 13, cuda)
    n, tau, mix, gamma, eta, gz, g, h, logu, gp = args
    tau_f, mix_f, ll_f = ops.fused_sweep(*args)
    tau_s, mix_s, ll_old, ll2 = _staged(*args)
    torch.cuda.synchronize()
    assert torch.equal(tau_f, tau_s) and torch.equal(mix_f, mix_s)
    assert torch.equal(ll_f[0], ll_old) and torch.equal(ll_f[1], ll2[1])

    tau_k, mix_k, ll_k = ops.swap(n, tau, mix, gamma, eta, g, h, logu, emit_ll=True)
    tau_p, mix_p, ll_p = ops.swap_reference(n, tau, mix, gamma, eta, g, h, logu,
                                            emit_ll=True)
    torch.cuda.synchronize()
    same = (tau_k == tau_p).all(dim=1)
    assert same.float().mean().item() >= 0.99
    torch.testing.assert_close(mix_k[same], mix_p[same], rtol=1e-5, atol=1e-6)
    if bool(same.all()):
        _assert_ll_close(ll_k, ll_p)
    for with_old in (True, False):
        _assert_ll_close(ops.gamma_ll(n, mix, tau, gp, eta, with_old=with_old),
                         ops.gamma_ll_reference(n, mix, tau, gp, eta, with_old))
    accept = torch.as_tensor(np.random.default_rng(13).random(S) < 0.5, device=cuda)
    mix_k, ll_k = ops.gamma_apply_eta(n, mix, tau, gp, accept, eta)
    mix_p, ll_p = ops.gamma_apply_eta_reference(n, mix, tau, gp, accept, eta)
    torch.cuda.synchronize()
    torch.testing.assert_close(mix_k, mix_p, rtol=1e-5, atol=1e-7)
    _assert_ll_close(ll_k, ll_p)


def test_resident_sampler_runs_past_shared_memory_slots(cuda):
    """A cuda_resident chain at S=4000 runs through its kernels, bitwise the
    same from run to run."""
    from desman_tpu_torch.sampler import SamplerConfig, run_chain

    t = synth.generate(V=64, S=4000, G=4, coverage=30.0, seed=5)
    n = torch.as_tensor(t.data.counts, device=cuda)
    cfg = SamplerConfig(G=4, burn=3, samples=3, nmf_iters=20)
    results = []
    for _ in range(2):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        ops.reset_launches()
        results.append(run_chain(n, cfg, gen, kernel="cuda_resident"))
        torch.cuda.synchronize()
        assert (ops.fused_sweep.launches, ops.gamma_apply_eta.launches) == (6, 6)
    for x, y in zip(*results):
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.isfinite(results[0].loglik_trace).all()


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


# ---- checkpoints and auto-length runs on the card ----


class _Interrupt(Exception):
    pass


@pytest.mark.parametrize("kernel", ["cuda", "cuda_topk"])
def test_checkpointed_chain_resumes_bitwise(cuda, kernel, tmp_path, monkeypatch):
    """A checkpointed chain at V=1e4 S=64 G=8 (cuda_topk: on biallelic
    counts) stopped after two of three segments and resumed from its
    snapshot (the Philox state included) is bitwise the uninterrupted
    chain; the resumed part launches the kernels of its sweeps only."""
    from desman_tpu_torch import checkpoint
    from desman_tpu_torch.sampler import SamplerConfig, chain_generator, run_chain

    two = dict(error_rate=0.0, max_alleles=2) if kernel == "cuda_topk" else {}
    t = synth.generate(V=10_000, S=64, G=8, coverage=50.0, seed=0, **two)
    n = torch.as_tensor(t.data.counts, device=cuda)
    cfg = SamplerConfig(G=8, burn=30, samples=30, nmf_iters=50)
    ref = run_chain(n, cfg, chain_generator(0, cuda), kernel=kernel)
    ck = str(tmp_path / "c.npz")
    real = checkpoint.run_segment
    calls = []

    def segment(*args, **kw):
        if len(calls) == 2:
            raise _Interrupt
        calls.append(args[4])
        return real(*args, **kw)

    monkeypatch.setattr(checkpoint, "run_segment", segment)
    with pytest.raises(_Interrupt):
        checkpoint.run_chain_checkpointed(n, cfg, chain_generator(0, cuda), ck,
                                          checkpoint_every=20, kernel=kernel)
    monkeypatch.undo()
    assert checkpoint.load(ck)[2] == 40
    ops.reset_launches()
    got = checkpoint.run_chain_checkpointed(n, cfg, chain_generator(7, cuda), ck,
                                            checkpoint_every=20, kernel=kernel)
    torch.cuda.synchronize()
    tau = ops.tau_sweep_topk if kernel == "cuda_topk" else ops.tau_sweep
    assert tau.launches == 20 and ops.swap.launches == 20
    for name, a, b in zip(ref._fields, ref, got):
        assert (a is None and b is None) or torch.equal(a, b), name


def test_chains_auto_is_each_chains_auto_on_the_card(cuda):
    """run_chains_auto's three chains, given the same stopping points (one
    burn segment to max_burn; sampling extended to the cap in segments), are
    three single-chain auto runs of their seeds, bit for bit."""
    from desman_tpu_torch.converge import run_chain_auto, run_chains_auto
    from desman_tpu_torch.sampler import SamplerConfig, chain_generator, chain_result

    t = synth.generate(V=2000, S=32, G=4, coverage=50.0, seed=2)
    n = torch.as_tensor(t.data.counts, device=cuda)
    cfg = SamplerConfig(G=4, burn=40, samples=20, nmf_iters=50)
    kw = dict(check_every=20, rel_tol=0.0, max_burn=40, ess_target=1e9, max_samples=60)
    res, burn, samples = run_chains_auto(n, cfg, [0, 1, 2], **kw)
    assert (burn, samples) == (40, 60) and res.loglik_trace.is_cuda
    for i in range(3):
        one, b, s = run_chain_auto(n, cfg, chain_generator(i, cuda), **kw)
        assert (b, s) == (burn, samples)
        for name, a, x in zip(one._fields, chain_result(res, i), one):
            assert (a is None and x is None) or torch.equal(a, x), (i, name)


# ---- parallel tempering on the card ----


@pytest.mark.parametrize("kernel", ["cuda", "cuda_topk"])
def test_pt_checkpoint_resumes_bitwise(cuda, kernel, tmp_path, monkeypatch):
    """A 4-replica PT run at V=1e4 S=64 G=8 (cuda_topk: on biallelic
    counts) launches its tau kernel and the swap R x sweeps times; stopped
    after two of three checkpoint segments and resumed from its snapshot
    (every replica's and the exchange's Philox state included), it is
    bitwise the uninterrupted run, and the resumed part launches R x its
    sweeps."""
    from desman_tpu_torch import checkpoint
    from desman_tpu_torch.sampler import SamplerConfig, run_chain_pt

    two = dict(error_rate=0.0, max_alleles=2) if kernel == "cuda_topk" else {}
    t = synth.generate(V=10_000, S=64, G=8, coverage=50.0, seed=0, **two)
    n = torch.as_tensor(t.data.counts, device=cuda)
    cfg = SamplerConfig(G=8, burn=30, samples=30, nmf_iters=50)
    tau = ops.tau_sweep_topk if kernel == "cuda_topk" else ops.tau_sweep
    ops.reset_launches()
    ref = run_chain_pt(n, cfg, 0, n_replicas=4, kernel=kernel)
    torch.cuda.synchronize()
    assert tau.launches == 4 * 60 and ops.swap.launches == 4 * 60
    assert 0.0 < float(ref.pt_swap_accept) <= 1.0
    ck = str(tmp_path / "pt.npz")
    real = checkpoint.run_pt_segment
    calls = []

    def segment(*args, **kw):
        if len(calls) == 2:
            raise _Interrupt
        calls.append(args[5])
        return real(*args, **kw)

    monkeypatch.setattr(checkpoint, "run_pt_segment", segment)
    with pytest.raises(_Interrupt):
        checkpoint.run_chain_pt_checkpointed(n, cfg, 0, ck, checkpoint_every=20,
                                             n_replicas=4, kernel=kernel)
    monkeypatch.undo()
    assert checkpoint.load_pt(ck)[3] == 40
    ops.reset_launches()
    got = checkpoint.run_chain_pt_checkpointed(n, cfg, 0, ck, checkpoint_every=20,
                                               n_replicas=4, kernel=kernel)
    torch.cuda.synchronize()
    assert tau.launches == 4 * 20 and ops.swap.launches == 4 * 20
    for name, a, b in zip(ref._fields, ref, got):
        assert (a is None and b is None) or torch.equal(a, b), name


# ---- multibin and --profile on the card ----


def test_multibin_is_bitwise_run_chain_per_bin(cuda):
    """Three bins of S=64 padded to V=1999 (a tail tile short of 8 rows)
    run through the tau and swap kernels, each bitwise run_chain of its
    padded counts with its generator; the kernels agree with their plain
    versions on the padded counts, zero rows included."""
    from desman_tpu_torch import multibin
    from desman_tpu_torch.sampler import (
        SamplerConfig, chain_generator, init_state, run_chain, spawn_seeds,
    )

    bins = [synth.generate(V=V, S=64, G=4, coverage=50.0, seed=40 + V).data.counts
            for V in (611, 1999, 1203)]
    cfg = SamplerConfig(G=4, burn=15, samples=15, nmf_iters=50)
    ops.reset_launches()
    results = multibin.run_bins(bins, cfg, seed=3, device=cuda)
    torch.cuda.synchronize()
    assert ops.tau_sweep.launches == 3 * 30 and ops.swap.launches == 3 * 30
    padded = torch.as_tensor(multibin.pad_bins(bins), device=cuda)
    assert padded.shape == (3, 1999, 64, 4)
    for b, (counts, res, seed) in enumerate(zip(bins, results, spawn_seeds(3, 3))):
        V = counts.shape[0]
        want = run_chain(padded[b], cfg, chain_generator(seed, cuda))
        for name, a, ref in zip(want._fields, res, want):
            if name in ("tau_mean", "tau_star"):
                ref = ref[:V]
            assert (a is None and ref is None) or torch.equal(a, ref), (b, name)
        # one tau sweep and one swap from the bin's start, kernel vs plain
        st = init_state(padded[b], cfg, chain_generator(seed, cuda))
        rng = np.random.default_rng(b)
        gz = torch.as_tensor(rng.gumbel(size=(1999, 4, 4)), dtype=torch.float32,
                             device=cuda)
        args = (padded[b], st.tau, st.mix, st.gamma, st.eta, gz)
        tau_k, _ = ops.tau_sweep(*args)
        tau_p, _ = ops.tau_sweep_reference(*args)
        assert torch.equal(tau_k[V:], tau_p[V:])   # zero rows: Gumbel alone
        assert (tau_k == tau_p).all(1).float().mean().item() >= 0.99
        g = torch.tensor(0, dtype=torch.int32, device=cuda)
        h = torch.tensor(3, dtype=torch.int32, device=cuda)
        logu = torch.as_tensor(np.log(rng.uniform(size=1999)), dtype=torch.float32,
                               device=cuda)
        sargs = (padded[b], st.tau, st.mix, st.gamma, st.eta, g, h, logu)
        tau_k, _ = ops.swap(*sargs)
        tau_p, _ = ops.swap_reference(*sargs)
        assert torch.equal(tau_k[V:], tau_p[V:])   # log ratio 0 on zero rows
        assert (tau_k == tau_p).all(1).float().mean().item() >= 0.99


def test_profile_trace_names_the_kernels(cuda, tmp_path):
    """run() with profile_dir on the card writes a trace whose kernel
    events name the tau and swap kernels as often as their wrappers
    launched them."""
    import json

    from desman_tpu_torch import io, profiling, run

    data = synth.generate(V=500, S=16, G=3, coverage=40.0, seed=2).data
    ops.reset_launches()
    rc = run.RunConfig(G=3, iterations=20, seed=0, out_dir=str(tmp_path / "o"),
                       profile_dir=str(tmp_path / "trace"))
    run.run(data, rc, device="cuda", kernel="cuda")
    launched = (ops.tau_sweep.launches, ops.swap.launches)
    assert launched == (20, 20)
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    counted = (sum("tau_sweep_kernel" in k for k in kernels),
               sum("swap_kernel" in k for k in kernels))
    assert counted == launched, counted
    assert io.read_fit_txt(str(tmp_path / "o" / "fit.txt"))["V"] == 500


# ---- a mesh of ranks on the card ----


def _mesh_world(tmp_path, fn, nprocs, *args):
    """fn as every rank of a world of nprocs processes (tests/mesh_workers.py);
    rank 0's npz."""
    import mesh_workers
    from desman_tpu_torch.parallel import launch

    out = str(tmp_path / f"{fn}_{nprocs}_{len(list(tmp_path.iterdir()))}.npz")
    assert launch(getattr(mesh_workers, fn), nprocs, (out, *args),
                  timeout_s=4 * mesh_workers.WORLD_TIMEOUT_S) == 0
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_mesh_1x1_over_nccl_is_run_chains(cuda, monkeypatch):
    """A world of one rank on its own card, joined from torchrun's
    environment, runs over NCCL; its 1x1 mesh chains (V=2001, a tail tile)
    are run_chains', field for field (the per-position fields on the
    host)."""
    from desman_tpu_torch.parallel import distributed, make_mesh, run_chains_sharded
    from desman_tpu_torch.sampler import SamplerConfig, run_chains

    t = synth.generate(V=2001, S=32, G=4, coverage=50.0, seed=3)
    cfg = SamplerConfig(G=4, burn=20, samples=20, nmf_iters=50)
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(distributed.free_port())}.items():
        monkeypatch.setenv(k, v)
    assert distributed.maybe_initialize("cuda")
    try:
        assert distributed.backend() == "nccl"
        ops.reset_launches()
        got = run_chains_sharded(t.data.counts, cfg, [0, 1], make_mesh(1, 1), device="cuda")
        assert ops.tau_sweep.launches == ops.swap.launches == 2 * 40
    finally:
        distributed.leave()
    ref = run_chains(torch.as_tensor(t.data.counts, device=cuda), cfg, [0, 1])
    for name, a, b in zip(ref._fields, ref, got):
        assert (a is None and b is None) or torch.equal(a.cpu(), b.cpu()), name
    assert got.tau_star.device.type == "cpu" and got.gamma_mean.is_cuda


def test_mesh_two_ranks_are_bitwise_repeatable(cuda, tmp_path):
    """Two ranks at 1x2 (sharing one card over gloo; one card each over
    NCCL where there are two): two runs in one world and a second world
    give the same bits; against run_chains on one device, tau_star
    agreement >= 0.99 and the trace to rtol 1e-5."""
    from desman_tpu_torch.sampler import SamplerConfig, run_chains

    t = synth.generate(V=2001, S=32, G=4, coverage=50.0, seed=3)
    cfg = dict(G=4, burn=20, samples=20, nmf_iters=50)
    args = (t.data.counts, cfg, [0], (1, 2), "cuda", "cuda", 2)
    a = _mesh_world(tmp_path, "chains", 2, *args)
    b = _mesh_world(tmp_path, "chains", 2, *args)
    assert str(a["backend"]) == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    for k in a:
        if k.startswith("0_"):
            assert np.array_equal(a[k], a["1" + k[1:]]) and np.array_equal(a[k], b[k]), k
    ref = run_chains(torch.as_tensor(t.data.counts, device=cuda), SamplerConfig(**cfg), [0])
    padded_v = a["0_tau_star"].shape[1]
    assert padded_v == 2001
    assert (a["0_tau_star"] == ref.tau_star.cpu().numpy()).all(-1).mean() >= 0.99
    np.testing.assert_allclose(a["0_loglik_trace"], ref.loglik_trace.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("kernel", ["cuda", "cuda_topk"])
def test_mesh_checkpoint_resumes_bitwise_on_the_card(cuda, kernel, tmp_path):
    """Two ranks on the card at 1x2, V=2001 (cuda_topk: biallelic
    counts): stopped after a segment and resumed, the sharded chain is
    bitwise the uninterrupted one, its stored draws included."""
    two = dict(error_rate=0.0, max_alleles=2) if kernel == "cuda_topk" else {}
    t = synth.generate(V=2001, S=32, G=4, coverage=50.0, seed=3, **two)
    cfg = dict(G=4, burn=20, samples=20, nmf_iters=50, store_samples=True, store_thin=4)
    ck = str(tmp_path / "ck")
    got = _mesh_world(tmp_path, "checkpointed", 2, t.data.counts, cfg, [
        ("whole", [0], str(tmp_path / "whole"), 15, None, True),
        ("stop", [0], ck, 15, 15, True),
        ("resumed", [0], ck, 15, None, True)], (1, 2), "cuda", None, kernel)
    assert got["stop_stopped"] == 1
    whole = {k[6:]: v for k, v in got.items() if k.startswith("whole_")}
    assert whole["tau_samples"].shape == (5, 2001, 4)
    for k, v in whole.items():
        assert np.array_equal(got[f"resumed_{k}"], v), k


def test_mesh_store_every_holds_no_more_on_a_card_than_one_device(cuda, tmp_path):
    """run_multi with --store_every (200 draws of V=4001, G=4) at 1x2, two
    ranks on the card, against one device, each run in fresh processes: no
    rank's peak allocated device memory exceeds the single-device run's
    (the draws reach the coordinator on the host, as int8); the draws file
    matches the single-device run's in shape and dtype and its tau draws
    agree on >= 99% of the positions."""
    from desman_tpu_torch import io

    data = synth.generate(V=4001, S=16, G=4, coverage=50.0, seed=3).data
    rc_kw = dict(G=4, iterations=400, seed=0, store_every=1)
    got = _mesh_world(tmp_path, "peak_memory", 2, data,
                      dict(rc_kw, out_dir=str(tmp_path / "mesh")), (1, 2))
    one = _mesh_world(tmp_path, "peak_memory", 1, data,
                      dict(rc_kw, out_dir=str(tmp_path / "one")))
    print(f"peak device bytes: ranks {got['peaks'].tolist()}, one device "
          f"{one['peaks'].tolist()}")
    assert got["peaks"].shape == (2,) and (got["peaks"] <= one["peaks"][0]).all()
    mesh_draws = io.read_draws(str(tmp_path / "mesh" / "draws.npz"))
    one_draws = io.read_draws(str(tmp_path / "one" / "draws.npz"))
    assert mesh_draws["tau"].shape == one_draws["tau"].shape == (200, 4001, 4)
    assert mesh_draws["tau"].dtype == one_draws["tau"].dtype
    assert (mesh_draws["tau"] == one_draws["tau"]).all(-1).mean() >= 0.99
