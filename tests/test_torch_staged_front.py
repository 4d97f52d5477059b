"""The staged front half of a sweep (``sampler._staged_front``, the ``cuda``
and ``cuda_topk`` choices): its gamma and eta passes over [V,S,4] run on
the gamma_ll and apply/eta kernels' wrappers (their plain versions on CPU
tensors), and land where the PyTorch composition they replace lands,
``gamma_step`` then ``eta_step_joint``: the same MH decisions, the same
gamma, eta and tau, the mixture and loglik to f32 rounding. Fixed gamma
and per-row eta keep their PyTorch passes.
"""
import dataclasses
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from desman_tpu_torch import ops, profiling, sampler, synth
from desman_tpu_torch.parallel.sharded import ShardNoise

V, S, C = 40, 6, 3
SWEEPS = 4
SEED = 11


def _counts(G, seed=1):
    return torch.as_tensor(synth.generate(V=V, S=S, G=G, coverage=40.0,
                                          seed=seed).data.counts, dtype=torch.float32)


def _composed_front(cfg, ks, n, state, it, noise, temp, beta=1.0, psum=sampler._own):
    """The staged front as it ran its gamma and eta passes in PyTorch:
    the tau sweep and swap (the front with gamma and eta frozen, whose one
    extra likelihood pass draws nothing), then ``gamma_step`` (one
    likelihood pass for a frozen gamma) and ``eta_step_joint``
    (``eta_step`` for per-row eta)."""
    frozen = dataclasses.replace(cfg, fix_gamma=True, fix_eta=True)
    tau, mix = sampler._staged_front(frozen, ks, n, state, it, noise, temp, beta,
                                     psum)[:2]
    if cfg.fix_gamma:
        gamma, acc_g = state.gamma, torch.zeros(state.loglik.shape)
        loglik = sampler._loglik(n, mix, state.eta, psum)
    else:
        gamma, mix, acc_g, loglik = sampler.gamma_step(
            cfg, n, tau, mix, state.gamma, state.eta, state.kappa_gamma, noise, it,
            beta, psum)
    if cfg.fix_eta:
        return tau, mix, gamma, state.eta, loglik, acc_g, torch.zeros_like(acc_g)
    eta_fn = sampler.eta_step_joint if cfg.eta_update == "joint" else sampler.eta_step
    eta, loglik, acc_e = eta_fn(cfg, n, mix, state.eta, loglik, state.kappa_eta,
                                noise, it, beta, psum)
    return tau, mix, gamma, eta, loglik, acc_g, acc_e


def _noise(gen_states):
    """A noise source of fresh generators set to `gen_states` (one a chain;
    several on a chain axis)."""
    sources = []
    for st in gen_states:
        g = torch.Generator()
        g.set_state(st)
        sources.append(sampler.TorchNoise(g))
    return sources[0] if len(sources) == 1 else sampler.ChainNoise(sources)


def _case(name):
    """(cfg, n, state, generators, temp, beta): one chain, or C on a chain
    axis (PT's replicas with a [C] temp and beta, or chains on shared or
    their own counts)."""
    G = 1 if name == "one_strain" else 3
    cfg = sampler.SamplerConfig(G=G, nmf_iters=20, fix_eta=name == "fix_eta",
                                eta_update="rows" if name == "rows" else "joint",
                                fix_gamma=name == "fix_gamma")
    temp, beta = 1.0, 1.0
    if name in ("pt_beta", "chains_shared", "chains_own"):
        gens = [sampler.chain_generator(SEED + c, "cpu") for c in range(C)]
        n = (torch.stack([_counts(G, seed=1 + c) for c in range(C)])
             if name == "chains_own" else _counts(G))
        state = sampler.init_states(n, cfg, gens)
        if name == "pt_beta":
            temp = torch.tensor([1.0, 2.0, 4.0])
            beta = 1.0 / temp
    else:
        gens, n = [sampler.chain_generator(SEED, "cpu")], _counts(G)
        state = sampler.init_state(n, cfg, gens[0])
    return cfg, n, state, gens, temp, beta


def _starts(cfg, ks, n, state, gens, temp, beta):
    """SWEEPS starts of a run of the front: each sweep's state and its
    generators' states."""
    starts, noise = [], _noise([g.get_state() for g in gens])
    for it in range(SWEEPS):
        starts.append((state, [g.get_state() for g in _generators(noise)]))
        out = sampler._staged_front(cfg, ks, n, state, it, noise, temp, beta)
        state = state._replace(tau=out[0], mix=out[1], gamma=out[2], eta=out[3],
                               loglik=out[4])
    return starts


def _generators(noise):
    return ([noise.generator] if isinstance(noise, sampler.TorchNoise)
            else noise.generators)


def _assert_same_sweep(new, old, before):
    """The same decisions, gamma, eta and tau; mix and loglik to rounding.
    Returns the gamma accepts."""
    tau, mix, gamma, eta, loglik, acc_g, acc_e = new
    assert torch.equal(tau, old[0])
    assert torch.equal(gamma, old[2]) and torch.equal(eta, old[3])
    assert torch.equal(acc_g, old[5]) and torch.equal(acc_e, old[6])
    torch.testing.assert_close(mix, old[1], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(loglik, old[4], rtol=1e-6, atol=0.0)
    return (gamma != before.gamma).any(-1)


class _TwoShards:
    """Two position shards of one chain, each front in a thread of its own;
    psum adds the shards' sums in shard order, as ``Axis.sum`` does."""

    def __init__(self):
        self.parts = [None, None]
        self.barrier = threading.Barrier(2, timeout=60)

    def psum(self, rank):
        def add(x):
            self.parts[rank] = x
            self.barrier.wait()
            out = self.parts[0] + self.parts[1]
            self.barrier.wait()
            return out
        return add


def _sharded(front, cfg, ks, n, starts):
    """Each of two shards' outputs of `front` from each start, the state cut
    to the shard's positions and the noise to its block (``ShardNoise``)."""
    mesh, half = _TwoShards(), V // 2

    def rank(r):
        lo, hi = r * half, (r + 1) * half
        outs = []
        for it, (st, gen_states) in enumerate(starts):
            st = st._replace(tau=st.tau[lo:hi].contiguous(),
                             mix=st.mix[lo:hi].contiguous())
            outs.append(front(cfg, ks, n[lo:hi], st, it,
                              ShardNoise(_noise(gen_states), lo, hi, V, V), 1.0, 1.0,
                              mesh.psum(r)))
        return outs

    with ThreadPoolExecutor(2) as pool:
        return [f.result() for f in [pool.submit(rank, r) for r in (0, 1)]]


CASES = ["joint", "fix_eta", "pt_beta", "chains_shared", "chains_own", "one_strain",
         "two_shards", "rows", "fix_gamma"]


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
@pytest.mark.parametrize("case", CASES)
def test_staged_front_is_the_pytorch_composition(case, kernel):
    """Sweep by sweep from the same state and the same draws, the front
    against gamma_step then eta_step_joint (eta_step for per-row eta; the
    frozen gamma's one pass as it was): the same gamma and eta accepts,
    tau, gamma and eta bitwise, mix and loglik to f32 rounding; in a
    two-shard run each shard's against the composition on the same shards
    and psum, and both shards take the same decisions."""
    cfg, n, state, gens, temp, beta = _case("joint" if case == "two_shards" else case)
    ks = ops.resolve(kernel, n)
    starts = _starts(cfg, ks, n, state, gens, temp, beta)
    if case == "two_shards":
        new = _sharded(sampler._staged_front, cfg, ks, n, starts)
        old = _sharded(_composed_front, cfg, ks, n, starts)
        for a, b in zip(*new):
            assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
            assert torch.equal(a[4], b[4])   # the psum's total, on every shard
        pairs = [(a, b, st) for r in (0, 1)
                 for a, b, (st, _) in zip(new[r], old[r], starts)]
    else:
        pairs = [(sampler._staged_front(cfg, ks, n, st, it, _noise(g), temp, beta),
                  _composed_front(cfg, ks, n, st, it, _noise(g), temp, beta), st)
                 for it, (st, g) in enumerate(starts)]
    accepted = torch.cat([_assert_same_sweep(a, b, st).reshape(-1)
                          for a, b, st in pairs])
    if cfg.G > 1 and not cfg.fix_gamma:   # both decisions seen (one strain: no move)
        assert accepted.any() and not accepted.all(), accepted


@pytest.mark.parametrize("mode", ["rows", "fix_gamma"])
def test_rows_and_fixed_gamma_keep_their_pytorch_passes(mode, monkeypatch):
    """Per-row eta: gamma_ll once, the apply once without the eta loglik,
    then eta_step's four likelihood passes. Fixed gamma: neither kernel, one
    likelihood pass and eta_step_joint's."""
    cfg, n, state, gens, temp, beta = _case(mode)
    calls = Counter()

    def counted(name, fn):
        def call(*args, **kw):
            calls[name, kw.get("with_eta")] += 1
            return fn(*args, **kw)
        return call

    ks = ops.resolve("cuda", n)
    ks = ks._replace(gamma_ll=counted("gamma_ll", ks.gamma_ll),
                     gamma_apply_eta=counted("apply", ks.gamma_apply_eta))
    monkeypatch.setattr(sampler, "_loglik", counted("_loglik", sampler._loglik))
    for name in ("eta_step", "eta_step_joint"):
        monkeypatch.setattr(sampler, name, counted(name, getattr(sampler, name)))
    sampler._staged_front(cfg, ks, n, state, 0, _noise([g.get_state() for g in gens]),
                          temp, beta)
    if mode == "rows":
        assert calls == {("gamma_ll", None): 1, ("apply", False): 1,
                         ("eta_step", None): 1, ("_loglik", None): 4}
    else:
        assert calls == {("_loglik", None): 2, ("eta_step_joint", None): 1}


@pytest.mark.parametrize("pt", [False, True], ids=["chains", "pt"])
def test_sweeps_span_counts_no_ll_kernel_on_cpu_tensors(pt):
    """The chains.sweeps span's ll_kernel counts gamma_ll's kernel launches
    in the segment: none on CPU tensors, whose wrappers run plain code."""
    n = _counts(2)
    cfg = sampler.SamplerConfig(G=2, burn=2, samples=2, nmf_iters=10)
    profiling.take_spans()
    with torch.profiler.profile(activities=profiling.activities("cpu")):
        if pt:
            sampler.run_chain_pt(n, cfg, 3, n_replicas=2)
        else:
            sampler.run_chains(n, cfg, [0, 1])
    spans = [s for s in profiling.take_spans() if s.name == "chains.sweeps"]
    assert [(s.attrs["sweeps"], s.attrs["ll_kernel"]) for s in spans] == [(4, 0)]
