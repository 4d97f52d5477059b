"""CUDA graphs of the sweep (``desman_tpu_torch.sweep_graph``).

On the CPU: the rule that picks graphs or the eager loop, the key and the
cache, as functions of what they observe, and the graphs' sweep body
(``sweep_into``: the sweep leaving its carry in static buffers) against
the eager sweep, bit for bit, on every kernel choice's plain versions.

On the card (marked ``cuda``; the tests directory's conftest imports jax,
which a GPU installation of the port need not have):

    python -m pytest --noconftest -q -m cuda tests/test_torch_graph.py

a graphed ``run_segment`` against the eager sweep looped by hand, bit for
bit: state, accumulators, trace, stored draws and the generators' next
draws, on ``cuda``, ``cuda_topk`` and ``cuda_resident``, one chain and five
on the chain axis, shared and per-chain counts, anneal on and off, fixed
eta, one segment against several, and the ``ops`` launch counters.
"""
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from desman_tpu_torch import ops, sampler, sweep_graph, synth
from desman_tpu_torch.sampler import (
    ChainNoise, SamplerConfig, TorchNoise, chain_generator, init_accum, init_states,
)


class _Replay:
    """A noise source of another kind (as a replay of the JAX package's
    streams is): the generator rule never takes it."""

    def __init__(self, generator):
        self.generator = generator


def _torch_noise(chains=None):
    if chains is None:
        return TorchNoise(torch.Generator())
    return ChainNoise(TorchNoise(torch.Generator()) for _ in range(chains))


def _sum(x):
    return x


@pytest.mark.parametrize("device,noise,psum,trap,graphed", [
    ("cuda", _torch_noise(), sampler._own, False, True),
    ("cuda", _torch_noise(3), sampler._own, False, True),
    ("cpu", _torch_noise(), sampler._own, False, False),
    ("cuda", _torch_noise(), _sum, False, False),
    ("cuda", _torch_noise(), sampler._own, True, False),
    ("cuda", _Replay(torch.Generator()), sampler._own, False, False),
    ("cuda", ChainNoise([TorchNoise(torch.Generator()), _Replay(torch.Generator())]),
     sampler._own, False, False),
], ids=["one-chain", "chain-axis", "cpu", "psum", "nan-trap", "replay", "mixed-sources"])
def test_rule_graphs_only_what_the_input_allows(device, noise, psum, trap, graphed):
    """Graphs on a CUDA device with no position shards, noise from
    torch.Generators alone and the NaN trap off; the eager loop otherwise."""
    sampler.set_nan_trap(trap)
    try:
        assert sweep_graph.applies(torch.device(device), noise, psum) is graphed
    finally:
        sampler.set_nan_trap(False)


def test_eager_loop_for_cpu_and_pt(monkeypatch):
    """A CPU segment never makes an entry, and parallel tempering never asks
    for one: run_chain and run_chain_pt on the CPU run with the entry's
    constructor and the cache lookup made to fail."""
    def refuse(*a, **kw):
        raise AssertionError("graphs for an eager input")

    monkeypatch.setattr(sweep_graph, "SweepGraphs", refuse)
    t = synth.generate(V=30, S=4, G=2, coverage=20.0, seed=3)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32)
    cfg = SamplerConfig(G=2, burn=3, samples=3, nmf_iters=10)
    sampler.run_chain(n, cfg, chain_generator(0, "cpu"))
    monkeypatch.setattr(sweep_graph, "lookup", refuse)
    res = sampler.run_chain_pt(n, cfg, 0, n_replicas=2)
    assert res.loglik_trace.shape == (6,)


def _carry(V=20, S=4, G=3, chains=None):
    lead = () if chains is None else (chains,)
    state = sampler.SamplerState(
        tau=torch.zeros((*lead, V, G), dtype=torch.int32),
        gamma=torch.zeros((*lead, S, G)), eta=torch.zeros((*lead, 4, 4)),
        mix=torch.zeros((*lead, V, S, 4)), loglik=torch.zeros(lead),
        kappa_gamma=torch.zeros(lead), kappa_eta=torch.zeros(lead))
    return state, init_accum(V, S, G, "cpu", chains=chains)


def test_key_ignores_the_schedule_and_follows_shape_and_counts():
    """burn, samples, the anneal and the starts' settings pick phases and
    temperatures on the host: not in the key. The counts' storage, the
    carry's shapes, the kernel choice and the sweep's own settings are."""
    n = torch.zeros(20, 4, 4)
    state, accum = _carry()
    ks = ops.resolve("cuda")
    cfg = SamplerConfig(G=3, burn=125, samples=125)
    key = sweep_graph.graph_key(cfg, ks, n, state, accum)
    for same in (replace(cfg, burn=2, samples=2), replace(cfg, anneal_temp0=1.0),
                 replace(cfg, kappa_gamma=5.0, nmf_iters=3, store_samples=True)):
        assert sweep_graph.graph_key(same, ks, n, state, accum) == key
    other_n = torch.zeros(20, 4, 4)
    state5, accum5 = _carry(G=5)
    for other in (
            sweep_graph.graph_key(cfg, ks, other_n, state, accum),
            sweep_graph.graph_key(cfg, ks, torch.zeros(24, 4, 4), *_carry(V=24)),
            sweep_graph.graph_key(replace(cfg, G=5), ks, n, state5, accum5),
            sweep_graph.graph_key(cfg, ks, n, *_carry(chains=5)),
            sweep_graph.graph_key(cfg, ops.resolve("cuda_resident"), n, state, accum),
            sweep_graph.graph_key(replace(cfg, fix_eta=True), ks, n, state, accum)):
        assert other != key
    assert sweep_graph.graph_key(cfg, ks, other_n, state, accum).shape == key.shape
    assert sweep_graph.graph_key(replace(cfg, G=5), ks, n, state5, accum5).shape != key.shape


def test_cache_is_bounded_and_drops_other_shapes():
    """At most `size` entries, least recently used out first; an entry of
    another shape (a grid's next G) drops all the others."""
    ks = ops.resolve("cuda")
    cfg = SamplerConfig(G=3)
    state, accum = _carry()
    counts = [torch.zeros(20, 4, 4) for _ in range(3)]   # held, as an entry holds them
    keys = [sweep_graph.graph_key(cfg, ks, n, state, accum)
            for n in counts]
    cache = sweep_graph.GraphCache(size=2)
    cache.put(keys[0], "a")
    cache.put(keys[1], "b")
    assert cache.get(keys[0]) == "a"          # keys[1] is now the oldest
    cache.put(keys[2], "c")
    assert list(cache.entries) == [keys[0], keys[2]]
    assert cache.get(keys[1]) is None
    state5, accum5 = _carry(G=5)
    g5 = sweep_graph.graph_key(replace(cfg, G=5), ks, torch.zeros(20, 4, 4),
                               state5, accum5)
    cache.put(g5, "d")
    assert list(cache.entries) == [g5]


def _counts(V, S, G, chains, topk, seed=5):
    """[V,S,4] counts, or with `chains` each chain's own [C,V,S,4]."""
    kw = dict(error_rate=0.0, max_alleles=2) if topk else {}
    counts = [synth.generate(V=V, S=S, G=G, coverage=30.0, seed=seed + c, **kw).data.counts
              for c in range(chains or 1)]
    return torch.as_tensor(np.stack(counts) if chains else counts[0],
                           dtype=torch.float32)


# (kernel, chains, per-chain counts, config changes)
CPU_CASES = [
    ("cuda", None, False, {}),
    ("cuda", 3, False, {}),
    ("cuda", 3, True, dict(fix_eta=True)),
    ("cuda", None, False, dict(anneal_temp0=1.0)),
    ("cuda", None, False, dict(fix_gamma=True)),
    ("cuda", None, False, dict(fix_tau=True)),
    ("cuda", 2, False, dict(eta_update="rows", adapt_kappa=False)),
    ("cuda", None, False, dict(G=1)),
    ("cuda", None, False, dict(swap_moves=False)),
    ("cuda_resident", None, False, {}),
    ("cuda_resident", 3, True, dict(fix_eta=True)),
    ("cuda_resident", None, False, dict(G=1)),
    ("cuda_topk", 3, False, {}),
    ("torch", 2, False, {}),
]


@pytest.mark.parametrize("kernel,chains,own,changes", CPU_CASES)
def test_sweep_into_static_buffers_is_the_eager_sweep(kernel, chains, own, changes):
    """What a graph replays, run eagerly on the CPU: sweep_into on one set
    of static buffers, the tempered phase's temperature a 0-d tensor, over
    every phase, against the eager loop of run_segment, bit for bit (the
    last writers' out= and in-place writes read nothing they overwrite)."""
    cfg = replace(SamplerConfig(G=3, burn=6, samples=4, nmf_iters=20), **changes)
    n = _counts(24, 5, cfg.G, chains if own else None, kernel == "cuda_topk")
    ks = ops.resolve(kernel, n)
    seeds = [11 + c for c in range(chains or 1)]

    def start():
        gens = [chain_generator(s, "cpu") for s in seeds]
        if chains is None:
            st = sampler.init_state(n, cfg, gens[0])
            return st, init_accum(*n.shape[:2], cfg.G, "cpu"), TorchNoise(gens[0])
        st = init_states(n, cfg, gens)
        return (st, init_accum(*n.shape[-3:-1], cfg.G, "cpu", chains=chains),
                ChainNoise(TorchNoise(g) for g in gens))

    state, accum, noise = start()
    e_state, e_accum, e_trace = sampler.run_segment(n, cfg, state, accum, 0,
                                                    cfg.total_sweeps, noise, ks)

    state, accum, noise = start()
    sweep = sampler.make_sweep_fn(cfg, ks)
    st = sampler.SamplerState(*(torch.empty_like(x) for x in state))
    ac = sampler.SamplerAccum(*(torch.empty_like(x) for x in accum))
    sweep_graph.copy_all((*st, *ac), (*state, *accum))
    trace = []
    for it in range(cfg.total_sweeps):
        temp = sweep.temperature(it)
        sweep_graph.sweep_into(
            sweep.step, n, st, ac, it, noise,
            torch.tensor(temp) if temp != 1.0 else 1.0,
            cfg.adapt_kappa and it < cfg.burn, it >= cfg.burn)
        trace.append(st.loglik.clone())
    for name, a, b in zip(st._fields + ac._fields, (*st, *ac), (*e_state, *e_accum)):
        assert torch.equal(a, b), name
    assert torch.equal(torch.stack(trace, -1), e_trace)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_start(n, cfg, seeds, chains, dev):
    gens = [chain_generator(s, dev) for s in seeds]
    if chains is None:
        return (sampler.init_state(n, cfg, gens[0]),
                init_accum(*n.shape[:2], cfg.G, dev), TorchNoise(gens[0]), gens)
    return (init_states(n, cfg, gens),
            init_accum(*n.shape[-3:-1], cfg.G, dev, chains=chains),
            ChainNoise(TorchNoise(g) for g in gens), gens)


def _eager(n, cfg, ks, state, accum, noise, store):
    """make_sweep_fn's sweep looped by hand, with run_segment's trace and
    stored draws."""
    sweep = sampler.make_sweep_fn(cfg, ks)
    slots = sampler.stored_slots(0, cfg.total_sweeps, cfg.burn, cfg.store_thin)
    trace, draws = [], []
    for it in range(cfg.total_sweeps):
        state, accum, ll = sweep(n, state, accum, it, noise)
        trace.append(ll)
        if store and it in slots:
            draws.append((state.tau.to(torch.int8), state.gamma.clone(),
                          state.eta.clone()))
    trace = torch.stack(trace, -1)
    if store:
        lead = state.loglik.dim()
        draws = tuple(torch.stack(x, lead) for x in zip(*draws))
    return state, accum, trace, draws


# (kernel, chains, per-chain counts, config changes, segments)
CARD_CASES = [
    ("cuda", None, False, {}, 1),
    ("cuda", 5, False, {}, 1),
    ("cuda", 5, False, {}, 2),
    ("cuda", 5, True, dict(fix_eta=True), 1),
    ("cuda", None, False, dict(anneal_temp0=1.0), 1),
    ("cuda", None, False, dict(store_samples=True, store_thin=2), 3),
    ("cuda", 5, False, dict(fix_eta=True), 4),
    ("cuda", None, False, dict(G=1), 1),
    ("cuda", None, False, dict(fix_tau=True), 1),
    ("cuda", 5, False, dict(eta_update="rows"), 1),
    ("cuda", None, False, dict(fix_gamma=True), 1),
    ("cuda_topk", None, False, {}, 1),
    ("cuda_topk", 5, False, {}, 2),
    ("cuda_resident", None, False, {}, 1),
    ("cuda_resident", 5, False, {}, 1),
    ("cuda_resident", 5, True, dict(fix_eta=True), 3),
    ("cuda_resident", None, False, dict(G=1), 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,chains,own,changes,segments", CARD_CASES)
def test_graphed_segments_are_the_eager_sweep(cuda, kernel, chains, own, changes,
                                              segments):
    """run_segment on the card (graphed, in `segments` pieces) against the
    eager sweep looped by hand from the same seeds: state, accumulators,
    trace, stored draws and each generator's next draw, bit for bit; the
    spans say every sweep was replayed; the ops launch counters advance as
    the eager loop's do, gamma_ll's as the spans' ll_kernel says (on the
    staged front, with apply/eta, once a sweep but for a frozen gamma)."""
    from desman_tpu_torch import profiling

    sweep_graph._CACHE.clear()
    cfg = replace(SamplerConfig(G=4, burn=20, samples=20, nmf_iters=50), **changes)
    n = _counts(300, 12, cfg.G, chains if own else None, kernel == "cuda_topk").to(cuda)
    ks = ops.resolve(kernel, n)
    seeds = [101 + c for c in range(chains or 1)]
    store = cfg.store_samples

    state, accum, noise, gens = _card_start(n, cfg, seeds, chains, cuda)
    ops.reset_launches()
    e_state, e_accum, e_trace, e_draws = _eager(n, cfg, ks, state, accum, noise, store)
    e_next = [torch.rand(3, generator=g, device=cuda) for g in gens]
    eager_launches = [(w.launches, w.chain_launches) for w in ops.CHAIN_AXIS]

    state, accum, noise, gens = _card_start(n, cfg, seeds, chains, cuda)
    ops.reset_launches()
    cuts = [cfg.total_sweeps * k // segments for k in range(segments + 1)]
    traces, draws = [], []
    with torch.profiler.profile(activities=profiling.activities(cuda)):
        for a, b in zip(cuts, cuts[1:]):
            out = sampler.run_segment(n, cfg, state, accum, a, b - a, noise, ks,
                                      store=store)
            state, accum = out[:2]
            traces.append(out[2])
            if store:
                draws.append(out[3])
    spans = [s for s in profiling.take_spans() if s.name == "chains.sweeps"]
    assert sum(s.attrs["graphed"] for s in spans) == cfg.total_sweeps
    assert 1 <= sum(s.attrs["captures"] for s in spans) <= 3
    assert [(w.launches, w.chain_launches) for w in ops.CHAIN_AXIS] == eager_launches
    assert sum(s.attrs["ll_kernel"] for s in spans) == ops.gamma_ll.launches
    if kernel != "cuda_resident" and not cfg.fix_gamma:   # the staged front's kernels
        assert ops.gamma_ll.launches == ops.gamma_apply_eta.launches == cfg.total_sweeps

    for name, a, b in zip(state._fields + accum._fields, (*state, *accum),
                          (*e_state, *e_accum)):
        assert torch.equal(a, b), name
    assert torch.equal(torch.cat(traces, -1), e_trace)
    if store:
        lead = state.loglik.dim()
        for a, b in zip((torch.cat(x, lead) for x in zip(*draws)), e_draws):
            assert torch.equal(a, b)
    for g, want in zip(gens, e_next):
        assert torch.equal(torch.rand(3, generator=g, device=cuda), want)


@pytest.mark.cuda
def test_timed_chains_replay_what_the_warm_chain_captured(cuda):
    """The chain cells' pattern: a 4-sweep chain (burn 2) reaches the
    anneal, burn and sampling phases, so later chains of the same counts,
    at any burn and samples, capture nothing; run_chain is still bitwise
    the eager chain, and a shape change drops the entry."""
    from desman_tpu_torch import profiling

    sweep_graph._CACHE.clear()
    n = _counts(300, 12, 4, None, False).to(cuda)
    cfg = SamplerConfig(G=4, burn=30, samples=30, nmf_iters=50)
    sampler.run_chain(n, replace(cfg, burn=2, samples=2), chain_generator(9, cuda))
    with torch.profiler.profile(activities=profiling.activities(cuda)):
        res = sampler.run_chain(n, cfg, chain_generator(10, cuda))
    spans = [s for s in profiling.take_spans() if s.name == "chains.sweeps"]
    assert [(s.attrs["graphed"], s.attrs["captures"]) for s in spans] == [(60, 0)]

    g = chain_generator(10, cuda)
    state = sampler.init_state(n, cfg, g)
    accum = init_accum(300, 12, 4, cuda)
    _, e_accum, e_trace, _ = _eager(n, cfg, ops.resolve("cuda"), state, accum,
                                    TorchNoise(g), False)
    assert torch.equal(res.loglik_trace, e_trace)
    assert torch.equal(res.tau_star, e_accum.star_tau)

    sampler.run_chain(n[:200].contiguous(), cfg, chain_generator(11, cuda))
    assert len(sweep_graph._CACHE.entries) == 1


@pytest.mark.cuda
def test_nan_trap_keeps_the_eager_loop_on_the_card(cuda):
    """With the NaN trap on, the card's sweeps run eagerly (graphed 0)."""
    from desman_tpu_torch import profiling

    n = _counts(300, 12, 3, None, False).to(cuda)
    cfg = SamplerConfig(G=3, burn=3, samples=3, nmf_iters=20)
    sampler.set_nan_trap(True)
    try:
        with torch.profiler.profile(activities=profiling.activities(cuda)):
            sampler.run_chain(n, cfg, chain_generator(0, cuda))
    finally:
        sampler.set_nan_trap(False)
    spans = [s for s in profiling.take_spans() if s.name == "chains.sweeps"]
    assert [s.attrs["graphed"] for s in spans] == [0]

@pytest.mark.cuda
def test_evicted_entries_leave_no_memory_behind(cuda):
    """Shapes in turn (a grid's G values) evict each other's entries: the
    allocated bytes after each run stay level (the captures share one side
    stream, so cuBLAS keeps one workspace for them)."""
    n = _counts(300, 12, 4, None, False).to(cuda)
    cfg = SamplerConfig(G=4, burn=4, samples=4, nmf_iters=20)
    sampler.run_chain(n, cfg, chain_generator(0, cuda))
    level = []
    for k, G in enumerate((2, 3, 4, 2, 3, 4)):
        sampler.run_chain(n, replace(cfg, G=G), chain_generator(k, cuda))
        torch.cuda.synchronize()
        level.append(torch.cuda.memory_allocated())
    assert max(level) - min(level) < 2 ** 20, level

# a process whose first matrix product is inside a capture (its start made
# on the CPU, as a run resumed from a snapshot has its start from a file)
_FIRST_PRODUCT_IN_A_CAPTURE = """
import torch
from desman_tpu_torch import sampler, synth
from desman_tpu_torch.sampler import SamplerConfig, SamplerState, TorchNoise, chain_generator, init_accum

t = synth.generate(V=300, S=12, G=4, coverage=30.0, seed=5)
n = torch.as_tensor(t.data.counts, dtype=torch.float32)
cfg = SamplerConfig(G=4, burn=6, samples=6, nmf_iters=20)
start = sampler.init_state(n, cfg, chain_generator(1, "cpu"))
n = n.cuda()

def fresh():
    return SamplerState(*(x.cuda() for x in start)), init_accum(300, 12, 4, "cuda")

state, accum = fresh()
g_state, g_accum, g_trace = sampler.run_segment(
    n, cfg, state, accum, 0, 12, TorchNoise(chain_generator(2, "cuda")), "cuda")
state, accum = fresh()
sweep, noise, trace = sampler.make_sweep_fn(cfg, "cuda"), TorchNoise(chain_generator(2, "cuda")), []
for it in range(12):
    state, accum, ll = sweep(n, state, accum, it, noise)
    trace.append(ll)
same = all(torch.equal(a, b) for a, b in zip((*g_state, *g_accum), (*state, *accum)))
print("bitwise" if same and torch.equal(g_trace, torch.stack(trace)) else "differs")
"""


@pytest.mark.cuda
def test_a_capture_holding_the_first_product_of_a_process(cuda):
    """A fresh process whose first matrix product is in the first captured
    sweep (cuBLAS's handle cannot be made inside a capture) runs its graphed
    segment, bitwise the eager sweep from the same start."""
    out = subprocess.run([sys.executable, "-c", _FIRST_PRODUCT_IN_A_CAPTURE],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "bitwise"
