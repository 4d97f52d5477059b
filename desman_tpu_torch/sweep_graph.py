"""CUDA graphs of the Gibbs sweep: ``sampler.run_segment``'s sweeps, each
one replay of a graph captured once a phase.

A sweep is a chain of small device ops (173 for one chain at the E. coli
mock's shape, about 350 for five chains on the chain axis) whose host
dispatch, not the card, sets the pace there (PERF.md §5). A graph launches
them at once. Every op of the eager sweep runs inside it as it is, the
tau, swap, top-2, fused and apply/eta kernels included.

Where (``applies``): n on a CUDA device, no position shards (psum the
identity, so no NCCL), draws from ``torch.Generator``s alone (a
``TorchNoise``, or a ``ChainNoise`` of them) and the NaN trap off (it reads
flags to the host every sweep). Everything else runs the eager loop: CPU
tensors, a mesh rank's chains, replay sources of another package's
streams; parallel tempering (``run_pt_segment``) always does.

Phases: a graph bakes in the host's three decisions of a sweep (the
arguments of ``make_sweep_fn``'s ``step``): whether the tau update is
tempered (the anneal; its temperature is then a 0-d device scalar the host
sets before each replay), whether kappa adapts (it < burn) and whether the
sweep accumulates (it >= burn). A phase is captured when a segment first
reaches it and replayed for its every sweep after that. Capturing runs
nothing, so no sweep is run to warm up and thrown away.

Carry: a graph reads the state and accumulators from static buffers of
its entry and leaves the next sweep's there. The last writers of the large
tensors write into them (the swap's tau, the gamma step's or the apply/eta
kernel's mix, sum_tau and star_tau in place); the rest are copied at the
graph's end, one launch a dtype. A segment copies its carry in before its
first replay and out, into fresh tensors, after its last: what
``run_segment`` returns belongs to the caller.

Randomness: each chain draws from a generator of the entry's own,
registered with its graphs. A segment sets each of them to its chain's
generator state before its first replay and sets the chain's generator
to where the replays left it after its last, so a run split into segments
continues its streams as one long segment does. A graphed segment gives
the eager loop's state, accumulators, trace, stored draws and generator
states, bit for bit.

Counters: a capture counts no launches; each replay adds the launches it
captured to the ``ops`` wrappers' ``launches`` and ``chain_launches``.

Cache: an entry holds what its graphs read (counts, kernels, static
buffers, generators, one memory pool) under ``graph_key``: the kernel
choice, the counts' storage, the carry's shapes and the config fields the
sweep reads. ``GraphCache`` keeps a few, and drops every entry of another
shape when one is added, so that graph memory pools do not pile up over a
grid's G values or a study's bins.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
from collections import OrderedDict
from typing import NamedTuple

import torch

from . import ops
from .sampler import ChainNoise, SamplerAccum, SamplerState, TorchNoise, _own, nan_trap

# the config fields no sweep op reads, set alike in every key: the schedule
# (burn and samples pick the phase, the anneal its temperature, on the
# host), the start (kappa_*, nmf_iters) and storage (copied outside a graph)
_OFF_SWEEP = dict(burn=0, samples=0, anneal_temp0=1.0, anneal_frac=0.5,
                  kappa_gamma=0.0, kappa_eta=0.0, nmf_iters=0,
                  store_samples=False, store_thin=1)


def generators_of(noise):
    """The generators of a noise source that draws from torch.Generators
    alone, one a chain; None for any other source."""
    if type(noise) is TorchNoise:
        return [noise.generator]
    if type(noise) is ChainNoise:
        return noise.generators   # None unless every source is a TorchNoise
    return None


def applies(device, noise, psum) -> bool:
    """Whether ``run_segment`` replays its sweeps from CUDA graphs, from what
    its input shows: a CUDA device, psum the one-device identity, noise from
    torch.Generators alone, the NaN trap off."""
    return (torch.device(device).type == "cuda" and psum is _own
            and not nan_trap() and generators_of(noise) is not None)


class GraphKey(NamedTuple):
    """What a sweep's graphs bake in."""

    device: torch.device
    kernels: ops.Kernels          # the kernel choice (cuda_topk's bound layout)
    counts: tuple                 # (data_ptr, shape, stride, dtype) of n
    carry: tuple                  # (shape, dtype) of each state, accum field
    config: object                # the SamplerConfig, schedule fields unset

    @property
    def shape(self) -> tuple:
        return self.device, self.counts[1], self.carry


def graph_key(cfg, ks, n, state, accum) -> GraphKey:
    """The key of a segment's graphs: burn and samples are not in it."""
    return GraphKey(n.device, ks, (n.data_ptr(), tuple(n.shape), n.stride(), n.dtype),
                    tuple((tuple(x.shape), x.dtype) for x in (*state, *accum)),
                    dataclasses.replace(cfg, **_OFF_SWEEP))


class GraphCache:
    """At most `size` entries, the least recently used dropped first; adding
    an entry drops every entry whose key has another shape."""

    def __init__(self, size: int = 2):
        self.size = size
        self.entries: OrderedDict = OrderedDict()

    def get(self, key: GraphKey):
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key: GraphKey, entry) -> None:
        for old in [k for k in self.entries if k.shape != key.shape]:
            del self.entries[old]
        while len(self.entries) >= self.size:
            self.entries.popitem(last=False)
        self.entries[key] = entry

    def clear(self) -> None:
        self.entries.clear()


_CACHE = GraphCache()
atexit.register(_CACHE.clear)   # graphs go before the CUDA context does


def lookup(cfg, ks, n, state, accum, noise, psum):
    """The entry whose graphs replay a segment's sweeps (made and cached on
    a miss), or None where the segment runs the eager loop: where
    ``applies`` says so, or a carry tensor is not contiguous on n's device
    (the static buffers are, as every sweep's outputs are)."""
    if not applies(n.device, noise, psum) or not all(
            x.device == n.device and x.is_contiguous() for x in (*state, *accum)):
        return None
    key = graph_key(cfg, ks, n, state, accum)
    entry = _CACHE.get(key)
    if entry is None:
        entry = SweepGraphs(n, ks, state, accum)
        _CACHE.put(key, entry)
    return entry


def copy_all(dsts, srcs) -> None:
    """dst.copy_(src) for every pair whose two tensors differ, one launch a
    dtype."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        if d is not s:
            ds, ss = groups.setdefault(d.dtype, ([], []))
            ds.append(d)
            ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def sweep_into(step, n, state, accum, it: int, noise, temp, adapt: bool,
               accumulate: bool) -> None:
    """One sweep that leaves its carry in state's and accum's own buffers:
    ``step`` with them as its destination, then a copy of each field whose
    last writer wrote elsewhere. What a graph captures; any device runs it."""
    st, ac, _ = step(n, state, accum, it, noise, temp, adapt, accumulate,
                     into=(state, accum))
    copy_all((*state, *accum), (*st, *ac))


def _launch_counts() -> list:
    return [(w.launches, w.chain_launches) for w in ops.CHAIN_AXIS]


class SweepGraphs:
    """The captured sweeps of one key: the counts and kernels they read,
    static carry buffers, a generator a chain, the anneal's temperature, a
    memory pool and side stream, and one graph a phase."""

    def __init__(self, n, ks, state, accum):
        dev = n.device
        self.n, self.ks = n, ks   # held: the graphs read their memory
        self.state = SamplerState(*map(_static, state))
        self.accum = SamplerAccum(*map(_static, accum))
        self.generators = [torch.Generator(device=dev) for _ in range(state.loglik.numel())]
        sources = [TorchNoise(g) for g in self.generators]
        # one chain draws from its source, a chain axis through a ChainNoise
        self.noise = sources[0] if state.loglik.dim() == 0 else ChainNoise(sources)
        self.temp = torch.ones((), dtype=torch.float32, device=dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = _capture_stream(dev)
        self.graphs: dict = {}    # phase -> (CUDAGraph, [(wrapper, launches, chains)])

    def segment(self, cfg, sweep, noise) -> "Segment":
        """The sweeps of one ``run_segment`` call on this entry."""
        return Segment(self, cfg, sweep, generators_of(noise))

    def capture(self, step, phase: tuple, it: int) -> tuple:
        """Capture the sweep of `phase` (tempered, adapt, accumulate) on the
        static buffers. Nothing runs: the wrappers' launch counts are put
        back, and each replay adds what they counted."""
        tempered, adapt, accumulate = phase
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = _launch_counts()
        # capture_begin sets the registered generators' device seeds and
        # offsets on the capture stream, which replays in flight on the
        # current stream read: order it after them, and them after it
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        try:
            with torch.cuda.stream(self.stream):
                # cuBLAS makes its handle at a thread's first product, which a
                # capture cannot hold (a run resumed from a snapshot runs none
                # before its first sweep): make it here
                torch.cuda.current_blas_handle()
                graph.capture_begin(pool=self.pool)
                try:
                    sweep_into(step, self.n, self.state, self.accum, it, self.noise,
                               self.temp if tempered else 1.0, adapt, accumulate)
                except BaseException:
                    with contextlib.suppress(RuntimeError):   # an invalidated capture
                        graph.capture_end()
                    raise
                graph.capture_end()
            after = _launch_counts()
        finally:
            current.wait_stream(self.stream)
            for w, (launches, chains) in zip(ops.CHAIN_AXIS, before):
                w.launches, w.chain_launches = launches, chains
        counted = [(w, a[0] - b[0], a[1] - b[1])
                   for w, a, b in zip(ops.CHAIN_AXIS, after, before) if a != b]
        self.graphs[phase] = (graph, counted)
        return self.graphs[phase]


class Segment:
    """Sweep `it` of a segment as one replay: ``make_sweep_fn``'s sweep's
    signature, returning the static buffers. ``release`` ends the segment."""

    def __init__(self, graphs: SweepGraphs, cfg, sweep, generators):
        self.graphs, self.cfg, self.sweep = graphs, cfg, sweep
        self.generators = generators   # the chains' own
        self.replayed = self.captured = 0

    def __call__(self, n, state, accum, it: int, noise, burn=None):
        g = self.graphs
        if state is not g.state:   # the segment's first sweep
            copy_all((*g.state, *g.accum), (*state, *accum))
            for mine, theirs in zip(g.generators, self.generators):
                mine.set_state(theirs.get_state())
        burn = self.cfg.burn if burn is None else burn
        temp = self.sweep.temperature(it)
        phase = (temp != 1.0, self.cfg.adapt_kappa and it < burn, it >= burn)
        entry = g.graphs.get(phase)
        if entry is None:
            entry = g.capture(self.sweep.step, phase, it)
            self.captured += 1
        graph, counted = entry
        if phase[0]:
            g.temp.fill_(temp)
        graph.replay()
        for w, launches, chains in counted:
            w.launches += launches
            w.chain_launches += chains
        self.replayed += 1
        return g.state, g.accum, g.state.loglik

    def release(self, state, accum) -> tuple:
        """(state, accum) as the caller's own tensors, and each chain's
        generator where the replays left its stream."""
        g = self.graphs
        if state is not g.state:   # no sweep ran
            return state, accum
        for mine, theirs in zip(g.generators, self.generators):
            theirs.set_state(mine.get_state())
        carry = (*g.state, *g.accum)
        out = [torch.empty_like(x) for x in carry]
        copy_all(out, carry)
        return SamplerState(*out[:len(state)]), SamplerAccum(*out[len(state):])


_STREAMS: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    """The side stream of every capture on `device`: one a device, since
    cuBLAS keeps a workspace (32 MiB on an H100) for each stream it runs on."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _static(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)
