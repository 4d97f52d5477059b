"""Sampler runs over a (chain, data) mesh, one process a rank (counterpart
of ``desman_tpu.parallel.sharded`` without parallel tempering).

Each rank holds one block of positions ``[lo, hi)`` of the counts padded
to a multiple of the data axis, and runs the ordinary sweep on it: the
tau sweep and swap kernels (or the top-2 tau kernel on a layout built from
the block) launch on the block, and every likelihood sum of the gamma and
eta MH steps adds the row's partial sums through ``Axis.sum`` (one
collective for the gamma step's [2,S] pair, one a likelihood pass of the
eta step, none on a data axis of one rank; ``sampler.make_sweep_fn``'s
``psum``).

Every rank of a chain row holds that chain's generator and draws from it
exactly as the chain on one device does: the NMF start on the full padded
counts, then each sweep's Gumbel and swap noise for all padded positions,
of which it keeps its block (``ShardNoise``; the JAX package draws them
globally too). So a chain on a 1xD mesh is the chain of ``run_chain`` on
the padded counts up to the order of the likelihood sums, and on a 1x1
mesh bit for bit. Pad rows get +inf swap thresholds and never accept.

Chains are split over the chain axis: row c runs its contiguous share of
the seeds one after another, as ``run_chains`` does. The whole result is
gathered with the padding stripped (``Shard.gather``): the per-position
fields and the stored draws on the coordinator alone, on the host, and
the per-chain fields on every rank; callers write files on the
coordinator only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..checkpoint import (
    PREEMPTED_MESSAGE, Preempted, _numpy, restore_generators, stack,
    take_preempted,
)
from ..ops import compress_counts, resolve
from ..sampler import (
    DRAW_FIELDS, RESIDENT_SINGLE_DEVICE, SamplerConfig, SamplerResult,
    TorchNoise, _result_from_accum, chain_generator, check_store_thin,
    init_accum, init_state, make_sweep_fn, run_segment, stored_slots,
)
from .distributed import exchange, is_coordinator, mesh_axes, rank_device
from .mesh import Mesh, make_mesh, pad_positions, pad_tau
from .shard_ckpt import (
    assemble_draws, clear_draws_from, latest_step, load_sharded,
    save_draw_shards, save_sharded,
)

# result fields with a position axis, and where it is after the chain axis
_ROW_AXIS = {"tau_mean": 1, "tau_star": 1, "tau_samples": 2}
# the fields gathered to the coordinator alone, on the host
_HOST_FIELDS = frozenset(_ROW_AXIS) | frozenset(DRAW_FIELDS)
# this process's sweeps on a shard and the collectives they made (the run
# record's collectives a sweep)
SWEEP_STATS = {"sweeps": 0, "collectives": 0}


class ShardNoise:
    """A chain's noise source cut to one position block: the full padded
    draws of the wrapped source, rows [lo, hi) kept; swap thresholds of
    rows at or past the true V are +inf. The [S]- and [4,4]-sized draws
    pass through."""

    def __init__(self, noise, lo: int, hi: int, Vp: int, true_V: int):
        self.noise, self.lo, self.hi, self.Vp, self.true_V = noise, lo, hi, Vp, true_V

    def gumbel(self, it: int, V: int, G: int) -> torch.Tensor:
        return self.noise.gumbel(it, self.Vp, G)[self.lo:self.hi]

    def swap(self, it: int, V: int, G: int):
        g, h, logu = self.noise.swap(it, self.Vp, G)
        logu = logu[self.lo:self.hi]
        if self.true_V < self.hi:
            logu = logu.clone()
            logu[max(self.true_V - self.lo, 0):] = float("inf")
        return g, h, logu

    def __getattr__(self, name):   # gamma_prop, gamma_u, eta_prop, ...
        return getattr(self.noise, name)


def shard_kernels(kernel: str, padded: np.ndarray, n_block: torch.Tensor):
    """The kernel choice bound to a rank's block. ``cuda_resident`` is
    refused (single-device); ``cuda_topk`` is checked on the full counts
    first, so every rank refuses alike, then bound to the block."""
    if kernel == "cuda_resident":
        raise ValueError(RESIDENT_SINGLE_DEVICE)
    if kernel == "cuda_topk":
        compress_counts(padded)   # raises TopkInapplicable on every rank alike
    return resolve(kernel, n_block)


class Shard:
    """One rank's part of a sharded run: its place on the mesh (chain row
    c, data column d, the row's data axis and the world axis), its device,
    its block [lo, hi) of the padded counts and the kernel choice bound to
    it."""

    def __init__(self, counts: np.ndarray, mesh: Optional[Mesh] = None,
                 device="cuda", kernel: str = "cuda"):
        self.mesh = mesh or make_mesh()
        self.device = rank_device(device)
        ax = mesh_axes(self.mesh, self.device)
        self.c, self.d, self.data, self.world = ax.c, ax.d, ax.data, ax.world
        self.padded, self.V = pad_positions(np.asarray(counts, np.float32),
                                            self.mesh.n_data)
        self.Vp, self.S = self.padded.shape[:2]
        self.lo, self.hi = self.mesh.block(self.Vp, self.d)
        self.n = torch.as_tensor(self.padded[self.lo:self.hi], device=self.device)
        self.ks = shard_kernels(kernel, self.padded, self.n)

    def chains(self, n_chains: int, replicated: bool = False) -> range:
        """This row's chains of n_chains: a contiguous share, or all of
        them when every row runs the same chains."""
        if replicated:
            return range(n_chains)
        k, r = divmod(n_chains, self.mesh.n_chain)
        if r or not k:
            raise ValueError(f"{n_chains} chains do not split over the mesh's "
                             f"chain axis of {self.mesh.n_chain}")
        return range(self.c * k, (self.c + 1) * k)

    def init(self, cfg: SamplerConfig, generators, eta_init=None, tau_init=None):
        """Each generator's chain start, its NMF (or EM) start on the full
        padded counts, rows [lo, hi) kept."""
        n_full = torch.as_tensor(self.padded, device=self.device)
        eta = (None if eta_init is None else
               torch.as_tensor(eta_init, dtype=torch.float32, device=self.device))
        tau0 = (None if tau_init is None else torch.as_tensor(
            pad_tau(_host(tau_init), self.mesh.n_data), device=self.device))
        return [init_state(n_full, cfg, g, eta, tau0, block=(self.lo, self.hi),
                           psum=self.data.sum) for g in generators]

    def accum(self, cfg: SamplerConfig):
        return init_accum(self.hi - self.lo, self.S, cfg.G, self.device)

    def noise(self, base) -> ShardNoise:
        """A chain's noise source (a generator, or any full-size source)
        cut to this block."""
        if isinstance(base, torch.Generator):
            base = TorchNoise(base)
        return ShardNoise(base, self.lo, self.hi, self.Vp, self.V)

    def segment(self, cfg: SamplerConfig, state, accum, start_it: int,
                n_sweeps: int, noise, burn: Optional[int] = None,
                store: bool = False):
        """``sampler.run_segment`` on this block."""
        before = exchange.calls
        out = run_segment(self.n, cfg, state, accum, start_it, n_sweeps, noise,
                          self.ks, burn=burn, store=store, psum=self.data.sum)
        SWEEP_STATS["sweeps"] += n_sweeps
        SWEEP_STATS["collectives"] += exchange.calls - before
        return out

    def sweep_fn(self, cfg: SamplerConfig):
        """``sampler.make_sweep_fn`` on this block's kernels and row."""
        return make_sweep_fn(cfg, self.ks, psum=self.data.sum)

    def gather(self, local: SamplerResult, replicated: bool = False) -> SamplerResult:
        """The whole result from every rank's part (this rank's chains
        stacked on a leading axis, rows [lo, hi)): chains in seed order,
        positions cut to the true V. The fields with a position axis and
        the stored draws reach the coordinator alone, on the host, in
        their own dtype (``Axis.collect``; None on the other ranks); the
        rest reach every rank, on its device."""
        mesh = self.mesh
        out = []
        for name, x in zip(SamplerResult._fields, local):
            parts = None
            if x is not None:
                parts = (self.world.collect(x) if name in _HOST_FIELDS
                         else self.world.gather(x))
            if parts is None:
                out.append(None)
                continue
            parts = parts.reshape((mesh.n_chain, mesh.n_data) + tuple(x.shape))
            if replicated:
                parts = parts[:1]
            if name in _ROW_AXIS:
                ax = _ROW_AXIS[name]
                whole = torch.cat([parts[:, d] for d in range(mesh.n_data)], dim=1 + ax)
                whole = whole.narrow(1 + ax, 0, self.V)
            else:
                whole = parts[:, 0]
            out.append(whole.reshape((-1,) + tuple(whole.shape[2:])))
        return SamplerResult(*out)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_chains_sharded(
    counts: np.ndarray,
    cfg: SamplerConfig,
    seeds: Sequence[int],
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    kernel: str = "cuda",
    device="cuda",
) -> SamplerResult:
    """Chains over seeds on a (chain, data) mesh: positions over the data
    axis, seeds split over the chain axis (len(seeds) a multiple of it).
    Called on every rank of the mesh's world with the same arguments; each
    rank returns the result stacked over seeds, padding stripped
    (``Shard.gather``: tau_mean, tau_star and the draws on the coordinator
    alone, on the host).

    counts: host [V,S,4]; V is padded with zero rows to a multiple of the
    data axis. Chain i is ``run_chain`` of seeds[i] on the padded counts up
    to the order of the likelihood sums (bitwise on a 1x1 mesh). kernel:
    "cuda", "cuda_topk" or "torch" ("cuda_resident" is refused).
    """
    check_store_thin(cfg)
    sh = Shard(counts, mesh, device, kernel)
    chains = sh.chains(len(seeds))
    gens = [chain_generator(seeds[i], sh.device) for i in chains]
    states = sh.init(cfg, gens, eta_init, tau_init)
    results = []
    for gen, state in zip(gens, states):
        out = sh.segment(cfg, state, sh.accum(cfg), 0, cfg.total_sweeps,
                         sh.noise(gen), store=cfg.store_samples)
        draws = dict(zip(DRAW_FIELDS, out[3])) if cfg.store_samples else {}
        results.append(_result_from_accum(out[1], cfg, out[2], **draws))
    return sh.gather(stack(results))


def run_chains_sharded_checkpointed(
    counts: np.ndarray,
    cfg: SamplerConfig,
    seeds: Sequence[int],
    checkpoint_path: str,
    checkpoint_every: int = 50,
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    kernel: str = "cuda",
    device="cuda",
    stop_after: Optional[int] = None,
    replicated: bool = False,
) -> Optional[SamplerResult]:
    """``run_chains_sharded`` with a sharded checkpoint every
    checkpoint_every sweeps in the directory checkpoint_path
    (``shard_ckpt``), resumed from it when it holds a committed step, on
    this layout or another: the result is bitwise the uninterrupted run's
    on the same mesh. The generators' states ride the checkpoint.

    Before each segment the ranks agree whether any of them got SIGTERM;
    if one did, all raise ``Preempted`` with the checkpoint committed (a
    rank that stopped alone would leave the others waiting in a
    collective). ``stop_after``: return None once at least this many
    sweeps are committed, the directory resumable (a crash, for tests).
    ``replicated``: every chain row runs all the chains (a single chain on
    an n_chain > 1 mesh). cfg.store_samples keeps the thinned draws in
    per-rank files, assembled on the coordinator at the end.
    """
    check_store_thin(cfg)
    sh = Shard(counts, mesh, device, kernel)
    C = len(seeds)
    chains = sh.chains(C, replicated)
    gens = [chain_generator(seeds[i], sh.device) for i in chains]
    if latest_step(checkpoint_path) is not None:
        states, accums, it, trace_done, gen_state = load_sharded(
            checkpoint_path, sh, chains, C, sh.device)
        restore_generators(gens, gen_state)
        trace_parts = [trace_done[:, :it]]
    else:
        states = sh.init(cfg, gens, eta_init, tau_init)
        accums = [sh.accum(cfg) for _ in gens]
        it, trace_parts = 0, []
    if is_coordinator():
        clear_draws_from(checkpoint_path, it)
    sh.world.barrier()
    noises = [sh.noise(g) for g in gens]

    while it < cfg.total_sweeps:
        if sh.world.any(take_preempted()):
            raise Preempted(PREEMPTED_MESSAGE)
        if stop_after is not None and it >= stop_after:
            return None
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        traces, seg_draws = [], []
        for i, noise in enumerate(noises):
            out = sh.segment(cfg, states[i], accums[i], it, seg, noise,
                             store=cfg.store_samples)
            states[i], accums[i] = out[:2]
            traces.append(out[2])
            if cfg.store_samples:
                seg_draws.append(out[3])
        slots = stored_slots(it, seg, cfg.burn, cfg.store_thin) if seg_draws else []
        if slots:
            draws = tuple(_numpy(torch.stack(d)) for d in zip(*seg_draws))
            save_draw_shards(checkpoint_path, sh, chains, it, [it + j for j in slots],
                             draws, replicated)
        it += seg
        trace_parts.append(_numpy(torch.stack(traces)))
        save_sharded(checkpoint_path, sh, chains, C, states, accums, gens, it,
                     np.concatenate(trace_parts, axis=1), replicated)

    trace = torch.as_tensor(np.concatenate(trace_parts, axis=1), device=sh.device)
    local = stack([_result_from_accum(ac, cfg, trace[i]) for i, ac in enumerate(accums)])
    res = sh.gather(local, replicated)
    if cfg.store_samples:
        sh.world.barrier()   # every rank's draw files are on disk
        if is_coordinator():
            draws = assemble_draws(checkpoint_path, C, sh.V, sh.S, cfg.G)
            res = res._replace(**{f: torch.from_numpy(draws[k])
                                  for f, k in zip(DRAW_FIELDS, ("tau", "gamma", "eta"))
                                  if k in draws})
    return res


def run_chain_sharded_checkpointed(
    counts: np.ndarray,
    cfg: SamplerConfig,
    seed: int,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    kernel: str = "cuda",
    device="cuda",
    stop_after: Optional[int] = None,
) -> Optional[SamplerResult]:
    """One chain (generator seeded `seed`) of
    ``run_chains_sharded_checkpointed``: positions over the data axis,
    every chain row running the chain alike (only row 0 writes)."""
    res = run_chains_sharded_checkpointed(
        counts, cfg, [seed], checkpoint_path, checkpoint_every, mesh, eta_init,
        tau_init, kernel, device, stop_after, replicated=True)
    return None if res is None else SamplerResult(
        *(None if x is None else x[0] for x in res))

