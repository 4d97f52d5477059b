"""Sampler runs over a (chain, data) mesh, one process a rank (counterpart
of ``desman_tpu.parallel.sharded``).

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

Chains are split over the chain axis: row c holds its contiguous share of
the seeds as one state with a leading chain axis, swept together as
``run_chains`` sweeps its chains on one device (one launch of each kernel
and one set of collectives a sweep, whatever the share; ``Axis.sum`` adds
a [k] sum element by element, so chain c keeps its own bits). The whole
result is gathered with the padding stripped (``Shard.gather``): the
per-position fields and the stored draws on the coordinator alone, on the
host, and the per-chain fields on every rank; callers write files on the
coordinator only. ``_ShardChains`` is a rank's chain set for the auto runs
(``converge.run_chains_auto(mesh=)``).

Parallel tempering (``run_chain_pt_sharded``) puts the R replicas in the
place of chains: row c holds replicas [c R/C, (c+1) R/C), which sweep as
one chain axis (one launch of each kernel a sweep), and their
generators, every rank holds the exchange generator. After the row's
replica sweeps one exchange on the chain axis (``Axis.gather`` of the
[3, R/C] loglik and kappas; none on a chain axis of one rank) gives every
rank the ensemble's [3, R], so every rank draws the same uniforms and
computes the same rung (``sampler.make_pt_step``'s ``shard``). Only the
winning row's blocks cross rows at the end: the star replica's through a
masked exchange, the cold-rung sums (integer counts for tau) added over
the rows, the stored draws (zeros on the rows not holding rung 0) added
on the coordinator's host. So a 1x1 mesh is ``run_chain_pt`` bit for bit,
and a Cx1 one too: its chain axis moves values, never adds them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..checkpoint import (
    PREEMPTED_MESSAGE, Preempted, _Chains, _DrawBuf, _numpy, restore_generators,
    take_preempted,
)
from ..ops import compress_counts, resolve
from ..sampler import (
    DRAW_FIELDS, RESIDENT_SINGLE_DEVICE, ChainNoise, ExchangeNoise, ReplicaShard,
    SamplerAccum, SamplerConfig, SamplerResult, TorchNoise, _result_from_accum,
    chain_generator, chain_result, check_store_thin, init_accum, init_states,
    make_sweep_fn, pt_generators, pt_merge_accums, pt_merge_stacked,
    pt_swap_rate, run_pt_segment, run_segment, stored_slots,
)
from .distributed import exchange, is_coordinator, mesh_axes, rank_device
from .mesh import Mesh, make_mesh, pad_positions, pad_tau
from .shard_ckpt import (
    assemble_draws, clear_draws_from, latest_step, load_extras_sharded,
    load_sharded, save_draw_shards, save_sharded,
)

# result fields with a position axis, and where it is after the chain axis
_ROW_AXIS = {"tau_mean": 1, "tau_star": 1, "tau_samples": 2}
# the fields gathered to the coordinator alone, on the host
_HOST_FIELDS = frozenset(_ROW_AXIS) | frozenset(DRAW_FIELDS)
# this process's sweeps of its state on a shard (one a sweep of all its
# chains or replicas) and the collectives they made (the run record's
# collectives a sweep)
SWEEP_STATS = {"sweeps": 0, "collectives": 0}


class ShardNoise:
    """A noise source cut to one position block: the full padded draws of
    the wrapped source (one chain's, or a ``ChainNoise``'s with a leading
    chain axis), rows [lo, hi) of the position axis counted from the end
    kept, so [Vp,G,4] and [C,Vp,G,4] Gumbels, [Vp] and [C,Vp] swap
    thresholds are cut alike (contiguous, as the kernels take them);
    thresholds of rows at or past the true V are +inf. The [S]- and
    [4,4]-sized draws pass through."""

    def __init__(self, noise, lo: int, hi: int, Vp: int, true_V: int):
        self.noise, self.lo, self.hi, self.Vp, self.true_V = noise, lo, hi, Vp, true_V

    def gumbel(self, it: int, V: int, G: int) -> torch.Tensor:
        return self.noise.gumbel(it, self.Vp, G)[..., self.lo:self.hi, :, :].contiguous()

    def swap(self, it: int, V: int, G: int):
        g, h, logu = self.noise.swap(it, self.Vp, G)
        logu = logu[..., self.lo:self.hi]
        if self.true_V < self.hi:
            logu = logu.clone(memory_format=torch.contiguous_format)
            logu[..., max(self.true_V - self.lo, 0):] = float("inf")
        return g, h, logu.contiguous()

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
        self.c, self.d = ax.c, ax.d
        self.data, self.chain, self.world = ax.data, ax.chain, ax.world
        self.padded, self.V = pad_positions(np.asarray(counts, np.float32),
                                            self.mesh.n_data)
        self.Vp, self.S = self.padded.shape[:2]
        self.lo, self.hi = self.mesh.block(self.Vp, self.d)
        self.n = torch.as_tensor(self.padded[self.lo:self.hi], device=self.device)
        self.ks = shard_kernels(kernel, self.padded, self.n)

    def chains(self, n_chains: int, replicated: bool = False,
               what: str = "chains") -> range:
        """This row's chains (or PT replicas) of n_chains: a contiguous
        share, or all of them when every row runs the same chains."""
        if replicated:
            return range(n_chains)
        k, r = divmod(n_chains, self.mesh.n_chain)
        if r or not k:
            raise ValueError(f"{n_chains} {what} do not split over the mesh's "
                             f"chain axis of {self.mesh.n_chain}")
        return range(self.c * k, (self.c + 1) * k)

    def init(self, cfg: SamplerConfig, generators, eta_init=None, tau_init=None):
        """The generators' chain starts as one state with a leading chain
        axis (``init_states``): each its NMF (or EM) start on the full
        padded counts, rows [lo, hi) kept."""
        n_full = torch.as_tensor(self.padded, device=self.device)
        eta = (None if eta_init is None else
               torch.as_tensor(eta_init, dtype=torch.float32, device=self.device))
        tau0 = (None if tau_init is None else torch.as_tensor(
            pad_tau(_host(tau_init), self.mesh.n_data), device=self.device))
        return init_states(n_full, cfg, generators, eta, tau0, block=(self.lo, self.hi),
                           psum=self.data.sum)

    def accum(self, cfg: SamplerConfig, chains: int):
        """Fresh accumulators of `chains` chains on this block."""
        return init_accum(self.hi - self.lo, self.S, cfg.G, self.device, chains=chains)

    def noise(self, sources) -> ShardNoise:
        """The chains' draws (each source a generator, or any full-size
        source) on one chain axis, cut to this block."""
        return ShardNoise(ChainNoise(TorchNoise(s) if isinstance(s, torch.Generator)
                                     else s for s in sources),
                          self.lo, self.hi, self.Vp, self.V)

    def segment(self, cfg: SamplerConfig, state, accum, start_it: int,
                n_sweeps: int, noise, burn: Optional[int] = None,
                store: bool = False):
        """``sampler.run_segment`` of this rank's chains (state and accum
        with a leading chain axis, swept as one: one launch of each kernel a
        sweep) on this block."""
        before = exchange.calls
        out = run_segment(self.n, cfg, state, accum, start_it, n_sweeps, noise,
                          self.ks, burn=burn, store=store, psum=self.data.sum,
                          agree=self.world.sum)
        SWEEP_STATS["sweeps"] += n_sweeps
        SWEEP_STATS["collectives"] += exchange.calls - before
        return out

    def replica_shard(self, R: int) -> ReplicaShard:
        """This rank's part of an R-replica ensemble: its row's replicas,
        the row's sums, the chain axis's gather (None on an axis of one
        rank) and the world's NaN-trap agreement."""
        replicas = self.chains(R, what="replicas")
        gather = None
        if self.chain.size > 1:
            def gather(stats):   # [3, k] -> [C, 3, k] -> [3, R]
                return self.chain.gather(stats).permute(1, 0, 2).reshape(3, R)
        return ReplicaShard(replicas, self.data.sum, gather, self.world.sum)

    def pt_segment(self, cfg: SamplerConfig, state, accum, rung, start_it: int,
                   n_sweeps: int, noise, exchange_noise, max_temp: float,
                   replicas: ReplicaShard, burn: Optional[int] = None,
                   store: bool = False):
        """``sampler.run_pt_segment`` of this rank's replicas on its block
        (state and accum with the replicas on a leading axis, swept as one
        chain axis: one launch of each kernel a sweep)."""
        before = exchange.calls
        out = run_pt_segment(self.n, cfg, state, accum, rung, start_it, n_sweeps,
                             noise, exchange_noise, max_temp, self.ks, burn=burn,
                             store=store, shard=replicas)
        SWEEP_STATS["sweeps"] += n_sweeps
        SWEEP_STATS["collectives"] += exchange.calls - before
        return out

    def rows_add(self, x: torch.Tensor) -> torch.Tensor:
        """The chain rows' x added (exact where at most one row's element
        is not zero: a stored draw of the row that held rung 0)."""
        return x if self.chain.size == 1 else exchange(x.clone(), self.chain)

    def sweep_fn(self, cfg: SamplerConfig):
        """``sampler.make_sweep_fn`` on this block's kernels and row."""
        return make_sweep_fn(cfg, self.ks, psum=self.data.sum)

    def gather(self, local: SamplerResult, replicated: bool = False,
               add_rows: bool = False) -> SamplerResult:
        """The whole result from every rank's part (this rank's chains
        stacked on a leading axis, rows [lo, hi)): chains in seed order,
        positions cut to the true V. The fields with a position axis and
        the stored draws reach the coordinator alone, on the host, in
        their own dtype (``Axis.collect``; None on the other ranks); the
        rest reach every rank, on its device. ``replicated``: every row
        holds the same chains, row 0's are kept; ``add_rows`` then adds the
        rows' stored draws instead (a PT run's, each the zeros of the rows
        that did not hold rung 0)."""
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
            if replicated and add_rows and name in DRAW_FIELDS:
                parts = parts.sum(0, keepdim=True).to(x.dtype)   # exact: see above
            elif replicated:
                parts = parts[:1]
            if name in _ROW_AXIS:
                ax = _ROW_AXIS[name]
                whole = torch.cat([parts[:, d] for d in range(mesh.n_data)], dim=1 + ax)
                whole = whole.narrow(1 + ax, 0, self.V)
            else:
                whole = parts[:, 0]
            out.append(whole.reshape((-1,) + tuple(whole.shape[2:])))
        return SamplerResult(*out)


class _ShardChains(_Chains):
    """A mesh rank's chain set (``converge.run_chains_auto(mesh=)``): its
    share of the chains on its block of positions (``Shard``), one state
    and accumulators with a leading chain axis, snapshots in shard files
    (``shard_ckpt``, the trace and the caller's extras in the extras
    channel). Every rank gets the whole [C, seg] trace of a segment,
    gathered over the chain axis; without a snapshot, the chains' gamma
    draws too."""

    def __init__(self, counts, cfg: SamplerConfig, seeds, mesh, device, kernel,
                 eta_init, tau_init, checkpoint_path: Optional[str]):
        check_store_thin(cfg)
        self.sh = sh = Shard(counts, mesh, device, kernel)
        self.mine = sh.chains(len(seeds))
        self.generators = [chain_generator(seeds[i], sh.device) for i in self.mine]
        self.cfg, self.path, self.n_chains = cfg, checkpoint_path, len(seeds)
        self.device, self.draws, self.gamma = sh.device, _DrawBuf(), []
        self.eta_init, self.tau_init = eta_init, tau_init

    def start(self):
        sh, out = self.sh, None
        if self.path and latest_step(self.path) is not None:
            self.state, self.accum, it, _, gen_state = load_sharded(
                self.path, sh, self.mine, self.n_chains, sh.device)
            restore_generators(self.generators, gen_state)
            ex = load_extras_sharded(self.path)
            out = it, ex["trace"][:, :it], ex
        else:
            self.state = sh.init(self.cfg, self.generators, self.eta_init, self.tau_init)
            self.fresh_accums()
        if self.path:
            if is_coordinator():
                clear_draws_from(self.path, 0 if out is None else out[0])
            sh.world.barrier()
        self.noise = sh.noise(self.generators)
        return out

    def preempted(self) -> bool:
        return self.sh.world.any(take_preempted())

    def advance(self, it: int, seg: int, burn: int, store: bool = False) -> np.ndarray:
        sh = self.sh
        out = sh.segment(self.cfg, self.state, self.accum, it, seg, self.noise,
                         burn=burn, store=store)
        self.state, self.accum = out[:2]
        slots = stored_slots(it, seg, burn, self.cfg.store_thin) if store else []
        if slots:
            draws = tuple(_numpy(d) for d in out[3])
            if self.path:   # each rank its blocks, in the shard files
                save_draw_shards(self.path, sh, self.mine, it, [it + j for j in slots],
                                 draws)
            else:   # kept here; every chain's gamma draws for the verdict
                self.draws.append(*draws, axis=1)
                self.gamma.append(_numpy(sh.chain.gather(out[3][1]).flatten(0, 1)))
        return _numpy(sh.chain.gather(out[2]).flatten(0, 1))

    def fresh_accums(self) -> None:
        self.accum = self.sh.accum(self.cfg, len(self.mine))

    def gamma_draws(self):
        return np.concatenate(self.gamma, axis=1) if self.gamma else None

    def snapshot(self, it: int, trace: np.ndarray, extras: Optional[dict] = None) -> None:
        save_sharded(self.path, self.sh, self.mine, self.n_chains, self.state,
                     self.accum, self.generators, it, None,
                     extras={**(extras or {}), "trace": trace})

    def result(self, cfg: SamplerConfig, trace: np.ndarray) -> SamplerResult:
        sh = self.sh
        res = sh.gather(super().result(cfg, trace[self.mine.start:self.mine.stop]))
        if self.cfg.store_samples and self.path:
            sh.world.barrier()   # every rank's draw files are on disk
            if is_coordinator():
                res = res._replace(**_assembled(self.path, self.n_chains, sh, cfg))
        return res


def _assembled(ckpt_dir: str, n_chains: int, sh: Shard, cfg: SamplerConfig) -> dict:
    """The draw fields of ``shard_ckpt.assemble_draws`` (coordinator only)."""
    draws = assemble_draws(ckpt_dir, n_chains, sh.V, sh.S, cfg.G)
    return {f: torch.from_numpy(draws[k])
            for f, k in zip(DRAW_FIELDS, ("tau", "gamma", "eta")) if k in draws}


def _one(res: SamplerResult) -> SamplerResult:
    """One run's result on a chain axis of one (``Shard.gather``'s input)."""
    return SamplerResult(*(None if x is None else x.unsqueeze(0) for x in res))


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
    replicated: bool = False,
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
    ``replicated``: every chain row runs all the seeds alike (one chain on
    an n_chain > 1 mesh).
    """
    check_store_thin(cfg)
    sh = Shard(counts, mesh, device, kernel)
    chains = sh.chains(len(seeds), replicated)
    gens = [chain_generator(seeds[i], sh.device) for i in chains]
    out = sh.segment(cfg, sh.init(cfg, gens, eta_init, tau_init), sh.accum(cfg, len(gens)),
                     0, cfg.total_sweeps, sh.noise(gens), store=cfg.store_samples)
    draws = dict(zip(DRAW_FIELDS, out[3])) if cfg.store_samples else {}
    return sh.gather(_result_from_accum(out[1], cfg, out[2], **draws), replicated)


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
        state, accum, it, trace_done, gen_state = load_sharded(
            checkpoint_path, sh, chains, C, sh.device)
        restore_generators(gens, gen_state)
        trace_parts = [trace_done[:, :it]]
    else:
        state, accum = sh.init(cfg, gens, eta_init, tau_init), sh.accum(cfg, len(gens))
        it, trace_parts = 0, []
    if is_coordinator():
        clear_draws_from(checkpoint_path, it)
    sh.world.barrier()
    noise = sh.noise(gens)

    while it < cfg.total_sweeps:
        if sh.world.any(take_preempted()):
            raise Preempted(PREEMPTED_MESSAGE)
        if stop_after is not None and it >= stop_after:
            return None
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        out = sh.segment(cfg, state, accum, it, seg, noise, store=cfg.store_samples)
        state, accum = out[:2]
        slots = stored_slots(it, seg, cfg.burn, cfg.store_thin) if cfg.store_samples else []
        if slots:
            save_draw_shards(checkpoint_path, sh, chains, it, [it + j for j in slots],
                             tuple(_numpy(d) for d in out[3]), replicated)
        it += seg
        trace_parts.append(_numpy(out[2]))
        save_sharded(checkpoint_path, sh, chains, C, state, accum, gens, it,
                     np.concatenate(trace_parts, axis=1), replicated)

    trace = torch.as_tensor(np.concatenate(trace_parts, axis=1), device=sh.device)
    res = sh.gather(_result_from_accum(accum, cfg, trace), replicated)
    if cfg.store_samples:
        sh.world.barrier()   # every rank's draw files are on disk
        if is_coordinator():
            res = res._replace(**_assembled(checkpoint_path, C, sh, cfg))
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
    return None if res is None else chain_result(res, 0)



# --------------------------------------------------------------------------
# parallel tempering: replicas over the chain axis
# --------------------------------------------------------------------------

def _pt_start(sh: Shard, cfg: SamplerConfig, seed: int, R: int):
    """(replica shard, the R + 1 generators of ``sampler.pt_generators``,
    this row's replicas' generators)."""
    check_store_thin(cfg)
    part = sh.replica_shard(R)
    gens = pt_generators(seed, R, sh.device)
    return part, gens, [gens[i] for i in part.replicas]


def _pt_merge(sh: Shard, local: SamplerAccum, replicas: range, R: int) -> SamplerAccum:
    """``sampler.pt_merge_accums`` of the whole ensemble, the same on every
    rank, from this row's replicas' accumulators (on a leading axis): the
    [S]- and [4,4]-sized fields of every replica through the chain axis's
    gather (added in replica order, as on one device), tau's counts added
    over the rows (integers: exact in any order), the star replica's tau
    from its row alone (``Axis.pick``)."""
    if len(replicas) == R:
        return pt_merge_accums(local)
    rows = ("sum_tau", "star_tau")
    whole = SamplerAccum(*(None if f in rows else sh.chain.gather(x).flatten(0, 1)
                           for f, x in zip(SamplerAccum._fields, local)))
    star = torch.argmax(whole.star_loglik).reshape(1)
    mine = (star >= replicas.start) & (star < replicas.stop)
    own = torch.clamp(star - replicas.start, 0, len(replicas) - 1)
    return pt_merge_stacked(whole, star)._replace(
        sum_tau=exchange(local.sum_tau.sum(0), sh.chain),
        star_tau=sh.chain.pick(local.star_tau.index_select(0, own)[0], mine))


def run_chain_pt_sharded(
    counts: np.ndarray,
    cfg: SamplerConfig,
    seed: int,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    kernel: str = "cuda",
    device="cuda",
) -> SamplerResult:
    """Parallel tempering on a (chain, data) mesh: the replicas over the
    chain axis (n_replicas a multiple of it), positions over the data axis
    (counterpart of the JAX package's ``run_chain_pt_sharded``). Called on
    every rank with the same arguments; each returns the result with the
    padding stripped, tau_mean, tau_star and the stored cold draws on the
    coordinator alone, on the host.

    The run is ``sampler.run_chain_pt`` of `seed` on the padded counts up
    to the order of the likelihood sums (a data axis of one rank: bitwise):
    the same generators (``pt_generators``), ladder, exchange and merge.
    A sweep adds one exchange on the chain axis to the row sums of the
    replica sweeps. R < 2 is one chain of ``run_chains_sharded`` on a
    generator seeded `seed`, as ``run_chain_pt`` falls back to
    ``run_chain``.
    """
    R = int(n_replicas)
    if R < 2:
        res = run_chains_sharded(counts, cfg, [seed], mesh, eta_init, tau_init, kernel,
                                 device, replicated=True)
        return chain_result(res, 0)
    sh = Shard(counts, mesh, device, kernel)
    part, gens, own = _pt_start(sh, cfg, seed, R)
    rung = torch.arange(R, device=sh.device)
    out = sh.pt_segment(cfg, sh.init(cfg, own, eta_init, tau_init), sh.accum(cfg, len(own)),
                        rung, 0, cfg.total_sweeps, sh.noise(own), [ExchangeNoise(gens[-1])],
                        max_temp, part, store=cfg.store_samples)
    draws = dict(zip(DRAW_FIELDS, out[6])) if cfg.store_samples else {}
    res = _result_from_accum(_pt_merge(sh, out[1], part.replicas, R), cfg, out[3],
                             pt_swap_accept=pt_swap_rate(out[4], out[5]), **draws)
    return chain_result(sh.gather(_one(res), replicated=True, add_rows=True), 0)


def run_chain_pt_sharded_checkpointed(
    counts: np.ndarray,
    cfg: SamplerConfig,
    seed: int,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    kernel: str = "cuda",
    device="cuda",
    stop_after: Optional[int] = None,
) -> Optional[SamplerResult]:
    """``run_chain_pt_sharded`` with a sharded checkpoint every
    checkpoint_every sweeps in the directory checkpoint_path, resumed from
    it when it holds a committed step (counterpart of the JAX package's
    ``run_chain_pt_sharded_checkpointed``). The replicas take the place of
    chains in ``shard_ckpt``, so a step resumes on another mesh shape; the
    rung vector, the exchange counters, the exchange generator's state and
    the cold trace ride the extras channel. On the same mesh the result is
    bitwise the uninterrupted run's.

    SIGTERM is agreed at each segment head (every rank raises
    ``Preempted`` with the step committed); ``stop_after`` returns None
    once that many sweeps are committed. With cfg.store_samples the cold
    replica's draws of a segment are added over the rows and written by
    row 0. R < 2 is ``run_chain_sharded_checkpointed`` of `seed`.
    """
    R = int(n_replicas)
    if R < 2:
        return run_chain_sharded_checkpointed(
            counts, cfg, seed, checkpoint_path, checkpoint_every, mesh, eta_init,
            tau_init, kernel, device, stop_after)
    sh = Shard(counts, mesh, device, kernel)
    part, gens, own = _pt_start(sh, cfg, seed, R)
    if latest_step(checkpoint_path) is not None:
        state, accum, it, _, gen_state = load_sharded(
            checkpoint_path, sh, part.replicas, R, sh.device)
        ex = load_extras_sharded(checkpoint_path)
        restore_generators(own + [gens[-1]],
                           np.concatenate([gen_state, ex["exchange_generator"][None]]))
        rung = torch.as_tensor(ex["rung"].astype(np.int64), device=sh.device)
        acc_sum, head_sum = float(ex["n_acc"]), float(ex["n_heads"])
        trace_parts = [ex["trace"][:it]]
    else:
        state, accum = sh.init(cfg, own, eta_init, tau_init), sh.accum(cfg, len(own))
        rung = torch.arange(R, device=sh.device)
        it, acc_sum, head_sum, trace_parts = 0, 0.0, 0.0, []
    if is_coordinator():
        clear_draws_from(checkpoint_path, it)
    sh.world.barrier()
    noise = sh.noise(own)
    exchange_noise = [ExchangeNoise(gens[-1])]
    n_acc = torch.tensor(acc_sum, dtype=torch.float32, device=sh.device)

    while it < cfg.total_sweeps:
        if sh.world.any(take_preempted()):
            raise Preempted(PREEMPTED_MESSAGE)
        if stop_after is not None and it >= stop_after:
            return None
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        out = sh.pt_segment(cfg, state, accum, rung, it, seg, noise, exchange_noise,
                            max_temp, part, store=cfg.store_samples)
        state, accum, rung, trace, seg_acc, seg_heads = out[:6]
        slots = stored_slots(it, seg, cfg.burn, cfg.store_thin) if cfg.store_samples else []
        if slots:
            draws = tuple(_numpy(sh.rows_add(d))[None] for d in out[6])
            save_draw_shards(checkpoint_path, sh, range(1), it, [it + j for j in slots],
                             draws, replicated=True)
        it += seg
        n_acc = n_acc + seg_acc
        head_sum += seg_heads
        trace_parts.append(_numpy(trace))
        save_sharded(checkpoint_path, sh, part.replicas, R, state, accum, own, it,
                     None, extras={
                         "rung": _numpy(rung), "n_acc": float(n_acc),
                         "n_heads": head_sum, "trace": np.concatenate(trace_parts),
                         "exchange_generator": _numpy(gens[-1].get_state())})

    trace = torch.as_tensor(np.concatenate(trace_parts), device=sh.device)
    res = _result_from_accum(_pt_merge(sh, accum, part.replicas, R), cfg, trace,
                             pt_swap_accept=pt_swap_rate(n_acc, head_sum))
    res = chain_result(sh.gather(_one(res), replicated=True), 0)
    if cfg.store_samples:
        sh.world.barrier()   # row 0's draw files are on disk
        if is_coordinator():
            res = res._replace(**{f: x[0] for f, x in
                                  _assembled(checkpoint_path, 1, sh, cfg).items()})
    return res
