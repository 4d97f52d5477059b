"""End-to-end run: counts -> sampler -> DESMAN-format output dir
(counterpart of ``desman_tpu.run``).

Load the counts, optionally subsample positions (-r) and apply min coverage
(-m), run one Gibbs chain (``run``) or several (``run_multi``) on the
chosen device (optionally with a fixed eta from the filter's tran_df, -e;
with parallel tempering, --pt; checkpointed and resumable with
--checkpoint; of data-driven length with --auto_burn/--auto_samples), and
write fit.txt, Gamma_{mean,star}.csv, Eta_{mean,star}.csv,
Filtered_Tau_star.csv, Tau_mean.csv, metrics.json and loglik_trace.csv
(and chains.json for several chains; draws.npz with --store_every). A
haplotype file (-t, or -f to hold it fixed) starts tau from known strains.
On a (chain, data) mesh of ranks (``parallel``), ``run_multi(mesh=...)``
(with --auto_* too), ``run_sharded_checkpointed`` and ``run_pt_sharded``
run on every rank and write the files on the coordinator.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from . import io
from .checkpoint import (
    run_chain_checkpointed, run_chain_pt_checkpointed, run_chains_checkpointed,
)
from .converge import run_chain_pt_auto, run_chains_auto
from .likelihood import (
    deviance_from_loglik, log_likelihood_host_f64, total_coeff_host_f64,
)
from .ops import resolve
from .profiling import device_trace, span
from .sampler import (
    RESIDENT_PLAIN_ONLY, SamplerConfig, SamplerResult, chain_generator,
    chain_result, run_chain, run_chain_pt, run_chains, run_chains_pt,
)


@dataclass
class RunConfig:
    """Host-side run options; the same fields and defaults as the JAX
    package's ``RunConfig``."""

    G: int                           # -g number of strains
    iterations: int = 250            # -i total sweeps (burn = half)
    seed: int = 0                    # -s
    eta_file: Optional[str] = None   # -e tran_df.csv (fixes eta unless sample_eta)
    sample_eta: bool = False         # sample eta even when eta_file seeds it
    min_coverage: float = 0.0        # -m drop positions below this total coverage
    n_positions: int = 0             # -r random position subsample (0 = all)
    out_dir: str = "desman_out"      # -o
    burn_frac: float = 0.5
    # 0.0 = warm-start the MH proposal concentrations from the data's
    # posterior curvature (see SamplerConfig); positive pins
    kappa_gamma: float = 0.0
    kappa_eta: float = 0.0
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 50
    profile_dir: Optional[str] = None
    tau_file: Optional[str] = None   # -t/-f: tau-star CSV to start from
    fix_tau: bool = False            # -f: freeze tau (fit gamma/eta only)
    pt_replicas: int = 0
    pt_max_temp: float = 8.0
    auto_burn: bool = False
    auto_tol: float = 1e-5
    auto_max_burn: int = 2000
    auto_samples: float = 0.0
    auto_max_samples: int = 2000
    eta_update: str = "joint"        # "joint" | "rows" (per-row eta MH)
    store_every: int = 0             # >0: write every k-th post-burn draw


def prepare_data(
    data: io.CountsData, min_coverage: float, n_positions: int, seed: int
) -> io.CountsData:
    """Coverage gate + optional random subsample of positions (-r/-m)."""
    keep = data.counts.sum(axis=(1, 2)) >= min_coverage
    data = data.select(np.flatnonzero(keep))
    if n_positions and data.V > n_positions:
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(data.V, size=n_positions, replace=False))
        data = data.select(idx)
    return data


def sampler_config(rc: RunConfig) -> SamplerConfig:
    burn = int(rc.iterations * rc.burn_frac)
    if rc.store_every and (rc.iterations - burn) % rc.store_every != 0:
        raise ValueError(
            f"store_every={rc.store_every} must divide the sampling sweeps "
            f"({rc.iterations - burn} = iterations - burn)"
        )
    return SamplerConfig(
        G=rc.G,
        burn=burn,
        samples=rc.iterations - burn,
        kappa_gamma=rc.kappa_gamma,
        kappa_eta=rc.kappa_eta,
        fix_eta=(rc.eta_file is not None and not rc.sample_eta),
        fix_tau=rc.fix_tau,
        eta_update=rc.eta_update,
        store_samples=rc.store_every > 0,
        store_thin=max(rc.store_every, 1),
    )


def load_tau_init(tau_file: str, data: io.CountsData) -> np.ndarray:
    """Load a Filtered_Tau_star.csv and align it to data's positions.

    Every (Contig, Position) of `data` must appear in the tau file (the
    fixed/initial haplotypes share the filter's position set).
    """
    tau, contigs, positions = io.read_tau_star_csv(tau_file)
    index = {(str(c), int(p)): i for i, (c, p) in enumerate(zip(contigs, positions))}
    rows = []
    for c, p in zip(data.contigs, data.positions):
        key = (str(c), int(p))
        if key not in index:
            raise ValueError(f"tau file missing position {key}")
        rows.append(index[key])
    return tau[rows]


# the JAX CLI's refusals: auto-length PT with --mesh, --checkpoint or
# --chains; PT on a mesh with --chains; replicas that do not split over the
# mesh's chain axis (``pt_mesh_split``)
AUTO_PT_SINGLE_CHAIN = (
    "--auto_burn/--auto_samples with --pt composes only single-chain "
    "without --mesh/--checkpoint (pin -i for those combinations)")
PT_MESH_CHAINS = ("--pt --mesh does not compose with --chains "
                  "(replicas already occupy the mesh chain axis)")


def pt_mesh_split(R: int, n_chain: int) -> Optional[str]:
    """The JAX CLI's refusal of --pt R on a chain axis of n_chain that does
    not divide it, else None."""
    if R >= 2 and R % n_chain:
        return f"--pt {R} must be a multiple of the mesh chain axis {n_chain}"
    return None


def _prepare_host(data: io.CountsData, rc: RunConfig, nmf_iters: Optional[int]):
    """The host part of a run's preparation: the prepared data, the sampler
    config, eta and the known haplotypes as host arrays (None when not
    given), and the fix_tau refusal."""
    data = prepare_data(data, rc.min_coverage, rc.n_positions, rc.seed)
    cfg = sampler_config(rc)
    if nmf_iters is not None:
        cfg = replace(cfg, nmf_iters=nmf_iters)
    eta_init = io.read_eta_csv(rc.eta_file) if rc.eta_file else None
    tau_init = None
    if rc.tau_file:
        tau_init = load_tau_init(rc.tau_file, data)
    elif rc.fix_tau:
        raise ValueError("fix_tau requires tau_file")
    return data, cfg, eta_init, tau_init


def _prepare(data: io.CountsData, rc: RunConfig, device, kernel: str,
             nmf_iters: Optional[int], n_chains: int = 1):
    """What run and run_multi share: the refusals, the prepared data, the
    sampler config, the counts, eta and the known haplotypes on the device,
    and the kernel choice bound to those counts (once per run)."""
    pt = rc.pt_replicas >= 2
    if _auto(rc) and pt and (rc.checkpoint_path or n_chains > 1):
        # the JAX CLI refuses these; its run()/run_multi() would drop the
        # checkpoint or the tempering without a word
        raise ValueError(AUTO_PT_SINGLE_CHAIN)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    data, cfg, eta_init, tau_init = _prepare_host(data, rc, nmf_iters)
    if eta_init is not None:
        eta_init = torch.as_tensor(eta_init, dtype=torch.float32, device=device)
    if tau_init is not None:
        tau_init = torch.as_tensor(tau_init, dtype=torch.int32, device=device)
    n = torch.as_tensor(data.counts, device=device).to(torch.float32)
    ks = resolve(kernel, n)
    if ks.resident and (_auto(rc) or pt or rc.checkpoint_path):
        # run-mode fields the resident path cannot honor must not be
        # silently dropped (API callers bypass the CLI's refusal)
        raise ValueError(RESIDENT_PLAIN_ONLY)
    return device, data, cfg, eta_init, tau_init, n, ks


def _auto(rc: RunConfig) -> bool:
    return rc.auto_burn or rc.auto_samples > 0


def _auto_kw(rc: RunConfig, cfg: SamplerConfig) -> dict:
    """converge's arguments for --auto_burn/--auto_samples; without
    auto_burn the burn is pinned at cfg.burn (max_burn=cfg.burn burns
    exactly that, segment-wise: the same trajectory)."""
    return dict(rel_tol=rc.auto_tol,
                max_burn=rc.auto_max_burn if rc.auto_burn else cfg.burn,
                ess_target=rc.auto_samples, max_samples=rc.auto_max_samples)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(data: io.CountsData, rc: RunConfig, device="cuda", kernel: str = "cuda",
        nmf_iters: Optional[int] = None) -> SamplerResult:
    """Run one chain on `device` and write the output directory.

    kernel: one of ``ops.KERNELS``: "cuda" (the tau-sweep and swap kernels;
    their plain versions on a CPU device), "cuda_resident" (the resident
    sweep's kernels, see ``resident``), "cuda_topk" (the top-2 tau kernel,
    for counts with at most two observed bases per cell: raises
    TopkInapplicable otherwise, before the first sweep) or "torch" (the
    plain versions). nmf_iters overrides the NMF start's iteration count
    (benchmarks use a short start). Returns the result, its tensors still
    on the device.

    The JAX package's branches, in its order: rc.auto_burn/auto_samples
    with rc.pt_replicas >= 2 run ``converge.run_chain_pt_auto`` (without
    a checkpoint: refused); alone, ``converge``'s data-driven length (a
    one-chain ``run_chains_auto``, checkpointed with rc.checkpoint_path),
    and metrics.json reports the sweeps run; rc.checkpoint_path runs
    ``checkpoint.run_chain_pt_checkpointed`` with PT and
    ``checkpoint.run_chain_checkpointed`` without; rc.pt_replicas >= 2
    alone runs ``sampler.run_chain_pt`` (rc.pt_max_temp the top of the
    ladder; metrics.json adds pt_swap_accept). "cuda_resident" refuses
    every one of these modes. With rc.profile_dir every branch runs inside
    ``profiling.device_trace`` (the trace ends when the chain has; the
    output files are written after it).
    """
    device, data, cfg, eta_init, tau_init, n, ks = _prepare(
        data, rc, device, kernel, nmf_iters)
    generator = chain_generator(rc.seed, device)
    init = dict(eta_init=eta_init, tau_init=tau_init, kernel=ks)
    ladder = dict(n_replicas=rc.pt_replicas, max_temp=rc.pt_max_temp)

    t0 = time.time()
    with device_trace(rc.profile_dir, device):
        if _auto(rc) and rc.pt_replicas >= 2:
            res, burn_used, samples_used = run_chain_pt_auto(
                n, cfg, rc.seed, **ladder, **init, auto_burn=rc.auto_burn,
                **_auto_kw(rc, cfg))
            cfg = replace(cfg, burn=burn_used, samples=samples_used)
        elif _auto(rc):   # one chain of run_chains_auto (checkpointed or not)
            res, burn_used, samples_used = run_chains_auto(
                n, cfg, [rc.seed], checkpoint_path=rc.checkpoint_path,
                **init, **_auto_kw(rc, cfg))
            res = chain_result(res, 0)
            cfg = replace(cfg, burn=burn_used, samples=samples_used)
        elif rc.checkpoint_path and rc.pt_replicas >= 2:
            res = run_chain_pt_checkpointed(n, cfg, rc.seed, rc.checkpoint_path,
                                            checkpoint_every=rc.checkpoint_every,
                                            **ladder, **init)
        elif rc.checkpoint_path:
            res = run_chain_checkpointed(n, cfg, generator, rc.checkpoint_path,
                                         checkpoint_every=rc.checkpoint_every,
                                         **init)
        elif rc.pt_replicas >= 2:
            res = run_chain_pt(n, cfg, rc.seed, **ladder, **init)
        else:
            res = run_chain(n, cfg, generator, **init)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    elapsed = time.time() - t0

    write_outputs(rc.out_dir, data, res, cfg, elapsed, seed=rc.seed,
                  extra_metrics={"device": _device_name(device), "kernel": kernel})
    _write_draws(rc.out_dir, res, cfg)
    return res


def _write_draws(out_dir: str, res: SamplerResult, cfg: SamplerConfig) -> None:
    """draws.npz from a result with stored draws (--store_every)."""
    if res.tau_samples is not None:
        io.write_draws(os.path.join(out_dir, "draws.npz"), _np(res.tau_samples),
                       _np(res.gamma_samples), _np(res.eta_samples),
                       burn=cfg.burn, thin=cfg.store_thin)


def run_multi(data: io.CountsData, rc: RunConfig, n_chains: int, device="cuda",
              kernel: str = "cuda", nmf_iters: Optional[int] = None, mesh=None
              ) -> SamplerResult:
    """Run n_chains chains (seeds rc.seed .. rc.seed + n_chains - 1) on
    `device`, write the outputs of the chain with the best star loglik, and
    chains.json: the seeds, each chain's star loglik, split-R-hat and bulk
    ESS of the post-burn loglik traces, and the pairwise SNP distances of
    the chains' tau-stars. Returns the best chain's result.

    The counterpart of the JAX package's ``run_multi``, with its branches
    in its order: rc.auto_burn/auto_samples burn
    until every chain plateaus (``converge.run_chains_auto``, checkpointed
    with rc.checkpoint_path; with PT refused); rc.pt_replicas >= 2 runs
    ``sampler.run_chains_pt``, and, as in the JAX package, without
    checkpoints even when rc.checkpoint_path is set; rc.checkpoint_path
    alone runs ``checkpoint.run_chains_checkpointed``. As in the JAX
    package, no branch opens a trace: rc.profile_dir is ignored here.

    mesh: a ``parallel.Mesh`` over the ranks of the joined world (called on
    every rank): positions over its data axis, the chains split over its
    chain axis (n_chains a multiple of it); with rc.auto_burn/auto_samples
    ``converge.run_chains_auto(mesh=...)`` (checkpointed in a directory of
    shard files with rc.checkpoint_path), else
    ``parallel.run_chains_sharded``, or with rc.checkpoint_path
    ``run_chains_sharded_checkpointed``. `device` is each rank's by the
    device rule (``parallel.distributed.rank_device``). Only the
    coordinator writes. rc.pt_replicas >= 2 raises ValueError naming
    ``run_pt_sharded`` (PT on a mesh puts the replicas on the chain axis:
    one run, not n_chains); "cuda_resident" is single-device.
    """
    if mesh is not None:
        return _run_multi_mesh(data, rc, n_chains, device, kernel, nmf_iters, mesh)
    device, data, cfg, eta_init, tau_init, n, ks = _prepare(
        data, rc, device, kernel, nmf_iters, n_chains)
    seeds = list(range(rc.seed, rc.seed + n_chains))
    init = dict(eta_init=eta_init, tau_init=tau_init, kernel=ks)
    t0 = time.time()
    if _auto(rc):
        res, burn_used, samples_used = run_chains_auto(
            n, cfg, seeds, checkpoint_path=rc.checkpoint_path, **init,
            **_auto_kw(rc, cfg))
        cfg = replace(cfg, burn=burn_used, samples=samples_used)
    elif rc.pt_replicas >= 2:
        res = run_chains_pt(n, cfg, seeds, n_replicas=rc.pt_replicas,
                            max_temp=rc.pt_max_temp, **init)
    elif rc.checkpoint_path:
        res = run_chains_checkpointed(n, cfg, seeds, rc.checkpoint_path,
                                      checkpoint_every=rc.checkpoint_every, **init)
    else:
        res = run_chains(n, cfg, seeds, **init)
    _sync(device)
    return _write_multi(rc, data, res, cfg, seeds, time.time() - t0,
                        {"device": _device_name(device), "kernel": kernel,
                         "chains": n_chains})


def _write_multi(rc: RunConfig, data: io.CountsData, res: SamplerResult,
                 cfg: SamplerConfig, seeds, elapsed: float, extra: dict
                 ) -> SamplerResult:
    """run_multi's files: the best chain's outputs and chains.json."""
    from .diagnostics import ess_bulk, replicate_agreement, split_rhat

    star = _np(res.star_loglik)
    best = int(np.argmax(star))
    best_res = chain_result(res, best)
    write_outputs(rc.out_dir, data, best_res, cfg, elapsed, seed=seeds[best],
                  extra_metrics=extra)
    _write_draws(rc.out_dir, best_res, cfg)
    post = _np(res.loglik_trace)[:, cfg.burn:]
    with open(os.path.join(rc.out_dir, "chains.json"), "w") as f:
        json.dump(
            {"seeds": seeds, "best_seed": seeds[best],
             "star_logliks": star.tolist(),
             "loglik_split_rhat": split_rhat(post),
             "loglik_ess_bulk": ess_bulk(post),
             "tau_star_pairwise_snp": replicate_agreement(
                 list(_np(res.tau_star))).tolist()}, f, indent=2)
    return best_res


def _mesh_prepare(data: io.CountsData, rc: RunConfig, device, nmf_iters,
                  entry: str, pt: bool = False, auto: bool = False):
    """What the mesh runs share: the refusal of auto-length PT and of a run
    mode another entry point runs (none is dropped without a word), the
    rank's device, and ``_prepare_host`` (host arrays: the shards place
    them)."""
    from .parallel.distributed import rank_device

    if _auto(rc) and rc.pt_replicas >= 2:
        raise ValueError(AUTO_PT_SINGLE_CHAIN)
    if rc.pt_replicas >= 2 and not pt:
        raise ValueError(f"{entry} runs no parallel tempering: on a mesh that "
                         "is run.run_pt_sharded")
    if _auto(rc) and not auto:
        raise ValueError(f"{entry} runs no auto-length run: on a mesh that is "
                         "run.run_multi(mesh=...)")
    return (rank_device(device),) + _prepare_host(data, rc, nmf_iters)


# the kernels a mesh run launches, counted in its run record
_MESH_KERNELS = ("tau_sweep", "swap", "tau_sweep_topk")


def _mesh_counts() -> dict:
    """This process's kernel launches, chain launches and shard sweep
    statistics so far."""
    from . import ops
    from .parallel.sharded import SWEEP_STATS

    return dict({k: getattr(ops, k).launches for k in _MESH_KERNELS},
                **{f"{k}_chains": getattr(ops, k).chain_launches for k in _MESH_KERNELS},
                **SWEEP_STATS)


def _mesh_metrics(device, kernel: str, mesh, before: dict) -> dict:
    """The run record of a mesh run (every rank calls it: one collective):
    device, kernel, mesh, backend, ranks, each kernel's launches and chain
    launches since `before` summed over the ranks, and the collectives a
    sweep made on this rank."""
    from .parallel import distributed

    after = _mesh_counts()
    names = _MESH_KERNELS + tuple(f"{k}_chains" for k in _MESH_KERNELS)
    launched = torch.tensor([after[k] - before[k] for k in names],
                            dtype=torch.int64, device=device)
    launched = distributed.mesh_axes(mesh, device).world.sum(launched).tolist()
    sweeps = after["sweeps"] - before["sweeps"]
    k = len(_MESH_KERNELS)
    return {"device": _device_name(device), "kernel": kernel, "mesh": str(mesh),
            "backend": distributed.backend(), "ranks": distributed.world_ranks(),
            "launches": dict(zip(_MESH_KERNELS, launched[:k])),
            "chain_launches": dict(zip(_MESH_KERNELS, launched[k:])),
            "collectives_per_sweep": (after["collectives"] - before["collectives"])
            / max(sweeps, 1)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_multi_mesh(data, rc: RunConfig, n_chains: int, device, kernel: str,
                    nmf_iters, mesh) -> SamplerResult:
    from .parallel import distributed
    from .parallel.sharded import (
        run_chains_sharded, run_chains_sharded_checkpointed,
    )

    device, data, cfg, eta_init, tau_init = _mesh_prepare(
        data, rc, device, nmf_iters, "run_multi(mesh=...)", auto=True)
    seeds = list(range(rc.seed, rc.seed + n_chains))
    init = dict(mesh=mesh, eta_init=eta_init, tau_init=tau_init, kernel=kernel,
                device=device)
    before = _mesh_counts()
    t0 = time.time()
    if _auto(rc):
        res, burn_used, samples_used = run_chains_auto(
            data.counts, cfg, seeds, checkpoint_path=rc.checkpoint_path, **init,
            **_auto_kw(rc, cfg))
        cfg = replace(cfg, burn=burn_used, samples=samples_used)
    elif rc.checkpoint_path:
        res = run_chains_sharded_checkpointed(
            data.counts, cfg, seeds, rc.checkpoint_path,
            checkpoint_every=rc.checkpoint_every, **init)
    else:
        res = run_chains_sharded(data.counts, cfg, seeds, **init)
    _sync(device)
    elapsed = time.time() - t0
    extra = dict(_mesh_metrics(device, kernel, mesh, before), chains=n_chains)
    if distributed.is_coordinator():
        return _write_multi(rc, data, res, cfg, seeds, elapsed, extra)
    return chain_result(res, int(np.argmax(_np(res.star_loglik))))


def run_sharded_checkpointed(data: io.CountsData, rc: RunConfig, mesh,
                             device="cuda", kernel: str = "cuda",
                             nmf_iters: Optional[int] = None) -> SamplerResult:
    """One chain (seed rc.seed) on a mesh with sharded checkpoints in the
    directory rc.checkpoint_path (``desman --mesh --checkpoint``): positions
    over the data axis, every chain row running the chain alike. Called on
    every rank; the coordinator writes the files. PT and auto-length runs
    raise ValueError naming the entry point that runs them."""
    from .parallel import distributed
    from .parallel.sharded import run_chain_sharded_checkpointed

    device, data, cfg, eta_init, tau_init = _mesh_prepare(
        data, rc, device, nmf_iters, "run_sharded_checkpointed")
    before = _mesh_counts()
    t0 = time.time()
    res = run_chain_sharded_checkpointed(
        data.counts, cfg, rc.seed, rc.checkpoint_path,
        checkpoint_every=rc.checkpoint_every, mesh=mesh, eta_init=eta_init,
        tau_init=tau_init, kernel=kernel, device=device)
    _sync(device)
    elapsed = time.time() - t0
    extra = _mesh_metrics(device, kernel, mesh, before)
    if distributed.is_coordinator():
        write_outputs(rc.out_dir, data, res, cfg, elapsed, seed=rc.seed,
                      extra_metrics=extra)
        _write_draws(rc.out_dir, res, cfg)
    return res


def run_pt_sharded(data: io.CountsData, rc: RunConfig, mesh, device="cuda",
                   kernel: str = "cuda", nmf_iters: Optional[int] = None
                   ) -> SamplerResult:
    """Parallel tempering on a mesh (``desman --mesh CxD --pt R``, the
    JAX package's ``run_pt_sharded``): the rc.pt_replicas replicas over the
    chain axis (a multiple of it), positions over the data axis
    (``parallel.run_chain_pt_sharded``); with rc.checkpoint_path checkpointed
    in a directory of shard files
    (``parallel.run_chain_pt_sharded_checkpointed``). Called on every rank;
    the coordinator writes the files, metrics.json with pt_swap_accept and
    the mesh record. Auto-length runs raise ``AUTO_PT_SINGLE_CHAIN``, as
    the JAX CLI refuses them."""
    from .parallel import distributed
    from .parallel.sharded import (
        run_chain_pt_sharded, run_chain_pt_sharded_checkpointed,
    )

    split = pt_mesh_split(rc.pt_replicas, mesh.n_chain)
    if split:
        raise ValueError(split)
    device, data, cfg, eta_init, tau_init = _mesh_prepare(
        data, rc, device, nmf_iters, "run_pt_sharded", pt=True)
    init = dict(n_replicas=rc.pt_replicas, max_temp=rc.pt_max_temp, mesh=mesh,
                eta_init=eta_init, tau_init=tau_init, kernel=kernel, device=device)
    before = _mesh_counts()
    t0 = time.time()
    if rc.checkpoint_path:
        res = run_chain_pt_sharded_checkpointed(
            data.counts, cfg, rc.seed, rc.checkpoint_path,
            checkpoint_every=rc.checkpoint_every, **init)
    else:
        res = run_chain_pt_sharded(data.counts, cfg, rc.seed, **init)
    _sync(device)
    elapsed = time.time() - t0
    extra = _mesh_metrics(device, kernel, mesh, before)
    if distributed.is_coordinator():
        write_outputs(rc.out_dir, data, res, cfg, elapsed, seed=rc.seed,
                      extra_metrics=extra)
        _write_draws(rc.out_dir, res, cfg)
    return res


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def write_outputs(
    out_dir: str,
    data: io.CountsData,
    res: SamplerResult,
    cfg: SamplerConfig,
    elapsed: Optional[float] = None,
    seed: Optional[int] = None,
    extra_metrics: Optional[dict] = None,
) -> None:
    """Write the DESMAN-compatible output file set.

    Deviances are computed in float64 on the host (star: exact
    re-evaluation of the star state; mean: math.fsum over the post-burn f32
    trace), so the numbers model selection discriminates on never carry the
    f32 device reduction error.
    """
    from .diagnostics import draws_diagnostics, ess_bulk

    with span("write_outputs", G=cfg.G, seed=seed):
        io.ensure_dir(out_dir)
        trace = _np(res.loglik_trace).astype(np.float64)
        coeff = total_coeff_host_f64(data.counts)
        post = trace[cfg.burn:]
        if post.size:
            mean_ll = math.fsum(post.tolist()) / post.size
        else:  # degenerate all-burn config: fall back to the device accumulator
            mean_ll = float(res.mean_loglik)
        mean_dev = deviance_from_loglik(mean_ll, coeff)
        tau_star, gamma_star, eta_star = (_np(res.tau_star), _np(res.gamma_star),
                                          _np(res.eta_star))
        with span("write_outputs.star_ll"):
            star_ll_f64 = log_likelihood_host_f64(
                data.counts, tau_star, gamma_star, eta_star, include_coeff=False)
        star_dev = deviance_from_loglik(star_ll_f64, coeff)

        io.write_fit_txt(
            os.path.join(out_dir, "fit.txt"),
            G=cfg.G, V=data.V, S=data.S,
            mean_deviance=mean_dev, star_deviance=star_dev,
            star_loglik=float(res.star_loglik) + coeff,
        )
        io.write_gamma_csv(os.path.join(out_dir, "Gamma_mean.csv"),
                           _np(res.gamma_mean), data.samples)
        io.write_gamma_csv(os.path.join(out_dir, "Gamma_star.csv"), gamma_star,
                           data.samples)
        io.write_eta_csv(os.path.join(out_dir, "Eta_mean.csv"), _np(res.eta_mean))
        io.write_eta_csv(os.path.join(out_dir, "Eta_star.csv"), eta_star)
        io.write_tau_star_csv(os.path.join(out_dir, "Filtered_Tau_star.csv"),
                              tau_star, data.contigs, data.positions)
        io.write_tau_mean_csv(os.path.join(out_dir, "Tau_mean.csv"),
                              _np(res.tau_mean), data.contigs, data.positions)

        ess_fields = {}
        if post.size >= 4:
            ess_fields["loglik_ess_bulk"] = float(ess_bulk(post[None, :]))
        # per-parameter gamma/eta ESS whenever draws were stored
        if res.gamma_samples is not None and res.gamma_samples.shape[0] >= 4:
            d = draws_diagnostics({"gamma": _np(res.gamma_samples),
                                   "eta": _np(res.eta_samples)})
            ess_fields.update({k: d[k] for k in
                               ("gamma_ess_min", "gamma_ess_median", "eta_ess_min")})
        metrics = {
            "G": cfg.G, "V": data.V, "S": data.S,
            **({"seed": int(seed)} if seed is not None else {}),
            "sweeps": cfg.total_sweeps,
            "sampling_sweeps": cfg.samples,
            "mean_deviance": mean_dev,
            "star_deviance": star_dev,
            "accept_gamma": float(res.accept_gamma),
            "accept_eta": float(res.accept_eta),
            "accept_gamma_post": float(res.accept_gamma_post),
            "accept_eta_post": float(res.accept_eta_post),
            **ess_fields,
            **({"pt_swap_accept": float(res.pt_swap_accept)}
               if res.pt_swap_accept is not None else {}),
            "final_loglik": float(trace[-1]),
            "elapsed_s": elapsed,
            "sweeps_per_s": (cfg.total_sweeps / elapsed) if elapsed else None,
            **(extra_metrics or {}),
        }
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        np.savetxt(os.path.join(out_dir, "loglik_trace.csv"),
                   _np(res.loglik_trace), delimiter=",")
