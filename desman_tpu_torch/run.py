"""End-to-end run: counts -> sampler -> DESMAN-format output dir
(counterpart of the plain and ``--chains`` branches of ``desman_tpu.run``).

Load the counts, optionally subsample positions (-r) and apply min coverage
(-m), run one Gibbs chain (``run``) or several (``run_multi``) on the
chosen device (optionally with a fixed eta from the filter's tran_df, -e),
and write fit.txt, Gamma_{mean,star}.csv, Eta_{mean,star}.csv,
Filtered_Tau_star.csv, Tau_mean.csv, metrics.json and loglik_trace.csv
(and chains.json for several chains).
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
from .likelihood import (
    deviance_from_loglik, log_likelihood_host_f64, total_coeff_host_f64,
)
from .ops import resolve
from .sampler import SamplerConfig, SamplerResult, run_chain, run_chains


@dataclass
class RunConfig:
    """Host-side run options; the same fields and defaults as the JAX
    package's ``RunConfig``. Fields of run modes the port does not have yet
    make ``run`` raise instead of being ignored."""

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
    tau_file: Optional[str] = None
    fix_tau: bool = False
    pt_replicas: int = 0
    pt_max_temp: float = 8.0
    auto_burn: bool = False
    auto_tol: float = 1e-5
    auto_max_burn: int = 2000
    auto_samples: float = 0.0
    auto_max_samples: int = 2000
    eta_update: str = "joint"
    store_every: int = 0


def _refuse_unported(rc: RunConfig) -> None:
    """Raise for every RunConfig field whose run mode is not ported yet."""
    waiting = [
        (rc.checkpoint_path, "checkpoint_path", "11 (checkpoints)"),
        (rc.auto_burn or rc.auto_samples > 0, "auto_burn/auto_samples",
         "11 (auto-length)"),
        (rc.pt_replicas >= 2, "pt_replicas", "12 (parallel tempering)"),
        (rc.tau_file or rc.fix_tau, "tau_file/fix_tau", "5 (em_gamma, -t/-f)"),
        (rc.store_every, "store_every", "3 (stored draws)"),
        (rc.eta_update != "joint", "eta_update='rows'", "3 (per-row eta MH)"),
        (rc.profile_dir, "profile_dir", "13 (profiling)"),
    ]
    for on, field, item in waiting:
        if on:
            raise NotImplementedError(
                f"RunConfig.{field} is not ported yet (ROADMAP queue 1 item {item})")


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


def _prepare(data: io.CountsData, rc: RunConfig, device, kernel: str,
             nmf_iters: Optional[int]):
    """What run and run_multi share: the refusals, the prepared data, the
    sampler config, the counts and eta on the device, and the kernel choice
    bound to those counts (once per run)."""
    _refuse_unported(rc)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    data = prepare_data(data, rc.min_coverage, rc.n_positions, rc.seed)
    cfg = sampler_config(rc)
    if nmf_iters is not None:
        cfg = replace(cfg, nmf_iters=nmf_iters)
    eta_init = None
    if rc.eta_file:
        eta_init = torch.as_tensor(io.read_eta_csv(rc.eta_file),
                                   dtype=torch.float32, device=device)
    n = torch.as_tensor(data.counts, device=device).to(torch.float32)
    return device, data, cfg, eta_init, n, resolve(kernel, n)


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
    """
    device, data, cfg, eta_init, n, ks = _prepare(data, rc, device, kernel,
                                                  nmf_iters)
    generator = torch.Generator(device=device)
    generator.manual_seed(rc.seed)

    t0 = time.time()
    res = run_chain(n, cfg, generator, eta_init=eta_init, kernel=ks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - t0

    write_outputs(rc.out_dir, data, res, cfg, elapsed, seed=rc.seed,
                  extra_metrics={"device": _device_name(device), "kernel": kernel})
    return res


def run_multi(data: io.CountsData, rc: RunConfig, n_chains: int, device="cuda",
              kernel: str = "cuda", nmf_iters: Optional[int] = None
              ) -> SamplerResult:
    """Run n_chains chains (seeds rc.seed .. rc.seed + n_chains - 1) on
    `device`, write the outputs of the chain with the best star loglik, and
    chains.json: the seeds, each chain's star loglik, split-R-hat and bulk
    ESS of the post-burn loglik traces, and the pairwise SNP distances of
    the chains' tau-stars. Returns the best chain's result.

    The counterpart of the JAX package's ``run_multi`` without its mesh,
    PT, checkpoint and auto-length modes (refused by ``_refuse_unported``).
    """
    from .diagnostics import ess_bulk, replicate_agreement, split_rhat

    device, data, cfg, eta_init, n, ks = _prepare(data, rc, device, kernel,
                                                  nmf_iters)
    seeds = list(range(rc.seed, rc.seed + n_chains))
    t0 = time.time()
    res = run_chains(n, cfg, seeds, eta_init=eta_init, kernel=ks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - t0

    star = _np(res.star_loglik)
    best = int(np.argmax(star))
    best_res = SamplerResult(*(x[best] for x in res))
    write_outputs(rc.out_dir, data, best_res, cfg, elapsed, seed=seeds[best],
                  extra_metrics={"device": _device_name(device), "kernel": kernel,
                                 "chains": n_chains})
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
    from .diagnostics import ess_bulk

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
        "final_loglik": float(trace[-1]),
        "elapsed_s": elapsed,
        "sweeps_per_s": (cfg.total_sweeps / elapsed) if elapsed else None,
        **(extra_metrics or {}),
    }
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    np.savetxt(os.path.join(out_dir, "loglik_trace.csv"),
               _np(res.loglik_trace), delimiter=",")
