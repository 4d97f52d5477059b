"""Model selection over the number of strains G (counterpart of
``desman_tpu.model_selection``; the reference's resolvenhap semantics).

``fit_grid`` runs the (G, seed) grid on one device: for each G, one chain
per seed (``sampler.run_chains``, or ``converge.run_chains_auto`` to an
ESS target), with the kernel choice bound to the counts once for the
whole grid; or on a (chain, data) mesh of ranks, the seeds over its chain
axis (``parallel.run_chains_sharded``). The JAX package compiles one
program per G ahead of time in a thread pool; eager PyTorch has nothing to
compile, so the port loops over G. ``resolve_nhap`` picks G from the runs' posterior
mean deviances and SNV uncertainties, over the same fit.txt conventions.

Selection rule: for each G take the best replicate by posterior mean
deviance; choose the smallest G whose step to G+1 is not both substantial
and credible (see ``resolve_nhap``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import io
from .likelihood import (
    deviance_from_loglik, snv_uncertainty, total_coeff_host_f64,
)
from .converge import run_chains_auto
from .ops import resolve
from .run import write_outputs
from .sampler import (
    RESIDENT_SINGLE_DEVICE, SamplerConfig, chain_result, run_chains,
)

_RUN_FILES = ("fit.txt", "metrics.json", "Tau_mean.csv")


def _data_digest(counts: np.ndarray, eta_init) -> str:
    """Content hash of the inputs a grid run depends on (counts + seeded eta)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(counts, np.float32).tobytes())
    if eta_init is not None:
        h.update(np.ascontiguousarray(np.asarray(eta_init), np.float32).tobytes())
    return h.hexdigest()[:16]


def run_fingerprint(data_digest: str, cfg: SamplerConfig, seed: int) -> str:
    """Fingerprint of everything that determines a grid run's outputs: the
    data digest, every SamplerConfig field and the seed (the JAX package's
    hash of the same fields). Stored in metrics.json and checked before
    elastic resume reuses a directory."""
    key = (data_digest, tuple(sorted(
        (f.name, repr(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
    )), int(seed))
    return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


@dataclass
class RunRecord:
    G: int
    seed: int
    mean_deviance: float
    uncertainty: float
    run_dir: Optional[str] = None


@dataclass
class SelectionResult:
    G: int
    seed: int
    uncertainty: float
    mean_deviance: float
    records: List[RunRecord]
    run_dir: Optional[str] = None

    def summary_line(self) -> str:
        """CSV summary (the reference CLI's stdout contract analogue)."""
        return (
            f"{self.G},{self.seed},{self.uncertainty:.6f},"
            f"{self.mean_deviance:.6f},{self.run_dir or ''}"
        )


def fit_grid(
    counts: np.ndarray,
    g_values: Sequence[int],
    seeds: Sequence[int],
    iterations: int = 250,
    eta_init: Optional[np.ndarray] = None,
    fix_eta: bool = False,
    kappa_gamma: float = 0.0,   # 0 = curvature warm start (SamplerConfig)
    kappa_eta: float = 0.0,
    unc_threshold: float = 0.9,
    out_stub: Optional[str] = None,
    data: Optional[io.CountsData] = None,
    mesh=None,
    kernel: str = "cuda",
    resume: bool = True,
    ess_target: float = 0.0,
    max_samples: int = 2000,
    device="cuda",
) -> List[RunRecord]:
    """Fit G x seeds on `device`; with out_stub and data, write one output
    dir per run, ``<out_stub>_<G>_<seed>``.

    kernel: a kernel choice of ``ops.KERNELS``, bound to these counts once
    for the whole grid (``cuda_topk`` raises TopkInapplicable here, before
    any chain, on counts with a cell of more than two observed bases).

    ``ess_target > 0``: each G's chains extend their sampling phase in
    segments until every chain's post-burn ESS reaches the target
    (``converge.run_chains_auto`` with the burn pinned at iterations//2;
    capped at ``max_samples``), so the posterior-mean deviances the
    selection rule compares carry a chosen MC precision; each run's
    metrics.json reports the sampling sweeps it ran. Not with
    ``cuda_resident``.

    Elastic recovery: with out_stub, data and resume (default), a G value
    whose every seed directory is complete on disk and carries this run's
    config fingerprint is skipped and its records are rebuilt from the
    files; a rerun after a crash does only the missing work, and a rerun
    with another config (or ESS regime) recomputes. resume=False always
    recomputes.

    ``mesh``: a ``parallel.Mesh`` over the joined world's ranks (call
    fit_grid on every rank with the same arguments): each G's seeds split
    over its chain axis (len(seeds) a multiple of it), positions over its
    data axis, `device` each rank's by the device rule; the coordinator
    decides elastic resume and writes the run directories. Refused with
    ``cuda_resident`` (single-device) and with ``ess_target`` (ROADMAP
    queue 1 item 15).
    """
    axes = None
    if mesh is not None:
        from .parallel.distributed import mesh_axes, rank_device

        if kernel == "cuda_resident":
            raise ValueError(RESIDENT_SINGLE_DEVICE)
        if ess_target > 0:
            raise ValueError("fit_grid(mesh=...) with ess_target is not ported "
                             "to desman_tpu_torch yet (ROADMAP queue 1 item 15)")
        device = rank_device(device)
        axes = mesh_axes(mesh, device)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    if mesh is None:
        n = torch.as_tensor(np.asarray(counts), device=device).to(torch.float32)
        ks = resolve(kernel, n)
        if ks.resident and ess_target > 0:
            raise ValueError("ess_target needs the segmented converge path; "
                             "use kernel 'cuda' with it")
    coeff = total_coeff_host_f64(counts)
    burn = iterations // 2
    eta = (None if eta_init is None else
           torch.as_tensor(np.asarray(eta_init), dtype=torch.float32, device=device))
    digest = _data_digest(counts, eta_init) if out_stub is not None else None
    if digest is not None and ess_target > 0:
        # the achieved sampling length is data-driven: runs made under
        # another ESS regime must not be reused by elastic resume
        digest = f"{digest}|ess{ess_target:g}x{int(max_samples)}"
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")

    def make_cfg(G: int) -> SamplerConfig:
        return SamplerConfig(
            G=G, burn=burn, samples=iterations - burn,
            kappa_gamma=kappa_gamma, kappa_eta=kappa_eta, fix_eta=fix_eta,
        )

    def done_on_disk(G: int) -> bool:
        if axes is not None:   # the coordinator decides for every rank
            return axes.world.any(axes.world.index == 0 and on_disk(G))
        return on_disk(G)

    def on_disk(G: int) -> bool:
        if not (resume and out_stub is not None and data is not None):
            return False
        cfg = make_cfg(G)
        for s in seeds:
            d = f"{out_stub}_{G}_{int(s)}"
            if not all(os.path.isfile(os.path.join(d, f)) for f in _RUN_FILES):
                return False
            with open(os.path.join(d, "metrics.json")) as f:
                if json.load(f).get("config_fingerprint") != run_fingerprint(
                        digest, cfg, int(s)):
                    return False
        return True

    records: List[RunRecord] = []
    for G in g_values:
        if done_on_disk(G):
            records.extend(scan_run_dirs(
                [f"{out_stub}_{G}_{int(s)}" for s in seeds], unc_threshold))
            continue
        cfg = fp_cfg = make_cfg(G)
        if mesh is not None:
            from .parallel.sharded import run_chains_sharded

            res = run_chains_sharded(counts, cfg, seeds, mesh, eta_init=eta,
                                     kernel=kernel, device=device)
        elif ess_target > 0:
            res, _, samples_used = run_chains_auto(
                n, cfg, seeds, eta_init=eta, max_burn=cfg.burn, kernel=ks,
                ess_target=ess_target, max_samples=max_samples)
            # write_outputs reports the sampling length run; the
            # fingerprint stays on the base config (the regime salts the
            # digest)
            cfg = dataclasses.replace(cfg, samples=samples_used)
        else:
            res = run_chains(n, cfg, seeds, eta_init=eta, kernel=ks)
        trace = res.loglik_trace.cpu().numpy().astype(np.float64)
        uncs = [0.0] * len(seeds)
        if res.tau_mean is not None:
            uncs = [float(snv_uncertainty(res.tau_mean[i].to(device), unc_threshold))
                    for i in range(len(seeds))]
        if axes is not None:   # tau_mean reaches the coordinator alone
            uncs = axes.world.sum(torch.tensor(uncs, dtype=torch.float64,
                                               device=device)).tolist()
        for i, seed in enumerate(seeds):
            # f64 compensated mean over the post-burn trace: the deviance
            # differences this grid compares must not carry f32 sum error
            post = trace[i, burn:]
            mean_ll = (math.fsum(post.tolist()) / post.size if post.size
                       else float(res.mean_loglik[i]))
            mean_dev = deviance_from_loglik(mean_ll, coeff)
            run_dir = None
            if out_stub is not None and data is not None:
                run_dir = f"{out_stub}_{G}_{seed}"
            if run_dir is not None and (axes is None or axes.world.index == 0):
                write_outputs(
                    run_dir, data, chain_result(res, i), cfg,
                    seed=int(seed), extra_metrics={
                        "config_fingerprint": run_fingerprint(digest, fp_cfg,
                                                              int(seed)),
                        "device": device_name, "kernel": kernel})
            records.append(RunRecord(G=G, seed=int(seed), mean_deviance=mean_dev,
                                     uncertainty=uncs[i], run_dir=run_dir))
    if axes is not None:
        axes.world.barrier()   # the coordinator's files are on disk
    return records


def scan_run_dirs(run_dirs: Sequence[str], unc_threshold: float = 0.9) -> List[RunRecord]:
    """Rebuild RunRecords from on-disk output dirs (the reference
    resolvenhap's glob-and-parse path). The seed comes from the run's
    metrics.json when present, else from the trailing ``_<G>_<seed>`` of
    the dir name, else 0; selection itself uses the deviance, not the
    seed."""
    records = []
    for d in run_dirs:
        fit = io.read_fit_txt(os.path.join(d, "fit.txt"))
        tau_mean = io.read_tau_mean_csv(os.path.join(d, "Tau_mean.csv"))
        unc = float(snv_uncertainty(
            torch.as_tensor(tau_mean, dtype=torch.float32), unc_threshold))
        seed = None
        mpath = os.path.join(d, "metrics.json")
        if os.path.isfile(mpath):
            with open(mpath) as f:
                seed = json.load(f).get("seed")
        if seed is None:
            parts = os.path.basename(os.path.normpath(d)).split("_")
            seed = int(parts[-1]) if parts[-1].isdigit() else 0
        records.append(RunRecord(G=fit["G"], seed=int(seed),
                                 mean_deviance=fit["mean_deviance"],
                                 uncertainty=unc, run_dir=d))
    return records


def resolve_nhap(
    records: Sequence[RunRecord],
    dev_cutoff: float = 0.02,
    unc_cutoff: float = 0.1,
    unc_veto_slack: float = 0.2,
) -> SelectionResult:
    """Pick (G, run) from a fitted grid.

    Walk G ascending over the best replicates (by posterior mean deviance
    D) and stop at g when the step to g+1 is not both substantial and
    credible:

    - the improvement (D(g) - D(g+1)) / D(g+1) is below ``dev_cutoff``, or
    - the improvement is marginal (below ``unc_veto_slack``) and g+1's best
      run has mean SNV uncertainty above ``unc_cutoff``: an extra strain
      that lowers the deviance a little by absorbing noise shows up as an
      uncertain posterior. The veto is conditional because an underfit G
      also shows high uncertainty while cutting the deviance by 2x or more
      per added strain.

    Needs converged chains (tempered burn-in and enough iterations).
    """
    if not records:
        raise ValueError("no run records")
    by_g: Dict[int, RunRecord] = {}
    for r in records:
        if r.G not in by_g or r.mean_deviance < by_g[r.G].mean_deviance:
            by_g[r.G] = r
    gs = sorted(by_g)
    chosen = by_g[gs[-1]]
    for i, g in enumerate(gs[:-1]):
        nxt = by_g[gs[i + 1]]
        d_here = by_g[g].mean_deviance
        improvement = (d_here - nxt.mean_deviance) / max(abs(nxt.mean_deviance), 1e-9)
        if improvement < dev_cutoff or (
                improvement < unc_veto_slack
                and nxt.uncertainty > unc_cutoff):
            chosen = by_g[g]
            break
    return SelectionResult(
        G=chosen.G, seed=chosen.seed, uncertainty=chosen.uncertainty,
        mean_deviance=chosen.mean_deviance, records=list(records),
        run_dir=chosen.run_dir,
    )
