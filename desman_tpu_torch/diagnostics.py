"""MCMC convergence diagnostics on host numpy (counterpart of
``desman_tpu.diagnostics``): split-R-hat and bulk effective sample size over
post-burn scalar traces, replicate agreement of tau-stars, and per-parameter
ESS of stored draws.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .utils import snp_distance_perm


def split_rhat(chains: np.ndarray) -> float:
    """Split-R-hat over [n_chains, n_draws] scalar traces.

    Values near 1 indicate the chains mixed; > ~1.05 is suspect.
    """
    x = np.asarray(chains, dtype=np.float64)
    m, n = x.shape
    if n < 4:
        return float("nan")
    half = n // 2
    halves = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    M, N = halves.shape
    means = halves.mean(axis=1)
    B = N * means.var(ddof=1)
    W = halves.var(axis=1, ddof=1).mean()
    if W <= 0:
        return 1.0
    var_hat = (N - 1) / N * W + B / N
    return float(np.sqrt(var_hat / W))


def ess_bulk(chains: np.ndarray, max_lag: int = 200) -> float:
    """Bulk effective sample size via Geyer's initial positive sequence."""
    x = np.asarray(chains, dtype=np.float64)
    m, n = x.shape
    if n < 4:
        return float("nan")
    x = x - x.mean(axis=1, keepdims=True)
    denom = (x * x).sum(axis=1).mean()
    if denom == 0:
        return float(m * n)
    max_lag = min(max_lag, n - 1)
    rho = []
    for k in range(1, max_lag + 1):
        acov = (x[:, :-k] * x[:, k:]).sum(axis=1).mean() / n
        rho.append(acov / (denom / n))
    # sum consecutive pairs while positive
    tau = 1.0
    for k in range(0, len(rho) - 1, 2):
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        tau += 2 * pair
    return float(m * n / tau)


def replicate_agreement(tau_stars: Sequence[np.ndarray]) -> np.ndarray:
    """Pairwise permutation-matched SNP distances between replicate
    tau-stars [V,G] (the reference's taucomp.py check). Returns [R,R]."""
    R = len(tau_stars)
    out = np.zeros((R, R), dtype=np.int64)
    for i in range(R):
        for j in range(i + 1, R):
            d = snp_distance_perm(np.asarray(tau_stars[i]), np.asarray(tau_stars[j]))
            out[i, j] = out[j, i] = d
    return out


def draws_diagnostics(draws: dict) -> dict:
    """Min/median bulk-ESS over the gamma entries and min over the eta
    entries of stored draws (gamma [n,S,G], eta [n,4,4])."""
    gamma = np.asarray(draws["gamma"], np.float64)
    eta = np.asarray(draws["eta"], np.float64)
    n = gamma.shape[0]
    g_ess = np.array([ess_bulk(x[None, :]) for x in gamma.reshape(n, -1).T])
    e_ess = np.array([ess_bulk(x[None, :]) for x in eta.reshape(n, -1).T])
    return {
        "n_draws": int(n),
        "gamma_ess_min": float(np.nanmin(g_ess)) if g_ess.size else float("nan"),
        "gamma_ess_median": float(np.nanmedian(g_ess)) if g_ess.size else float("nan"),
        "eta_ess_min": float(np.nanmin(e_ess)) if e_ess.size else float("nan"),
    }
