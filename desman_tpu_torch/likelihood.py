"""The DESMAN generative model's likelihood, as f32 tensor ops.

Model:

    p[v,s,b] = sum_a ( sum_g tau[v,g,a] * gamma[s,g] ) * eta[a,b]
    n[v,s,:] ~ Multinomial(N[v,s], p[v,s,:])
    logL     = sum_vs [ logMultinomCoeff(n[v,s,:]) + sum_b n[v,s,b] log p[v,s,b] ]
    D        = -2 logL

The device functions run in f32 on whatever device their tensors are on;
the host f64 functions are the ones the deviances in fit.txt go through.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import log_multinomial_coeff, safe_log


def mixture(tau_onehot: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """M[v,s,a] = sum_g gamma[s,g] * tau[v,g,a] — the true-base mixture
    (contiguous [V,S,4], the layout the kernels take)."""
    return torch.einsum("vga,sg->vsa", tau_onehot, gamma).contiguous()


def probs(tau_onehot: torch.Tensor, gamma: torch.Tensor,
          eta: torch.Tensor) -> torch.Tensor:
    """p[v,s,b] = (M @ eta)[v,s,b]."""
    return torch.einsum("vsa,ab->vsb", mixture(tau_onehot, gamma), eta)


def log_likelihood(
    n: torch.Tensor, tau_onehot: torch.Tensor, gamma: torch.Tensor,
    eta: torch.Tensor, include_coeff: bool = True,
) -> torch.Tensor:
    """Full-data multinomial log-likelihood (0-d tensor)."""
    ll = torch.sum(n * safe_log(probs(tau_onehot, gamma, eta)))
    if include_coeff:
        ll = ll + torch.sum(log_multinomial_coeff(n, dim=-1))
    return ll


def per_sample_loglik(
    n: torch.Tensor, tau_onehot: torch.Tensor, gamma: torch.Tensor,
    eta: torch.Tensor,
) -> torch.Tensor:
    """logL decomposed per sample [S] (no coeff) — the gamma-MH target."""
    return torch.sum(n * safe_log(probs(tau_onehot, gamma, eta)), dim=(0, 2))


def log_likelihood_host_f64(
    counts, tau_idx, gamma, eta, include_coeff: bool = True
) -> float:
    """Exact float64 log-likelihood on host numpy (same math as the device
    f32 path, including the 1e-12 probability floor). Cost: one O(V*S*16)
    numpy pass per finished run — not a hot path.
    """
    n = np.asarray(counts, np.float64)
    tau_idx = np.asarray(tau_idx)
    gamma = np.asarray(gamma, np.float64)
    eta = np.asarray(eta, np.float64)
    onehot = np.eye(4, dtype=np.float64)[tau_idx]          # [V,G,4]
    mix = np.einsum("vga,sg->vsa", onehot, gamma)
    p = mix @ eta                                          # [V,S,4]
    ll = float(np.sum(n * np.log(np.maximum(p, 1e-12))))
    if include_coeff:
        ll += total_coeff_host_f64(n)
    return ll


def total_coeff_host_f64(counts) -> float:
    """Multinomial-coefficient term of logL in float64 on host."""
    from scipy.special import gammaln

    n = np.asarray(counts, np.float64)
    return float(
        np.sum(gammaln(n.sum(axis=-1) + 1.0)) - np.sum(gammaln(n + 1.0))
    )


def deviance_from_loglik(loglik: float, coeff: float) -> float:
    return -2.0 * (loglik + coeff)


def snv_uncertainty(tau_mean: torch.Tensor, threshold: float = 0.9) -> torch.Tensor:
    """Fraction of (position, strain) posterior base calls below `threshold`
    (0-d f32): a call is uncertain when its posterior mode probability is
    below the threshold. Model selection pairs this with the posterior mean
    deviance."""
    conf = torch.amax(tau_mean, dim=-1)                     # [V,G]
    return torch.mean((conf < threshold).to(torch.float32))
