"""Single-core numpy reference sampler, the benchmark baseline (the port's
own copy of ``desman_tpu.baseline_numpy``, so that a host without jax can
time it).

The same O(V*G*4*S) per-sweep math as the sampler (tau exact Gibbs, gamma
MH, per-row eta MH), vectorized numpy, standing in for the reference
DESMAN's single-threaded Cython+GSL sweep. Restrict BLAS threads to 1
before import to emulate the reference's single core. Used by tests and
benchmarks, never on the sampler's path.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln

_EYE4 = np.eye(4, dtype=np.float64)


def _safe_log(x):
    return np.log(np.maximum(x, 1e-12))


def sweep(n, tau, gamma, eta, rng):
    """One full Gibbs sweep (tau exact + gamma MH + eta MH), numpy.

    n: [V,S,4] float; tau: [V,G] int; gamma: [S,G]; eta: [4,4].
    Returns (tau, gamma, eta, loglik).
    """
    V, S, _ = n.shape
    G = tau.shape[1]
    onehot = _EYE4[tau]                                   # [V,G,4]
    mix = np.einsum("vga,sg->vsa", onehot, gamma)

    # --- tau update ---
    for g in range(G):
        oh = _EYE4[tau[:, g]]                             # [V,4]
        rest = mix - gamma[None, :, g, None] * oh[:, None, :]
        q = rest @ eta                                    # [V,S,4]
        cand = np.empty((V, 4))
        for c in range(4):
            p = q + gamma[None, :, g, None] * eta[c][None, None, :]
            cand[:, c] = np.einsum("vsb->v", n * _safe_log(p))
        gz = rng.gumbel(size=(V, 4))
        tau[:, g] = np.argmax(cand + gz, axis=1)
        mix = rest + gamma[None, :, g, None] * _EYE4[tau[:, g]][:, None, :]

    # --- gamma MH (per-sample Dirichlet random walk) ---
    kappa = 100.0
    alpha_fwd = kappa * gamma + 0.1
    prop = rng.gamma(alpha_fwd)
    prop = np.maximum(prop, 1e-10)
    prop /= prop.sum(axis=1, keepdims=True)
    onehot = _EYE4[tau]
    mix_prop = np.einsum("vga,sg->vsa", onehot, prop)
    ll_old = np.einsum("vsb->s", n * _safe_log(mix @ eta))
    ll_new = np.einsum("vsb->s", n * _safe_log(mix_prop @ eta))
    def dlogpdf(x, a):
        return ((a - 1) * _safe_log(x)).sum(1) + gammaln(a.sum(1)) - gammaln(a).sum(1)

    alpha_rev = kappa * prop + 0.1
    ratio = ll_new - ll_old + dlogpdf(gamma, alpha_rev) - dlogpdf(prop, alpha_fwd)
    accept = np.log(rng.uniform(size=S)) < ratio
    gamma = np.where(accept[:, None], prop, gamma)
    mix = np.where(accept[None, :, None], mix_prop, mix)

    # --- eta MH (per-row) ---
    kappa_e = 1000.0
    loglik = np.sum(n * _safe_log(mix @ eta))
    for a in range(4):
        af = kappa_e * eta[a] + 0.1
        row = rng.gamma(af)
        row = np.maximum(row, 1e-10)
        row /= row.sum()
        eta_prop = eta.copy()
        eta_prop[a] = row
        ll_new_s = np.sum(n * _safe_log(mix @ eta_prop))
        ar = kappa_e * row + 0.1
        r = (ll_new_s - loglik
             + dlogpdf(eta[a][None], ar[None])[0]
             - dlogpdf(row[None], af[None])[0])
        if np.log(rng.uniform()) < r:
            eta = eta_prop
            loglik = ll_new_s

    return tau, gamma, eta, loglik


def run(n, G, sweeps, seed=0):
    """Run `sweeps` sweeps from a random init; returns final state + loglik."""
    rng = np.random.default_rng(seed)
    V, S, _ = n.shape
    tau = rng.integers(0, 4, size=(V, G))
    gamma = rng.dirichlet(np.ones(G), size=S)
    eta = np.full((4, 4), 0.01 / 3) + np.eye(4) * (0.99 - 0.01 / 3)
    ll = None
    for _ in range(sweeps):
        tau, gamma, eta, ll = sweep(n, tau, gamma, eta, rng)
    return tau, gamma, eta, ll
