"""A plain Gibbs sampler of the DESMAN model, in a precision the caller
names: the reference that the chain cells' control puts in the program's
place.

The model: counts n[v,s,b] ~ Multinomial over p[v,s,:] = M[v,s,:] @ eta,
M[v,s,a] = sum_g gamma[s,g] [tau[v,g] = a]; tau uniform, gamma rows
Dirichlet(1), eta rows Dirichlet(10 on the diagonal, 1 off it). A chain
starts from a rank-G KL-NMF of the base frequencies (300 multiplicative
updates), then each sweep draws tau strain by strain from its full
conditional (tempered from T=3 down to 1 over the first half of burn-in),
each sample's gamma row by a Dirichlet random-walk Metropolis-Hastings step,
and eta by one joint Dirichlet step; the proposal concentrations adapt
during burn-in towards an acceptance of 0.3. The star is the state of the
highest loglik. It has no swap move: that is a mixing move, and the target
is the same without it.

Every tensor of the arithmetic is in the precision ``prec``
(``reference.Precision``; the random draws are made in float32 and cast),
and so is every matrix product. Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch

from .reference import Precision

NBASES = 4
FLOOR = 1e-12
ANNEAL_T0, ANNEAL_FRAC = 3.0, 0.5
TARGET, RATE, PROPOSAL_FLOOR = 0.3, 0.15, 0.1
PRIOR_DIAG, PRIOR_OFF = 10.0, 1.0
NMF_ITERS, EPS = 300, 1e-9


def _log(x):
    return torch.log(torch.clamp_min(x, FLOOR))


def _mixture(tau, gamma, prec: Precision):
    """M [V,S,4] from tau [V,G] and gamma [S,G]."""
    onehot = torch.nn.functional.one_hot(tau.long(), NBASES).to(gamma.dtype)
    return prec.einsum("vga,sg->vsa", onehot, gamma)


def _nmf(n, G: int, gen, prec: Precision):
    """(tau, gamma) from a rank-G KL-NMF of the base frequencies."""
    V, S, _ = n.shape
    dtype, mm = prec.dtype, prec.mm
    freq = n / torch.clamp_min(n.sum(2, keepdim=True), 1.0)
    F = freq.permute(0, 2, 1).reshape(V * NBASES, S)
    W = (0.1 + 0.9 * torch.rand((V * NBASES, G), generator=gen, device=n.device)).to(dtype)
    H = (0.1 + 0.9 * torch.rand((G, S), generator=gen, device=n.device)).to(dtype)
    for _ in range(NMF_ITERS):
        WH = torch.clamp_min(mm(W, H), EPS)
        H = H * mm(W.T, F / WH) / torch.clamp_min(W.sum(0)[:, None], EPS)
        WH = torch.clamp_min(mm(W, H), EPS)
        W = W * mm(F / WH, H.T) / torch.clamp_min(H.sum(1)[None, :], EPS)
    tau = W.reshape(V, NBASES, G).argmax(1)
    gamma = H.T / torch.clamp_min(H.T.sum(1, keepdim=True), EPS)
    return tau, gamma


def _dirichlet(alpha, gen):
    """Dirichlet rows of concentration alpha, drawn in float32."""
    g = torch._standard_gamma(alpha.float(), generator=gen)
    g = torch.clamp_min(g, 1e-30)
    return (g / g.sum(-1, keepdim=True)).to(alpha.dtype)


def _log_dirichlet(x, alpha):
    """log Dirichlet density of each row of x."""
    return (torch.lgamma(alpha.sum(-1)) - torch.lgamma(alpha).sum(-1)
            + ((alpha - 1.0) * _log(x)).sum(-1))


def _per_sample_ll(n, mix, eta, prec: Precision):
    """[S] sum over positions and bases of n log p."""
    return (n * _log(prec.mm(mix, eta))).sum((0, 2))


def chain(counts, G: int, burn: int, samples: int, seed: int, prec: Precision, device):
    """One chain; returns (tau*, gamma*, eta*, loglik*) as numpy arrays and
    a float: the star state and its loglik as this sampler computed it."""
    dev, dtype, mm = torch.device(device), prec.dtype, prec.mm
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = torch.as_tensor(counts, device=dev).to(dtype)
    V, S, _ = n.shape
    tau, gamma = _nmf(n, G, gen, prec)
    eta = torch.full((NBASES, NBASES), 0.01 / 3, dtype=torch.float64)
    eta.fill_diagonal_(0.99)
    eta = eta.to(dev, dtype)
    prior = torch.full((NBASES, NBASES), PRIOR_OFF, dtype=dtype, device=dev)
    prior.fill_diagonal_(PRIOR_DIAG)
    total = float(counts.sum())
    k_gamma, k_eta = max(total / S / 32.0, 100.0), max(total, 1000.0)
    mix = _mixture(tau, gamma, prec)
    anneal = max(int(burn * ANNEAL_FRAC), 1)
    star = (-math.inf, None)
    for it in range(burn + samples):
        temp = max(1.0, ANNEAL_T0 ** (1.0 - it / anneal)) if burn else 1.0
        # tau: each strain in turn from its full conditional
        for g in range(G):
            old = torch.nn.functional.one_hot(tau[:, g].long(), NBASES).to(dtype)
            base = mix - gamma[None, :, g, None] * old[:, None, :]
            logp = torch.stack([
                (n * _log(mm(base + gamma[None, :, g, None]
                             * torch.eye(NBASES, dtype=dtype, device=dev)[a], eta))
                 ).sum((1, 2))
                for a in range(NBASES)], 1)                             # [V,4]
            u = torch.rand((V, NBASES), generator=gen, device=dev)
            gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0)))
            tau[:, g] = torch.argmax(logp.float() / temp + gumbel, 1)
            new = torch.nn.functional.one_hot(tau[:, g].long(), NBASES).to(dtype)
            mix = base + gamma[None, :, g, None] * new[:, None, :]
        # gamma: per-sample Dirichlet random walk
        a_fwd = k_gamma * gamma + PROPOSAL_FLOOR
        prop = _dirichlet(a_fwd, gen)
        a_rev = k_gamma * prop + PROPOSAL_FLOOR
        mix_prop = _mixture(tau, prop, prec)
        ll_old = _per_sample_ll(n, mix, eta, prec)
        ll_new = _per_sample_ll(n, mix_prop, eta, prec)
        log_ratio = (ll_new - ll_old + _log_dirichlet(gamma, a_rev)
                     - _log_dirichlet(prop, a_fwd))
        accept = _log(torch.rand((S,), generator=gen, device=dev).to(dtype)) < log_ratio
        gamma = torch.where(accept[:, None], prop, gamma)
        mix = torch.where(accept[None, :, None], mix_prop, mix)
        loglik = torch.where(accept, ll_new, ll_old).sum()
        acc_g = float(accept.float().mean())
        # eta: one joint Dirichlet step
        a_fwd = k_eta * eta + PROPOSAL_FLOOR
        prop = _dirichlet(a_fwd, gen)
        a_rev = k_eta * prop + PROPOSAL_FLOOR
        ll_prop = (n * _log(mm(mix, prop))).sum()
        log_ratio = (ll_prop - loglik + ((prior - 1.0) * (_log(prop) - _log(eta))).sum()
                     + _log_dirichlet(eta, a_rev).sum() - _log_dirichlet(prop, a_fwd).sum())
        acc_e = float(_log(torch.rand((), generator=gen, device=dev).to(dtype)) < log_ratio)
        if acc_e:
            eta, loglik = prop, ll_prop
        if it < burn:
            k_gamma = min(max(k_gamma * math.exp(RATE * (TARGET - acc_g)), 10.0), 1e9)
            k_eta = min(max(k_eta * math.exp(RATE * (TARGET - acc_e)), 10.0), 1e10)
        ll = float(loglik)
        if ll > star[0]:
            star = (ll, (tau.clone(), gamma.clone(), eta.clone()))
    t, gm, e = star[1]
    return (t.cpu().numpy().astype("int32"), gm.double().cpu().numpy(),
            e.double().cpu().numpy(), star[0])
