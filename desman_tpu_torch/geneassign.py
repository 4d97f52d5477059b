"""Accessory-gene assignment in PyTorch (counterpart of
``desman_tpu.geneassign``).

Gene d's mean coverage across samples is modelled as

    x[d,s] ~ noise( mu[d,s] ),   mu[d,s] = sum_g etaG[d,g] * cov[g,s]

where cov[g,s] = gamma[s,g] * total_cov[s] is strain g's absolute coverage
in sample s, and etaG[d,g] in {0..max_copy} is gene d's copy number in
strain g. With (max_copy+1)^G <= state_cap every copy-number state is
enumerated exactly (one [K,S] mu shared by every gene, one [D,K] loglik
matmul, an argmax and a softmax); above it, annealed Gibbs over strains
runs for all genes and restarts at once, as one batched [D,R] state.

``assign_gene_tau`` (the ``--assign_tau`` mode) assigns gene-level SNVs to
strains with gamma and eta frozen: exact enumeration of the 4^G joint
bases for 4^G <= state_cap, else annealed tau sweeps through the tau
kernel (``ops.tau_sweep``).

Products run in f32 with TF32 off (importing ``utils`` turns it off), as
the JAX package's ``heinsum`` contract asks. ``argmax`` takes the first
maximum, and states come in ``itertools.product`` order (the last strain
varies fastest), so ties resolve as in the JAX package.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .likelihood import mixture
from .ops import resolve
from .utils import NBASES, one_hot_tau, safe_log

_MU_FLOOR = 1e-6


@dataclass(frozen=True)
class GeneAssignConfig:
    max_copy: int = 1            # max gene copies per strain (1 = presence/absence)
    model: str = "quasipoisson"  # or "gaussian"
    phi: float = 1.0             # quasi-Poisson dispersion / Gaussian sigma^2 scale
    state_cap: int = 4096        # enumeration limit; above this use Gibbs
    gibbs_sweeps: int = 100
    gibbs_restarts: int = 4      # independent annealed chains per gene (best-of)
    min_strain_cov: float = 0.0  # strains below this total coverage can't carry genes


class GeneAssignResult(NamedTuple):
    eta_star: torch.Tensor        # [D,G] int32 MAP copy numbers
    presence_prob: torch.Tensor   # [D,G] posterior P(etaG >= 1)
    copy_post_mean: torch.Tensor  # [D,G] posterior mean copy number
    loglik: torch.Tensor          # [D] MAP state log-likelihood
    confidence: torch.Tensor      # [D] posterior prob of the MAP state


def strain_coverage(gamma: np.ndarray, sample_cov: np.ndarray) -> np.ndarray:
    """cov[g,s] = gamma[s,g] * total_cov[s]: strain absolute coverage."""
    return (np.asarray(gamma) * np.asarray(sample_cov)[:, None]).T


def sample_total_coverage(counts: np.ndarray) -> np.ndarray:
    """Per-sample mean coverage over the core variant positions [S]."""
    return np.asarray(counts).sum(axis=2).mean(axis=0)


def _states(G: int, max_copy: int) -> np.ndarray:
    """All copy-number states [(max_copy+1)^G, G], the last strain varying
    fastest."""
    return np.array(
        list(itertools.product(range(max_copy + 1), repeat=G)), dtype=np.float32
    )


def _state_loglik(x, mu, model: str, phi: float):
    """ll[d,k] = sum_s log p(x[d,s] | mu[k,s]). x: [D,S], mu: [K,S]."""
    mu = torch.clamp_min(mu, _MU_FLOOR)
    if model == "quasipoisson":
        # x log mu - mu, scaled by dispersion phi (constants drop out)
        return (x @ safe_log(mu).T - mu.sum(dim=1)[None, :]) / phi
    if model == "gaussian":
        # -(x-mu)^2 / (2 phi) summed over s
        x2 = (x * x).sum(dim=1)[:, None]
        m2 = (mu * mu).sum(dim=1)[None, :]
        return -(x2 - 2.0 * (x @ mu.T) + m2) / (2.0 * phi)
    raise ValueError(f"unknown model {model!r}")


def _enumerate_assign(x, cov, states, model: str, phi: float) -> GeneAssignResult:
    mu = states @ cov                                      # [K,S]
    ll = _state_loglik(x, mu, model, phi)                  # [D,K]
    best = torch.argmax(ll, dim=1)                         # [D]
    post = torch.softmax(ll, dim=1)                        # [D,K] uniform prior
    return GeneAssignResult(
        eta_star=states[best].to(torch.int32),
        presence_prob=post @ (states >= 1.0).to(torch.float32),
        copy_post_mean=post @ states,
        loglik=ll.gather(1, best[:, None])[:, 0],
        confidence=post.gather(1, best[:, None])[:, 0],
    )


def assign_genes(
    gene_cov: np.ndarray,
    cov: np.ndarray,
    cfg: GeneAssignConfig = GeneAssignConfig(),
    generator: Optional[torch.Generator] = None,
    device="cpu",
) -> GeneAssignResult:
    """Assign genes to strains on `device`. gene_cov: [D,S]; cov: [G,S]
    strain coverage. The Gibbs path draws from `generator` (default: one
    seeded with 0 on `device`)."""
    device = torch.device(device)
    G = cov.shape[0]
    K = (cfg.max_copy + 1) ** G
    x = torch.as_tensor(np.asarray(gene_cov), device=device).to(torch.float32)
    c = torch.as_tensor(np.asarray(cov), device=device).to(torch.float32)
    if K <= cfg.state_cap:
        states = torch.as_tensor(_states(G, cfg.max_copy), device=device)
        return _enumerate_assign(x, c, states, cfg.model, cfg.phi)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return _gibbs_assign(x, c, cfg, generator)


def _gene_ll(x, mu, cfg: GeneAssignConfig):
    """Per-gene loglik over the last (sample) axis; x broadcasts to mu."""
    mu = torch.clamp_min(mu, _MU_FLOOR)
    if cfg.model == "quasipoisson":
        return ((x * safe_log(mu)).sum(dim=-1) - mu.sum(dim=-1)) / cfg.phi
    return -((x - mu) ** 2).sum(dim=-1) / (2.0 * cfg.phi)


def _gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _anneal_temp(it: int, anneal: int) -> float:
    """max(1, 30^(1 - it/anneal)) in f32, as the JAX package computes it."""
    t = np.float32(30.0) ** (np.float32(1.0) - np.float32(it) / np.float32(anneal))
    return max(1.0, float(t))


def _strain_candidates(mu, eta_g, cov_g, copies):
    """Strain g removed from mu and each candidate copy number put back:
    (base [..., S], cand_mu [..., C, S])."""
    base = mu - eta_g[..., None] * cov_g
    return base, base[..., None, :] + copies[:, None] * cov_g


def _gibbs_assign(x, cov, cfg: GeneAssignConfig,
                  generator: torch.Generator) -> GeneAssignResult:
    """Annealed Gibbs over strain copy numbers for large G.

    Every gene and every one of the R restarts is one row of a batched
    [D,R] state: a sweep visits the strains in turn and draws each one's
    copy number from its full conditional over the C candidates
    (Gumbel-argmax at the anneal temperature), all rows at once. The best
    state by loglik of each row is kept, and the second half of the sweeps
    gives the copy-number mean. Best of R by loglik wins, as in the JAX
    package (a single chain freezes into a local optimum on a few percent
    of genes at G=14).
    """
    D, S = x.shape
    G = cov.shape[0]
    C = cfg.max_copy + 1
    R = max(int(cfg.gibbs_restarts), 1)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    copies = torch.arange(C, **f32)                               # [C]
    xr = x[:, None, :]                                            # [D,1,S]

    eta = torch.zeros((D, R, G), **f32)
    mu = torch.zeros((D, R, S), **f32)
    acc = torch.zeros((D, R, G), **f32)
    best_ll = torch.full((D, R), -float("inf"), **f32)
    best_eta = torch.zeros((D, R, G), **f32)
    anneal = max(cfg.gibbs_sweeps // 2, 1)
    half = cfg.gibbs_sweeps // 2
    for it in range(cfg.gibbs_sweeps):
        # annealed tempering: escape the local optima a cold-started,
        # near-deterministic Gibbs freezes into
        temp = _anneal_temp(it, anneal)
        for g in range(G):
            base, cand_mu = _strain_candidates(mu, eta[:, :, g], cov[g], copies)
            cand_ll = _gene_ll(xr[:, :, None, :], cand_mu, cfg)   # [D,R,C]
            gz = _gumbel(generator, (D, R, C))
            new = torch.argmax(cand_ll + temp * gz, dim=-1).to(torch.float32)
            eta[:, :, g] = new
            mu = base + new[..., None] * cov[g]
        ll = _gene_ll(xr, mu, cfg)                                # [D,R]
        better = ll > best_ll
        best_ll = torch.where(better, ll, best_ll)
        best_eta = torch.where(better[..., None], eta, best_eta)
        if it >= half:
            acc += eta

    best_r = torch.argmax(best_ll, dim=1)                         # [D]
    rows = torch.arange(D, device=dev)
    eta_star = best_eta[rows, best_r].to(torch.int32)             # [D,G]
    copy_mean = acc[rows, best_r] / (cfg.gibbs_sweeps - half)
    ll = best_ll[rows, best_r]

    # Confidence by local enumeration around the MAP: the product over
    # strains of the full-conditional probability of the MAP value given
    # the other MAP coordinates (a Rao-Blackwellised pseudo-posterior; exact
    # when the posterior factorizes).
    eta_f = eta_star.to(torch.float32)
    mu_star = eta_f @ cov                                         # [D,S]
    conf = torch.ones(D, **f32)
    for g in range(G):
        _, cand_mu = _strain_candidates(mu_star, eta_f[:, g], cov[g], copies)
        p = torch.softmax(_gene_ll(x[:, None, :], cand_mu, cfg), dim=-1)  # [D,C]
        conf = conf * p.gather(1, eta_star[:, g:g + 1].long())[:, 0]
    return GeneAssignResult(eta_star, torch.clamp(copy_mean, 0.0, 1.0),
                            copy_mean, ll, conf)


def assign_gene_tau(
    counts: np.ndarray,
    gamma: np.ndarray,
    eta: np.ndarray,
    sweeps: int = 50,
    seed: int = 0,
    state_cap: int = 4096,
    device="cpu",
    kernel: str = "cuda",
    noise=None,
):
    """Assign gene-level SNVs to strains with gamma/eta frozen (the
    ``--assign_tau`` mode). Returns (tau_star [V,G] int32, tau_mean
    [V,G,4]) on `device`.

    With gamma and eta fixed the positions are independent, so for
    4^G <= state_cap the 4^G joint base assignments are enumerated exactly
    (ll is a [V, 4^G] f32 matrix; the [V,K,S,4] terms are never formed).
    Larger G runs `sweeps` annealed tau sweeps from the plurality base:
    through the tau kernel with kernel="cuda" (its plain version on a CPU
    device), through the plain version with kernel="torch". Each sweep's
    Gumbel noise comes from `noise.gumbel(it, V, G)` (default: a generator
    on `device` seeded with `seed`) times the temperature
    max(1, 30^(1 - it/max(sweeps//2, 1))); the second half's one-hot taus
    are averaged into tau_mean.
    """
    if kernel not in ("cuda", "torch"):
        raise ValueError(f"assign_gene_tau: kernel {kernel!r}; one of cuda, torch")
    device = torch.device(device)
    n = torch.as_tensor(np.asarray(counts), device=device).to(torch.float32)
    gam = torch.as_tensor(np.asarray(gamma), device=device).to(torch.float32)
    et = torch.as_tensor(np.asarray(eta), device=device).to(torch.float32)
    V, S, _ = n.shape
    G = gam.shape[1]

    if NBASES ** G <= state_cap:
        st = torch.as_tensor(
            np.array(list(itertools.product(range(NBASES), repeat=G)),
                     dtype=np.int32), device=device)                 # [K,G]
        K = st.shape[0]
        oh = one_hot_tau(st)                                          # [K,G,4]
        p = torch.einsum("kga,sg->ksa", oh, gam) @ et                 # [K,S,4]
        ll = n.reshape(V, S * NBASES) @ safe_log(p).reshape(K, S * NBASES).T
        best = torch.argmax(ll, dim=1)                                # [V]
        post = torch.softmax(ll, dim=1)                               # [V,K]
        tau_mean = (post @ oh.reshape(K, G * NBASES)).reshape(V, G, NBASES)
        return st[best], tau_mean

    if noise is None:
        from .sampler import TorchNoise

        noise = TorchNoise(torch.Generator(device=device).manual_seed(seed))
    tau_sweep = resolve(kernel).tau_sweep
    # plurality-base start + annealed tempering: with gamma/eta frozen the
    # per-site conditionals are near-deterministic, so cold-started Gibbs
    # freezes into poor local optima; annealing T -> 1 recovers the MAP
    plurality = torch.argmax(n.sum(dim=1), dim=-1).to(torch.int32)   # [V]
    tau = plurality[:, None].repeat(1, G).contiguous()
    mix = mixture(one_hot_tau(tau), gam).contiguous()
    anneal = max(sweeps // 2, 1)
    acc = torch.zeros((V, G, NBASES), dtype=torch.float32, device=device)
    for it in range(sweeps):
        gz = noise.gumbel(it, V, G)
        temp = _anneal_temp(it, anneal)
        if temp != 1.0:
            gz = gz * temp
        tau, mix = tau_sweep(n, tau, mix, gam, et, gz.contiguous())
        if it >= sweeps // 2:
            acc += one_hot_tau(tau)
    tau_mean = acc / (sweeps - sweeps // 2)
    return torch.argmax(tau_mean, dim=-1).to(torch.int32), tau_mean
