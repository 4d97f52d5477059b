"""The plain reference that decides ``correct``: the model's log-likelihood,
the variant filter and GeneAssign's enumeration, written from the DESMAN
model in plain PyTorch, each in a precision (``Precision``) the caller
names.

float64 is the reference. The control of ``control.py`` runs the same
functions in the precision below the one a configuration states
(``control_precision``: TF32 below the float32 the configurations state,
which the harness runs with TF32 off) and puts what they give in the
program's place. Nothing here imports the program, JAX or the JAX package,
and nothing takes what the program made: the judge hands in the
benchmark's own inputs and, only to be judged, the program's answers.
"""
from __future__ import annotations

import numpy as np
import torch

NBASES = 4
LOG_FLOOR = 1e-12      # the model's floor inside every log
ROWS = 8192            # positions a block: the float64 [rows, S, 4] temporaries


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away from
    zero), as a tensor core reads a matrix product's operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Precision:
    """A precision the reference computes in: a torch dtype by name, or
    ``tf32``: float32 whose matrix products take their operands rounded to
    TF32 and sum in float32, as with TF32 on, alike on every device."""

    def __init__(self, name: str):
        self.name, self.tf32 = name, name == "tf32"
        self.dtype = torch.float32 if self.tf32 else getattr(torch, name)

    def _r(self, x):
        return _to_tf32(x) if self.tf32 else x

    def mm(self, a, b):
        return self._r(a) @ self._r(b)

    def einsum(self, eq: str, *xs):
        return torch.einsum(eq, *map(self._r, xs))

    def __repr__(self):
        return self.name


F64 = Precision("float64")
# the nearest precision below a configuration's stated one
BELOW = {"float64": "float32", "float32": "tf32"}


def control_precision(stated: str) -> Precision:
    return Precision(BELOW[stated])


def _log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp_min(x, LOG_FLOOR))


def loglik(counts, tau, gamma, eta, prec: Precision = F64, device="cpu") -> float:
    """sum_{v,s,b} n[v,s,b] log((M @ eta)[v,s,b]), M[v,s,a] = sum_g
    gamma[s,g] [tau[v,g] = a], without the multinomial coefficient, in
    `prec`, in blocks of ROWS positions. counts [V,S,4], tau [V,G] ints,
    gamma [S,G], eta [4,4]."""
    dev, dtype = torch.device(device), prec.dtype
    gam = torch.as_tensor(np.asarray(gamma, np.float64), device=dev).to(dtype)
    et = torch.as_tensor(np.asarray(eta, np.float64), device=dev).to(dtype)
    counts = np.asarray(counts)
    tau = np.asarray(tau).astype(np.int64)
    total = torch.zeros((), dtype=dtype, device=dev)
    for lo in range(0, counts.shape[0], ROWS):
        n = torch.as_tensor(counts[lo:lo + ROWS], device=dev).to(dtype)
        t = torch.as_tensor(tau[lo:lo + ROWS], device=dev)
        onehot = torch.nn.functional.one_hot(t, NBASES).to(dtype)       # [v,G,4]
        mix = prec.einsum("vga,sg->vsa", onehot, gam)
        total = total + torch.sum(n * _log(prec.mm(mix, et)))
    return float(total)


def coeff(counts) -> float:
    """The multinomial coefficients' term, sum log(N_vs! / prod_b n_vsb!),
    in float64."""
    from scipy.special import gammaln

    n = np.asarray(counts, np.float64)
    return float(np.sum(gammaln(n.sum(axis=-1) + 1.0)) - np.sum(gammaln(n + 1.0)))


# ------------------------------------------------------------ the filter

def _eta0(error_rate: float, dtype) -> torch.Tensor:
    eta = torch.full((NBASES, NBASES), error_rate / (NBASES - 1), dtype=torch.float64)
    eta.fill_diagonal_(1.0 - error_rate)
    return eta.to(dtype)


def _pair_loglik(c, pa, pc, em_iters: int):
    """The best two-base mixture of each base pair by a fixed number of EM
    iterations on the fraction x: c [V,4], pa, pc [P,4] -> [P,V]."""
    pa, pc = pa[:, None, :], pc[:, None, :]
    N = torch.clamp_min(c.sum(-1), 1.0)
    x = torch.full((pa.shape[0],) + N.shape, 0.5, dtype=c.dtype)
    for _ in range(em_iters):
        mix = x[..., None] * pa + (1.0 - x[..., None]) * pc
        r = x[..., None] * pa / torch.clamp_min(mix, LOG_FLOOR)
        x = torch.clamp(torch.sum(c * r, -1) / N, 1e-6, 1.0 - 1e-6)
    mix = x[..., None] * pa + (1.0 - x[..., None]) * pc
    return torch.sum(c * _log(mix), -1)


def _chi2_sf_1(llr: torch.Tensor) -> np.ndarray:
    """The chi-square tail with one degree of freedom, in float64."""
    from scipy.special import gammaincc

    return gammaincc(0.5, np.asarray(llr.double()) / 2.0)


def filter_variants(counts, cfg: dict, prec: Precision = F64):
    """The DESMAN variant filter on counts pooled over samples: per position
    the likelihood-ratio of the best two-base mixture (6 base pairs) against
    the best single base under the error matrix eta, its chi-square(1) tail,
    eta re-estimated from the positions that look like one base (p above
    p_consistent) until it moves by less than eta_tol, and Benjamini-Hochberg
    q-values over the positions of enough coverage.

    Returns (eta [4,4], pvalues [V], selected [V] bool), all numpy float64 /
    bool; the statistics in `prec` (the tail and the FDR in float64)."""
    dtype = prec.dtype
    counts = np.asarray(counts)
    c = torch.as_tensor(counts.sum(axis=1), dtype=torch.float64).to(dtype)   # [V,4]
    cov_ok = counts.sum(axis=(1, 2)) >= cfg["min_coverage"]
    pairs = [(a, b) for a in range(NBASES) for b in range(a + 1, NBASES)]
    ia = torch.tensor([p[0] for p in pairs])
    ib = torch.tensor([p[1] for p in pairs])
    eta = _eta0(cfg["init_error_rate"], dtype)
    pvals = None
    for _ in range(cfg["max_outer_iters"]):
        ll_single = prec.mm(c, _log(eta).T)                                 # [V,4]
        ll0, base0 = torch.amax(ll_single, 1), torch.argmax(ll_single, 1)
        ll1 = torch.amax(_pair_loglik(c, eta[ia], eta[ib], cfg["em_iters"]), 0)
        llr = torch.clamp_min(2.0 * (ll1 - ll0), 0.0)
        pvals = _chi2_sf_1(llr)
        consistent = torch.as_tensor((pvals > cfg["p_consistent"]) & cov_ok)
        w = consistent.to(dtype)[:, None] * c
        onehot = torch.nn.functional.one_hot(base0, NBASES).to(dtype)
        rows = prec.mm(onehot.T, w) + torch.eye(NBASES, dtype=dtype)
        eta_new = rows / rows.sum(1, keepdim=True)
        delta = float(torch.max(torch.abs(eta_new - eta)))
        eta = eta_new
        if delta < cfg["eta_tol"]:
            break
    pvals = np.where(cov_ok, pvals, 1.0)
    return eta.double().numpy(), pvals, select(pvals, counts, cfg)


def select(pvals, counts, cfg: dict) -> np.ndarray:
    """The filter's selection from p-values [V]: the positions of enough
    coverage whose Benjamini-Hochberg q-value (float64) is under the cut."""
    cov_ok = np.asarray(counts).sum(axis=(1, 2)) >= cfg["min_coverage"]
    pvals = np.where(cov_ok, np.asarray(pvals, np.float64), 1.0)
    return (bh_qvalues(pvals) < cfg["q_cutoff"]) & cov_ok


def bh_qvalues(p: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg q-values, float64."""
    p = np.asarray(p, np.float64)
    order = np.argsort(p, kind="stable")
    ranked = p[order] * p.size / (np.arange(p.size) + 1.0)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    q = np.empty_like(ranked)
    q[order] = np.clip(ranked, 0.0, 1.0)
    return q


# ------------------------------------------------------------ GeneAssign

def gene_presence(x, strain_cov, prec: Precision = F64, phi: float = 1.0):
    """Posterior probability that each strain carries each gene [D,G], under
    quasi-Poisson gene coverage x[d,s] ~ mu = sum_g present[d,g] cov[g,s],
    every presence pattern of G strains enumerated under a uniform prior
    (copy number at most 1). x [D,S]; strain_cov [G,S]."""
    G, dtype = strain_cov.shape[0], prec.dtype
    states = torch.tensor([[(k >> (G - 1 - g)) & 1 for g in range(G)]
                           for k in range(2 ** G)], dtype=dtype)          # [K,G]
    xs = torch.as_tensor(np.asarray(x, np.float64)).to(dtype)
    cov = torch.as_tensor(np.asarray(strain_cov, np.float64)).to(dtype)
    mu = torch.clamp_min(prec.mm(states, cov), 1e-6)                               # [K,S]
    ll = (prec.mm(xs, _log(mu).T) - mu.sum(1)[None, :]) / phi                      # [D,K]
    post = torch.softmax(ll, dim=1)
    return prec.mm(post, states).double().numpy()
