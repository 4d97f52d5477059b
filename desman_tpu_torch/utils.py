"""Shared numeric utilities (PyTorch counterpart of ``desman_tpu.utils``).

Device helpers are plain functions on tensors; the permutation matchers run
on the host (scipy Hungarian) because they are tiny O(G^3) problems run once
per comparison, not per sweep.

Importing this module turns TF32 off for CUDA matmuls and cuDNN: every
contraction of the sampler is a likelihood or MH-acceptance sum that needs
full f32 (the ``heinsum`` contract of the JAX package).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Base alphabet order used throughout (matches DESMAN CSV column order).
BASES = ("A", "C", "G", "T")
NBASES = 4

# Floor used inside logs: p entries are probabilities, and 1e-12 is far below
# any reachable probability at f32.
LOG_FLOOR = 1e-12


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """log with a floor: log(max(x, 1e-12)). Keeps -inf out of reductions."""
    return torch.log(torch.clamp_min(x, LOG_FLOOR))


def log_multinomial_coeff(n: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """log[ N! / prod_i n_i! ] with N = sum over `dim`, in f32."""
    n = n.to(torch.float32)
    total = n.sum(dim=dim)
    return torch.lgamma(total + 1.0) - torch.lgamma(n + 1.0).sum(dim=dim)


def one_hot_tau(tau_idx: torch.Tensor) -> torch.Tensor:
    """Expand integer base calls [...] in 0..3 to one-hot f32 [..., 4]."""
    return torch.nn.functional.one_hot(tau_idx.long(), NBASES).to(torch.float32)


def normalize_rows(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Project onto the simplex along `dim` by dividing by the sum."""
    return x / torch.clamp_min(x.sum(dim=dim, keepdim=True), eps)


def snp_distance_perm(tau_a: np.ndarray, tau_b: np.ndarray,
                      return_perm: bool = False):
    """Minimum SNP distance between two haplotype sets over strain permutations.

    tau_a: [V, Ga] integer base calls; tau_b: [V, Gb]. Strains of b are
    assigned to strains of a by the Hungarian algorithm on the pairwise
    SNP-count matrix. Returns total mismatches over matched pairs (and the
    permutation if requested); surplus strains are ignored.
    """
    from scipy.optimize import linear_sum_assignment

    tau_a = np.asarray(tau_a)
    tau_b = np.asarray(tau_b)
    if tau_a.shape[0] != tau_b.shape[0]:
        raise ValueError("position axes must match")
    ga, gb = tau_a.shape[1], tau_b.shape[1]
    cost = np.zeros((ga, gb), dtype=np.int64)
    for i in range(ga):
        for j in range(gb):
            cost[i, j] = int(np.sum(tau_a[:, i] != tau_b[:, j]))
    rows, cols = linear_sum_assignment(cost)
    dist = int(cost[rows, cols].sum())
    if return_perm:
        return dist, (rows, cols)
    return dist


def match_gamma_perm(gamma_a: np.ndarray, gamma_b: np.ndarray):
    """Best-permutation mean absolute error between two gamma matrices [S,G]."""
    from scipy.optimize import linear_sum_assignment

    gamma_a = np.asarray(gamma_a, dtype=np.float64)
    gamma_b = np.asarray(gamma_b, dtype=np.float64)
    ga, gb = gamma_a.shape[1], gamma_b.shape[1]
    cost = np.zeros((ga, gb))
    for i in range(ga):
        for j in range(gb):
            cost[i, j] = np.abs(gamma_a[:, i] - gamma_b[:, j]).mean()
    rows, cols = linear_sum_assignment(cost)
    return float(cost[rows, cols].mean()), (rows, cols)


def bh_fdr(pvalues: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg q-values on the host in float64 (the filter's FDR
    step)."""
    p = np.asarray(pvalues, dtype=np.float64)
    n = p.size
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1.0)
    # enforce monotonicity from the largest rank down
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    q = np.empty_like(ranked)
    q[order] = np.clip(ranked, 0.0, 1.0)
    return q


def all_base_pairs():
    """The 6 unordered distinct base pairs, used by the variant filter's H1."""
    return list(itertools.combinations(range(NBASES), 2))
