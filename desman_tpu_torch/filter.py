"""Variant-position filter: likelihood-ratio test + error-matrix estimation
(counterpart of ``desman_tpu.filter``).

Per position, on the counts pooled across samples:

  H0: one true base a plus sequencing error        -> p_b = eta[a, b]
  H1: two true bases (a, c) mixed with fraction x  -> p_b = x eta[a,b] + (1-x) eta[c,b]

H0 is maximized over the 4 bases, H1 over the 6 base pairs with the mixture
fraction fit by a fixed number of EM iterations (all pairs at once, as one
batch of [6, V] tensor ops). The LLR statistic is referred to a chi-square
tail; a few outer rounds re-estimate the error matrix eta from the
H0-consistent positions; Benjamini-Hochberg FDR on the host in float64
selects the variants. The statistics are f32 tensor ops on the device the
caller names (TF32 off: ``utils``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .io import CountsData
from .synth import make_eta
from .utils import NBASES, all_base_pairs, bh_fdr, safe_log


@dataclass(frozen=True)
class FilterConfig:
    """The same fields and defaults as the JAX package's ``FilterConfig``
    (see its note on the chi-square degrees of freedom)."""

    min_coverage: float = 5.0      # min total coverage per position
    q_cutoff: float = 0.05         # BH q-value selection threshold
    p_cutoff: float = 0.0          # select on raw p-values instead (0 = off)
    chi2_df: float = 0.0           # LRT degrees of freedom; 0 = auto (1)
    max_outer_iters: int = 8       # eta re-estimation rounds
    em_iters: int = 30             # fixed EM iterations for the H1 fraction
    eta_tol: float = 1e-5          # outer-loop convergence on eta
    init_error_rate: float = 0.01
    p_consistent: float = 0.05     # positions with p above this train eta
    per_sample: bool = False       # H1 mixture fraction free per sample


@dataclass
class FilterResult:
    selected: np.ndarray     # bool [V]
    pvalues: np.ndarray      # [V]
    qvalues: np.ndarray      # [V]
    eta: np.ndarray          # [4,4] fitted error matrix (tran_df)
    llr: np.ndarray          # [V]
    h0_base: np.ndarray      # [V] ML base under H0
    n_outer_iters: int


_PAIRS = np.array(all_base_pairs(), dtype=np.int64)  # [6,2]


def _h0_loglik(c: torch.Tensor, eta: torch.Tensor):
    """Best single-base log-likelihood per position. c: [V,4] -> ([V], [V])."""
    ll = c @ safe_log(eta).T          # ll[v,a] = sum_b c_vb log eta[a,b]
    return torch.amax(ll, dim=1), torch.argmax(ll, dim=1)


def _em_fraction(c, pa, pc, em_iters: int):
    """Fixed-iteration EM for the mixture fraction x of every base pair.

    c: [..., 4] counts; pa, pc: [P, 1.., 4] eta rows of each pair's two
    bases, broadcast against c. Returns the fitted mixture [P, ..., 4]. The
    EM of a two-component multinomial mixture is monotone in the
    likelihood, so a fixed iteration count is safe."""
    N = torch.clamp_min(torch.sum(c, dim=-1), 1.0)
    x = torch.full((pa.shape[0],) + N.shape, 0.5, device=c.device)
    for _ in range(em_iters):
        # responsibility of component a for base b
        mix = x[..., None] * pa + (1.0 - x[..., None]) * pc
        r = x[..., None] * pa / torch.clamp_min(mix, 1e-12)
        x = torch.clamp(torch.sum(c * r, dim=-1) / N, 1e-6, 1.0 - 1e-6)
    return x[..., None] * pa + (1.0 - x[..., None]) * pc


def _h1_pair_loglik(c, pa, pc, em_iters: int):
    """Max log-likelihood of each base pair's mixture per position.
    c: [V,4]; pa, pc: [P,4] -> [P,V]."""
    mix = _em_fraction(c, pa[:, None, :], pc[:, None, :], em_iters)
    return torch.sum(c * safe_log(mix), dim=-1)


def _h1_pair_loglik_per_sample(c3, pa, pc, em_iters: int):
    """Per-sample mixture fractions of each base pair: the DESMAN model's own
    shape (abundances vary per sample, the two true bases are fixed).
    c3: [V,S,4]; pa, pc: [P,4] -> the maximized log-likelihood [P,V,S]."""
    mix = _em_fraction(c3, pa[:, None, None, :], pc[:, None, None, :], em_iters)
    return torch.sum(c3 * safe_log(mix), dim=-1)


def _filter_stats(c, eta, em_iters: int = 30, c3=None, per_sample: bool = False):
    """Per-position LLR statistics given eta: (llr, ll0, ll1, base0) [V].
    c: [V,4] pooled counts; c3: [V,S,4] full counts (per-sample mode only).

    Pooled mode: the LLR of the pooled two-base mixture. Per-sample mode:
    the max over samples of the per-sample LLR, which concentrates a signal
    present in few samples; filter_variants corrects the S-way maximum
    (Sidak).
    """
    ll0, base0 = _h0_loglik(c, eta)   # H0: one genome base, fit pooled
    pairs = torch.as_tensor(_PAIRS, device=c.device)
    pa, pc = eta[pairs[:, 0]], eta[pairs[:, 1]]                     # [6,4]
    if per_sample:
        # per-sample H0 at the pooled ML base, per-sample H1 fractions
        ll0_s = torch.einsum("vsb,vb->vs", c3, safe_log(eta)[base0])
        ll1_s = _h1_pair_loglik_per_sample(c3, pa, pc, em_iters)     # [6,V,S]
        ll1_pairs = torch.amax(2.0 * (ll1_s - ll0_s), dim=2) / 2.0 + ll0
    else:
        ll1_pairs = _h1_pair_loglik(c, pa, pc, em_iters)             # [6,V]
    ll1 = torch.amax(ll1_pairs, dim=0)
    llr = torch.clamp_min(2.0 * (ll1 - ll0), 0.0)
    return llr, ll0, ll1, base0


def _chi2_sf(x: torch.Tensor, df: float) -> torch.Tensor:
    """Upper tail of chi-square via the regularized incomplete gamma."""
    return torch.special.gammaincc(torch.full_like(x, df / 2.0), x / 2.0)


def _reestimate_eta(c, base0, consistent):
    """Refit eta rows from H0-consistent positions' pooled counts.

    Row a accumulates the base counts of consistent positions whose ML true
    base is a; rows get a +1 pseudo-count on the diagonal to stay proper
    when a base is unobserved.
    """
    w = consistent.to(torch.float32)[:, None] * c                     # [V,4]
    onehot = torch.nn.functional.one_hot(base0, NBASES).to(torch.float32)
    rows = onehot.T @ w + torch.eye(NBASES, device=c.device)
    return rows / torch.sum(rows, dim=1, keepdim=True)


def filter_variants(data: CountsData, cfg: FilterConfig = FilterConfig(),
                    device="cuda") -> FilterResult:
    """Run the full filter on `device`: coverage gate -> iterate (LLR, eta
    refit) -> BH FDR.

    Positions failing min_coverage get p = q = 1 and are never selected.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    f32 = dict(dtype=torch.float32, device=device)
    c_all = torch.as_tensor(data.counts.sum(axis=1), **f32)         # [V,4] pooled
    cov_ok = np.asarray(data.counts.sum(axis=(1, 2)) >= cfg.min_coverage)
    c3 = torch.as_tensor(data.counts, **f32) if cfg.per_sample else None
    df = cfg.chi2_df if cfg.chi2_df > 0 else 1.0

    def to_pvals(llr):
        p = _chi2_sf(llr, df)
        if cfg.per_sample:
            # Sidak for the max over S per-sample statistics (stable for
            # small p via log1p/expm1)
            p = -torch.expm1(data.S * torch.log1p(-torch.clamp_max(p, 1.0 - 1e-12)))
        return p

    eta = torch.as_tensor(make_eta(cfg.init_error_rate), **f32)
    cov_ok_dev = torch.as_tensor(cov_ok, device=device)
    llr = base0 = None
    it = 0
    for it in range(1, cfg.max_outer_iters + 1):
        llr, _, _, base0 = _filter_stats(c_all, eta, em_iters=cfg.em_iters, c3=c3,
                                         per_sample=cfg.per_sample)
        consistent = (to_pvals(llr) > cfg.p_consistent) & cov_ok_dev
        eta_new = _reestimate_eta(c_all, base0, consistent)
        delta = float(torch.max(torch.abs(eta_new - eta)))
        eta = eta_new
        if delta < cfg.eta_tol:
            break

    pvals = to_pvals(llr).cpu().numpy().astype(np.float64)
    pvals = np.where(cov_ok, pvals, 1.0)
    qvals = np.where(cov_ok, bh_fdr(pvals), 1.0)
    if cfg.p_cutoff > 0:
        selected = (pvals < cfg.p_cutoff) & cov_ok
    else:
        selected = (qvals < cfg.q_cutoff) & cov_ok

    return FilterResult(
        selected=selected,
        pvalues=pvals,
        qvalues=qvals,
        eta=eta.cpu().numpy().astype(np.float64),
        llr=llr.cpu().numpy().astype(np.float64),
        h0_base=base0.cpu().numpy().astype(np.int32),
        n_outer_iters=it,
    )
