"""Permutation-matched comparison of inferred vs true strains (counterpart
of ``desman_tpu.validation``, the validateSNP step): haplotype calls under
the best strain permutation, and gammas likewise. Positions are aligned on
(Contig, Position) keys so the prediction may cover a subset of the truth.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import io
from .utils import match_gamma_perm, snp_distance_perm


@dataclass
class ValidationReport:
    n_positions: int
    n_strains_pred: int
    n_strains_true: int
    snp_errors: int            # total mismatches over matched strain pairs
    error_rate: float          # snp_errors / (n_positions * matched strains)
    per_strain_errors: np.ndarray
    permutation: Tuple[np.ndarray, np.ndarray]
    gamma_mae: Optional[float] = None

    def summary_line(self) -> str:
        g = "" if self.gamma_mae is None else f",{self.gamma_mae:.6f}"
        return (
            f"{self.n_positions},{self.n_strains_pred},{self.snp_errors},"
            f"{self.error_rate:.6f}{g}"
        )


def _align(pred_tau, pred_keys, true_tau, true_keys):
    """Inner-join two tau matrices on (contig, position) keys."""
    pred_index = {k: i for i, k in enumerate(pred_keys)}
    rows_p, rows_t = [], []
    for j, k in enumerate(true_keys):
        i = pred_index.get(k)
        if i is not None:
            rows_p.append(i)
            rows_t.append(j)
    return pred_tau[rows_p], true_tau[rows_t]


def compare_tau(
    pred_tau: np.ndarray,
    true_tau: np.ndarray,
    pred_keys=None,
    true_keys=None,
) -> ValidationReport:
    """Permutation-matched SNP error between two [V,G] call matrices."""
    if pred_keys is not None and true_keys is not None:
        pred_tau, true_tau = _align(pred_tau, pred_keys, true_tau, true_keys)
    if pred_tau.shape[0] == 0:
        raise ValueError("no overlapping positions between prediction and truth")
    dist, (rows, cols) = snp_distance_perm(true_tau, pred_tau, return_perm=True)
    per_strain = np.array([
        int((true_tau[:, r] != pred_tau[:, c]).sum()) for r, c in zip(rows, cols)
    ])
    matched = len(rows)
    return ValidationReport(
        n_positions=pred_tau.shape[0],
        n_strains_pred=pred_tau.shape[1],
        n_strains_true=true_tau.shape[1],
        snp_errors=dist,
        error_rate=dist / float(pred_tau.shape[0] * max(matched, 1)),
        per_strain_errors=per_strain,
        permutation=(rows, cols),
    )


def validate_files(
    pred_tau_csv: str,
    true_tau_csv: str,
    pred_gamma_csv: Optional[str] = None,
    true_gamma_csv: Optional[str] = None,
) -> ValidationReport:
    """File-level validation (both sides in Filtered_Tau_star.csv format;
    gammas in Gamma_mean.csv format)."""
    pred_tau, pc, pp = io.read_tau_star_csv(pred_tau_csv)
    true_tau, tc, tp = io.read_tau_star_csv(true_tau_csv)
    rep = compare_tau(
        pred_tau, true_tau,
        pred_keys=list(zip(map(str, pc), map(int, pp))),
        true_keys=list(zip(map(str, tc), map(int, tp))),
    )
    if pred_gamma_csv and true_gamma_csv:
        rep.gamma_mae, _ = match_gamma_perm(
            io.read_gamma_csv(true_gamma_csv), io.read_gamma_csv(pred_gamma_csv))
    return rep
