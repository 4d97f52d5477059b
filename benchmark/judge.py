"""The numbers that decide ``correct``, from the program's answers and the
plain reference (``reference``), over every item the window finished.

Chain cells:

- ``ll_gap``, the worst chain's: |the chain's reported star loglik - the
  reference's loglik of the star state it reports (tau, gamma, eta)|, over
  the latter. The star loglik is the sweep's own sum, kept through the tau
  and swap kernels' mixture updates and the gamma and eta steps; a state
  whose cached mixture or sums went wrong anywhere on the way reads here.
- ``fit_gap``, the median chain's: |the reference's loglik of the truth the
  counts were drawn from - the chain's star loglik|, over the former: a
  chain that did not reach the posterior's mode (a sweep that leaves its
  state as it was, a part of the positions not updated) reads here. One
  chain of 250 sweeps at G=16 often stops in a mode that merges two
  strains (0.1-0.85% below the truth), so the median over the window's
  chains is compared: it is steady from seed to seed, the worst chain is
  not.

Bin cells, each the worst bin's:

- ``eta_gap``, ``p_gap``: the filter's error matrix and p-values (its
  tran_df.csv, p_df.csv) against the reference filter's;
- ``sel_mismatch``: the positions the grid ran on (the selected run's
  Filtered_Tau_star.csv) that the reference's cut (``reference.select``:
  the coverage mask, Benjamini-Hochberg in float64, the q-value cut) does
  not select from the p-values the filter reported, and those it selects
  that the grid did not run on: a wrong q-value cut, coverage mask or
  hand-over to the grid reads here, exactly. The p-values themselves are
  ``p_gap``'s: against the reference's float64 p-values a position whose
  q-value lies at the cut can fall on either side of it in float32;
- ``G_gap``: |the G ``resolve_nhap`` picked - the strains the mock was
  drawn with|;
- ``ll_gap``, ``fit_gap``: as a chain's, of the selected run's star (its
  fit.txt and CSVs) over the positions the grid ran on;
- ``gene_gap``: GeneAssign's presence probabilities (geneassign_etaP_df.csv)
  against the reference enumeration on the selected run's Gamma_mean.csv; a
  table of another shape reads 1.

``prec`` (a ``reference.Precision``) puts the reference computed in that
precision in the program's place: for a bin the filter (and the selection
it makes), the loglik the grid reports for the selected star and
GeneAssign; a chain cell's control runs the reference sampler
(``reference_sampler``) in the program's place instead. Both are
``control.py``'s.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from . import reference

F64 = reference.F64


@dataclass
class ChainAnswer:
    tau: np.ndarray       # [V,G] star haplotypes
    gamma: np.ndarray     # [S,G] star abundances
    eta: np.ndarray       # [4,4] star error matrix
    loglik: float         # the star's loglik as the chain reports it
    sweeps: int


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def chains(answers, truth, device) -> dict:
    """ll_gap, the worst chain's, and fit_gap, the median chain's; {} with
    no chain finished."""
    if not answers:
        return {}
    ref_dev = device if device.type == "cuda" else "cpu"
    ll_truth = reference.loglik(truth.counts, truth.tau, truth.gamma, truth.eta,
                                F64, ref_dev)
    ll_gaps, fit_gaps = [], []
    for a in answers:
        star = reference.loglik(truth.counts, a.tau, a.gamma, a.eta, F64, ref_dev)
        ll_gaps.append(_rel(a.loglik, star))
        fit_gaps.append(_rel(a.loglik, ll_truth))
    return {"ll_gap": max(ll_gaps), "fit_gap": float(np.median(fit_gaps))}


# ------------------------------------------------------------ bins

def _rows(path: str) -> list:
    with open(path, newline="") as f:
        return [r for r in csv.reader(f) if r]


def _matrix(path: str) -> np.ndarray:
    """A labelled table's numbers (header and first column dropped)."""
    return np.asarray([r[1:] for r in _rows(path)[1:]], dtype=np.float64)


def _tau_star(path: str):
    """(positions [V], tau [V,G]) of a Filtered_Tau_star.csv."""
    rows = _rows(path)[1:]
    pos = np.asarray([int(r[1]) for r in rows])
    onehot = np.asarray([r[2:] for r in rows], dtype=np.int64)
    return pos, onehot.reshape(len(rows), -1, 4).argmax(2)


def _star_loglik(path: str) -> float:
    head, row = _rows(path)[:2]
    return float(row[head.index("star_loglik")])


def bins(done, wl: dict, G: int, prec=None) -> dict:
    """The seven numbers over the finished bins; {} with none finished.
    done: [(bin inputs, output dir, pipeline summary)]; G: the strains the
    mocks were drawn with."""
    if not done:
        return {}
    worst: dict = {}

    def keep(name, value):
        worst[name] = max(worst.get(name, 0.0), value)

    for b, out, summary in done:
        truth = b["truth"]
        counts = truth.counts
        # the filter
        eta_ref, p_ref, _ = reference.filter_variants(counts, wl["filter"], F64)
        if prec is not None:
            eta, p, sel_ctl = reference.filter_variants(counts, wl["filter"], prec)
        else:
            eta = _matrix(os.path.join(out, "tran_df.csv"))
            p = _matrix(os.path.join(out, "p_df.csv"))[:, -1]
        keep("eta_gap", float(np.max(np.abs(eta - eta_ref))))
        keep("p_gap", float(np.max(np.abs(p - p_ref))))
        # the selection: the positions the grid ran on against the cut of
        # the p-values the filter reported, the G it picked
        run = summary["best_run_dir"]
        pos, tau = _tau_star(os.path.join(run, "Filtered_Tau_star.csv"))
        ran = pos if prec is None else np.flatnonzero(sel_ctl)
        cut = np.flatnonzero(reference.select(p, counts, wl["filter"]))
        keep("sel_mismatch", float(np.setxor1d(ran, cut).size))
        keep("G_gap", float(abs(int(summary["selected_G"]) - G)))
        # the selected run's star, over the positions the grid ran on
        gamma = _matrix(os.path.join(run, "Gamma_star.csv"))
        eta_star = _matrix(os.path.join(run, "Eta_star.csv"))
        sel = counts[pos]
        star = reference.loglik(sel, tau, gamma, eta_star, F64)
        if prec is None:
            given = _star_loglik(os.path.join(run, "fit.txt")) - reference.coeff(sel)
        else:
            given = reference.loglik(sel, tau, gamma, eta_star, prec)
        keep("ll_gap", _rel(given, star))
        ll_truth = reference.loglik(sel, truth.tau[pos], truth.gamma, truth.eta, F64)
        keep("fit_gap", _rel(given, ll_truth))
        # GeneAssign on the selected run's mean abundances
        gamma_mean = _matrix(os.path.join(run, "Gamma_mean.csv"))
        strain_cov = (gamma_mean * counts.sum(2).mean(0)[:, None]).T
        want = reference.gene_presence(b["genes"], strain_cov, F64)
        got = (_matrix(os.path.join(out, "geneassign_etaP_df.csv"))
               if prec is None else reference.gene_presence(b["genes"], strain_cov, prec))
        keep("gene_gap", float(np.max(np.abs(got - want))) if got.shape == want.shape
             else 1.0)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limit of the cell met, and
    every number it limits read."""
    checks = [(k, numbers.get(k), limits[k]) for k in limits]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok, checks
