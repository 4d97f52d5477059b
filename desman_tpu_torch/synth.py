"""Synthetic metagenome generator for tests and benchmarks.

Draws (tau, gamma, eta) from the DESMAN generative model and samples a
variant-count tensor. Host-side numpy with the same draws, in the same order,
as ``desman_tpu.synth``: one seed gives the same arrays in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .io import CountsData
from .utils import NBASES


@dataclass
class SynthTruth:
    tau_idx: np.ndarray    # [V,G] int
    gamma: np.ndarray      # [S,G] rows on simplex
    eta: np.ndarray        # [4,4] row-stochastic
    data: CountsData


def make_eta(error_rate: float = 0.01) -> np.ndarray:
    """Near-diagonal base-transition matrix with uniform off-diagonal error."""
    eta = np.full((NBASES, NBASES), error_rate / (NBASES - 1))
    np.fill_diagonal(eta, 1.0 - error_rate)
    return eta


def generate(
    V: int = 200,
    S: int = 16,
    G: int = 3,
    coverage: float = 50.0,
    error_rate: float = 0.01,
    gamma_alpha: float = 1.0,
    seed: int = 0,
    ensure_variant: bool = True,
    max_alleles: int = NBASES,
) -> SynthTruth:
    """Sample a dataset from the model.

    coverage: mean per-(position,sample) read depth (Poisson).
    ensure_variant: resample tau rows where all strains agree, so every
    position is a true variant.
    max_alleles: distinct bases per position (default 4 = unconstrained;
    2 gives biallelic positions).
    """
    rng = np.random.default_rng(seed)
    if max_alleles < NBASES:
        # per-position allele palette; strains draw bases from it
        palette = np.stack([
            rng.permutation(NBASES)[:max_alleles] for _ in range(V)
        ])                                                   # [V, A]
        pick = rng.integers(0, max_alleles, size=(V, G))
        tau = np.take_along_axis(palette, pick, axis=1)
    else:
        tau = rng.integers(0, NBASES, size=(V, G))
    if ensure_variant and G > 1:
        same = (tau == tau[:, :1]).all(axis=1)
        while same.any():
            m = int(same.sum())
            if max_alleles < NBASES:
                pick = rng.integers(0, max_alleles, size=(m, G))
                tau[same] = np.take_along_axis(palette[same], pick, axis=1)
            else:
                tau[same] = rng.integers(0, NBASES, size=(m, G))
            same = (tau == tau[:, :1]).all(axis=1)
    gamma = rng.dirichlet(np.full(G, gamma_alpha), size=S)
    eta = make_eta(error_rate)

    onehot = np.eye(NBASES)[tau]                      # [V,G,4]
    mix = np.einsum("vga,sg->vsa", onehot, gamma)     # [V,S,4]
    p = mix @ eta                                     # [V,S,4]

    # Poisson(coverage) depth + multinomial split == independent
    # Poisson(coverage * p) per base (Poisson thinning) — one vectorized draw
    counts = rng.poisson(coverage * p).astype(np.int32)

    data = CountsData(
        counts=counts,
        contigs=np.array(["synth"] * V),
        positions=np.arange(V),
        samples=[f"Sample{s}" for s in range(S)],
    )
    return SynthTruth(tau_idx=tau.astype(np.int32), gamma=gamma, eta=eta, data=data)


def mock_community(
    V: int,
    S: int,
    G: int,
    coverage: float = 50.0,
    error_rate: float = 0.005,
    gamma_alpha: float = 0.6,
    max_alleles: int = 2,
    seed: int = 2017,
    rng: np.random.Generator | None = None,
):
    """The mock community of the JAX package's examples/complete_example.py:
    V variant positions from ``generate`` (positions 0..V-1) followed by V
    monomorphic ones (one true base plus sequencing error), as real counts
    tables are mostly non-variant and the filter learns eta from those.
    Its ``--paper`` scale is V=7000, S=64, G=5, gamma_alpha=0.6, biallelic
    (max_alleles=2), seed 2017.

    The monomorphic positions are drawn from `rng` (default: a new
    ``default_rng(seed)``); the example passes its own, as it goes on to
    draw the accessory genes from the same stream.

    Returns (truth of the variant positions, CountsData of all 2V).
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    t = generate(V=V, S=S, G=G, coverage=coverage, error_rate=error_rate,
                 gamma_alpha=gamma_alpha, seed=seed, max_alleles=max_alleles)
    mono_base = rng.integers(0, NBASES, size=V)
    mono = rng.poisson(
        coverage * t.eta[mono_base][:, None, :].repeat(S, axis=1)
    ).astype(np.int32)
    data = CountsData(
        counts=np.concatenate([t.data.counts, mono], axis=0),
        contigs=np.array(["synth"] * (2 * V)),
        positions=np.arange(2 * V),
        samples=t.data.samples,
    )
    return t, data
