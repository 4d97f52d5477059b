"""The benchmark's inputs, drawn from a seed: a frozen copy of the port's
synthetic metagenome (``synth.generate``), the E. coli mock community
(``synth.mock_community``, ``complete_example.mock``) and its accessory
genes (``complete_example.gene_truth``).

Pure numpy, the same draws in the same order as the originals, so one seed
gives the same arrays bit for bit (``test_bench_gen.py`` holds that at a
small size). It imports nothing of the program: a change to the program's
generator cannot change what the benchmark measures.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

NBASES = 4
BASES = "ACGT"


@dataclass
class Truth:
    tau: np.ndarray       # [V,G] int32, the true base of each strain
    gamma: np.ndarray     # [S,G] float64, rows on the simplex
    eta: np.ndarray       # [4,4] float64, row-stochastic
    counts: np.ndarray    # [V,S,4] int32


def make_eta(error_rate: float) -> np.ndarray:
    """Near-diagonal base-transition matrix with uniform off-diagonal error."""
    eta = np.full((NBASES, NBASES), error_rate / (NBASES - 1))
    np.fill_diagonal(eta, 1.0 - error_rate)
    return eta


def generate(V: int, S: int, G: int, coverage: float = 50.0,
             error_rate: float = 0.01, gamma_alpha: float = 1.0, seed: int = 0,
             max_alleles: int = NBASES) -> Truth:
    """(tau, gamma, eta) from the DESMAN model and Poisson(coverage * p)
    counts; every position a true variant (tau rows where all strains agree
    are drawn again); max_alleles < 4 draws each position's bases from a
    palette of that many."""
    rng = np.random.default_rng(seed)
    if max_alleles < NBASES:
        palette = np.stack([
            rng.permutation(NBASES)[:max_alleles] for _ in range(V)
        ])
        pick = rng.integers(0, max_alleles, size=(V, G))
        tau = np.take_along_axis(palette, pick, axis=1)
    else:
        tau = rng.integers(0, NBASES, size=(V, G))
    if G > 1:
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
    onehot = np.eye(NBASES)[tau]
    mix = np.einsum("vga,sg->vsa", onehot, gamma)
    p = mix @ eta
    counts = rng.poisson(coverage * p).astype(np.int32)
    return Truth(tau=tau.astype(np.int32), gamma=gamma, eta=eta, counts=counts)


def mock_community(V: int, S: int, G: int, coverage: float, error_rate: float,
                   gamma_alpha: float, max_alleles: int, seed: int):
    """The mock: V variant positions from ``generate`` followed by V
    monomorphic ones (one true base plus sequencing error), the latter drawn
    from a second ``default_rng(seed)``, which goes on to draw the genes.

    Returns (truth of all 2V positions, that generator). The monomorphic
    rows' truth is their base in every strain."""
    rng = np.random.default_rng(seed)
    t = generate(V=V, S=S, G=G, coverage=coverage, error_rate=error_rate,
                 gamma_alpha=gamma_alpha, seed=seed, max_alleles=max_alleles)
    mono_base = rng.integers(0, NBASES, size=V)
    mono = rng.poisson(
        coverage * t.eta[mono_base][:, None, :].repeat(S, axis=1)
    ).astype(np.int32)
    tau = np.concatenate([t.tau, np.repeat(mono_base[:, None], G, axis=1)
                          .astype(np.int32)])
    full = Truth(tau=tau, gamma=t.gamma, eta=t.eta,
                 counts=np.concatenate([t.counts, mono], axis=0))
    return full, rng


def gene_truth(rng: np.random.Generator, variant_counts: np.ndarray,
               gamma: np.ndarray, n_genes: int):
    """Accessory genes drawn after the mock's counts: presence in each true
    strain (every gene in at least one) [D,G] and Poisson coverage [D,S]
    from the true strain coverages over the variant positions' counts."""
    total_cov = variant_counts.sum(2).mean(0)
    present = rng.integers(0, 2, size=(n_genes, gamma.shape[1]))
    present[present.sum(1) == 0, 0] = 1
    cov_true = (np.asarray(gamma) * np.asarray(total_cov)[:, None]).T
    x = rng.poisson(np.maximum(present @ cov_true, 1e-9)).astype(np.float64)
    return present, x


def draw(config: dict, seed: int):
    """The inputs of one configuration from a seed: (Truth, genes), genes
    None unless the configuration has accessory genes ((presence, coverage)
    otherwise). The generator's ``kind`` names its file,
    ``benchmark/generators/<kind>.py``, whose ``draw(generator, seed)``
    makes them: adding a kind is adding a file."""
    g = config["generator"]
    return importlib.import_module(f"benchmark.generators.{g['kind']}").draw(g, seed)


def seed_of(seed: int, *index: int) -> int:
    """A 63-bit seed for item `index` of a run from the run's --seed: the
    first word of ``SeedSequence([seed, *index])`` (any seed of 0 up to
    2**63, distinct streams for distinct indices)."""
    ss = np.random.SeedSequence([int(seed), *map(int, index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def write_counts_csv(path: str, counts: np.ndarray) -> None:
    """DESMAN's variant-count table: ``Contig,Position,<sample>-<base>...``,
    one row a position (contig ``synth``, positions 0..V-1, samples
    ``Sample0``...)."""
    V, S, _ = counts.shape
    header = ",".join(["Contig", "Position"] + [
        f"Sample{s}-{b}" for s in range(S) for b in BASES])
    body = np.concatenate([np.arange(V)[:, None], counts.reshape(V, S * NBASES)], 1)
    with open(path, "w") as f:
        f.write(header + "\nsynth,")
        np.savetxt(f, body, fmt="%d", delimiter=",", newline="\nsynth,")
    _strip_tail(path, len("synth,"))


def write_gene_cov_csv(path: str, x: np.ndarray) -> None:
    """A gene coverage table as genecov writes it: ``,n_positions,<sample>...``,
    one row a gene (``gene0``...), n_positions 1000."""
    D, S = x.shape
    header = ",".join(["", "n_positions"] + [f"Sample{s}" for s in range(S)])
    with open(path, "w") as f:
        f.write(header + "\n")
        for d in range(D):
            f.write(f"gene{d},1000," + ",".join(repr(float(v)) for v in x[d]) + "\n")


def _strip_tail(path: str, k: int) -> None:
    """Drop the last k bytes of a file (savetxt's prefix after the last row)."""
    with open(path, "rb+") as f:
        f.seek(-k, 2)
        f.truncate()
