"""Strain haplotype FASTA from tau calls (counterpart of
``desman_tpu.strainfasta``).

The pipeline's last artifact: each strain's sequences, from the haplotype
base calls of ``Filtered_Tau_star.csv``. Two modes:

* full mode - given the bin's contig FASTA, each strain's full contig
  sequences with its bases substituted at the called positions;
* variants-only mode - no FASTA: each strain's called bases over the
  variant positions, concatenated.

Positions are 1-based (the samtools/DESMAN convention).
"""
from __future__ import annotations

import numpy as np

from .io import read_tau_star_csv

BASES = "ACGT"


def read_fasta(path: str) -> dict:
    """name -> sequence (the first whitespace-delimited token as name)."""
    seqs = {}
    name, chunks = None, []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks)
                tokens = line[1:].split()
                if not tokens:
                    raise ValueError(f"{path}:{lineno}: empty FASTA header")
                name = tokens[0]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


def strain_sequences(tau_idx: np.ndarray, contigs, positions,
                     ref_seqs: dict) -> dict:
    """strain g -> {contig -> sequence with the strain's bases substituted}.

    Every reference contig is emitted (contigs without calls are the same in
    every strain). Raises on a contig missing from the reference and on a
    position outside its contig.
    """
    V, G = tau_idx.shape
    missing = {str(c) for c in contigs} - set(ref_seqs)
    if missing:
        raise ValueError(
            f"contigs {sorted(missing)} not in reference FASTA")
    out = {}
    for g in range(G):
        seqs = {name: list(s) for name, s in ref_seqs.items()}
        for v in range(V):
            name = str(contigs[v])
            pos = int(positions[v]) - 1  # 1-based -> 0-based
            if not 0 <= pos < len(seqs[name]):
                raise ValueError(
                    f"position {positions[v]} outside contig {name!r} "
                    f"(length {len(seqs[name])})")
            seqs[name][pos] = BASES[int(tau_idx[v, g])]
        out[g] = {name: "".join(s) for name, s in seqs.items()}
    return out


def variant_haplotypes(tau_idx: np.ndarray) -> list:
    """strain g -> its called bases over the variant positions."""
    return ["".join(BASES[b] for b in tau_idx[:, g])
            for g in range(tau_idx.shape[1])]


def _write_wrapped(f, header: str, seq: str) -> None:
    f.write(header + "\n")
    for i in range(0, len(seq), 80):
        f.write(seq[i:i + 80] + "\n")


def write_strain_fasta(tau_file: str, out_path: str,
                       ref_fasta: str = None) -> int:
    """Write the strain sequences; returns the number of strains."""
    tau_idx, contigs, positions = read_tau_star_csv(tau_file)
    G = tau_idx.shape[1]
    with open(out_path, "w") as f:
        if ref_fasta:
            seqs = strain_sequences(tau_idx, contigs, positions,
                                    read_fasta(ref_fasta))
            for g in range(G):
                for name, s in sorted(seqs[g].items()):
                    _write_wrapped(f, f">{name}_hap{g + 1}", s)
        else:
            for g, h in enumerate(variant_haplotypes(tau_idx)):
                _write_wrapped(f, f">hap{g + 1} variants={len(h)}", h)
    return G
