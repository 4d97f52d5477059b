"""Per-gene coverage from a counts table (counterpart of
``desman_tpu.genecov``).

Given per-position counts over gene regions and a gene annotation table
(gene, contig, start, end), the [D, S] mean-coverage matrix GeneAssign
reads. Host numpy and csv, as the JAX package's pandas version computes it.
"""
from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import List

import numpy as np

from .io import CountsData

_COLUMNS = ("gene", "contig", "start", "end")


@dataclass
class GeneTable:
    names: List[str]
    contigs: np.ndarray
    starts: np.ndarray   # inclusive
    ends: np.ndarray     # exclusive


def read_gene_table(path: str) -> GeneTable:
    """TSV (``.tsv``/``.bed``) or CSV with columns gene, contig, start, end.

    A first row naming the four columns (any case, any order, other
    columns allowed) is a header; otherwise the file is headerless and each
    row's last four fields are gene, contig, start, end (pandas' reading of
    a headerless file with four names).
    """
    sep = "\t" if path.endswith((".tsv", ".bed")) else ","
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    cols = [c.lower() for c in rows[0]] if rows else []
    if set(_COLUMNS).issubset(cols):
        idx = [cols.index(c) for c in _COLUMNS]
        body = [[r[j] for j in idx] for r in rows[1:]]
    else:
        body = [r[-4:] for r in rows]
    return GeneTable(
        names=[r[0] for r in body],
        contigs=np.array([r[1] for r in body], dtype=object),
        starts=np.array([int(r[2]) for r in body], dtype=np.int64),
        ends=np.array([int(r[3]) for r in body], dtype=np.int64),
    )


def gene_coverage(data: CountsData, genes: GeneTable):
    """Mean per-sample coverage over each gene's positions.

    Returns (names, cov [D, S] float64, n_positions [D] int64). A position
    lies in a gene when start <= position < end on its contig; positions
    absent from the counts contribute nothing, and a gene with no covered
    position gets zero coverage (and n_positions 0).
    """
    cov = data.counts.sum(axis=2)                       # [V, S]
    contigs = data.contigs.astype(str)
    order = np.lexsort((data.positions, contigs))
    sorted_contigs = contigs[order]
    sorted_pos = data.positions[order]
    sorted_cov = cov[order]

    rows = np.zeros((len(genes.names), data.S))
    nps = np.zeros(len(genes.names), dtype=np.int64)
    for d, (contig, start, end) in enumerate(zip(
            genes.contigs.astype(str), genes.starts, genes.ends)):
        lo = np.searchsorted(sorted_contigs, contig, side="left")
        hi = np.searchsorted(sorted_contigs, contig, side="right")
        pos = sorted_pos[lo:hi]
        a = lo + np.searchsorted(pos, start, side="left")
        b = lo + np.searchsorted(pos, end, side="left")
        nps[d] = b - a
        if b > a:
            rows[d] = sorted_cov[a:b].mean(axis=0)
    return list(genes.names), rows, nps
