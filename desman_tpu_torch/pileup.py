"""Pileup -> variant-count extraction (counterpart of ``desman_tpu.pileup``).

Turns mapped-read pileups (multi-sample ``samtools mpileup`` text) into the
``Contig,Position,<sample>-A..T`` counts CSV the rest of the pipeline
consumes, optionally restricted to gene regions.

Two parsers with the same semantics:
  * :func:`read_pileup` - the C++ scanner (native/pileupio.cpp through
    ``native``); a library that cannot be built raises, and nothing falls
    back to Python quietly;
  * :func:`read_pileup_py` - the Python parser, chosen explicitly
    (``prefer_native=False``, ``extract --python``), and the oracle the
    scanner is tested against.

Bases-column grammar (htslib encoding): ``. ,`` ref match, ``ACGTNacgtn``
mismatch, ``^X`` read start (X = mapq char), ``$`` read end, ``+NN<seq>`` /
``-NN<seq>`` indels (consumed), ``*`` deletion placeholder and ``> <`` ref
skips (cover the site, count no base). Bases with quality (phred+33) below
``min_baseq`` are dropped.
"""
from __future__ import annotations

import re

import numpy as np

from .genecov import GeneTable
from .io import CountsData, decompressed

_BASE_IDX = {"A": 0, "C": 1, "G": 2, "T": 3,
             "a": 0, "c": 1, "g": 2, "t": 3}


def _decode_bases_py(bases: str, quals: str, ref_idx: int, min_baseq: int,
                     cnt: np.ndarray) -> None:
    qi = 0
    i = 0
    blen = len(bases)
    while i < blen:
        c = bases[i]
        if c == "^":
            if i + 1 >= blen:
                raise ValueError("dangling ^ in bases column")
            i += 2
            continue
        if c == "$":
            i += 1
            continue
        if c in "+-":
            j = i + 1
            while j < blen and "0" <= bases[j] <= "9":  # ASCII only, like C++
                j += 1
            if j == i + 1:
                raise ValueError("malformed indel in bases column")
            ln = int(bases[i + 1:j])
            if j + ln > blen:
                raise ValueError("malformed indel in bases column")
            i = j + ln
            continue
        if qi >= len(quals):
            raise ValueError("bases/quals length mismatch")
        q = ord(quals[qi]) - 33
        qi += 1
        if c in ".,":
            idx = ref_idx
        elif c in "*><Nn":
            idx = -1
        else:
            idx = _BASE_IDX.get(c, None)
            if idx is None:
                raise ValueError(f"unexpected symbol in bases column: {c!r}")
        if idx >= 0 and q >= min_baseq:
            cnt[idx] += 1
        i += 1


def read_pileup_py(path: str, samples=None, min_baseq: int = 0) -> CountsData:
    """Python mpileup parser (the oracle of the C++ scanner)."""
    contigs, positions, rows = [], [], []
    S = None
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\r\n")
            if not line or line.startswith("#"):
                continue
            fields = line.split("\t")
            if len(fields) < 6 or (len(fields) - 3) % 3 != 0:
                raise ValueError(
                    f"{path}:{lineno}: expected 3 + 3*S tab fields, "
                    f"got {len(fields)}")
            s_here = (len(fields) - 3) // 3
            if S is None:
                S = s_here
            elif s_here != S:
                raise ValueError(
                    f"{path}:{lineno}: {s_here} samples, expected {S}")
            ref = (fields[2] or "N")[0].upper()
            ref_idx = _BASE_IDX.get(ref, -1)
            cnt = np.zeros((S, 4), dtype=np.int32)
            for s in range(S):
                bases = fields[3 + 3 * s + 1]
                quals = fields[3 + 3 * s + 2]
                if bases == "*" and quals == "*":  # zero-depth sample
                    continue
                try:
                    _decode_bases_py(bases, quals, ref_idx, min_baseq, cnt[s])
                except ValueError as e:
                    raise ValueError(
                        f"{path}:{lineno} sample {s + 1}: {e}") from None
            contigs.append(fields[0])
            positions.append(int(fields[1]))
            rows.append(cnt)
    if S is None:
        raise ValueError(f"{path}: empty pileup")
    counts = (np.stack(rows) if rows
              else np.zeros((0, S, 4), dtype=np.int32))
    if samples is None:
        samples = [f"Sample{i + 1}" for i in range(S)]
    elif len(samples) != S:
        raise ValueError(f"{len(samples)} sample names for {S} pileup columns")
    return CountsData(counts=counts, contigs=np.array(contigs, dtype=object),
                      positions=np.array(positions, dtype=np.int64),
                      samples=list(samples))


def read_pileup(path: str, samples=None, min_baseq: int = 0,
                prefer_native: bool = True) -> CountsData:
    """Parse a multi-sample mpileup file into a :class:`CountsData`.

    prefer_native: the C++ scanner (its parse errors propagate; a library
    that cannot be built raises); False: the Python parser. Gzipped (.gz)
    pileups are handled transparently.
    """
    with decompressed(path) as plain:
        if prefer_native:
            from . import native

            return native.read_pileup_native(plain, samples=samples,
                                             min_baseq=min_baseq)
        return read_pileup_py(plain, samples=samples, min_baseq=min_baseq)


def write_pileup(path: str, data: CountsData, seed: int = 0) -> None:
    """Render a CountsData back to mpileup text (the inverse transform).

    For demos and tests: the reference base per position is the
    across-sample majority base; matching reads are written as ``.``/``,``
    and mismatches as letters, all at q40, with occasional read start/end
    markers. The same text as the JAX package's ``write_pileup`` for the
    same data and seed (the same ``np.random.default_rng(seed)`` draws).
    Round-trips exactly through :func:`read_pileup`.
    """
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    with open(path, "w") as f:
        for v in range(data.V):
            ref_idx = int(data.counts[v].sum(axis=0).argmax())
            fields = [str(data.contigs[v]), str(int(data.positions[v])),
                      bases[ref_idx]]
            for s in range(data.S):
                syms = []
                for b in range(4):
                    c = int(data.counts[v, s, b])
                    if b == ref_idx:
                        syms += ["." if rng.random() < 0.5 else ","] * c
                    else:
                        syms += [bases[b] if rng.random() < 0.5
                                 else bases[b].lower()] * c
                if not syms:
                    fields += ["0", "*", "*"]
                    continue
                if rng.random() < 0.3:
                    syms[0] = "^I" + syms[0]
                if rng.random() < 0.3:
                    syms[-1] = syms[-1] + "$"
                fields += [str(len(syms)), "".join(syms), "I" * len(syms)]
            f.write("\t".join(fields) + "\n")


def read_sample_names(path: str) -> list:
    """One sample name per line (or a comma/tab-separated single line)."""
    with open(path) as f:
        text = f.read().strip()
    if "\n" in text:
        return [ln.strip() for ln in text.splitlines() if ln.strip()]
    return [t for t in re.split(r"[,\t]", text) if t]


def restrict_to_genes(data: CountsData, genes: GeneTable) -> tuple:
    """Keep only positions inside gene intervals.

    ``genes``: gene, contig, start, end (half-open, the genecov
    convention). Returns (subset CountsData in file order, gene label per
    kept position); a position in several genes takes the first.
    """
    contig_str = data.contigs.astype(str)
    order = np.lexsort((data.positions, contig_str))
    sorted_contigs = contig_str[order]
    sorted_pos = data.positions[order]
    gene_of = np.full(data.V, -1, dtype=np.int64)  # sorted index -> gene id
    for gi, (contig, start, end) in enumerate(zip(
            genes.contigs.astype(str), genes.starts, genes.ends)):
        lo = np.searchsorted(sorted_contigs, contig, side="left")
        hi = np.searchsorted(sorted_contigs, contig, side="right")
        a = lo + np.searchsorted(sorted_pos[lo:hi], start, side="left")
        b = lo + np.searchsorted(sorted_pos[lo:hi], end, side="left")
        hit = gene_of[a:b] == -1
        gene_of[a:b][hit] = gi
    sel = gene_of >= 0
    idx = np.sort(order[sel])
    gene_by_orig = np.full(data.V, -1, dtype=np.int64)
    gene_by_orig[order] = gene_of
    labels = np.array([genes.names[g] for g in gene_by_orig[idx]], dtype=object)
    return data.select(idx), labels
