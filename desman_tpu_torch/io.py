"""DESMAN-format I/O on csv + numpy (counterpart of ``desman_tpu.io``).

Same file conventions, headers and error messages as the JAX package's
readers and writers, without pandas:

- variant counts CSV: ``Contig,Position,<sample>-A,<sample>-C,<sample>-G,<sample>-T``
  (``.gz`` accepted)
- ``tran_df.csv``: the 4x4 base-transition error matrix eta, rows/cols A,C,G,T
- run output dir: ``fit.txt``, ``Gamma_mean.csv``, ``Gamma_star.csv``,
  ``Eta_mean.csv``, ``Eta_star.csv``, ``Filtered_Tau_star.csv``, ``Tau_mean.csv``

Numbers are written as numpy prints each scalar (shortest round-trip form
for its dtype), which is what the JAX package's pandas writers emit, so the
two packages write the same text for the same arrays.
"""
from __future__ import annotations

import contextlib
import csv
import gzip
import os
import re
import shutil
import tempfile
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .utils import BASES, NBASES


@dataclass
class CountsData:
    """Dense variant-count tensor plus its row/column labels.

    counts: int32 [V, S, 4] — reads of each base at position v in sample s.
    contigs/positions: length-V labels; samples: length-S names.
    """

    counts: np.ndarray
    contigs: np.ndarray
    positions: np.ndarray
    samples: list

    @property
    def V(self) -> int:
        return self.counts.shape[0]

    @property
    def S(self) -> int:
        return self.counts.shape[1]

    def coverage(self) -> np.ndarray:
        """Per-position per-sample coverage N[v,s]."""
        return self.counts.sum(axis=2)

    def select(self, idx: np.ndarray) -> "CountsData":
        return CountsData(
            counts=self.counts[idx],
            contigs=self.contigs[idx],
            positions=self.positions[idx],
            samples=self.samples,
        )


def _read_rows(path: str) -> list:
    """All CSV rows of a plain or gzipped (.gz) text file."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        return list(csv.reader(f))


def write_rows(path: str, header: list, rows) -> None:
    """A CSV file: the header row, then the rows (each a list of strings)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def _labelled_rows(labels, values: np.ndarray):
    """[label, *values] rows, each number printed as numpy prints it."""
    return ([str(lab), *map(str, row)] for lab, row in zip(labels, values))


def _matrix(rows: list, path: str) -> np.ndarray:
    """float64 matrix of the body rows, minus the first (index) column."""
    try:
        return np.asarray([r[1:] for r in rows], dtype=np.float64)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


@contextlib.contextmanager
def decompressed(path: str):
    """Context manager yielding a plain-text path for `path`.

    Gzipped inputs (.gz) are streamed to a temporary file for the C++
    parsers (they read plain files); plain paths pass through untouched.
    Parse errors (ValueError) raised inside the block are rewritten to name
    the .gz path, not the temporary file.
    """
    if not str(path).endswith(".gz"):
        yield path
        return
    tmp = tempfile.NamedTemporaryFile(suffix=".txt", delete=False)
    try:
        with tmp, gzip.open(path, "rb") as src:
            shutil.copyfileobj(src, tmp, length=1 << 20)
        try:
            yield tmp.name
        except ValueError as e:
            raise ValueError(str(e).replace(tmp.name, str(path))) from None
    finally:
        os.unlink(tmp.name)


def read_counts_csv(path: str, prefer_native: bool = True) -> CountsData:
    """Read a DESMAN variant-count CSV into a dense [V,S,4] tensor.

    Accepts the reference header convention ``<sample>-A`` (also tolerates
    ``<sample>.A`` / ``<sample>_A``). The first two columns are
    ``Contig,Position`` (any capitalization). Gzipped (.gz) input is
    handled transparently. With prefer_native the C++ reader
    (``native.read_counts_csv_native``) parses the file; a parse error
    there falls through to the Python reader, so messages stay uniform. A
    C++ library that cannot be built raises (``native``).
    """
    if str(path).endswith(".gz"):
        with decompressed(path) as plain:
            return read_counts_csv(plain, prefer_native=prefer_native)
    if prefer_native:
        from . import native

        try:
            return native.read_counts_csv_native(path)
        except (ValueError, OSError):
            pass   # the Python reader below says what is wrong
    rows = _read_rows(path)
    cols = rows[0] if rows else []
    if len(cols) < 2 + NBASES:
        raise ValueError(f"{path}: expected Contig,Position + per-sample base columns")

    sample_names: list = []
    sample_cols: dict = {}
    pat = re.compile(r"^(.*)[-._]([ACGT])$")
    for j, c in enumerate(cols[2:], start=2):
        m = pat.match(str(c))
        if not m:
            raise ValueError(f"{path}: column {c!r} does not look like '<sample>-A/C/G/T'")
        name, base = m.group(1), m.group(2)
        if name not in sample_cols:
            sample_cols[name] = {}
            sample_names.append(name)
        sample_cols[name][base] = j

    body = [r for r in rows[1:] if r]
    if any(len(r) != len(cols) for r in body):
        raise ValueError(f"{path}: every row must have {len(cols)} fields")
    V = len(body)
    S = len(sample_names)
    try:
        table = np.asarray([r[2:] for r in body], dtype=np.float64).reshape(
            V, len(cols) - 2)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    counts = np.zeros((V, S, NBASES), dtype=np.int32)
    for s, name in enumerate(sample_names):
        for a, base in enumerate(BASES):
            j = sample_cols[name].get(base)
            if j is None:
                raise ValueError(f"{path}: sample {name!r} missing base column {base}")
            counts[:, s, a] = table[:, j - 2].astype(np.int64)

    return CountsData(
        counts=counts,
        contigs=np.array([r[0] for r in body], dtype=object),
        positions=np.array([int(r[1]) for r in body], dtype=np.int64),
        samples=sample_names,
    )


def write_counts_csv(path: str, data: CountsData) -> None:
    """Inverse of read_counts_csv."""
    header = ["Contig", "Position"] + [
        f"{name}-{base}" for name in data.samples for base in BASES]
    V = data.V
    flat = np.asarray(data.counts).reshape(V, NBASES * data.S)
    write_rows(path, header, (
        [str(c), str(p), *map(str, row)]
        for c, p, row in zip(data.contigs, data.positions, flat)))


def write_position_csv(path: str, data: CountsData, name: str, values) -> None:
    """Contig,Position,<name>: one value per position of data (the filter's
    p_df.csv / q_df.csv), each float printed as Python prints it (pandas'
    format)."""
    write_rows(path, ["Contig", "Position", name], (
        [str(c), str(p), repr(float(x))]
        for c, p, x in zip(data.contigs, data.positions, values)))


def read_eta_csv(path: str) -> np.ndarray:
    """Read a tran_df.csv-style 4x4 eta (row = true base, col = read base)."""
    eta = _matrix([r for r in _read_rows(path)[1:] if r], path)
    if eta.shape != (NBASES, NBASES):
        raise ValueError(f"{path}: expected 4x4 matrix, got {eta.shape}")
    return eta


def write_eta_csv(path: str, eta: np.ndarray) -> None:
    write_rows(path, ["", *BASES], _labelled_rows(BASES, np.asarray(eta)))


def write_gamma_csv(path: str, gamma: np.ndarray, samples=None) -> None:
    """gamma [S,G] → CSV with sample index and H1..HG strain columns."""
    gamma = np.asarray(gamma)
    S, G = gamma.shape
    idx = samples if samples is not None else [f"S{i}" for i in range(S)]
    write_rows(path, ["", *(f"H{g + 1}" for g in range(G))],
                _labelled_rows(idx, gamma))


def read_gamma_csv(path: str) -> np.ndarray:
    return _matrix([r for r in _read_rows(path)[1:] if r], path)


def _tau_header(G: int) -> list:
    return ["Contig", "Position"] + [
        f"H{g + 1}-{base}" for g in range(G) for base in BASES]


def write_tau_star_csv(path: str, tau_idx: np.ndarray, contigs, positions) -> None:
    """Haplotype calls: Contig,Position + one-hot base columns per strain.

    tau_idx: int [V,G]. Column layout ``H<g>-<base>`` mirrors the reference's
    Filtered_Tau_star.csv one-hot encoding.
    """
    tau_idx = np.asarray(tau_idx)
    V, G = tau_idx.shape
    onehot = np.eye(NBASES, dtype=np.int64)[tau_idx].reshape(V, G * NBASES)
    write_rows(path, _tau_header(G), (
        [str(c), str(p), *map(str, row)]
        for c, p, row in zip(contigs, positions, onehot)))


def read_tau_star_csv(path: str):
    """Read a Filtered_Tau_star.csv back to ([V,G] int calls, contigs, positions)."""
    rows = [r for r in _read_rows(path)[1:] if r]
    contigs = np.array([r[0] for r in rows], dtype=object)
    positions = np.array([int(r[1]) for r in rows], dtype=np.int64)
    onehot = np.asarray([r[2:] for r in rows], dtype=np.int64)
    G = onehot.shape[1] // NBASES if rows else 0
    onehot = onehot.reshape(len(rows), G, NBASES)
    return onehot.argmax(axis=2).astype(np.int32), contigs, positions


def write_tau_mean_csv(path: str, tau_mean: np.ndarray, contigs, positions) -> None:
    """Posterior base probabilities [V,G,4] (used for SNV uncertainty)."""
    tau_mean = np.asarray(tau_mean)
    V, G, _ = tau_mean.shape
    flat = tau_mean.reshape(V, G * NBASES)
    write_rows(path, _tau_header(G), (
        [str(c), str(p), *map(str, row)]
        for c, p, row in zip(contigs, positions, flat)))


def read_tau_mean_csv(path: str) -> np.ndarray:
    """Read a Tau_mean.csv back to posterior base probabilities [V,G,4]."""
    rows = [r for r in _read_rows(path)[1:] if r]
    flat = np.asarray([r[2:] for r in rows], dtype=np.float64)
    G = flat.shape[1] // NBASES if rows else 0
    return flat.reshape(len(rows), G, NBASES)


def write_fit_txt(
    path: str, G: int, V: int, S: int,
    mean_deviance: float, star_deviance: float, star_loglik: float,
) -> None:
    with open(path, "w") as f:
        f.write("G,V,S,mean_deviance,star_deviance,star_loglik\n")
        f.write(
            f"{G},{V},{S},{mean_deviance:.6f},{star_deviance:.6f},{star_loglik:.6f}\n"
        )


# The fit.txt column names each consumer accepts (the JAX package's adapter
# seam, kept identical so both packages parse the same files).
FIT_COLUMN_ALIASES = {
    "G": ["G", "H", "NHaplotypes", "nhap"],
    "V": ["V", "N", "NPositions"],
    "S": ["S", "NSamples"],
    "mean_deviance": ["mean_deviance", "Dev", "Deviance", "MeanDeviance"],
    "star_deviance": ["star_deviance", "StarDeviance", "DevStar"],
    "star_loglik": ["star_loglik", "StarLogLik", "LP"],
}
# positional schema used when the first line is numeric (headerless file)
FIT_HEADERLESS_COLUMNS = [
    "G", "V", "S", "mean_deviance", "star_deviance", "star_loglik",
]


def _is_numeric_row(fields) -> bool:
    try:
        [float(x) for x in fields]
        return len(fields) > 0
    except ValueError:
        return False


def read_fit_txt(path: str) -> dict:
    """Parse a fit.txt record; tolerant of header renames and headerless
    files. Missing optional columns come back as NaN; G/mean_deviance are
    required."""
    with open(path) as f:
        first = f.readline().strip().split(",")
        second = f.readline().strip().split(",")
    if _is_numeric_row(first):  # headerless: positional schema
        rec = dict(zip(FIT_HEADERLESS_COLUMNS, first))
    else:
        rec = dict(zip(first, second))
    out: dict = {}
    for canon, aliases in FIT_COLUMN_ALIASES.items():
        val = next((rec[a] for a in aliases if a in rec), None)
        if val is None:
            if canon in ("G", "mean_deviance"):
                raise ValueError(
                    f"{path}: no column for {canon!r} (header {list(rec)}); "
                    "extend desman_tpu_torch.io.FIT_COLUMN_ALIASES"
                )
            out[canon] = float("nan")
        else:
            out[canon] = float(val)
    out["G"] = int(out["G"])
    for k in ("V", "S"):
        if out[k] == out[k]:  # not NaN
            out[k] = int(out[k])
    return out


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


class GeneMatrix(NamedTuple):
    """A gene-indexed table: one row per gene, named columns."""

    names: list           # D gene names (the index column)
    columns: list         # the value columns' names
    values: np.ndarray    # float64 [D, len(columns)]
    index_label: str      # the index column's header cell ("" when unnamed)


def read_gene_cov_csv(path: str) -> GeneMatrix:
    """Gene-coverage matrix [D genes x S samples] (GeneAssign input).

    Drops the ``n_positions`` metadata column genecov prepends: it is
    bookkeeping, not a sample. Also reads the other gene-indexed tables
    (``etaS_df.csv``, ``etaP_df.csv``).
    """
    rows = _read_rows(path)
    header = rows[0] if rows else []
    body = [r for r in rows[1:] if r]
    values = _matrix(body, path).reshape(len(body), len(header) - 1)
    keep = [j for j, c in enumerate(header[1:]) if c != "n_positions"]
    return GeneMatrix(names=[r[0] for r in body],
                      columns=[header[1 + j] for j in keep],
                      values=values[:, keep],
                      index_label=header[0] if header else "")


def write_gene_table(path: str, names, columns, values,
                     index_label: str = "") -> None:
    """A gene-indexed table: ``<index_label>,<columns...>`` then one row per
    gene, name first (what pandas' ``to_csv`` writes for a frame indexed by
    gene, e.g. GeneAssign's etaS_df/etaP_df/eta_conf and genecov's output).
    values: [D, len(columns)], or a list of per-column arrays of mixed
    dtypes."""
    if isinstance(values, (list, tuple)):
        rows = ([str(name), *(str(col[d]) for col in values)]
                for d, name in enumerate(names))
    else:
        rows = _labelled_rows(names, np.asarray(values))
    write_rows(path, [index_label, *columns], rows)


def read_total_cov_csv(path: str) -> np.ndarray:
    """Per-sample total coverage (``geneassign -t``): an index column, then
    the values, raveled row by row into [S] float64."""
    return _matrix([r for r in _read_rows(path)[1:] if r], path).ravel()


def write_draws(path: str, tau_samples, gamma_samples, eta_samples,
                burn: int, thin: int) -> None:
    """Posterior draws (desman --store_every K -> draws.npz), compressed.

    tau draws are int8 [n_draws, V, G]; gamma [n_draws, S, G]; eta
    [n_draws, 4, 4]: every thin-th post-burn sweep. Written to a temporary
    file and moved into place, so a reader never sees half a file.
    """
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        tau=np.asarray(tau_samples, np.int8),
        gamma=np.asarray(gamma_samples, np.float32),
        eta=np.asarray(eta_samples, np.float32),
        burn=np.asarray(burn, np.int64),
        thin=np.asarray(thin, np.int64),
    )
    os.replace(tmp, path)


def read_draws(path: str) -> dict:
    """Load a draws.npz written by write_draws."""
    with np.load(path) as z:
        return {
            "tau": z["tau"], "gamma": z["gamma"], "eta": z["eta"],
            "burn": int(z["burn"]), "thin": int(z["thin"]),
        }
