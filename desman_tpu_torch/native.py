"""ctypes bindings for the repository's C++ readers (counterpart of
``desman_tpu.native``).

``read_counts_csv_native`` parses a DESMAN counts CSV with
``native/countsio.cpp``, ``read_pileup_native`` a multi-sample mpileup with
``native/pileupio.cpp``: the same sources the JAX package builds, compiled
unchanged with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``build/desman_tpu_torch/lib<name>.<hash>.so`` at the repository root, the
hash keyed on the source and the flags. A build writes to a temporary name
and renames it into place, so concurrent processes never load a
half-written library.

Failure mode, a deliberate difference from the JAX package: a library that
cannot be built or loaded raises ``RuntimeError`` with the compiler's
output; nothing falls back to the Python parsers quietly. The Python
parsers are chosen explicitly (``prefer_native=False``, ``extract
--python``). Parse errors are ``ValueError`` and name the file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .io import CountsData
from .utils import BASES

REPO = Path(__file__).resolve().parents[1]
NATIVE = REPO / "native"
BUILD_DIR = REPO / "build" / "desman_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_libraries: dict = {}


def library_path(name: str) -> Path:
    """Where the library built from native/<name>.cpp lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((NATIVE / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile native/<name>.cpp unless the library for this source exists;
    raise RuntimeError with g++'s output if it fails."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = ["g++", *GXX_FLAGS, str(NATIVE / f"{name}.cpp"), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building {name} failed: {e}") from None
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load(name: str, bind) -> ctypes.CDLL:
    """The library of native/<name>.cpp, built on first use, its C
    signatures set by bind(lib)."""
    lib = _libraries.get(name)
    if lib is None:
        path = build(name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from None
        bind(lib)
        _libraries[name] = lib
    return lib


def _bind_counts(lib) -> None:
    lib.counts_open.restype = ctypes.c_void_p
    lib.counts_open.argtypes = [ctypes.c_char_p]
    lib.counts_error.restype = ctypes.c_char_p
    lib.counts_error.argtypes = [ctypes.c_void_p]
    for fn in ("counts_V", "counts_S", "counts_n_contigs"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.counts_fill.restype = None
    lib.counts_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    for fn in ("counts_sample_name", "counts_contig_name"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
    lib.counts_close.restype = None
    lib.counts_close.argtypes = [ctypes.c_void_p]


def _bind_pileup(lib) -> None:
    lib.pileup_open.restype = ctypes.c_void_p
    lib.pileup_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pileup_error.restype = ctypes.c_char_p
    lib.pileup_error.argtypes = [ctypes.c_void_p]
    for fn in ("pileup_V", "pileup_S", "pileup_n_contigs"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.pileup_fill.restype = None
    lib.pileup_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.pileup_contig_name.restype = ctypes.c_int64
    lib.pileup_contig_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.pileup_close.restype = None
    lib.pileup_close.argtypes = [ctypes.c_void_p]


def _counts_lib() -> ctypes.CDLL:
    return _load("countsio", _bind_counts)


def _pileup_lib() -> ctypes.CDLL:
    return _load("pileupio", _bind_pileup)


def available() -> bool:
    """Whether the counts reader's library builds and loads here."""
    try:
        _counts_lib()
        return True
    except RuntimeError:
        return False


def pileup_available() -> bool:
    """Whether the pileup scanner's library builds and loads here."""
    try:
        _pileup_lib()
        return True
    except RuntimeError:
        return False


def _names(fn, h, count: int) -> list:
    buf = ctypes.create_string_buffer(4096)
    out = []
    for i in range(count):
        fn(h, i, buf, 4096)
        out.append(buf.value.decode())
    return out


def read_pileup_native(path: str, samples=None, min_baseq: int = 0) -> CountsData:
    """Parse a multi-sample mpileup file with the C++ scanner
    (native/pileupio.cpp; the semantics of pileup.read_pileup_py)."""
    lib = _pileup_lib()
    h = lib.pileup_open(str(path).encode(), int(min_baseq))
    try:
        err = lib.pileup_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        V = lib.pileup_V(h)
        S = lib.pileup_S(h)
        if V == 0 and S == 0:
            raise ValueError(f"{path}: empty pileup")
        counts = np.empty((V, S, 4), dtype=np.int32)
        positions = np.empty(V, dtype=np.int64)
        contig_ids = np.empty(V, dtype=np.int32)
        refs = np.empty(V, dtype=np.uint8)
        lib.pileup_fill(
            h,
            counts.ctypes.data_as(ctypes.c_void_p),
            positions.ctypes.data_as(ctypes.c_void_p),
            contig_ids.ctypes.data_as(ctypes.c_void_p),
            refs.ctypes.data_as(ctypes.c_void_p),
        )
        names = _names(lib.pileup_contig_name, h, lib.pileup_n_contigs(h))
        contigs = np.array(names, dtype=object)[contig_ids]
        if samples is None:
            samples = [f"Sample{i + 1}" for i in range(S)]
        elif len(samples) != S:
            raise ValueError(
                f"{len(samples)} sample names for {S} pileup columns")
        return CountsData(counts=counts, contigs=contigs,
                          positions=positions, samples=list(samples))
    finally:
        lib.pileup_close(h)


_BASE_COLUMN = re.compile(r"^(.*)[-._]([ACGT])$")


def _check_base_columns(path: str, samples: list) -> None:
    """Raise, as io.read_counts_csv does, when a sample lacks one of its
    four base columns: the C++ reader would leave that base's counts 0."""
    with open(path, newline="") as f:
        header = f.readline().rstrip("\r\n").split(",")
    have = {}
    for col in header[2:]:
        m = _BASE_COLUMN.match(col.rstrip("\r "))
        if m:
            have.setdefault(m.group(1), set()).add(m.group(2))
    for name in samples:
        for base in BASES:
            if base not in have.get(name, ()):
                raise ValueError(
                    f"{path}: sample {name!r} missing base column {base}")


def read_counts_csv_native(path: str) -> CountsData:
    """Parse a DESMAN counts CSV with the C++ reader."""
    lib = _counts_lib()
    h = lib.counts_open(str(path).encode())
    try:
        err = lib.counts_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        V = lib.counts_V(h)
        S = lib.counts_S(h)
        counts = np.empty((V, S, 4), dtype=np.int32)
        positions = np.empty(V, dtype=np.int64)
        contig_ids = np.empty(V, dtype=np.int32)
        lib.counts_fill(
            h,
            counts.ctypes.data_as(ctypes.c_void_p),
            positions.ctypes.data_as(ctypes.c_void_p),
            contig_ids.ctypes.data_as(ctypes.c_void_p),
        )
        samples = _names(lib.counts_sample_name, h, S)
        names = _names(lib.counts_contig_name, h, lib.counts_n_contigs(h))
        contigs = np.array(names, dtype=object)[contig_ids]
    finally:
        lib.counts_close(h)
    if any('"' in name for name in names):
        # the C++ reader splits on every comma and keeps quotes
        raise ValueError(f"{path}: quoted contig field")
    _check_base_columns(path, samples)
    return CountsData(counts=counts, contigs=contigs, positions=positions,
                      samples=samples)
