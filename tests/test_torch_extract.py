"""The port's count extraction (``desman_tpu_torch.pileup``,
``desman_tpu_torch.native``, ``io.read_counts_csv`` and the ``extract``
subcommand) against the JAX package's.

Pileups are made with numpy from a seed by tests/test_pileup.py's generator
(the whole htslib grammar, zero-depth samples, ref N). Everything here is
exact: counts, positions, contigs and the files written must be equal,
byte for byte where a file is compared.
"""
import gzip
import os
import shutil
import subprocess

import numpy as np
import pytest

from desman_tpu import cli as jcli
from desman_tpu import io as jio
from desman_tpu import native as jnative
from desman_tpu import pileup as jpileup
from desman_tpu.genecov import GeneTable as JGeneTable
from desman_tpu_torch import cli, genecov, io, native, pileup, synth

from test_pileup import synth_pileup
from torch_helpers import REPO


def _same(a, b):
    assert np.array_equal(a.counts, b.counts) and a.counts.dtype == np.int32
    assert np.array_equal(a.positions, b.positions) and a.positions.dtype == np.int64
    assert list(a.contigs) == list(b.contigs) and a.contigs.dtype == object
    assert list(a.samples) == list(b.samples)


@pytest.fixture(scope="module", autouse=True)
def jax_native_of_this_module(tmp_path_factory):
    """The JAX package's native readers built into this module's own
    directory and loaded from there. Its loaders build them in place under
    ``desman_tpu/``, where another test file running at the same time may be
    writing them still. Without a compiler nothing is patched: the loaders
    then fail as they would."""
    lib_dir = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        for lib, src, cached in (("_LIB_PATH", "_SRC", ("_lib",)),
                                 ("_PILEUP_LIB_PATH", "_PILEUP_SRC",
                                  ("_pileup_lib", "_pileup_load_error"))):
            out = str(lib_dir / os.path.basename(getattr(jnative, lib)))
            try:
                jnative._compile(getattr(jnative, src), out)
            except (OSError, subprocess.CalledProcessError):
                continue
            mp.setattr(jnative, lib, out)
            for name in cached:
                mp.setattr(jnative, name, None)
        yield


@pytest.fixture(scope="module")
def pileups(tmp_path_factory):
    """Three random pileups (each with zero-depth samples) and a .gz copy
    of the first."""
    d = tmp_path_factory.mktemp("pileups")
    paths = []
    for seed, (V, S) in zip((7, 8, 9), ((40, 5), (25, 3), (60, 1))):
        path = str(d / f"sim{seed}.pileup")
        synth_pileup(path, np.random.default_rng(seed), V=V, S=S)
        paths.append(path)
    with open(paths[0], "rb") as src, gzip.open(paths[0] + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return paths


@pytest.mark.parametrize("seed", [0, 3])
def test_write_pileup_is_byte_identical_to_jax(seed, tmp_path):
    data = synth.generate(V=40, S=6, G=3, coverage=8.0, seed=seed).data
    data.counts[3, 2] = 0   # a zero-depth sample
    ours, theirs = str(tmp_path / "ours.pileup"), str(tmp_path / "theirs.pileup")
    pileup.write_pileup(ours, data, seed=seed)
    jpileup.write_pileup(theirs, data, seed=seed)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _same(pileup.read_pileup(ours, samples=data.samples), data)


@pytest.mark.parametrize("min_baseq", [0, 35])
@pytest.mark.parametrize("which", [0, 1, 2, "gz"])
def test_parsers_match_jax(pileups, which, min_baseq):
    path = pileups[0] + ".gz" if which == "gz" else pileups[which]
    want = jpileup.read_pileup_py(pileups[0] if which == "gz" else path,
                                  min_baseq=min_baseq)
    for prefer_native in (True, False):
        _same(pileup.read_pileup(path, min_baseq=min_baseq,
                                 prefer_native=prefer_native), want)
    if which != "gz":
        _same(pileup.read_pileup_py(path, min_baseq=min_baseq), want)
        _same(native.read_pileup_native(path, min_baseq=min_baseq), want)
    if min_baseq:
        assert want.counts.sum() < jpileup.read_pileup_py(
            pileups[0] if which == "gz" else path).counts.sum()


def test_zero_depth_sample(tmp_path):
    path = tmp_path / "z.pileup"
    path.write_text("c\t1\tA\t0\t*\t*\t2\t.T\tII\nc\t2\tC\t1\t,\tI\t0\t*\t*\n")
    want = jpileup.read_pileup_py(str(path))
    assert want.counts[0, 0].sum() == 0 and want.counts[1, 1].sum() == 0
    for prefer_native in (True, False):
        _same(pileup.read_pileup(str(path), prefer_native=prefer_native), want)


MALFORMED = {
    "fields": "c\t1\tA\t1\t.\n",
    "dangling": "c\t1\tA\t1\t.^\tI\n",
    "qual_short": "c\t1\tA\t2\t..\tI\n",
    "indel": "c\t1\tA\t1\t.+\tI\n",
    "symbol": "c\t1\tA\t1\t!\tI\n",
    "samples": "c\t1\tA\t1\t.\tI\nc\t2\tA\t1\t.\tI\t1\t.\tI\n",
    "position": "c\tabc\tA\t1\t.\tI\n",
    "empty": "# only a comment\n",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_input_gives_jax_messages(name, tmp_path):
    path = tmp_path / f"{name}.pileup"
    path.write_text(MALFORMED[name])
    with pytest.raises(ValueError) as theirs:
        jpileup.read_pileup_py(str(path))
    with pytest.raises(ValueError) as ours:
        pileup.read_pileup(str(path), prefer_native=False)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as theirs:
        jnative.read_pileup_native(str(path))
    with pytest.raises(ValueError) as ours:
        pileup.read_pileup(str(path))
    assert str(ours.value) == str(theirs.value)
    gz = str(path) + ".gz"
    with open(path, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    with pytest.raises(ValueError) as ours:
        pileup.read_pileup(gz)
    assert str(ours.value).startswith(f"{gz}: ")   # not the temporary file


def test_sample_names_and_gene_restriction_match_jax(tmp_path):
    names = tmp_path / "names.txt"
    for text in ("s1\ns2\n s3 \n", "s1,s2\ts3\n"):
        names.write_text(text)
        assert pileup.read_sample_names(str(names)) == \
            jpileup.read_sample_names(str(names)) == ["s1", "s2", "s3"]
    rng = np.random.default_rng(5)
    V = 200
    data = io.CountsData(
        counts=rng.integers(0, 5, size=(V, 3, 4)).astype(np.int32),
        contigs=np.array([f"c{i % 4}" for i in range(V)], dtype=object),
        positions=np.asarray(rng.integers(0, 500, size=V), dtype=np.int64),
        samples=["a", "b", "c"])
    kw = dict(names=[f"g{i}" for i in range(10)],
              contigs=np.array([f"c{i % 4}" for i in range(10)], dtype=object),
              starts=np.asarray(rng.integers(0, 400, size=10), dtype=np.int64),
              ends=np.asarray(rng.integers(400, 520, size=10), dtype=np.int64))
    sub, labels = pileup.restrict_to_genes(data, genecov.GeneTable(**kw))
    jsub, jlabels = jpileup.restrict_to_genes(data, JGeneTable(**kw))
    _same(sub, jsub)
    assert list(labels) == list(jlabels) and len(labels) > 0


HEADERS = {
    "dash": ("Contig,Position", "-", "\n"),
    "dot": ("contig,position", ".", "\n"),
    "underscore": ("CONTIG,POSITION", "_", "\n"),
    "crlf": ("Contig,Position", "-", "\r\n"),
}


@pytest.mark.parametrize("form", sorted(HEADERS) + ["gz", "empty_body"])
def test_native_counts_reader_equals_python(form, tmp_path):
    """On every header form the port accepts, the C++ reader gives what
    the Python reader and the JAX package's pandas reader give."""
    first, sep, eol = HEADERS.get(form, HEADERS["dash"])
    data = synth.generate(V=0 if form == "empty_body" else 30, S=3, G=2,
                          coverage=9.0, seed=1).data
    names = ["s.1", "s-2", "s_3"]
    lines = [",".join([first] + [f"{n}{sep}{b}" for n in names for b in "ACGT"])]
    for c, p, row in zip(data.contigs, data.positions, data.counts.reshape(data.V, 4 * data.S)):
        lines.append(",".join([str(c), str(p), *map(str, row)]))
    path = str(tmp_path / "counts.csv")
    with open(path, "w", newline="") as f:
        f.write(eol.join(lines) + eol)
    if form == "gz":
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        path += ".gz"
    got = io.read_counts_csv(path)
    py = io.read_counts_csv(path, prefer_native=False)
    _same(got, py)
    if form != "gz":
        _same(native.read_counts_csv_native(path), py)
    theirs = jio.read_counts_csv(path, prefer_native=False)
    assert got.samples == names == list(theirs.samples)
    assert np.array_equal(got.counts, theirs.counts)
    assert np.array_equal(got.positions, theirs.positions)
    assert [str(c) for c in got.contigs] == [str(c) for c in theirs.contigs]


@pytest.mark.parametrize("text,says", [
    ("Contig,Position,a-A,a-C,a-G,b-A,b-C,b-G,b-T\nc,1,1,2,3,4,5,6,7\n",
     "sample 'a' missing base column T"),
    ("Contig,Position,a-A,a-C,a-G,a-X\nc,1,1,2,3,4\n", "does not look like"),
    ("Contig,Position,a-A,a-C,a-G,a-T\nc,1,1,2,3\n", "every row must have"),
    ('Contig,Position,a-A,a-C,a-G,a-T\n"c1",1,1,2,3,4\n', None),
])
def test_counts_reader_errors_fall_through_to_python(text, says, tmp_path):
    """A parse error of the C++ reader (or a file it would misread: a
    missing base column, a quoted field) falls through to the Python
    reader, whose message or result stands."""
    path = str(tmp_path / "c.csv")
    with open(path, "w") as f:
        f.write(text)
    if says is None:
        _same(io.read_counts_csv(path), io.read_counts_csv(path, prefer_native=False))
        assert list(io.read_counts_csv(path).contigs) == ["c1"]
        return
    with pytest.raises(ValueError) as ours:
        io.read_counts_csv(path)
    with pytest.raises(ValueError) as python:
        io.read_counts_csv(path, prefer_native=False)
    assert str(ours.value) == str(python.value) and says in str(ours.value)


BAD_CELLS = {"empty": "", "decimal": "2.5", "exponent": "1e3", "junk": "5x",
             "negative": "-3", "space": " 4"}
# what the default reader (C++ first) gives for a=[1, 2, 3, 4] with the
# cell in a-C ("middle") or a-T ("last"), None for a ValueError: the C++
# reader reads an empty cell as 0 and, in the last column only, stops at
# the first non-digit; elsewhere its parse error falls through to Python
MALFORMED_READS = {
    ("middle", "empty"): [1, 0, 3, 4], ("last", "empty"): [1, 2, 3, 0],
    ("middle", "decimal"): [1, 2, 3, 4], ("last", "decimal"): [1, 2, 3, 2],
    ("middle", "exponent"): [1, 1000, 3, 4], ("last", "exponent"): [1, 2, 3, 1],
    ("middle", "junk"): None, ("last", "junk"): [1, 2, 3, 5],
    ("middle", "negative"): [1, -3, 3, 4], ("last", "negative"): [1, 2, 3, -3],
    ("middle", "space"): [1, 4, 3, 4], ("last", "space"): [1, 2, 3, 4],
}


@pytest.mark.parametrize("where,cell", sorted(MALFORMED_READS))
def test_malformed_counts_cells_read_as_jax_reads_them(where, cell, tmp_path):
    """A malformed count cell reads as the JAX package's default reader
    (its C++ reader first, pandas after) reads it, which is the same C++
    source: the values pinned in MALFORMED_READS. Where the JAX reader
    raises, so does the port's (its message is the Python reader's)."""
    row = ["c", "7", "1", "2", "3", "4"]
    row[3 if where == "middle" else 5] = BAD_CELLS[cell]
    path = str(tmp_path / "c.csv")
    with open(path, "w") as f:
        f.write("Contig,Position,a-A,a-C,a-G,a-T\n" + ",".join(row) + "\n")
    want = MALFORMED_READS[where, cell]
    if want is None:
        with pytest.raises(ValueError):
            jio.read_counts_csv(path)
        with pytest.raises(ValueError, match="could not convert"):
            io.read_counts_csv(path)
        return
    got = io.read_counts_csv(path)
    assert got.counts.ravel().tolist() == want
    _same(got, jio.read_counts_csv(path))


def _gene_table(tmp_path):
    genes = tmp_path / "genes.csv"
    genes.write_text("gene,contig,start,end\ngeneA,contig_0,100,120\n"
                     "geneB,contig_1,100,140\ngeneC,contig_9,1,5\n")
    return str(genes)


@pytest.mark.parametrize("extra", [[], ["-G"], ["-G", "none"], ["-q", "35", "--python"]],
                         ids=["plain", "genes", "no_gene_position", "python_q35"])
def test_extract_cli_writes_jax_files(pileups, extra, tmp_path):
    """extract writes byte for byte the counts CSV (and gene coverage) of
    the JAX CLI, also where the genes cover no position (a header alone)."""
    names = tmp_path / "names.txt"
    names.write_text("".join(f"sample_{i}\n" for i in range(5)))
    args = [pileups[0], "-n", str(names)]
    if extra == ["-G", "none"]:
        genes = tmp_path / "far.csv"
        genes.write_text("gene,contig,start,end\nfar,contig_0,5000,6000\n")
        args += ["-G", str(genes)]
    elif extra == ["-G"]:
        args += ["-G", _gene_table(tmp_path)]
    else:
        args += extra
    outs = {}
    for who in ("ours", "theirs"):
        o = tmp_path / who
        o.mkdir()
        argv = [*args, "-o", str(o / "counts.csv")]
        if extra[:1] == ["-G"]:
            argv += ["--gene_cov", str(o / "gene_cov.csv")]
        main = cli.main if who == "ours" else jcli.main
        assert main(["extract", *argv]) == 0
        outs[who] = o
    files = ["counts.csv"] + (["gene_cov.csv"] if extra[:1] == ["-G"] else [])
    for f in files:
        with open(outs["ours"] / f, "rb") as a, open(outs["theirs"] / f, "rb") as b:
            assert a.read() == b.read(), f
    got = io.read_counts_csv(str(outs["ours"] / "counts.csv"))
    assert got.samples == [f"sample_{i}" for i in range(5)]
    assert (got.V == 0) == (extra == ["-G", "none"])


def test_extract_gene_cov_needs_genes(pileups, tmp_path, capsys):
    assert cli.main(["extract", pileups[0], "--gene_cov", str(tmp_path / "g.csv"),
                     "-o", str(tmp_path / "c.csv")]) == 2
    assert "--gene_cov requires -G/--genes" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "c.csv")


def test_libraries_land_in_the_build_dir():
    """The readers are built from native/*.cpp into build/desman_tpu_torch/
    and never load the JAX package's libraries."""
    io.read_counts_csv(os.path.join(REPO, "TestData", "variant_counts.csv"))
    assert native.pileup_available() and native.available()
    build = os.path.join(REPO, "build", "desman_tpu_torch")
    for name in ("countsio", "pileupio"):
        path = native.library_path(name)
        assert os.path.dirname(path) == build and path.exists()
        assert os.path.basename(path).startswith(f"lib{name}.")
        loaded = native._libraries[name]._name
        assert os.path.realpath(loaded) == os.path.realpath(path)
        assert os.path.dirname(os.path.realpath(loaded)) != \
            os.path.join(REPO, "desman_tpu")


def test_failed_build_raises_and_never_falls_back(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "countsio.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libraries", {})
    csv = os.path.join(REPO, "TestData", "variant_counts.csv")
    with pytest.raises(RuntimeError, match="g[+][+] failed") as e:
        io.read_counts_csv(csv)
    assert "countsio.cpp" in str(e.value)
    assert not native.available()
    assert not list((tmp_path / "build").glob("*.so"))
    # the Python reader stays available when asked for
    assert io.read_counts_csv(csv, prefer_native=False).V == 2000
