"""The port's strain FASTA writer (``desman_tpu_torch.strainfasta`` and the
``strainfasta`` subcommand) against the JAX package's: both modes byte for
byte, on a hand-made case and on a run's calls, and the same errors."""
import numpy as np
import pytest

from desman_tpu import cli as jcli
from desman_tpu import strainfasta as jsf
from desman_tpu_torch import cli, io, strainfasta


@pytest.fixture()
def tau_files(tmp_path):
    """Two contigs and one without calls; 3 variant positions; 2 strains."""
    tau_idx = np.array([[0, 3], [1, 1], [2, 0]])
    contigs = np.array(["c1", "c1", "c2"], dtype=object)
    positions = np.array([2, 4, 1])
    tau_csv = tmp_path / "Filtered_Tau_star.csv"
    io.write_tau_star_csv(str(tau_csv), tau_idx, contigs, positions)
    ref = tmp_path / "bin.fasta"
    ref.write_text(">c1 descr\nTTTTTT\n>c2\nCCC\n>c3_novars\nAAAA\n")
    return str(tau_csv), str(ref), tau_idx


@pytest.fixture()
def long_calls(tmp_path):
    """A run's worth of calls: 4 strains over 250 positions of 3 contigs of
    several hundred bases (lines wrap at 80)."""
    rng = np.random.default_rng(4)
    lengths = {"ctgA": 301, "ctgB": 170, "ctgC": 95}
    ref = tmp_path / "ref.fasta"
    with open(ref, "w") as f:
        for name, n in lengths.items():
            seq = "".join(rng.choice(list("ACGT"), n))
            f.write(f">{name} len={n}\n")
            for i in range(0, n, 60):
                f.write(seq[i:i + 60] + "\n")
    keys = sorted({(c, int(p)) for c in lengths
                   for p in rng.integers(1, lengths[c] + 1, 90)})[:250]
    contigs = np.array([c for c, _ in keys], dtype=object)
    positions = np.array([p for _, p in keys])
    tau_csv = tmp_path / "calls.csv"
    io.write_tau_star_csv(str(tau_csv), rng.integers(0, 4, (len(keys), 4)),
                          contigs, positions)
    return str(tau_csv), str(ref)


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("full", [True, False], ids=["full", "variants"])
@pytest.mark.parametrize("case", ["tau_files", "long_calls"])
def test_both_modes_are_byte_identical_to_jax(case, full, request, tmp_path):
    tau_csv, ref = request.getfixturevalue(case)[:2]
    ref = ref if full else None
    ours, theirs = str(tmp_path / "ours.fa"), str(tmp_path / "theirs.fa")
    G = strainfasta.write_strain_fasta(tau_csv, ours, ref_fasta=ref)
    assert G == jsf.write_strain_fasta(tau_csv, theirs, ref_fasta=ref)
    assert _same_file(ours, theirs)
    # the CLIs too
    argv = [tau_csv] + (["-f", ref] if ref else [])
    assert cli.main(["strainfasta", *argv, "-o", ours]) == 0
    assert jcli.main(["strainfasta", *argv, "-o", theirs]) == 0
    assert _same_file(ours, theirs)


def test_sequences_carry_the_calls(tau_files):
    tau_csv, ref, tau_idx = tau_files
    idx, contigs, positions = io.read_tau_star_csv(tau_csv)
    assert np.array_equal(idx, tau_idx)
    seqs = strainfasta.strain_sequences(idx, contigs, positions,
                                        strainfasta.read_fasta(ref))
    assert seqs == jsf.strain_sequences(idx, contigs, positions, jsf.read_fasta(ref))
    assert (seqs[0]["c1"], seqs[0]["c2"], seqs[1]["c1"], seqs[1]["c2"]) == \
        ("TATCTT", "GCC", "TTTCTT", "ACC")
    assert seqs[0]["c3_novars"] == seqs[1]["c3_novars"] == "AAAA"
    assert strainfasta.variant_haplotypes(tau_idx) == ["ACG", "TCA"] == \
        jsf.variant_haplotypes(tau_idx)


@pytest.mark.parametrize("fasta,says", [
    (">c1\nTT\n>c2\nCCC\n", "outside contig"),
    (">c1\nTTTTTT\n", "not in reference"),
    (">\nACGT\n", "empty FASTA header"),
], ids=["out_of_range", "missing_contig", "bare_header"])
def test_errors_match_jax(fasta, says, tau_files, tmp_path):
    tau_csv = tau_files[0]
    bad = tmp_path / "bad.fasta"
    bad.write_text(fasta)
    with pytest.raises(ValueError) as theirs:
        jsf.write_strain_fasta(tau_csv, str(tmp_path / "j.fa"), ref_fasta=str(bad))
    with pytest.raises(ValueError) as ours:
        strainfasta.write_strain_fasta(tau_csv, str(tmp_path / "p.fa"),
                                       ref_fasta=str(bad))
    assert str(ours.value) == str(theirs.value) and says in str(ours.value)
