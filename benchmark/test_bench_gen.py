"""The benchmark's frozen generators draw what the port's own generators
draw, bit for bit, at a small size (the port's ``synth`` and
``complete_example``; no card needed)."""
import numpy as np
import pytest

from benchmark import gen


@pytest.mark.parametrize("max_alleles", [4, 2])
@pytest.mark.parametrize("seed", [0, 2017, 2**31 + 5])
def test_generate_is_the_ports(seed, max_alleles):
    from desman_tpu_torch import synth

    want = synth.generate(V=300, S=12, G=5, coverage=50.0, error_rate=0.01,
                          gamma_alpha=0.6, seed=seed, max_alleles=max_alleles)
    got = gen.generate(V=300, S=12, G=5, coverage=50.0, error_rate=0.01,
                       gamma_alpha=0.6, seed=seed, max_alleles=max_alleles)
    assert np.array_equal(got.tau, want.tau_idx)
    assert np.array_equal(got.gamma, want.gamma)
    assert np.array_equal(got.eta, want.eta)
    assert np.array_equal(got.counts, want.data.counts)
    assert got.counts.dtype == want.data.counts.dtype


@pytest.mark.parametrize("seed", [1, 2017, 3_000_000_019])
def test_mock_and_genes_are_complete_examples(seed):
    from desman_tpu_torch import complete_example

    sc = complete_example.Scale(200, 16, 5, 8, [0, 1], 250, 60, 0.6, 2)
    t, full, rng = complete_example.mock(sc, seed)
    present, x = complete_example.gene_truth(rng, t, sc.n_genes)
    config = {"generator": {"kind": "mock_community", "V": 200, "S": 16, "G": 5,
                            "coverage": 50.0, "error_rate": 0.005, "gamma_alpha": 0.6,
                            "max_alleles": 2, "n_genes": 60}}
    truth, (g_present, g_x) = gen.draw(config, seed)
    assert np.array_equal(truth.counts, full.counts)
    assert np.array_equal(truth.tau[:200], t.tau_idx)
    assert np.array_equal(truth.gamma, t.gamma)
    assert np.array_equal(g_present, present)
    assert np.array_equal(g_x, x)


def test_monomorphic_truth_is_one_base():
    config = {"generator": {"kind": "mock_community", "V": 50, "S": 4, "G": 3,
                            "coverage": 50.0, "error_rate": 0.005, "gamma_alpha": 0.6,
                            "max_alleles": 2}}
    truth, genes = gen.draw(config, 9)
    assert genes is None
    mono = truth.tau[50:]
    assert (mono == mono[:, :1]).all()
    # the observed base of a monomorphic row is its truth's
    assert np.array_equal(truth.counts[50:].sum(1).argmax(1), mono[:, 0])


def test_counts_csv_reads_back(tmp_path):
    from desman_tpu_torch import io

    t = gen.generate(V=40, S=3, G=2, seed=4)
    path = tmp_path / "c.csv"
    gen.write_counts_csv(str(path), t.counts)
    data = io.read_counts_csv(str(path))
    assert np.array_equal(data.counts, t.counts)
    assert list(data.positions) == list(range(40))
    x = np.arange(6.0).reshape(2, 3) * 1.5
    gpath = tmp_path / "g.csv"
    gen.write_gene_cov_csv(str(gpath), x)
    assert np.array_equal(io.read_gene_cov_csv(str(gpath)).values, x)


def test_item_seeds_differ_and_repeat():
    seeds = {gen.seed_of(2**31 + 11, 1, k) for k in range(100)}
    assert len(seeds) == 100
    assert gen.seed_of(7, 1, 3) == gen.seed_of(7, 1, 3) < 2**63
