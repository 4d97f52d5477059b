"""The port's variant filter against the JAX package's (``desman_tpu.filter``)
on TestData and on tests/test_filter.py's mixed dataset, pooled and
per-sample, and the ``filter`` CLI.

Tolerances, with their reasons:
- eta within 1e-6: both refit it from the same integer counts;
- the chi-square tail on the same statistics within rtol 1e-4 (the two
  packages' gammaincc may differ in the last ulps), wherever JAX's value is
  a normal float32 (XLA on the CPU flushes subnormals to zero);
- the statistic LLR = 2 (ll1 - ll0) within atol 2e-3: a difference of two
  f32 log-likelihoods of up to ~1e4 in magnitude, summed in another order,
  so a few of their ulps (~1e-3) apart;
- the filter's p-values within rtol 1e-3 where 1e-30 <= p < 0.5: p carries
  the LLR's error (relative error about half the LLR's absolute error in
  the chi-square tail; 1.05e-4 measured on the mixed dataset), and above
  0.5 the tail's slope at an LLR near 0 is unbounded, so there only the
  LLR is compared;
- ``selected`` identical except at positions whose q lies within 1e-4 of
  the cutoff.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from desman_tpu import cli as jcli
from desman_tpu import filter as jfilter
from desman_tpu import io as jio
from desman_tpu import utils as jutils
from desman_tpu_torch import cli, filter as pfilter, io, utils

from torch_helpers import TESTDATA

TINY = float(np.finfo(np.float32).tiny)


def _mixed():
    """tests/test_filter.py's _mixed_dataset: 80 variant + 120 noise-only
    positions, S=12."""
    import test_filter

    data, _, _ = test_filter._mixed_dataset()
    return data


def _testdata():
    return jio.read_counts_csv(os.path.join(TESTDATA, "variant_counts.csv"))


@pytest.mark.parametrize("per_sample", [False, True], ids=["pooled", "per_sample"])
@pytest.mark.parametrize("dataset", ["testdata", "mixed"])
def test_filter_matches_jax(dataset, per_sample):
    data = _testdata() if dataset == "testdata" else _mixed()
    ours = pfilter.filter_variants(data, pfilter.FilterConfig(per_sample=per_sample),
                                   device="cpu")
    theirs = jfilter.filter_variants(data, jfilter.FilterConfig(per_sample=per_sample))
    assert ours.n_outer_iters == theirs.n_outer_iters
    np.testing.assert_allclose(ours.eta, theirs.eta, rtol=0, atol=1e-6)
    assert np.array_equal(ours.h0_base, theirs.h0_base)
    low = (theirs.pvalues < 0.5) & (theirs.pvalues >= 1e-30)
    np.testing.assert_allclose(ours.pvalues[low], theirs.pvalues[low], rtol=1e-3)
    assert np.array_equal(ours.pvalues < 0.5, theirs.pvalues < 0.5)
    np.testing.assert_allclose(ours.llr, theirs.llr, rtol=1e-5, atol=2e-3)
    near = np.abs(theirs.qvalues - 0.05) <= 1e-4
    assert np.array_equal(ours.selected[~near], theirs.selected[~near])
    assert ours.selected.sum() > 0
    for r in (ours, theirs):
        assert ((r.pvalues >= 0) & (r.pvalues <= 1)).all()


@pytest.mark.parametrize("df", [1.0, 2.0, 5.0])
def test_chi2_tail_matches_jax(df):
    import torch

    llr = np.concatenate([np.linspace(0, 40, 401), [100.0, 150.0, 300.0]]
                         ).astype(np.float32)
    ours = pfilter._chi2_sf(torch.as_tensor(llr), df).numpy()
    theirs = np.asarray(jfilter._chi2_sf(jnp.asarray(llr), df))
    normal = theirs >= TINY
    np.testing.assert_allclose(ours[normal], theirs[normal], rtol=1e-4)
    assert (ours[~normal] < TINY).all()


def test_bh_fdr_and_base_pairs_match_jax():
    rng = np.random.default_rng(0)
    p = np.concatenate([rng.uniform(size=200), rng.uniform(size=20) * 1e-4,
                        [0.5, 0.5, 1.0, 0.0]])
    assert np.array_equal(utils.bh_fdr(p), jutils.bh_fdr(p))
    assert utils.all_base_pairs() == jutils.all_base_pairs()


def test_min_coverage_gate():
    data = _mixed()
    data.counts[0] = 0
    res = pfilter.filter_variants(data, pfilter.FilterConfig(min_coverage=5.0),
                                  device="cpu")
    assert not res.selected[0] and res.qvalues[0] == 1.0 and res.pvalues[0] == 1.0


def test_filter_cli_writes_the_jax_files(tmp_path):
    counts = os.path.join(TESTDATA, "variant_counts.csv")
    ours, theirs = str(tmp_path / "ours_"), str(tmp_path / "theirs_")
    assert cli.main(["filter", counts, "-o", ours, "--device", "cpu"]) == 0
    assert jcli.main(["filter", counts, "-o", theirs]) == 0
    for name in ("sel_var.csv", "tran_df.csv", "log_file.txt"):
        with open(ours + name) as a, open(theirs + name) as b:
            assert a.read() == b.read(), name
    for name, col in (("p_df.csv", "p"), ("q_df.csv", "q")):
        import pandas as pd

        a, b = pd.read_csv(ours + name), pd.read_csv(theirs + name)
        assert list(a.columns) == list(b.columns) == ["Contig", "Position", col]
        assert a["Position"].tolist() == b["Position"].tolist()
        low = b[col] < 0.5
        np.testing.assert_allclose(a[col][low], b[col][low], rtol=1e-3, atol=1e-30)
    assert io.read_counts_csv(ours + "sel_var.csv").V > 0


def test_filter_cli_on_cuda_without_cuda_exits_2(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    rc = cli.main(["filter", os.path.join(TESTDATA, "variant_counts.csv"),
                   "-o", str(tmp_path / "f_")])
    assert rc == 2
    assert "CUDA is not available" in capsys.readouterr().err
