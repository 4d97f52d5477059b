"""Generate the quickstart dataset, TestData, without jax.

    python -m desman_tpu_torch.make_testdata OUTDIR

The counterpart of the repository's ``scripts/make_testdata.py``: the same
draws write the same four files, byte for byte, into OUTDIR:
``variant_counts.csv`` (1000 variant positions of a G=5 mixture over S=16
samples, then 1000 monomorphic ones, on one contig), ``true_tau.csv`` (the
variant positions' haplotypes), ``true_gamma.csv`` and ``true_eta.csv``.
Pass the committed ``TestData`` directory to regenerate it in place. No
device is involved.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import io, synth

V, S, G = 1000, 16, 5
SEED = 2017   # the DESMAN paper year
FILES = ("variant_counts.csv", "true_tau.csv", "true_gamma.csv", "true_eta.csv")


def write(outdir: str) -> None:
    """Write the four TestData files into outdir."""
    os.makedirs(outdir, exist_ok=True)
    t = synth.generate(V=V, S=S, G=G, coverage=40.0, error_rate=0.005,
                       gamma_alpha=2.0, seed=SEED)
    # an equal number of monomorphic positions: realistic input for the
    # filter, which learns eta from exactly these
    rng = np.random.default_rng(SEED)
    mono_base = rng.integers(0, 4, size=V)
    mono = rng.poisson(
        40.0 * t.eta[mono_base][:, None, :].repeat(S, axis=1)
    ).astype(np.int32)
    full = io.CountsData(
        counts=np.concatenate([t.data.counts, mono], axis=0),
        contigs=np.array(["contig_test"] * (2 * V)),
        positions=np.arange(2 * V),
        samples=t.data.samples,
    )
    io.write_counts_csv(os.path.join(outdir, "variant_counts.csv"), full)
    # the truth covers the variant positions (0..V-1) only
    io.write_tau_star_csv(os.path.join(outdir, "true_tau.csv"), t.tau_idx,
                          np.array(["contig_test"] * V), np.arange(V))
    io.write_gamma_csv(os.path.join(outdir, "true_gamma.csv"), t.gamma,
                       t.data.samples)
    io.write_eta_csv(os.path.join(outdir, "true_eta.csv"), t.eta)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desman_tpu_torch.make_testdata")
    ap.add_argument("outdir", help="directory for the four files (TestData "
                                   "to regenerate the committed copy)")
    args = ap.parse_args(argv)
    write(args.outdir)
    print(f"wrote TestData: {V} variant + {V} monomorphic positions, "
          f"S={S}, G={G} -> {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
