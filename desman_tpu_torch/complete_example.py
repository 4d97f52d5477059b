"""The complete_example pipeline end to end on the card.

    python -m desman_tpu_torch.complete_example [--quick | --paper] [--prune]
        [--outdir DIR] [--seed N] [--device cuda|cpu]

The counterpart of the repository's ``examples/complete_example.py``, which
runs the JAX package. It generates the same E. coli-like mock community,
core-gene variant counts plus accessory-gene coverage with known ground
truth, and runs the in-scope pipeline:

    counts CSV -> variant filter -> desman G=1..Gmax x seeds (``fit_grid``,
    kernel ``cuda``) -> resolvenhap model selection -> validateSNP against
    the truth -> GeneAssign accessory-genome recovery

It prints the same five ``[k/5]`` lines, writes ``summary.json`` with the
same keys in the same order, and ends with ``COMPLETE_EXAMPLE PASS`` (exit
0) or ``FAIL`` (exit 1). Scales: ``--quick`` V=200 S=12 G=3; the default
V=1000 S=16 G=5; ``--paper`` the published mock's shape, V=7000 S=64 G=5,
biallelic, 8 G x 5 seeds, 1500 accessory genes. From one seed the mock's
counts CSV is byte for byte the JAX example's.

The default ``--outdir`` is ``complete_example_out_torch``, beside the
committed ``complete_example_out/`` of the JAX run. Without a card it exits
2 unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np

from . import io, synth
from .cli import _add_device, _cuda_missing
from .filter import filter_variants
from .geneassign import GeneAssignConfig, assign_genes, strain_coverage
from .model_selection import fit_grid, resolve_nhap
from .utils import NBASES, match_gamma_perm
from .validation import compare_tau


class Scale(NamedTuple):
    V: int               # variant positions (as many monomorphic ones again)
    S: int
    G_true: int
    gmax: int
    seeds: list
    iterations: int
    n_genes: int
    gamma_alpha: float
    max_alleles: int


SCALES = {
    "quick": Scale(200, 12, 3, 5, [0, 1], 80, 40, 2.0, NBASES),
    "default": Scale(1000, 16, 5, 8, [0, 1, 2], 250, 200, 2.0, NBASES),
    # the published E. coli mock's shape: tens of samples, thousands of core
    # SNVs, 5 strains, skewed per-sample abundances; biallelic positions
    "paper": Scale(7000, 64, 5, 8, [0, 1, 2, 3, 4], 250, 1500, 0.6, 2),
}


def mock(sc: Scale, seed: int):
    """The mock community's core counts: (truth of the variant positions,
    CountsData of all 2V positions, the generator to draw the genes from)."""
    rng = np.random.default_rng(seed)
    t, full = synth.mock_community(V=sc.V, S=sc.S, G=sc.G_true, coverage=50.0,
                                   error_rate=0.005, gamma_alpha=sc.gamma_alpha,
                                   max_alleles=sc.max_alleles, seed=seed, rng=rng)
    return t, full, rng


def gene_truth(rng: np.random.Generator, t: synth.SynthTruth, n_genes: int):
    """Accessory genes: presence/absence in each true strain (every gene in
    at least one) and their Poisson coverage [D,S] from the true strain
    coverages, drawn from `rng` after the mock's counts."""
    total_cov = t.data.counts.sum(2).mean(0)
    etaG_true = rng.integers(0, 2, size=(n_genes, t.gamma.shape[1]))
    etaG_true[etaG_true.sum(1) == 0, 0] = 1
    cov_true = strain_coverage(t.gamma, total_cov)
    x = rng.poisson(np.maximum(etaG_true @ cov_true, 1e-9)).astype(np.float64)
    return etaG_true, x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desman_tpu_torch.complete_example")
    ap.add_argument("--quick", action="store_true", help="small config for CI")
    ap.add_argument("--paper", action="store_true",
                    help="published-mock scale: S=64 samples, ~7k core SNVs, "
                    "G=5 strains, 8G x 5 seeds grid, 1500 accessory genes")
    ap.add_argument("--prune", action="store_true",
                    help="after selection, drop bulky CSVs from non-selected "
                    "run dirs (keep fit.txt/metrics.json)")
    ap.add_argument("--outdir", default="complete_example_out_torch")
    ap.add_argument("--seed", type=int, default=2017)
    _add_device(ap)
    args = ap.parse_args(argv)
    if _cuda_missing("complete_example", args.device):
        return 2

    name = "quick" if args.quick else "paper" if args.paper else "default"
    sc = SCALES[name]
    V, S, G_true = sc.V, sc.S, sc.G_true
    os.makedirs(args.outdir, exist_ok=True)

    # ---- mock community ground truth ----
    t, full, rng = mock(sc, args.seed)
    is_variant = np.concatenate([np.ones(V, bool), np.zeros(V, bool)])
    counts_csv = os.path.join(args.outdir, "core_counts.csv")
    io.write_counts_csv(counts_csv, full)
    print(f"[1/5] mock community: {V} variant + {V} monomorphic positions, "
          f"S={S}, true G={G_true} -> {counts_csv}")

    # ---- variant filter ----
    data = io.read_counts_csv(counts_csv)
    fres = filter_variants(data, device=args.device)
    sel = data.select(np.flatnonzero(fres.selected))
    sens = fres.selected[is_variant].mean()
    fpr = fres.selected[~is_variant].mean()
    io.write_eta_csv(os.path.join(args.outdir, "tran_df.csv"), fres.eta)
    print(f"[2/5] filter: kept {sel.V} positions "
          f"(sensitivity {sens:.3f}, FPR {fpr:.3f}); "
          f"eta max err {np.abs(fres.eta - t.eta).max():.4f}")

    # ---- G-grid + model selection ----
    t0 = time.time()
    records = fit_grid(
        sel.counts, g_values=list(range(1, sc.gmax + 1)), seeds=sc.seeds,
        iterations=sc.iterations, eta_init=fres.eta, fix_eta=True,
        out_stub=os.path.join(args.outdir, "run"), data=sel, device=args.device,
    )
    selres = resolve_nhap(records)
    print(f"[3/5] grid {sc.gmax}G x {len(sc.seeds)} seeds in {time.time()-t0:.1f}s; "
          f"selected G={selres.G} (true {G_true}), "
          f"uncertainty={selres.uncertainty:.4f}")

    # ---- validate haplotypes vs truth ----
    # align on (Contig, Position): the prediction covers the selected
    # positions (true variants + any false positives, which have no truth row)
    pred_tau, pc, pp = io.read_tau_star_csv(
        os.path.join(selres.run_dir, "Filtered_Tau_star.csv"))
    rep = compare_tau(
        pred_tau, t.tau_idx,
        pred_keys=list(zip(map(str, pc), map(int, pp))),
        true_keys=[("synth", i) for i in range(V)],
    )
    gamma_inf = io.read_gamma_csv(os.path.join(selres.run_dir, "Gamma_mean.csv"))
    gmae, (ti, pi) = match_gamma_perm(t.gamma, gamma_inf)
    print(f"[4/5] validate: SNP error rate {rep.error_rate:.5f} "
          f"({rep.snp_errors} errors / {rep.n_positions} positions), "
          f"gamma MAE {gmae:.5f}")

    # ---- accessory genes ----
    total_cov = t.data.counts.sum(2).mean(0)
    cov_inf = strain_coverage(gamma_inf, total_cov)
    etaG_true, x = gene_truth(rng, t, sc.n_genes)
    gres = assign_genes(x, cov_inf, GeneAssignConfig(), device=args.device)
    # inferred strains in the truth's order before scoring
    acc = (gres.eta_star.cpu().numpy()[:, pi] == etaG_true[:, ti]).mean()
    print(f"[5/5] geneassign: presence accuracy {acc:.4f} over {sc.n_genes} genes")

    ok = (selres.G == G_true and rep.error_rate < 0.02 and gmae < 0.02
          and acc > 0.9)
    summary = {
        "scale": name,
        "V_variant": V, "S": S, "G_true": G_true, "gmax": sc.gmax,
        "seeds": sc.seeds, "iterations": sc.iterations, "n_genes": sc.n_genes,
        "filter_sensitivity": round(float(sens), 4),
        "filter_fpr": round(float(fpr), 4),
        "selected_G": selres.G,
        "snv_uncertainty": round(float(selres.uncertainty), 5),
        "snp_errors": int(rep.snp_errors),
        "snp_error_rate": round(float(rep.error_rate), 6),
        "gamma_mae": round(float(gmae), 6),
        "gene_presence_accuracy": round(float(acc), 5),
        "pass": bool(ok),
    }
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)

    if args.prune:
        keep = {"fit.txt", "metrics.json"}
        for d in glob.glob(os.path.join(args.outdir, "run_*")):
            if os.path.abspath(d) == os.path.abspath(selres.run_dir or ""):
                continue
            for fpath in os.listdir(d):
                if fpath not in keep:
                    os.remove(os.path.join(d, fpath))
    print("COMPLETE_EXAMPLE", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
