"""One-command pipeline: filter -> G-grid -> selection -> (genes)
(counterpart of ``desman_tpu.pipeline``).

A YAML (or JSON) config runs the whole in-scope pipeline on one device and
writes a results tree:

    outdir/
      tran_df.csv  sel_var.csv  p_df.csv  q_df.csv      (filter)
      run_<G>_<seed>/...                                 (grid runs)
      collated_fits.csv  best.txt                        (selection)
      geneassign_etaS_df.csv  geneassign_etaP_df.csv     (genes, optional)
      pipeline_summary.json

Config keys (all optional except counts):
    counts: counts.csv
    output_dir: desman_pipeline_out
    filter: {min_coverage: 5.0, q_cutoff: 0.05}
    grid: {g_min: 1, g_max: 8, seeds: [0,1,2], iterations: 250, kernel: cuda,
           fix_eta: true, auto_samples: 0, auto_max_samples: 2000}
    selection: {dev_cutoff: 0.02, unc_cutoff: 0.1}
    genes: {coverage_csv: gene_cov.csv, max_copy: 1, model: quasipoisson}

grid.auto_samples > 0 extends each G's sampling until every chain's
post-burn ESS reaches it (``fit_grid``'s ess_target, capped at
auto_max_samples). The genes stage assigns the accessory genes of
coverage_csv to the selected run's strains (its Gamma_mean.csv), with each
sample's total coverage from all the input counts. The tables are written
with ``io``'s csv writers (no pandas), in the JAX package's columns.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from . import io
from .filter import FilterConfig, filter_variants
from .geneassign import (
    GeneAssignConfig, assign_genes, sample_total_coverage, strain_coverage,
)
from .model_selection import fit_grid, resolve_nhap


def load_config(path: str) -> dict:
    """YAML if the yaml module is importable, else JSON."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return json.loads(text)
    return yaml.safe_load(text)


def _run_sweeps(run_dir: str) -> int:
    with open(os.path.join(run_dir, "metrics.json")) as f:
        return int(json.load(f)["sweeps"])


def run_pipeline(config: dict, device="cuda") -> dict:
    """Run filter -> grid -> selection (-> genes) on `device`; returns the
    summary (also written to pipeline_summary.json)."""
    outdir = config.get("output_dir", "desman_pipeline_out")
    os.makedirs(outdir, exist_ok=True)
    data = io.read_counts_csv(config["counts"])

    # ---- filter ----
    fres = filter_variants(data, FilterConfig(**config.get("filter", {})),
                           device=device)
    sel = data.select(np.flatnonzero(fres.selected))
    io.write_counts_csv(os.path.join(outdir, "sel_var.csv"), sel)
    io.write_eta_csv(os.path.join(outdir, "tran_df.csv"), fres.eta)
    io.write_position_csv(os.path.join(outdir, "p_df.csv"), data, "p", fres.pvalues)
    io.write_position_csv(os.path.join(outdir, "q_df.csv"), data, "q", fres.qvalues)

    # ---- grid ----
    grid = config.get("grid", {})
    g_values = list(range(int(grid.get("g_min", 1)), int(grid.get("g_max", 8)) + 1))
    seeds = [int(s) for s in grid.get("seeds", [0, 1, 2])]
    iterations = int(grid.get("iterations", 250))
    t0 = time.time()
    records = fit_grid(
        sel.counts, g_values=g_values, seeds=seeds, iterations=iterations,
        eta_init=fres.eta, fix_eta=bool(grid.get("fix_eta", True)),
        out_stub=os.path.join(outdir, "run"), data=sel,
        kernel=grid.get("kernel", "cuda"), device=device,
        ess_target=float(grid.get("auto_samples", 0.0)),
        max_samples=int(grid.get("auto_max_samples", 2000)),
    )
    grid_wall = time.time() - t0
    fields = ["G", "seed", "mean_deviance", "uncertainty", "run_dir"]
    io.write_rows(os.path.join(outdir, "collated_fits.csv"), fields,
                  (["" if getattr(r, k) is None else str(getattr(r, k))
                    for k in fields] for r in records))

    # ---- selection ----
    scfg = config.get("selection", {})
    selres = resolve_nhap(
        records, dev_cutoff=float(scfg.get("dev_cutoff", 0.02)),
        unc_cutoff=float(scfg.get("unc_cutoff", 0.1)),
    )
    with open(os.path.join(outdir, "best.txt"), "w") as f:
        f.write("G,seed,uncertainty,mean_deviance,run_dir\n")
        f.write(selres.summary_line() + "\n")

    summary = {
        "V_total": int(data.V),
        "V_selected": int(sel.V),
        "selected_G": selres.G,
        "best_seed": selres.seed,
        "uncertainty": selres.uncertainty,
        "mean_deviance": selres.mean_deviance,
        "best_run_dir": selres.run_dir,
        "grid_runs": len(records),
        # each run's own count: with grid.auto_samples sampling lengths differ
        "grid_sweeps": sum(_run_sweeps(r.run_dir) for r in records),
        "grid_wall_s": grid_wall,
    }

    # ---- genes (optional) ----
    genes = config.get("genes")
    if genes:
        t0 = time.time()
        gene_cov = io.read_gene_cov_csv(genes["coverage_csv"])
        gamma = io.read_gamma_csv(os.path.join(selres.run_dir, "Gamma_mean.csv"))
        cov = strain_coverage(gamma, sample_total_coverage(data.counts))
        gres = assign_genes(gene_cov.values, cov, GeneAssignConfig(
            max_copy=int(genes.get("max_copy", 1)),
            model=genes.get("model", "quasipoisson"),
        ), device=device)
        cols = [f"H{g + 1}" for g in range(gamma.shape[1])]
        for name, table in (("etaS", gres.eta_star), ("etaP", gres.presence_prob)):
            io.write_gene_table(
                os.path.join(outdir, f"geneassign_{name}_df.csv"), gene_cov.names,
                cols, table.cpu().numpy(), gene_cov.index_label)
        summary["genes_assigned"] = len(gene_cov.names)
        summary["genes_wall_s"] = time.time() - t0

    with open(os.path.join(outdir, "pipeline_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
