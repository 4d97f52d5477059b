"""One-command pipeline: filter -> G-grid -> selection (counterpart of
``desman_tpu.pipeline``).

A YAML (or JSON) config runs the whole in-scope pipeline on one device and
writes a results tree:

    outdir/
      tran_df.csv  sel_var.csv  p_df.csv  q_df.csv      (filter)
      run_<G>_<seed>/...                                 (grid runs)
      collated_fits.csv  best.txt                        (selection)
      pipeline_summary.json

Config keys (all optional except counts):
    counts: counts.csv
    output_dir: desman_pipeline_out
    filter: {min_coverage: 5.0, q_cutoff: 0.05}
    grid: {g_min: 1, g_max: 8, seeds: [0,1,2], iterations: 250, kernel: cuda,
           fix_eta: true}
    selection: {dev_cutoff: 0.02, unc_cutoff: 0.1}

Not ported yet: the ``genes`` stage (GeneAssign, ROADMAP queue 1 item 10)
and ``grid.auto_samples`` (ESS-targeted sampling, item 11) raise
NotImplementedError before any work. The tables are written with ``io``'s
csv writers (no pandas), in the JAX package's columns.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from . import io
from .filter import FilterConfig, filter_variants
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


def _refuse_unported(config: dict) -> None:
    if config.get("genes"):
        raise NotImplementedError(
            "the pipeline's genes stage (GeneAssign) is not ported yet "
            "(ROADMAP queue 1 item 10)")
    if float(config.get("grid", {}).get("auto_samples", 0.0)) > 0:
        raise NotImplementedError(
            "grid.auto_samples (ESS-targeted sampling) is not ported yet "
            "(ROADMAP queue 1 item 11)")


def run_pipeline(config: dict, device="cuda") -> dict:
    """Run filter -> grid -> selection on `device`; returns the summary
    (also written to pipeline_summary.json)."""
    _refuse_unported(config)
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
        "grid_sweeps": len(g_values) * len(seeds) * iterations,
        "grid_wall_s": grid_wall,
    }
    with open(os.path.join(outdir, "pipeline_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
