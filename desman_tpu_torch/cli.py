"""Command-line entry point of the PyTorch port.

    python -m desman_tpu_torch desman counts.csv -g 5 -o out [--device cuda]
    python -m desman_tpu_torch filter counts.csv -o filtered_
    python -m desman_tpu_torch pipeline config.yaml
    python -m desman_tpu_torch resolvenhap 'out/run_*'
    python -m desman_tpu_torch collate 'out/run_*' -o collated_fits.csv

    desman       tau/gamma/eta Gibbs deconvolution (--chains, --kernel
                 cuda|cuda_resident|cuda_topk|torch)
    filter       variant-position LLR filter -> sel_var/p/q/tran_df CSVs
    pipeline     filter -> G-grid -> selection from one YAML/JSON config
    resolvenhap  pick the number of strains from a run grid (-c copies)
    collate      one CSV of a run grid's fit records

The JAX package's other subcommands and run-mode flags exit with code 2 and
name the ROADMAP item that will port them; none is silently ignored.
``--device cuda`` (the default) never falls back to the CPU: without CUDA it
exits with code 2. ``--kernel cuda_topk`` on counts with a cell of more
than two observed bases exits with code 1 and says so; it never switches to
the full kernel.
"""
from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import sys

# flag -> the ROADMAP queue-1 item that ports it
_WAITING_FLAGS = {
    "--store_every": "3 (stored draws)",
    "-t": "5 (em_gamma, known-haplotype start)",
    "--tau_init": "5 (em_gamma, known-haplotype start)",
    "-f": "5 (em_gamma, known-haplotype start)",
    "--tau_fixed": "5 (em_gamma, known-haplotype start)",
    "--checkpoint": "11 (checkpoints)",
    "--checkpoint_every": "11 (checkpoints)",
    "--auto_burn": "11 (auto-length)",
    "--auto_tol": "11 (auto-length)",
    "--auto_max_burn": "11 (auto-length)",
    "--auto_samples": "11 (auto-length)",
    "--auto_max_samples": "11 (auto-length)",
    "--pt": "12 (parallel tempering)",
    "--pt_max_temp": "12 (parallel tempering)",
    "--profile": "13 (profiling)",
    "--mesh": "14 (multi-GPU)",
}

# the JAX package's other subcommands -> the ROADMAP queue-1 item
_WAITING_COMMANDS = {
    "geneassign": "10 (GeneAssign)",
    "multibin": "13 (remaining surface)",
    "diag": "13 (remaining surface)",
    "genecov": "13 (remaining surface)",
    "extract": "13 (remaining surface)",
    "validate": "13 (remaining surface)",
    "strainfasta": "13 (remaining surface)",
}


def _expand_dirs(patterns) -> list:
    """Glob-expand run-dir patterns, deduplicated, order-preserving."""
    seen = set()
    dirs = []
    for pat in patterns:
        hits = sorted(globlib.glob(pat))
        for d in hits if hits else [pat]:
            key = os.path.normpath(os.path.abspath(d))
            if key not in seen:
                seen.add(key)
                dirs.append(d)
    return dirs


def _cuda_missing(prog: str, device: str) -> bool:
    """Report and return True when `device` is cuda and CUDA is missing."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: --device cuda requested but CUDA is not available "
              "(use --device cpu to run on the CPU)", file=sys.stderr)
        return True
    return False


def _add_device(ap) -> None:
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the work runs; cuda never falls back to cpu")


def _waiting_flag(argv) -> str:
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in _WAITING_FLAGS:
            return flag
    return ""


def _desman(argv) -> int:
    flag = _waiting_flag(argv)
    if flag:
        print(f"desman: {flag} is not ported to desman_tpu_torch yet "
              f"(ROADMAP queue 1 item {_WAITING_FLAGS[flag]})", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(
        prog="desman",
        description="Strain deconvolution (tau/gamma/eta Gibbs sampler), PyTorch/CUDA")
    ap.add_argument("variant_file", help="counts CSV: Contig,Position,<sample>-A..T")
    ap.add_argument("-g", "--num_strains", type=int, required=True)
    ap.add_argument("-e", "--eta_file", default=None,
                    help="tran_df.csv from the filter; fixes eta unless --sample_eta")
    ap.add_argument("-o", "--output_dir", default="desman_out")
    ap.add_argument("-i", "--iterations", type=int, default=250)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-r", "--random_positions", type=int, default=0,
                    help="subsample this many positions (0 = all)")
    ap.add_argument("-m", "--min_coverage", type=float, default=0.0)
    ap.add_argument("--sample_eta", action="store_true",
                    help="sample eta even when -e seeds it")
    ap.add_argument("--kappa_gamma", type=float, default=0.0,
                    help="gamma MH proposal concentration (0 = auto)")
    ap.add_argument("--kappa_eta", type=float, default=0.0,
                    help="eta MH proposal concentration (0 = auto)")
    ap.add_argument("--eta_update", choices=["joint", "rows"], default="joint",
                    help="error-matrix MH (only 'joint' is ported)")
    ap.add_argument("--chains", type=int, default=1,
                    help="independent chains (seeds seed..seed+chains-1), run "
                    "one after another; the best by star likelihood is "
                    "written, with chains.json")
    _add_device(ap)
    ap.add_argument("--kernel",
                    choices=["cuda", "cuda_resident", "cuda_topk", "torch"],
                    default="cuda",
                    help="cuda: the hand-written tau-sweep and swap kernels; "
                    "cuda_resident: the whole sweep's [V]-sized work in two "
                    "kernel launches (the tau sweep, swap and gamma-MH "
                    "likelihoods fused, then gamma apply + eta likelihood); "
                    "cuda_topk: cuda with the top-2 tau kernel, half the "
                    "logs, for counts whose every cell observes at most two "
                    "bases (refuses other counts); "
                    "torch: the plain PyTorch versions (on a cpu device "
                    "cuda and torch are the same)")
    args = ap.parse_args(argv)
    if args.eta_update != "joint":
        print("desman: --eta_update rows is not ported to desman_tpu_torch yet "
              "(ROADMAP queue 1 item 3 (per-row eta MH))", file=sys.stderr)
        return 2
    if _cuda_missing("desman", args.device):
        return 2

    from . import io
    from .ops import TopkInapplicable
    from .run import RunConfig, run, run_multi

    data = io.read_counts_csv(args.variant_file)
    rc = RunConfig(
        G=args.num_strains, iterations=args.iterations, seed=args.seed,
        eta_file=args.eta_file, sample_eta=args.sample_eta,
        min_coverage=args.min_coverage, n_positions=args.random_positions,
        out_dir=args.output_dir, kappa_gamma=args.kappa_gamma,
        kappa_eta=args.kappa_eta, eta_update=args.eta_update,
    )
    try:
        if args.chains > 1:
            run_multi(data, rc, n_chains=args.chains, device=args.device,
                      kernel=args.kernel)
        else:
            run(data, rc, device=args.device, kernel=args.kernel)
    except TopkInapplicable as e:
        print(f"desman: --kernel cuda_topk cannot take {args.variant_file}: {e} "
              "(--kernel cuda)", file=sys.stderr)
        return 1
    print(f"desman: wrote {args.output_dir}/fit.txt")
    return 0


def _filter(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-filter", description="Variant-position LLR filter")
    ap.add_argument("counts_file")
    ap.add_argument("-o", "--output_stub", default="filtered_")
    ap.add_argument("-m", "--min_coverage", type=float, default=5.0)
    ap.add_argument("-q", "--q_cutoff", type=float, default=0.05)
    ap.add_argument("-p", "--p_cutoff", type=float, default=0.0,
                    help="select on raw p-values instead of BH q (0 = off)")
    ap.add_argument("-f", "--max_iterations", type=int, default=8,
                    help="outer eta re-estimation rounds")
    ap.add_argument("--chi2_df", type=float, default=0.0,
                    help="LRT degrees of freedom (0 = auto: 1)")
    ap.add_argument("--per_sample", action="store_true",
                    help="H1 mixture fraction free per sample: detects "
                    "variants present in few samples that the pooled "
                    "test dilutes")
    _add_device(ap)
    args = ap.parse_args(argv)
    if _cuda_missing("filter", args.device):
        return 2

    import numpy as np

    from . import io
    from .filter import FilterConfig, filter_variants

    data = io.read_counts_csv(args.counts_file)
    cfg = FilterConfig(
        min_coverage=args.min_coverage, q_cutoff=args.q_cutoff,
        p_cutoff=args.p_cutoff, max_outer_iters=args.max_iterations,
        chi2_df=args.chi2_df, per_sample=args.per_sample,
    )
    res = filter_variants(data, cfg, device=args.device)
    stub = args.output_stub
    io.write_counts_csv(stub + "sel_var.csv", data.select(np.flatnonzero(res.selected)))
    io.write_eta_csv(stub + "tran_df.csv", res.eta)
    io.write_position_csv(stub + "p_df.csv", data, "p", res.pvalues)
    io.write_position_csv(stub + "q_df.csv", data, "q", res.qvalues)
    with open(stub + "log_file.txt", "w") as f:
        f.write(f"positions={data.V} selected={int(res.selected.sum())} "
                f"outer_iters={res.n_outer_iters}\n")
    print(f"filter: {int(res.selected.sum())}/{data.V} variants -> {stub}sel_var.csv")
    return 0


_CHOSEN_FILES = ("Filtered_Tau_star.csv", "Tau_mean.csv", "Gamma_mean.csv",
                 "Gamma_star.csv", "Eta_mean.csv", "Eta_star.csv", "fit.txt")


def _resolvenhap(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-resolvenhap",
        description="Pick the number of strains from a grid of run dirs")
    ap.add_argument("run_dirs", nargs="+",
                    help="run output dirs (globs ok), e.g. out_stub_*")
    ap.add_argument("-d", "--dev_cutoff", type=float, default=0.02,
                    help="relative deviance-improvement elbow cutoff")
    ap.add_argument("-u", "--unc_cutoff", type=float, default=0.1)
    ap.add_argument("-o", "--output_file", default=None)
    ap.add_argument("-c", "--copy_dir", default=None,
                    help="copy the chosen run's haplotype/abundance outputs here")
    args = ap.parse_args(argv)

    from .model_selection import resolve_nhap, scan_run_dirs

    dirs = [d for d in _expand_dirs(args.run_dirs)
            if os.path.isfile(os.path.join(d, "fit.txt"))]
    if not dirs:
        print("resolvenhap: no run dirs with fit.txt", file=sys.stderr)
        return 1
    sel = resolve_nhap(scan_run_dirs(dirs), dev_cutoff=args.dev_cutoff,
                       unc_cutoff=args.unc_cutoff)
    header = "G,seed,uncertainty,mean_deviance,run_dir"
    line = sel.summary_line()
    print(header)
    print(line)
    if args.output_file:
        with open(args.output_file, "w") as f:
            f.write(header + "\n" + line + "\n")
    if args.copy_dir and sel.run_dir:
        import shutil

        os.makedirs(args.copy_dir, exist_ok=True)
        copied = 0
        for name in _CHOSEN_FILES:
            src = os.path.join(sel.run_dir, name)
            if os.path.isfile(src):
                shutil.copy2(src, os.path.join(args.copy_dir, name))
                copied += 1
        print(f"resolvenhap: copied {copied} files from {sel.run_dir} "
              f"-> {args.copy_dir}")
    return 0


def _collate(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-collate",
        description="Collate fit.txt records from run dirs into one CSV")
    ap.add_argument("run_dirs", nargs="+")
    ap.add_argument("-o", "--output", default="collated_fits.csv")
    args = ap.parse_args(argv)

    from . import io

    rows = []
    for d in _expand_dirs(args.run_dirs):
        fp = os.path.join(d, "fit.txt")
        if os.path.isfile(fp):
            rows.append({**io.read_fit_txt(fp), "run_dir": d})
    if not rows:
        print("collate: no fit.txt found", file=sys.stderr)
        return 1
    rows.sort(key=lambda r: r["G"])
    header = list(rows[0])
    io.write_rows(args.output, header, ([str(r[k]) for k in header] for r in rows))
    print(f"collate: {len(rows)} runs -> {args.output}")
    return 0


def _pipeline(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-pipeline",
        description="Run filter -> G-grid -> selection from one YAML/JSON "
        "config")
    ap.add_argument("config", help="YAML/JSON pipeline config")
    _add_device(ap)
    args = ap.parse_args(argv)
    if _cuda_missing("pipeline", args.device):
        return 2

    from .ops import TopkInapplicable
    from .pipeline import load_config, run_pipeline

    try:
        summary = run_pipeline(load_config(args.config), device=args.device)
    except NotImplementedError as e:
        print(f"pipeline: {e}", file=sys.stderr)
        return 2
    except TopkInapplicable as e:
        print(f"pipeline: grid kernel cuda_topk cannot take the selected "
              f"counts: {e} (kernel: cuda)", file=sys.stderr)
        return 1
    print(json.dumps(summary, indent=2))
    return 0


_COMMANDS = {
    "desman": _desman,
    "filter": _filter,
    "pipeline": _pipeline,
    "resolvenhap": _resolvenhap,
    "collate": _collate,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    cmd = argv[0]
    if cmd in _WAITING_COMMANDS:
        print(f"{cmd}: not ported to desman_tpu_torch yet "
              f"(ROADMAP queue 1 item {_WAITING_COMMANDS[cmd]})", file=sys.stderr)
        return 2
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; one of {sorted(_COMMANDS)}", file=sys.stderr)
        return 2
    return _COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
