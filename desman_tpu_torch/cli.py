"""Command-line entry point of the PyTorch port.

    python -m desman_tpu_torch desman counts.csv -g 5 -o out [--device cuda]
    python -m desman_tpu_torch filter counts.csv -o filtered_
    python -m desman_tpu_torch pipeline config.yaml
    python -m desman_tpu_torch resolvenhap 'out/run_*'
    python -m desman_tpu_torch collate 'out/run_*' -o collated_fits.csv
    python -m desman_tpu_torch geneassign -g Gamma_mean.csv -c gene_cov.csv
    python -m desman_tpu_torch genecov counts.csv -G genes.tsv -o gene_cov.csv
    python -m desman_tpu_torch validate -p Filtered_Tau_star.csv -t true_tau.csv
    python -m desman_tpu_torch diag 'out/run_*'
    python -m desman_tpu_torch multibin bin1.csv bin2.csv -g 5 -o bins_
    python -m desman_tpu_torch extract sample.pileup -o counts.csv
    python -m desman_tpu_torch strainfasta Filtered_Tau_star.csv -o strains.fasta

    desman       tau/gamma/eta Gibbs deconvolution (--chains, --pt, -t/-f,
                 --eta_update, --store_every, --checkpoint, --auto_burn,
                 --auto_samples, --profile, --mesh,
                 --kernel cuda|cuda_resident|cuda_topk|torch)
    filter       variant-position LLR filter -> sel_var/p/q/tran_df CSVs
    pipeline     filter -> G-grid -> selection (-> genes) from one YAML/JSON
                 config
    resolvenhap  pick the number of strains from a run grid (-c copies)
    collate      one CSV of a run grid's fit records
    geneassign   accessory-gene strain assignment (+ --assign_tau)
    genecov      per-gene coverage matrix from a counts CSV
    validate     permutation-matched SNP/gamma error vs ground truth
    diag         split R-hat / ESS / replicate tau agreement per G
    multibin     many genome bins sharing one sample set, one chain a bin
    extract      per-position base counts (and per-gene coverage) from a
                 multi-sample samtools mpileup (C++ scanner; --python)
    strainfasta  strain haplotype sequences from Filtered_Tau_star calls

``desman --mesh CxD`` runs on a (chain, data) mesh of C*D ranks: under
torchrun it joins torchrun's world (C*D must be its size); otherwise it
starts the C*D ranks on this host itself, forwards SIGTERM to them, and
kills the rest when one fails. It composes with --chains (a multiple of
C), --pt R (the replicas on the chain axis: R a multiple of C, no
--chains), --auto_* and --checkpoint (a directory), and refuses what the
JAX CLI refuses with exit code 2; no flag is silently ignored.
``--debug`` (anywhere in the arguments) turns on the NaN trap: every sweep's
loglik, gamma, eta and mix are checked, and the first non-finite value
raises FloatingPointError naming the sweep and the field.
``--device cuda`` (the default) never falls back to the CPU: without CUDA it
exits with code 2. ``--kernel cuda_topk`` on counts with a cell of more
than two observed bases exits with code 1 and says so; it never switches to
the full kernel. A ``--checkpoint`` run that gets SIGTERM finishes its
segment, commits the checkpoint and exits with code 75; rerunning the same
command resumes it.
"""
from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import sys

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


def _desman_parser() -> argparse.ArgumentParser:
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
    ap.add_argument("-t", "--tau_init", default=None,
                    help="Filtered_Tau_star.csv to initialize tau from")
    ap.add_argument("-f", "--tau_fixed", default=None,
                    help="Filtered_Tau_star.csv to FIX tau to (fits gamma/eta "
                    "only, e.g. assigning new samples to known haplotypes)")
    ap.add_argument("--kappa_gamma", type=float, default=0.0,
                    help="gamma MH proposal concentration (0 = auto)")
    ap.add_argument("--kappa_eta", type=float, default=0.0,
                    help="eta MH proposal concentration (0 = auto)")
    ap.add_argument("--eta_update", choices=["joint", "rows"], default="joint",
                    help="error-matrix MH: one blocked update (default) or 4 "
                    "per-row updates (same stationary distribution)")
    ap.add_argument("--store_every", type=int, default=0, metavar="K",
                    help="write every K-th post-burn (tau,gamma,eta) draw to "
                    "<out>/draws.npz (K must divide the sampling sweeps)")
    ap.add_argument("--chains", type=int, default=1,
                    help="independent chains (seeds seed..seed+chains-1), "
                    "advanced together, one sweep of all of them at a time "
                    "(with --pt, every run's replicas in that sweep); "
                    "the best by star likelihood is written, with chains.json")
    ap.add_argument("--checkpoint", default=None,
                    help="npz path: checkpoint every --checkpoint_every "
                    "sweeps and resume from it if present")
    ap.add_argument("--checkpoint_every", type=int, default=50)
    ap.add_argument("--auto_burn", action="store_true",
                    help="extend burn-in until the loglik plateaus (at "
                    "least -i/2, at most --auto_max_burn); -i/2 sampling "
                    "sweeps follow")
    ap.add_argument("--auto_tol", type=float, default=1e-5)
    ap.add_argument("--auto_max_burn", type=int, default=2000)
    ap.add_argument("--auto_samples", type=float, default=0.0, metavar="ESS",
                    help="extend sampling past -i/2 sweeps until the "
                    "post-burn loglik bulk ESS (and min gamma ESS when "
                    "--store_every draws exist) reaches this target, capped "
                    "at --auto_max_samples")
    ap.add_argument("--auto_max_samples", type=int, default=2000)
    ap.add_argument("--pt", type=int, default=0, metavar="R",
                    help="parallel tempering with R replicas (better mixing "
                    "on multimodal posteriors; composes with --chains/-t/-f/"
                    "--checkpoint, and with --auto_burn/--auto_samples via "
                    "the cold-rung trace)")
    ap.add_argument("--pt_max_temp", type=float, default=8.0)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the chain to "
                    "DIR/trace.json (one chain; --chains > 1 runs untraced)")
    ap.add_argument("--mesh", default=None, metavar="CHAINxDATA",
                    help="shard over a mesh of ranks, e.g. 2x4 (chain x "
                    "position axes); requires --chains (or --pt's replicas) "
                    "a multiple of the chain axis (with --checkpoint, a "
                    "directory); joins torchrun's world, else starts the "
                    "ranks on this host")
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
    return ap


def _desman_refusal(args) -> str:
    """The JAX CLI's checks of a flag combination, in its order: the
    message of a refused combination, else ''."""
    from .run import AUTO_PT_SINGLE_CHAIN, PT_MESH_CHAINS, pt_mesh_split

    auto = args.auto_burn or args.auto_samples > 0
    pt = args.pt >= 2
    # the JAX CLI's capability check: auto-length PT runs one chain, on one
    # device, without checkpoints
    if auto and pt and (args.mesh or args.checkpoint or args.chains > 1):
        return AUTO_PT_SINGLE_CHAIN
    if args.mesh and pt and args.chains > 1:
        return PT_MESH_CHAINS
    if args.kernel == "cuda_resident" and (
            args.mesh or args.pt >= 2 or auto or args.checkpoint
            or args.store_every or args.tau_fixed or args.eta_update == "rows"):
        return ("--kernel cuda_resident is the single-device speed mode for "
                "plain runs (composes with --chains and -t only); use --kernel "
                "cuda for --pt/--auto_*/--checkpoint/--store_every/-f/"
                "--eta_update rows/--mesh")
    if args.mesh:
        try:
            c, _ = _mesh_shape(args.mesh)
        except ValueError:
            return f"--mesh expects CHAINxDATA, e.g. 2x4, not {args.mesh!r}"
        if pt:
            return pt_mesh_split(args.pt, c) or ""
        # one checkpointed chain runs on every chain row alike
        single = args.checkpoint and args.chains <= 1 and not auto
        if not single and args.chains % c:
            return (f"--mesh {args.mesh} needs --chains a multiple of its "
                    f"chain axis {c}, not {args.chains}")
    return ""


def _mesh_shape(text: str):
    from .parallel.mesh import parse_mesh

    c, d = parse_mesh(text)
    if c < 1 or d < 1:
        raise ValueError(text)
    return c, d


def _desman(argv) -> int:
    args = _desman_parser().parse_args(argv)
    refusal = _desman_refusal(args)
    if refusal:
        print(f"desman: {refusal}", file=sys.stderr)
        return 2
    if _cuda_missing("desman", args.device):
        return 2
    if args.mesh:
        from .parallel import distributed

        c, d = _mesh_shape(args.mesh)
        if c * d > 1 and not (distributed.initialized()
                              or "RANK" in os.environ):
            # no world to join: start the ranks here, one process each
            from .sampler import nan_trap

            return distributed.launch(_desman_rank, c * d, (argv, nan_trap()))
    return _desman_main(args)


def _desman_rank(argv, debug: bool = False) -> int:
    """One rank of a world `desman --mesh` started: CPU ranks share the
    host's cores; `debug` carries --debug's NaN trap to the rank."""
    from .sampler import set_nan_trap

    set_nan_trap(debug)
    args = _desman_parser().parse_args(argv)
    if args.device == "cpu":
        import torch

        local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        torch.set_num_threads(max(1, torch.get_num_threads() // local))
    return _desman_main(args)


def _desman_main(args) -> int:
    from . import io
    from .checkpoint import Preempted, install_preemption_handler
    from .ops import TopkInapplicable
    from .run import (
        RunConfig, run, run_multi, run_pt_sharded, run_sharded_checkpointed,
    )

    data = io.read_counts_csv(args.variant_file)
    rc = RunConfig(
        G=args.num_strains, iterations=args.iterations, seed=args.seed,
        eta_file=args.eta_file, sample_eta=args.sample_eta,
        min_coverage=args.min_coverage, n_positions=args.random_positions,
        out_dir=args.output_dir, kappa_gamma=args.kappa_gamma,
        kappa_eta=args.kappa_eta, checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        tau_file=args.tau_fixed or args.tau_init,
        fix_tau=args.tau_fixed is not None, auto_burn=args.auto_burn,
        auto_tol=args.auto_tol, auto_max_burn=args.auto_max_burn,
        auto_samples=args.auto_samples,
        auto_max_samples=args.auto_max_samples, eta_update=args.eta_update,
        store_every=args.store_every, pt_replicas=args.pt,
        pt_max_temp=args.pt_max_temp, profile_dir=args.profile,
    )
    mesh = None
    if args.mesh:
        from .parallel import distributed
        from .parallel.mesh import make_mesh

        distributed.maybe_initialize(args.device)
        try:
            mesh = make_mesh(*_mesh_shape(args.mesh))
        except ValueError as e:
            print(f"desman: {e}", file=sys.stderr)
            return 2
    if args.checkpoint:
        # SIGTERM (preemption) -> finish the in-flight segment, commit its
        # checkpoint, exit 75 (resumable)
        install_preemption_handler()
    auto = args.auto_burn or args.auto_samples > 0
    try:   # the JAX CLI's routing, in its order
        if mesh is not None and args.pt >= 2:
            run_pt_sharded(data, rc, mesh, device=args.device, kernel=args.kernel)
        elif mesh is not None and args.checkpoint and args.chains <= 1 and not auto:
            run_sharded_checkpointed(data, rc, mesh, device=args.device,
                                     kernel=args.kernel)
        elif args.chains > 1 or mesh is not None:
            run_multi(data, rc, n_chains=args.chains, device=args.device,
                      kernel=args.kernel, mesh=mesh)
        else:
            run(data, rc, device=args.device, kernel=args.kernel)
    except TopkInapplicable as e:
        print(f"desman: --kernel cuda_topk cannot take {args.variant_file}: {e} "
              "(--kernel cuda)", file=sys.stderr)
        return 1
    except Preempted as e:
        print(f"desman: preempted — {e}", file=sys.stderr)
        return 75  # EX_TEMPFAIL: rerun the same command to resume
    if mesh is None or distributed.is_coordinator():
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
    except TopkInapplicable as e:
        print(f"pipeline: grid kernel cuda_topk cannot take the selected "
              f"counts: {e} (kernel: cuda)", file=sys.stderr)
        return 1
    print(json.dumps(summary, indent=2))
    return 0


def _geneassign(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-geneassign", description="Assign accessory genes to strains")
    ap.add_argument("-g", "--gamma_file", required=True, help="Gamma_mean.csv")
    ap.add_argument("-c", "--gene_cov_file", required=True,
                    help="CSV: gene name + per-sample mean coverage columns")
    ap.add_argument("-t", "--total_cov_file", default=None,
                    help="CSV: per-sample total bin coverage (one row per "
                    "sample); default: derived from --core_counts")
    ap.add_argument("--core_counts", default=None,
                    help="core counts CSV to derive per-sample total coverage")
    ap.add_argument("-o", "--output_stub", default="geneassign_")
    ap.add_argument("-m", "--max_copy", type=int, default=1)
    ap.add_argument("--model", choices=["quasipoisson", "gaussian"],
                    default="quasipoisson")
    ap.add_argument("--assign_tau", default=None, metavar="GENE_VAR_COUNTS",
                    help="gene variant-counts CSV: also assign gene-level SNVs "
                    "to strains with gamma/eta frozen; requires -e")
    ap.add_argument("-e", "--eta_file", default=None,
                    help="tran_df.csv / Eta_star.csv for --assign_tau")
    _add_device(ap)
    args = ap.parse_args(argv)
    if _cuda_missing("geneassign", args.device):
        return 2

    from . import io
    from .geneassign import (
        GeneAssignConfig, assign_gene_tau, assign_genes, sample_total_coverage,
        strain_coverage,
    )

    gamma = io.read_gamma_csv(args.gamma_file)          # [S,G]
    genes = io.read_gene_cov_csv(args.gene_cov_file)    # [D,S]
    gene_cov = genes.values
    if args.total_cov_file:
        total = io.read_total_cov_csv(args.total_cov_file)
    elif args.core_counts:
        total = sample_total_coverage(io.read_counts_csv(args.core_counts).counts)
    else:
        total = gene_cov.mean(axis=0)
        print(
            "geneassign: WARNING: no -t/--total_cov_file or --core_counts "
            "given; approximating per-sample total bin coverage by the mean "
            "accessory-gene coverage. Strain absolute coverages are biased "
            "if accessory genes are not a representative sample of the bin; "
            "pass --core_counts (the filtered core counts CSV) for the "
            "reference-faithful derivation.", file=sys.stderr,
        )
    res = assign_genes(gene_cov, strain_coverage(gamma, total), GeneAssignConfig(
        max_copy=args.max_copy, model=args.model), device=args.device)
    stub = args.output_stub
    G = gamma.shape[1]
    cols = [f"H{g + 1}" for g in range(G)]
    label = genes.index_label
    io.write_gene_table(stub + "etaS_df.csv", genes.names, cols,
                        res.eta_star.cpu().numpy(), label)
    io.write_gene_table(stub + "etaP_df.csv", genes.names, cols,
                        res.presence_prob.cpu().numpy(), label)
    io.write_gene_table(stub + "eta_conf.csv", genes.names,
                        ["loglik", "confidence"],
                        [res.loglik.cpu().numpy(), res.confidence.cpu().numpy()],
                        label)
    print(f"geneassign: {gene_cov.shape[0]} genes x {G} strains -> {stub}etaS_df.csv")

    if args.assign_tau:
        if not args.eta_file:
            print("geneassign: --assign_tau requires -e/--eta_file",
                  file=sys.stderr)
            return 2
        var = io.read_counts_csv(args.assign_tau)
        eta = io.read_eta_csv(args.eta_file)
        tau_star, tau_mean = assign_gene_tau(var.counts, gamma, eta,
                                             device=args.device)
        io.write_tau_star_csv(stub + "gene_tau_star.csv", tau_star.cpu().numpy(),
                              var.contigs, var.positions)
        io.write_tau_mean_csv(stub + "gene_tau_mean.csv", tau_mean.cpu().numpy(),
                              var.contigs, var.positions)
        print(f"geneassign: assigned tau at {var.V} gene positions -> "
              f"{stub}gene_tau_star.csv")
    return 0


def _genecov(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-genecov",
        description="Per-gene mean coverage matrix from a counts CSV")
    ap.add_argument("counts_file")
    ap.add_argument("-G", "--genes", required=True,
                    help="gene table: gene,contig,start,end (csv/tsv/bed)")
    ap.add_argument("-o", "--output", default="gene_cov.csv")
    args = ap.parse_args(argv)

    from . import io
    from .genecov import read_gene_table

    data = io.read_counts_csv(args.counts_file)
    names = _write_gene_cov(args.output, data, read_gene_table(args.genes))
    print(f"genecov: {len(names)} genes x {data.S} samples -> {args.output}")
    return 0


def _write_gene_cov(path, data, genes) -> list:
    """The [D, S] gene-coverage table (n_positions first), as the JAX
    package's pandas frame writes it; returns the gene names."""
    from . import io
    from .genecov import gene_coverage

    names, cov, n_positions = gene_coverage(data, genes)
    io.write_gene_table(path, names, ["n_positions", *data.samples],
                        [n_positions, *cov.T])
    return names


def _extract(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-extract",
        description="Extract per-position base counts (and per-gene coverage) "
        "from a multi-sample samtools-mpileup file (C++ scanner)")
    ap.add_argument("pileup_file", help="multi-sample `samtools mpileup` output")
    ap.add_argument("-n", "--sample_names", default=None,
                    help="file with one sample name per line (default: "
                    "Sample1..S)")
    ap.add_argument("-o", "--output", default="counts.csv")
    ap.add_argument("-q", "--min_baseq", type=int, default=0,
                    help="drop bases below this phred quality")
    ap.add_argument("-G", "--genes", default=None,
                    help="gene table (gene,contig,start,end): restrict "
                    "positions to gene regions")
    ap.add_argument("--gene_cov", default=None, metavar="CSV",
                    help="also write the per-gene mean-coverage matrix "
                    "(GeneAssign input); requires -G")
    ap.add_argument("--python", action="store_true",
                    help="the Python parser instead of the C++ scanner")
    args = ap.parse_args(argv)

    if args.gene_cov and not args.genes:
        print("extract: --gene_cov requires -G/--genes", file=sys.stderr)
        return 2

    from . import io
    from .pileup import read_pileup, read_sample_names

    samples = read_sample_names(args.sample_names) if args.sample_names else None
    data = read_pileup(args.pileup_file, samples=samples,
                       min_baseq=args.min_baseq, prefer_native=not args.python)
    if args.genes:
        from .genecov import read_gene_table
        from .pileup import restrict_to_genes

        genes = read_gene_table(args.genes)
        if args.gene_cov:
            _write_gene_cov(args.gene_cov, data, genes)
            print(f"extract: {len(genes.names)} genes -> {args.gene_cov}")
        data, _ = restrict_to_genes(data, genes)
    io.write_counts_csv(args.output, data)
    print(f"extract: {data.V} positions x {data.S} samples -> {args.output}")
    return 0


def _bin_out_dirs(stub: str, counts_files) -> list:
    """One output dir per bin: stub + the counts file's basename,
    disambiguated by its parent dir, then by an index, so that
    bin1/counts.csv and bin2/counts.csv do not collide."""
    from collections import Counter

    stems = [os.path.splitext(os.path.basename(f))[0] for f in counts_files]
    stem_count = Counter(stems)
    names = [
        f"{os.path.basename(os.path.dirname(os.path.abspath(f)))}_{stem}"
        if stem_count[stem] > 1 else stem
        for f, stem in zip(counts_files, stems)
    ]
    seen: Counter = Counter()
    out_dirs = []
    for base in names:
        k = seen[base]
        seen[base] += 1
        out_dirs.append(stub + (base if k == 0 else f"{base}_{k}"))
    return out_dirs


def _multibin(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-multibin",
        description="Deconvolve many genome bins in one run (the bins share "
        "the sample set; one chain a bin on counts padded to a common V)")
    ap.add_argument("counts_files", nargs="+",
                    help="one counts CSV per bin (same sample columns)")
    ap.add_argument("-g", "--num_strains", type=int, required=True)
    ap.add_argument("-o", "--output_stub", default="bin_out_",
                    help="per-bin output dir = stub + counts-file basename")
    ap.add_argument("-i", "--iterations", type=int, default=250)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-e", "--eta_file", default=None,
                    help="tran_df.csv: fix eta for every bin")
    ap.add_argument("--kernel", choices=["cuda", "cuda_topk", "torch"],
                    default="cuda",
                    help="cuda: the tau-sweep and swap kernels; torch: the "
                    "plain PyTorch versions (cuda_topk binds to one counts "
                    "tensor and is refused)")
    _add_device(ap)
    args = ap.parse_args(argv)
    if args.kernel == "cuda_topk":
        print("desman-multibin: --kernel cuda_topk binds to one counts "
              "tensor; unsupported for batched bins (use cuda or torch)",
              file=sys.stderr)
        return 2
    if _cuda_missing("multibin", args.device):
        return 2

    from . import io
    from .multibin import run_bins_files
    from .sampler import SamplerConfig

    eta = io.read_eta_csv(args.eta_file) if args.eta_file else None
    burn = args.iterations // 2
    cfg = SamplerConfig(G=args.num_strains, burn=burn,
                        samples=args.iterations - burn,
                        fix_eta=eta is not None)
    out_dirs = _bin_out_dirs(args.output_stub, args.counts_files)
    run_bins_files(args.counts_files, cfg, out_dirs, seed=args.seed,
                   eta_init=eta, kernel=args.kernel, device=args.device)
    print(f"multibin: {len(out_dirs)} bins -> {args.output_stub}*")
    return 0


def _strainfasta(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-strainfasta",
        description="Write strain haplotype sequences from Filtered_Tau_star "
        "calls")
    ap.add_argument("tau_file", help="Filtered_Tau_star.csv")
    ap.add_argument("-f", "--ref_fasta", default=None,
                    help="bin contig FASTA: substitute strain bases into full "
                    "contigs (default: variants-only haplotype strings)")
    ap.add_argument("-o", "--output", default="strains.fasta")
    args = ap.parse_args(argv)

    from .strainfasta import write_strain_fasta

    G = write_strain_fasta(args.tau_file, args.output, ref_fasta=args.ref_fasta)
    print(f"strainfasta: {G} strains -> {args.output}")
    return 0


def _validate(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-validate",
        description="Permutation-matched SNP error vs ground truth "
        "(validateSNP/taucomp equivalent)")
    ap.add_argument("-p", "--pred_tau", required=True,
                    help="predicted Filtered_Tau_star.csv")
    ap.add_argument("-t", "--true_tau", required=True,
                    help="ground-truth tau CSV (same format)")
    ap.add_argument("--pred_gamma", default=None)
    ap.add_argument("--true_gamma", default=None)
    args = ap.parse_args(argv)

    from .validation import validate_files

    rep = validate_files(args.pred_tau, args.true_tau, args.pred_gamma,
                         args.true_gamma)
    hdr = "positions,pred_strains,snp_errors,error_rate"
    if rep.gamma_mae is not None:
        hdr += ",gamma_mae"
    print(hdr)
    print(rep.summary_line())
    return 0


def _csv_cell(v) -> str:
    """A cell as pandas' to_csv writes it: NaN empty, numbers as Python
    prints them."""
    if v is None or (isinstance(v, float) and v != v):
        return ""
    return str(v)


def _diag(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-diag",
        description="Convergence diagnostics over finished run dirs: per-G "
        "split R-hat / bulk ESS on the post-burn loglik traces and pairwise "
        "replicate tau agreement")
    ap.add_argument("run_dirs", nargs="+", help="run output dirs (globs ok)")
    ap.add_argument("-b", "--burn_frac", type=float, default=0.5,
                    help="fraction of each trace to discard as burn-in")
    ap.add_argument("-o", "--output", default=None, help="write CSV here")
    args = ap.parse_args(argv)

    import numpy as np

    from . import io
    from .diagnostics import (
        draws_diagnostics, ess_bulk, replicate_agreement, split_rhat,
    )

    # group by (G, V): same strain count AND same position set
    by_key: dict = {}
    for d in _expand_dirs(args.run_dirs):
        paths = [os.path.join(d, f) for f in
                 ("fit.txt", "loglik_trace.csv", "Filtered_Tau_star.csv")]
        if not all(os.path.isfile(p) for p in paths):
            continue
        G = io.read_fit_txt(paths[0])["G"]
        # each trace drops its own burn fraction, then chains align on their
        # last n common draws (traces of other lengths)
        trace = np.loadtxt(paths[1], ndmin=1)
        post = trace[int(len(trace) * args.burn_frac):]
        tau, _, _ = io.read_tau_star_csv(paths[2])
        by_key.setdefault((G, tau.shape[0]), []).append((d, post, tau))
    if not by_key:
        print("diag: no run dirs with fit.txt + loglik_trace.csv + "
              "Filtered_Tau_star.csv", file=sys.stderr)
        return 1
    rows = []
    for (G, V) in sorted(by_key):
        runs = by_key[(G, V)]
        n_draws = min(len(t) for _, t, _ in runs)
        post = np.stack([t[len(t) - n_draws:] for _, t, _ in runs])
        rhat = split_rhat(post) if len(runs) > 1 else float("nan")
        ess = ess_bulk(post)
        agree = replicate_agreement([tau for _, _, tau in runs])
        off = agree[np.triu_indices(len(runs), k=1)]
        rows.append({
            "G": G, "V": V, "chains": len(runs), "split_rhat": rhat,
            "ess_bulk": ess,
            "max_replicate_snp_distance": int(off.max()) if off.size else 0,
        })
        print(f"G={G}: chains={len(runs)} split_rhat={rhat:.4f} "
              f"ess={ess:.1f} max_replicate_snp_dist="
              f"{rows[-1]['max_replicate_snp_distance']}")
        # per-parameter diagnostics from stored draws (--store_every): the
        # loglik can look converged while an abundance still drifts
        per_run = []
        for d, _, _ in runs:
            dpath = os.path.join(d, "draws.npz")
            if os.path.isfile(dpath):
                dd = draws_diagnostics(io.read_draws(dpath))
                per_run.append(dd)
                print(f"  draws[{d}]: n={dd['n_draws']} "
                      f"gamma_ess_min={dd['gamma_ess_min']:.1f} "
                      f"eta_ess_min={dd['eta_ess_min']:.1f}")
        if per_run:
            # worst case across replicates: the least-converged run
            rows[-1].update({
                "draws_runs": len(per_run),
                **{f"draws_{k}": min(dd[k] for dd in per_run) for k in per_run[0]},
            })
    if args.output:
        header = list(dict.fromkeys(k for r in rows for k in r))
        io.write_rows(args.output, header,
                      ([_csv_cell(r.get(k)) for k in header] for r in rows))
        print(f"diag: wrote {args.output}")
    return 0


_COMMANDS = {
    "desman": _desman,
    "filter": _filter,
    "pipeline": _pipeline,
    "resolvenhap": _resolvenhap,
    "collate": _collate,
    "geneassign": _geneassign,
    "genecov": _genecov,
    "validate": _validate,
    "diag": _diag,
    "multibin": _multibin,
    "extract": _extract,
    "strainfasta": _strainfasta,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--debug" in argv:
        # the NaN trap (the JAX CLI's jax_debug_nans), taken from anywhere in
        # the arguments, for this call
        from .sampler import nan_trap, set_nan_trap

        argv.remove("--debug")
        was = nan_trap()
        set_nan_trap(True)
        try:
            return _main(argv)
        finally:
            set_nan_trap(was)
    return _main(argv)


def _main(argv) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; one of {sorted(_COMMANDS)}", file=sys.stderr)
        return 2
    return _COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
