"""Command-line entry point of the PyTorch port.

    python -m desman_tpu_torch desman counts.csv -g 5 -o out [--device cuda]

Only the ``desman`` subcommand's plain run is ported. The JAX package's
other subcommands and run-mode flags exit with code 2 and name the ROADMAP
item that will port them; none is silently ignored. ``--device cuda`` (the
default) never falls back to the CPU: without CUDA it exits with code 2.
"""
from __future__ import annotations

import argparse
import sys

# flag -> the ROADMAP queue-1 item that ports it
_WAITING_FLAGS = {
    "--chains": "3 (batched chains)",
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
    "filter": "8 (variant filter)",
    "resolvenhap": "9 (grid and model selection)",
    "collate": "9 (grid and model selection)",
    "geneassign": "10 (GeneAssign)",
    "pipeline": "13 (remaining surface)",
    "multibin": "13 (remaining surface)",
    "diag": "13 (remaining surface)",
    "genecov": "13 (remaining surface)",
    "extract": "13 (remaining surface)",
    "validate": "13 (remaining surface)",
    "strainfasta": "13 (remaining surface)",
}


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
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the sampler runs; cuda never falls back to cpu")
    ap.add_argument("--kernel", choices=["cuda", "cuda_resident", "torch"],
                    default="cuda",
                    help="cuda: the hand-written tau-sweep and swap kernels; "
                    "cuda_resident: the whole sweep's [V]-sized work in two "
                    "kernel launches (the tau sweep, swap and gamma-MH "
                    "likelihoods fused, then gamma apply + eta likelihood); "
                    "torch: the plain PyTorch versions (on a cpu device "
                    "cuda and torch are the same)")
    args = ap.parse_args(argv)
    if args.eta_update != "joint":
        print("desman: --eta_update rows is not ported to desman_tpu_torch yet "
              "(ROADMAP queue 1 item 3 (per-row eta MH))", file=sys.stderr)
        return 2

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("desman: --device cuda requested but CUDA is not available "
              "(use --device cpu to run on the CPU)", file=sys.stderr)
        return 2

    from . import io
    from .run import RunConfig, run

    data = io.read_counts_csv(args.variant_file)
    rc = RunConfig(
        G=args.num_strains, iterations=args.iterations, seed=args.seed,
        eta_file=args.eta_file, sample_eta=args.sample_eta,
        min_coverage=args.min_coverage, n_positions=args.random_positions,
        out_dir=args.output_dir, kappa_gamma=args.kappa_gamma,
        kappa_eta=args.kappa_eta, eta_update=args.eta_update,
    )
    run(data, rc, device=args.device, kernel=args.kernel)
    print(f"desman: wrote {args.output_dir}/fit.txt")
    return 0


_COMMANDS = {"desman": _desman}


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
