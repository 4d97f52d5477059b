"""Whole-surface benchmark suite (beyond ``bench``'s single north-star line).

    python -m desman_tpu_torch.bench_suite [--quick]
        [--only sweeps,convergence,filter,geneassign,io] [--device cuda|cpu]

The counterpart of the repository's ``scripts/bench_suite.py``, which runs
the JAX package, at the same sizes. It prints one JSON line per entry on
stdout and a markdown table of them on stderr:

  full_sweep_torch      V=1e4 x S=64 x G=8 Gibbs sweep, plain PyTorch
                        versions on the device (JAX's ``full_sweep_xla``)
  full_sweep_cuda       the same on the tau, swap, gamma_ll and apply/eta
                        kernels (``_pallas``)
  full_sweep_resident   the same on the resident kernels (``cuda_resident``)
  full_sweep_chains4    4 chains through ``sampler.run_chains``, aggregate
                        sweeps/s on one device
  full_sweep_scale      V=1e5 x S=96 x G=16 on ``cuda`` (not with --quick)
  convergence           time to within 0.01% of the star loglik
                        (``time_to_converged_deviance``), with the star
                        haplotypes' SNP errors against the truth
  filter                variant filter throughput, V=1e5 x S=64 (positions/s)
  geneassign            exact-enumeration gene assignment, D=5e3 x G=8
                        (``geneassign_enum``, genes/s)
  extract_native/python mpileup parsing throughput (MB/s)
  csv_native/python     counts-CSV ingestion throughput (MB/s)

The port has no pandas, so JAX's ``csv_pandas`` entry becomes
``csv_python``: ``io.read_counts_csv(prefer_native=False)``, the port's
Python reader. Every timed call ends with its result on the host, so a
time covers the device's work. Each entry is the median of three timed
calls after an untimed one (the io entries: of three calls).

Without a card it exits 2 unless given ``--device cpu``. On the CPU the
kernel wrappers would run their plain versions, so, as JAX skips its
Pallas entries off the TPU, ``full_sweep_cuda`` and ``full_sweep_resident``
are left out and the other sweeps run the plain versions (``kernel=torch``
in their config); a CPU rate is no card's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import io, native, synth
from .bench import card
from .cli import _add_device, _cuda_missing
from .filter import FilterConfig, filter_variants
from .geneassign import GeneAssignConfig, assign_genes
from .pileup import read_pileup_py, write_pileup
from .sampler import SamplerConfig, chain_generator, run_chain, run_chains
from .utils import snp_distance_perm

GROUPS = ("sweeps", "convergence", "filter", "geneassign", "io")


def _median_time(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _counts(V, S, G, device, seed=0):
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed)
    return t, torch.as_tensor(t.data.counts, dtype=torch.float32, device=device)


def bench_sweeps(results, quick, device):
    on_card = device.type == "cuda"
    sweeps = 30 if quick else 100

    def one(name, V, S, G, kernel, chains=None):
        _, n = _counts(V, S, G, device)
        cfg = SamplerConfig(G=G, burn=0, samples=sweeps, nmf_iters=30)
        calls = [0]

        def go():
            calls[0] += 1
            if chains:
                seeds = [s + calls[0] for s in range(chains)]
                run_chains(n, cfg, seeds, kernel=kernel).mean_loglik.cpu()
            else:
                run_chain(n, cfg, chain_generator(calls[0], device),
                          kernel=kernel).loglik_trace.cpu()

        go()  # builds the kernels
        el = _median_time(go)
        total = sweeps * (chains or 1)
        results.append({
            "bench": name, "value": round(total / el, 2), "unit": "sweeps/s",
            "config": f"V={V} S={S} G={G} kernel={kernel}"
                      + (f" chains={chains}" if chains else ""),
        })

    kernel = "cuda" if on_card else "torch"
    one("full_sweep_torch", 10_000, 64, 8, "torch")
    if on_card:
        one("full_sweep_cuda", 10_000, 64, 8, "cuda")
        one("full_sweep_resident", 10_000, 64, 8, "cuda_resident")
    one("full_sweep_chains4", 10_000, 64, 8, kernel, chains=4)
    if not quick:
        one("full_sweep_scale", 100_000, 96, 16, kernel)


def bench_convergence(results, quick, device):
    """Time-to-converged-deviance at the north-star config: sweeps and
    seconds until the trace reaches within 0.01% of the run's star (best)
    loglik. The plateau sits about 1e-4 relative below the truth's loglik
    (posterior gamma/eta jitter around the ML over ~3e7 reads), so the
    star-relative target is the meaningful one; the entry also reports the
    star haplotypes' SNP errors against the generating truth."""
    V, S, G = (2_000, 16, 4) if quick else (10_000, 64, 8)
    kernel = "cuda" if device.type == "cuda" else "torch"
    t, n = _counts(V, S, G, device)
    sweeps = 150 if quick else 300
    cfg = SamplerConfig(G=G, burn=sweeps // 2, samples=sweeps - sweeps // 2,
                        nmf_iters=50)
    run_chain(n, cfg, chain_generator(0, device), kernel=kernel).loglik_trace.cpu()
    t0 = time.perf_counter()
    res = run_chain(n, cfg, chain_generator(1, device), kernel=kernel)
    trace = res.loglik_trace.cpu().numpy()
    elapsed = time.perf_counter() - t0
    snp = snp_distance_perm(t.tau_idx, res.tau_star.cpu().numpy())
    star = float(res.star_loglik)
    target = star - 1e-4 * abs(star)
    hit = np.flatnonzero(trace >= target)
    sweeps_to = int(hit[0]) + 1 if hit.size else -1
    secs = sweeps_to * elapsed / sweeps if sweeps_to > 0 else -1.0
    results.append({
        "bench": "time_to_converged_deviance",
        "value": round(secs, 3), "unit": "s",
        "config": f"V={V} S={S} G={G} kernel={kernel}; {sweeps_to} sweeps to "
                  f"within 0.01% of star loglik; star-vs-truth SNP errors={snp}",
    })


def bench_filter(results, quick, device):
    V = 20_000 if quick else 100_000
    t = synth.generate(V=V, S=64, G=4, coverage=50.0, seed=1)

    def go():
        filter_variants(t.data, FilterConfig(), device=device)

    go()
    el = _median_time(go)
    results.append({"bench": "filter", "value": round(V / el, 1),
                    "unit": "positions/s", "config": f"V={V} S=64"})


def bench_geneassign(results, quick, device):
    D, G, S = (1000, 8, 64) if quick else (5000, 8, 64)
    rng = np.random.default_rng(0)
    gamma = rng.dirichlet(np.ones(G), size=S)
    cov = (gamma * 40.0).T
    etaG = rng.integers(0, 2, size=(D, G))
    x = rng.poisson(etaG @ cov).astype(np.float64)

    def go():
        assign_genes(x, cov, GeneAssignConfig(max_copy=1),
                     device=device).eta_star.cpu()

    go()
    el = _median_time(go)
    results.append({"bench": "geneassign_enum", "value": round(D / el, 1),
                    "unit": "genes/s", "config": f"D={D} G={G} S={S} states=256"})


def bench_io(results, quick, tmpdir):
    V = 5_000 if quick else 20_000
    t = synth.generate(V=V, S=32, G=4, coverage=50.0, seed=2)

    csv_path = os.path.join(tmpdir, "bench_counts.csv")
    io.write_counts_csv(csv_path, t.data)
    mb = os.path.getsize(csv_path) / 1e6
    el = _median_time(lambda: native.read_counts_csv_native(csv_path))
    results.append({"bench": "csv_native", "value": round(mb / el, 1),
                    "unit": "MB/s", "config": f"{mb:.1f} MB"})
    el = _median_time(lambda: io.read_counts_csv(csv_path, prefer_native=False))
    results.append({"bench": "csv_python", "value": round(mb / el, 1),
                    "unit": "MB/s", "config": f"{mb:.1f} MB"})

    pl_path = os.path.join(tmpdir, "bench.pileup")
    write_pileup(pl_path, t.data)
    mb = os.path.getsize(pl_path) / 1e6
    el = _median_time(lambda: native.read_pileup_native(pl_path))
    results.append({"bench": "extract_native", "value": round(mb / el, 1),
                    "unit": "MB/s", "config": f"{mb:.1f} MB"})
    el = _median_time(lambda: read_pileup_py(pl_path))
    results.append({"bench": "extract_python", "value": round(mb / el, 1),
                    "unit": "MB/s", "config": f"{mb:.1f} MB"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desman_tpu_torch.bench_suite")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma list: " + ",".join(GROUPS))
    _add_device(ap)
    args = ap.parse_args(argv)
    todo = (args.only or ",".join(GROUPS)).split(",")
    unknown = sorted(set(todo) - set(GROUPS))
    if unknown:
        ap.error(f"unknown --only entries {unknown}; choose from {', '.join(GROUPS)}")
    if _cuda_missing("bench_suite", args.device):
        return 2
    device = torch.device(args.device)
    print(f"# device: {card() if device.type == 'cuda' else 'cpu'}", file=sys.stderr)

    results = []
    with tempfile.TemporaryDirectory() as td:
        if "sweeps" in todo:
            bench_sweeps(results, args.quick, device)
        if "convergence" in todo:
            bench_convergence(results, args.quick, device)
        if "filter" in todo:
            bench_filter(results, args.quick, device)
        if "geneassign" in todo:
            bench_geneassign(results, args.quick, device)
        if "io" in todo:
            bench_io(results, args.quick, td)

    for r in results:
        print(json.dumps(r))
    print("\n| bench | value | unit | config |", file=sys.stderr)
    print("|---|---|---|---|", file=sys.stderr)
    for r in results:
        print(f"| {r['bench']} | {r['value']} | {r['unit']} | {r['config']} |",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
