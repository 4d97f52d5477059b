#!/usr/bin/env python3
"""Smoke run of the PyTorch port (desman_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own '# ...' lines:

1. device: require CUDA (exit 2 without it); print the card's name and
   power limit as nvidia-smi reports them;
2. build: compile the CUDA kernels from desman_tpu_torch/csrc;
3. kernels vs their plain PyTorch versions on the card at V=1e4, S=64,
   G=8, on inputs built on the CPU from numpy seeds and then moved to the
   card (kernel_bench.phase3_inputs): agreement, mixture consistency,
   per-sample loglik sums to rtol 1e-5, the tau, fused, top-2 and gamma_ll
   kernels' outputs bitwise equal to the SHA-256 digests the
   one-warp-per-position kernels gave on these inputs (TAU_SHA256,
   FUSED_SHA256, TOPK_SHA256, GAMMA_LL_SHA256), the fused front-half
   kernel bitwise equal to the staged kernels and to itself from run to
   run, the top-2 tau kernel (on biallelic, error-free counts,
   kernel_bench.topk_inputs) bitwise equal to the tau kernel and to itself
   from run to run, its log (warp.cuh's log_normal) bitwise logf on every
   float of [1e-12, FLT_MAX], gamma_ll's digest also at G=1; median times
   (CUDA events around each wrapper call, host included) and each kernel's
   device time (torch.profiler, 50 calls), its bound (kernel_bench.bound)
   and share of it; the row-resident kernels' tile plan, registers and
   resident blocks a SM; and those four kernels again at V=1e5, S=96,
   G=16 (device ms by CUDA events around 200 launches, digests gated as at
   V=1e4); then a resident sweep at V=64, S=4000, G=4, past the shared
   memory of a block's reduction slots: the fused kernel bitwise the staged
   chain, swap(emit_ll), gamma_ll and gamma_apply_eta against their plain
   versions, and a 10-sweep cuda_resident chain (a main path: its launches
   are counted);
4. the main paths, each with the launch counts set to 0 just before it and
   read just after: the `desman` CLI on TestData's true-variant half with
   `--kernel cuda` and with `--kernel cuda_resident`, each held to the
   quickstart's accuracy gates, and a one-strain `--kernel cuda_resident`
   run (the path without a swap to fuse); `--kernel cuda_topk` on TestData
   (cells of 3-4 observed bases) must exit non-zero and say why;
5. a V=1e4, S=64, G=8 run() of 400 sweeps with each kernel choice that
   takes such counts (cuda, cuda_resident, torch), printing sweeps/s and
   the final loglik and each kernel's launches per sweep;
6. the strain-count grid at the `--paper` scale of the JAX package's
   examples/complete_example.py (7000 variant + 7000 monomorphic positions,
   S=64, true G=5; G=1..8 x seeds 0-4, 250 sweeps, eta fixed from the
   filter) through `pipeline`, twice: (a) error rate 0.005 with `kernel:
   cuda_resident`, (b) error rate 0 with `kernel: cuda_topk`; each must
   select G=5 with SNP error rate < 0.02 and gamma MAE < 0.02; `resolvenhap`
   on (a)'s run dirs must pick best.txt's run; (b) must launch the top-2
   kernel and never the tau kernel; and a G=5 chain on (b)'s selected
   counts must have a loglik trace with `cuda_topk` equal to the one with
   `cuda`;
7. GeneAssign at that scale: (a)'s pipeline also runs its `genes` stage on
   1500 accessory genes drawn from the mock's truth as complete_example.py
   draws them (presence/absence, every gene in some strain, Poisson
   coverage); presence accuracy > 0.9 after matching the strains;
8. `assign_gene_tau` at V=1e4, S=64, G=8 with the true gamma and eta
   (4^8 > 4096: the annealed Gibbs path) with `kernel="cuda"` and
   `kernel="torch"` from one generator seed: 50 sweeps (the tau kernel
   launched 50 times, and never on the plain run; error rates within 0.5
   points of each other) and 1600 sweeps (each <= 2% errors against the
   truth, within 0.5 points); and G=5 at V=1e4 (exact enumeration of
   [V,1024]), <= 2% errors;
9. the `desman` run modes on TestData's true-variant half, each held to the
   quickstart gates: `--eta_update rows --sample_eta` (accept_eta > 0),
   `--store_every 5` (draws.npz of 15 draws, gamma_ess_min in metrics),
   `-t true_tau.csv --kernel cuda_resident` (fused kernels launched), `-f
   true_tau.csv` (Filtered_Tau_star.csv is the file's, no tau or swap
   launch); `-f --kernel cuda_resident` must exit 2;
10. run modes of length and resume, at V=1e4, S=64, G=8 with `--kernel
   cuda` unless said otherwise: (a) `-i 400 --checkpoint_every 50
   --checkpoint` in `python -m desman_tpu_torch desman` subprocesses side by
   side, one uninterrupted and one SIGKILLed once its snapshot shows 0 < it
   < 400 and then rerun: fit.txt, the Tau/Gamma/Eta CSVs and
   loglik_trace.csv byte-identical to each other and to an in-process run
   without --checkpoint; (b) beside them the same run SIGTERMed mid-run
   exits 75 naming the preemption, and its rerun's files match; then
   run()'s sweeps/s with and without --checkpoint_every 50 in turns, and
   the time of one snapshot write, printed;
   (c) in-process `--auto_burn --auto_samples 100 -i 200`: tau and swap
   kernels launched, 100 <= burn <= 2000, loglik_ess_bulk >= 100 or
   sampling at its cap; the same on TestData's half (quickstart gates) and
   with `cuda_topk` on grid (b)'s selected counts (the top-2 kernel, never
   the tau kernel); (d) `--chains 4 --checkpoint` and `--auto_burn --chains
   4` on TestData's half (quickstart gates, chains.json); (e) phase 6 (a)'s
   counts through `pipeline` with `grid: {kernel: cuda, auto_samples: 100,
   auto_max_samples: 500}`: G=5 within the gates, every run's
   sampling_sweeps >= 125, and a rerun launches no sweep; (f)
   `--checkpoint` and `--auto_burn` with `--kernel cuda_resident` exit 2
   with the JAX CLI's message and launch nothing;
11. parallel tempering, at V=1e4, S=64, G=8 with `--kernel cuda` unless
   said otherwise: (a) run() with pt_replicas=4, pt_max_temp=8, 400
   sweeps (nmf_iters 50): tau and swap launched exactly 4 x 400 times, 0 <
   pt_swap_accept <= 1, a finite cold trace; then ms an ensemble sweep
   beside 4 x ms a plain sweep, in turns plain, PT, PT, plain; and one
   run() at V=1e5, S=96, G=16, R=4, 40 sweeps: wall and peak device memory;
   (b) `desman --pt 4 -i 200` on TestData's half (quickstart gates) and
   with `cuda_topk` on grid (b)'s counts (the top-2 kernel, never the tau
   kernel); (c) tests/test_pt.py's mode-crossing case (V=40, swap moves
   off, 6 rungs to T=16), seeds 0-3: each PT star within 2 SNPs of the
   truth, the plain chains' further in sum; (d) `desman --pt 4 --checkpoint_every 50 --checkpoint -i 400`
   subprocesses side by side, one uninterrupted, one SIGKILLed and one
   SIGTERMed (exit 75) mid-run, then rerun: files byte-identical to the
   uninterrupted run's; and in process run_chain_pt_checkpointed bitwise
   run_chain_pt (V=2000, stored cold draws); (e) `--pt 4 --auto_burn
   --auto_samples 100` on TestData's half (quickstart gates); (f) `--pt`
   with `--auto_burn --checkpoint`, with `--auto_samples --chains 2` and
   with `--kernel cuda_resident` exit 2 with the JAX CLI's message and
   launch nothing;
12. the rest of the single-card surface: (a) `multibin -g 5 -i 250
   --kernel cuda` on 12 genome bins of S=64 (synth seeds 200-211, true
   G=5, V from 1000 to 1e4 in equal steps, each padded to V=1e4 on the
   card): tau and swap launched 12 x 250 times, every bin at SNP error
   rate < 0.02 and gamma MAE < 0.02 with fit.txt's V its own, bin 0
   bitwise run_chain of its padded counts, the tau and swap kernels
   against their plain versions at G=5 on bins 0 and 1 padded to V=1e4
   and bin 1 padded to V=9999 (zero rows bitwise, >= 99% elsewhere),
   `--kernel cuda_topk` exits 2
   and launches nothing, the wall a bin beside run() on the V=1e4 bin in
   turns; (b) `extract` of that bin written as a pileup (S=64, about 68 MB)
   through the C++ scanner gives its counts, positions and contigs; on a
   V=1000 slice the Python parser, the scanner and .gz input agree and `-G
   --gene_cov` writes what `genecov` writes; the readers' MB/s (host
   times); (c) `strainfasta` on bin 0's calls, variants only and against a
   reference FASTA of its contigs; (d) `desman --profile` at V=1e4 S=64
   G=8 -i 100 beside the untraced run: the sampled files byte-identical,
   the trace's kernel events naming the tau and swap kernels 100 times
   each, the walls, and where the traced wall goes;
13. position sharding over a mesh of ranks (``desman_tpu_torch.parallel``),
   at V=1e4, S=64, G=8, 200 sweeps: (f) the tau, swap and top-2 kernels
   against their plain versions on a shard's block as a 1x4 mesh gives it
   (V=1e4-2 padded to 1e4, the last rank's 2500 rows: a tail tile of 4 and
   2 pad rows with +inf swap thresholds; pad rows' tau bitwise, >= 99%
   agreement elsewhere); (c)-(e) `desman --mesh 1x2`, `--mesh 2x1 --chains
   2`, `--mesh 1x2 --kernel cuda_topk` (biallelic counts) and `--mesh 1x2
   --checkpoint` subprocesses side by side, each a world of two ranks
   sharing the card over gloo: the run records' launches exactly chains x
   data ranks x 200 over the ranks, <= 3 collectives a sweep, tau_star
   agreement >= 0.99 with the single-device chain and no more SNP errors
   than it; the checkpointed run SIGTERMed mid-run exits 75 and resumes on
   a 1x1 mesh in process; the host µs of a collective over gloo; (a) a
   1x1 mesh over NCCL in process through `run_multi(mesh=...)`: tau_star
   equal to `run_chain`'s and the trace within rtol 1e-5, tau and swap
   launched 200 times; (b) the host µs of the layer's all_reduce over NCCL,
   and ms a sweep of the 1x1 mesh against the plain chain, in turns, four
   runs each; (g) with two cards or more, `desman --mesh 1x2` alone over
   NCCL, a card a rank, held as (c) and with its in-sweep collectives
   counted, and with four or more `desman --mesh 2x2 --chains 2` too. Two
   ranks take NCCL where there are two cards (the backend rule).

Any failed gate exits 1 before the result lines; outside a checkout of the
repository the imports fail and nothing runs. On success the last three
lines are the kernels' JSON record, one record per TPU kernel (each
kernel's launches summed over every in-process path driven in phases 3-13,
the tau and swap kernels' multibin launches beside them, and the tau, swap
and top-2 kernels' mesh launches over every rank of phase 13 with their
agreement on a shard's block, each with
the counts set to 0 just before it and read just after; the swap's
emit_ll mode runs inside fused_sweep there and carries its launches), the
card's name and power limit, and
{"ok": true, "device": {...}}.
"""
import contextlib
import gzip
import io as stdio
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from desman_tpu_torch import cli, io, kernel_bench, ops, run, sampler, synth
from desman_tpu_torch.geneassign import assign_gene_tau, strain_coverage
from desman_tpu_torch.likelihood import mixture
from desman_tpu_torch.ops import _build, gamma_kernel, tau_kernel, tau_topk
from desman_tpu_torch.ops.fused_sweep import launch as fused_launch
from desman_tpu_torch.utils import match_gamma_perm, one_hot_tau
from desman_tpu_torch.validation import compare_tau

V, S, G = 10_000, 64, 8          # the port's metric configuration
TIMING_CALLS = 20
HERE = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(HERE, "TestData")
# each kernel's launches over every main path driven (counts set to 0 just
# before a path and read just after)
PATH_LAUNCHES = Counter()
# launches a sweep of each kernel on the path that runs it (phases 4-6)
SWEEP_LAUNCHES = {}
# SHA-256 of (tau, mix) from tau_sweep and of (tau, mix, ll) from
# fused_sweep on kernel_bench's inputs, as the one-warp-per-position
# kernels gave them (python -m desman_tpu_torch.kernel_bench --against a
# checkout from before the row-resident redesign; NVIDIA H100 80GB HBM3)
TAU_SHA256 = {
    kernel_bench.METRIC: "3ed8aeccc974a8de5492a1ae3a9f4346a3294f60c1025e039e896295974d6da8",
    kernel_bench.SCALE: "1467c994339182705b1ae3a50dbb6157816acefb7e96318ef3f64831add2ef0f"}
FUSED_SHA256 = {
    kernel_bench.METRIC: "9f4c9c0d866e002bb6c15eb1f227dd35faabdda777d612f957111322e98e551a",
    kernel_bench.SCALE: "64760bb508ebedeb67cbdd19d272a630c406e4e32553933e38b0e6a2a54fdb7f"}
# SHA-256 of (tau, mix) from tau_sweep_topk on kernel_bench.topk_inputs and
# of ll from gamma_ll(with_old=True) on kernel_bench.gamma_ll_args, as the
# one-warp-per-position kernels gave them (python -m
# desman_tpu_torch.kernel_bench --against a checkout from before the top-2
# kernel's row-resident redesign; NVIDIA H100 80GB HBM3)
TOPK_SHA256 = {
    kernel_bench.METRIC: "001c47ee079eeb0e971ced0c152369c0be4105aa025a07030f86ce070e9bc1fb",
    kernel_bench.SCALE: "e31b0a47100e2e7eec89042acc0fe7389556355cf4de01e5dc80d77f75276d9d"}
GAMMA_LL_SHA256 = {
    kernel_bench.METRIC: "6042415d0bd5aa995f7dacbf623a3093d9e7b31c9df178d272db3ee7cadd98a9",
    kernel_bench.ONE_STRAIN: "218113f1563effdfc6f9b56d5ca33bc91801aea1fac464825757969905fb7fae",
    kernel_bench.SCALE: "0a61aa54c0d0b84cd8cd98cf9f7bed5e96e5c7cd957cbdf12db843060f5d01ac"}


class GateFailed(Exception):
    pass


def gate(ok: bool, what: str) -> None:
    print(f"# {'pass' if ok else 'FAIL'}: {what}")
    if not ok:
        raise GateFailed(what)


def median_ms(fn) -> float:
    """Median of TIMING_CALLS CUDA-event timings of fn(), after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def record(name, source, replaces, err, ms, plain_ms, fn, **extra):
    """A kernel's record: its times, its device time (torch.profiler over
    50 calls of fn) against its bound at V, S, G, and `extra`."""
    prof = kernel_bench.profiled_ms(fn)
    device_ms = prof["total"]
    b = kernel_bench.bound(name, V, S, G)
    print(f"# {name}: device {device_ms:.4f} ms a call, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {b['logs']} logs, {b['bytes']} bytes), share of the bound "
          f"{b['bound_ms'] / device_ms:.3f}; profiler records {prof['records']}")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                share_of_bound=b["bound_ms"] / device_ms, library_ms=None,
                logs=b["logs"], bytes=b["bytes"], **extra)


def resident_info(name):
    """The row-resident kernel's tile plan, registers and resident blocks a
    SM at the metric configuration, and the plan and grid its launches
    there take."""
    info = tau_kernel.kernel_info(name, S, G)
    plan, grid = tau_kernel.resident_grid(name, V, S, G, torch.cuda.current_device())
    print(f"# {name} at S={S} G={G}: {info}; a launch at V={V}: {plan}, grid {grid}")
    return dict(tile_plan={"buffers": info["buffers"], "smem_bytes": info["smem_bytes"]},
                registers=info["registers"], local_bytes=info["local_bytes"],
                blocks_per_sm=info["blocks_per_sm"],
                launch_plan={"buffers": plan.buffers, "smem_bytes": plan.smem_bytes,
                             "grid": grid})


def phase_kernels():
    """Each kernel against its plain version on the same inputs."""
    dev = torch.device("cuda")
    host = kernel_bench.phase3_inputs(V, S, G)
    c = {k: v.to(dev) for k, v in host.items()}
    n, tau, mix, gamma, eta, gz = kernel_bench.tau_args(c)
    print(f"# kernels at V={V} S={S} G={G}: counts and mixture "
          f"{n.numel() * 4 / 1e6:.2f} MB f32 each")
    records = []

    tau_k, mix_k = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    tau_p, mix_p = ops.tau_sweep_reference(n, tau, mix, gamma, eta, gz)
    again = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    torch.cuda.synchronize()
    sha = kernel_bench.digest(tau_k, mix_k)
    print(f"# tau_sweep sha256 {sha}")
    gate(sha == TAU_SHA256[kernel_bench.METRIC],
         "tau_sweep's tau and mix are bitwise the one-warp-per-position kernel's")
    gate(torch.equal(again[0], tau_k) and torch.equal(again[1], mix_k),
         "tau_sweep is bitwise the same from run to run")
    same = (tau_k == tau_p).all(dim=1)
    agree = same.float().mean().item()
    err = (mix_k[same] - mix_p[same]).abs().max().item()
    consistent = torch.allclose(mix_k, mixture(one_hot_tau(tau_k), gamma),
                                rtol=1e-5, atol=1e-6)
    print(f"# tau_sweep: position agreement {agree:.6f}, max |mix kernel - "
          f"plain| on agreeing positions {err:.3e}")
    gate(agree >= 0.99, "tau_sweep agrees with its plain version on >= 99% "
         "of positions")
    gate(consistent, "tau_sweep mix == mixture(onehot(tau), gamma) within "
         "rtol 1e-5 / atol 1e-6")
    ms = median_ms(lambda: ops.tau_sweep(n, tau, mix, gamma, eta, gz))
    plain_ms = median_ms(
        lambda: ops.tau_sweep_reference(n, tau, mix, gamma, eta, gz))
    print(f"# tau_sweep median ms: kernel {ms:.4f}  plain {plain_ms:.4f}")
    records.append(record(
        "tau_sweep", "desman_tpu_torch/csrc/tau_kernel.cu",
        "desman_tpu/ops/tau_pallas.py:66", err, ms, plain_ms,
        lambda: ops.tau_sweep(n, tau, mix, gamma, eta, gz), agreement=agree,
        sha256=sha, **resident_info("tau_sweep")))

    # swap: the true haplotypes with strains g and h exchanged at half the
    # positions, so both the accept and the reject branch run
    tau_s, mix_s, gt, ht, logu = (c[k] for k in ("tau_s", "mix_s", "g", "h", "logu"))
    args = (n, tau_s, mix_s, gamma, eta, gt, ht, logu)
    tau_k, mix_k = ops.swap(*args)
    tau_p, mix_p = ops.swap_reference(*args)
    torch.cuda.synchronize()
    same = (tau_k == tau_p).all(dim=1)
    agree = same.float().mean().item()
    err = (mix_k[same] - mix_p[same]).abs().max().item()
    moved = (tau_k != tau_s).any(dim=1).float().mean().item()
    print(f"# swap: position agreement {agree:.6f}, accepted share {moved:.4f},"
          f" max |mix kernel - plain| on agreeing positions {err:.3e}")
    gate(agree >= 0.99, "swap agrees with its plain version on >= 99% of "
         "positions")
    gate(0.2 < moved < 0.6, "swap accepted where the strains were exchanged")
    gate(torch.allclose(mix_k, mixture(one_hot_tau(tau_k), gamma), rtol=1e-5,
                        atol=1e-6), "swap mix == mixture(onehot(tau), gamma)")
    ms = median_ms(lambda: ops.swap(*args))
    plain_ms = median_ms(lambda: ops.swap_reference(*args))
    print(f"# swap median ms: kernel {ms:.4f}  plain {plain_ms:.4f}")
    records.append(record(
        "swap", "desman_tpu_torch/csrc/swap_kernel.cu",
        "desman_tpu/ops/swap_pallas.py:54", err, ms, plain_ms,
        lambda: ops.swap(*args), agreement=agree))
    more = resident_kernels(n, gamma, eta, tau_s, mix_s, gt, ht, logu, gz, c)
    return records + more + [topk_kernel()]


def topk_kernel():
    """The top-2 tau kernel on biallelic, error-free counts (every cell
    observes at most two bases; kernel_bench.topk_inputs): against its
    plain version, against the full tau kernel (bitwise), against itself
    (bitwise), and against the one-warp-per-position kernel's digest."""
    dev = torch.device("cuda")
    d = {k: v.to(dev) for k, v in kernel_bench.topk_inputs(V, S, G).items()}
    n, tau, mix, gamma, eta, gz = kernel_bench.tau_args(d)
    args = kernel_bench.topk_args(d)
    tau_k, mix_k = ops.tau_sweep_topk(*args)
    tau_p, mix_p = ops.tau_sweep_topk_reference(*args)
    tau_f, mix_f = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    again = ops.tau_sweep_topk(*args)
    torch.cuda.synchronize()
    check = kernel_bench.log_mismatches()
    print(f"# log_normal against logf on the {check['floats']} floats of [1e-12, FLT_MAX]: "
          f"{check['mismatches']} differ")
    gate(check["mismatches"] == 0,
         "log_normal (the top-2 kernel's log) is bitwise logf on every float of [1e-12, "
         "FLT_MAX]")
    sha = kernel_bench.digest(tau_k, mix_k)
    print(f"# tau_sweep_topk sha256 {sha}")
    gate(sha == TOPK_SHA256[kernel_bench.METRIC],
         "tau_sweep_topk's tau and mix are bitwise the one-warp-per-position kernel's")
    same = (tau_k == tau_p).all(dim=1)
    agree = same.float().mean().item()
    err = (mix_k[same] - mix_p[same]).abs().max().item()
    print(f"# tau_sweep_topk: position agreement {agree:.6f}, max |mix kernel - "
          f"plain| on agreeing positions {err:.3e}")
    gate(agree >= 0.99, "tau_sweep_topk agrees with its plain version on >= 99% "
         "of positions")
    gate(torch.allclose(mix_k, mixture(one_hot_tau(tau_k), gamma), rtol=1e-5,
                        atol=1e-6),
         "tau_sweep_topk mix == mixture(onehot(tau), gamma) within rtol 1e-5 / "
         "atol 1e-6")
    gate(torch.equal(tau_k, tau_f) and torch.equal(mix_k, mix_f),
         "tau_sweep_topk is bitwise equal to tau_sweep on <=2-base counts")
    gate(torch.equal(again[0], tau_k) and torch.equal(again[1], mix_k),
         "tau_sweep_topk is bitwise the same from run to run")
    ms = median_ms(lambda: ops.tau_sweep_topk(*args))
    plain_ms = median_ms(lambda: ops.tau_sweep_topk_reference(*args))
    full_ms = median_ms(lambda: ops.tau_sweep(n, tau, mix, gamma, eta, gz))
    print(f"# tau_sweep_topk median ms: kernel {ms:.4f}  plain {plain_ms:.4f}  "
          f"tau_sweep on the same counts {full_ms:.4f}")
    return record(
        "tau_sweep_topk", "desman_tpu_torch/csrc/tau_topk.cu",
        "desman_tpu/ops/tau_topk.py:81", err, ms, plain_ms,
        lambda: ops.tau_sweep_topk(*args), agreement=agree, tau_sweep_ms=full_ms,
        tau_sweep_device_ms=kernel_bench.profiled_ms(
            lambda: ops.tau_sweep(n, tau, mix, gamma, eta, gz))["total"], sha256=sha,
        **resident_info("tau_sweep_topk"))


def ll_err(got, want, agree=1.0):
    """Max |got - want| after gating got == want to rtol 1e-5 (f32 sums in
    another order: a lane tree against torch's reduction). Where tau
    differs at a float near-tie (agree < 1) the sums are of other terms:
    they are not compared, and there is no error to report (None)."""
    if agree < 1.0:
        print("# per-sample loglik not compared: tau differs at a near-tie")
        return None
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    gate(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
         f"per-sample loglik within rtol 1e-5 (max rel {rel:.3e})")
    return (got - want).abs().max().item()


def worst(*errs) -> float:
    return max(e for e in errs if e is not None)


def resident_kernels(n, gamma, eta, tau, mix, gt, ht, logu, gz, c):
    """The resident sweep's kernels against their plain versions: the swap
    with emit_ll, gamma_ll (both with_old), gamma_apply_eta (both
    with_eta) and the fused front half."""
    gp, accept = c["gp"], c["accept"]
    eta_prop = eta.flip(0).contiguous()
    records = []

    # kernel 2': the swap's post-swap per-sample loglik
    args = (n, tau, mix, gamma, eta, gt, ht, logu)
    tau_k, mix_k, ll_k = ops.swap(*args, emit_ll=True)
    tau_p, mix_p, ll_p = ops.swap_reference(*args, emit_ll=True)
    torch.cuda.synchronize()
    same = (tau_k == tau_p).all(dim=1)
    agree = same.float().mean().item()
    print(f"# swap emit_ll: position agreement {agree:.6f}")
    gate(agree >= 0.99, "swap(emit_ll) agrees with its plain version on >= 99% "
         "of positions")
    gate(torch.allclose(mix_k[same], mix_p[same], rtol=1e-5, atol=1e-6),
         "swap(emit_ll) mix within rtol 1e-5 / atol 1e-6 on agreeing positions")
    err = worst(ll_err(ll_k, ll_p, agree),
                (mix_k[same] - mix_p[same]).abs().max().item())
    ms = median_ms(lambda: ops.swap(*args, emit_ll=True))
    plain_ms = median_ms(lambda: ops.swap_reference(*args, emit_ll=True))
    print(f"# swap emit_ll median ms: kernel {ms:.4f}  plain {plain_ms:.4f}")
    # kernel 2': on the main path its step runs inside each fused_sweep
    # launch (swap_position<true>), so its launches are fused_sweep's
    records.append(record(
        "swap_emit_ll", "desman_tpu_torch/csrc/swap_kernel.cu",
        "desman_tpu/ops/swap_pallas.py:111", err, ms, plain_ms,
        lambda: ops.swap(*args, emit_ll=True), agreement=agree,
        launched_in="fused_sweep"))

    # kernel 3: the gamma-MH loglik pair
    err, times = 0.0, {}
    for with_old in (True, False):
        ll_k = ops.gamma_ll(n, mix, tau, gp, eta, with_old=with_old)
        ll_p = ops.gamma_ll_reference(n, mix, tau, gp, eta, with_old)
        torch.cuda.synchronize()
        if with_old:
            err = ll_err(ll_k, ll_p)
        else:
            ll_err(ll_k[1], ll_p[1])
            gate(torch.equal(ll_k[0], torch.zeros_like(ll_k[0])),
                 "gamma_ll(with_old=False) row 0 is exactly zero")
        times[with_old] = (
            median_ms(lambda: ops.gamma_ll(n, mix, tau, gp, eta, with_old=with_old)),
            median_ms(lambda: ops.gamma_ll_reference(n, mix, tau, gp, eta, with_old)))
        print(f"# gamma_ll with_old={with_old} median ms: kernel "
              f"{times[with_old][0]:.4f}  plain {times[with_old][1]:.4f}")
    ll_args = kernel_bench.gamma_ll_args(c)
    ll_k = ops.gamma_ll(*ll_args)
    torch.cuda.synchronize()
    sha = kernel_bench.digest(ll_k)
    print(f"# gamma_ll sha256 {sha}")
    gate(sha == GAMMA_LL_SHA256[kernel_bench.METRIC],
         "gamma_ll's ll is bitwise the one-warp-per-position kernel's")
    one = kernel_bench.card_inputs(*kernel_bench.ONE_STRAIN, n.device)
    sha1 = kernel_bench.digest(ops.gamma_ll(*kernel_bench.gamma_ll_args(one)))
    print(f"# gamma_ll at G=1 sha256 {sha1}")
    gate(sha1 == GAMMA_LL_SHA256[kernel_bench.ONE_STRAIN],
         "gamma_ll's ll at G=1 (the resident path's shape) is bitwise the "
         "one-warp-per-position kernel's")
    records.append(record(
        "gamma_ll", "desman_tpu_torch/csrc/gamma_kernel.cu",
        "desman_tpu/ops/gamma_pallas.py:78", err, times[True][0], times[True][1],
        lambda: ops.gamma_ll(n, mix, tau, gp, eta, with_old=True),
        without_old_ms=times[False][0], without_old_plain_ms=times[False][1], sha256=sha))

    # kernel 4: accepted gamma applied + the eta proposal's loglik
    times = {}
    for with_eta in (True, False):
        a = (n, mix, tau, gp, accept, eta_prop)
        mix_k, ll_k = ops.gamma_apply_eta(*a, with_eta=with_eta)
        mix_p, ll_p = ops.gamma_apply_eta_reference(*a, with_eta=with_eta)
        torch.cuda.synchronize()
        gate(torch.allclose(mix_k, mix_p, rtol=1e-5, atol=1e-7),
             f"gamma_apply_eta(with_eta={with_eta}) mix within rtol 1e-5 / atol 1e-7")
        if with_eta:
            err = worst(ll_err(ll_k, ll_p), (mix_k - mix_p).abs().max().item())
        else:
            gate(torch.equal(ll_k, torch.zeros_like(ll_k)),
                 "gamma_apply_eta(with_eta=False) returns zeros")
        times[with_eta] = (
            median_ms(lambda: ops.gamma_apply_eta(*a, with_eta=with_eta)),
            median_ms(lambda: ops.gamma_apply_eta_reference(*a, with_eta=with_eta)))
        print(f"# gamma_apply_eta with_eta={with_eta} median ms: kernel "
              f"{times[with_eta][0]:.4f}  plain {times[with_eta][1]:.4f}")
    records.append(record(
        "gamma_apply_eta", "desman_tpu_torch/csrc/gamma_kernel.cu",
        "desman_tpu/ops/gamma_pallas.py:134", err, times[True][0], times[True][1],
        lambda: ops.gamma_apply_eta(n, mix, tau, gp, accept, eta_prop, with_eta=True),
        without_eta_ms=times[False][0], without_eta_plain_ms=times[False][1]))

    # kernel 5: the fused front half, from the random tau0 of phase 3's inputs
    fargs = kernel_bench.fused_args(c)
    tau_f, mix_f, ll_f = ops.fused_sweep(*fargs)
    tau_p, mix_p, ll_p = ops.fused_sweep_reference(*fargs)
    t1, m1 = ops.tau_sweep(*fargs[:6])
    t1, m1, ll_old = ops.swap(n, t1, m1, gamma, eta, gt, ht, logu, emit_ll=True)
    ll2 = ops.gamma_ll(n, m1, t1, gp, eta, with_old=False)
    again = ops.fused_sweep(*fargs)
    torch.cuda.synchronize()
    same = (tau_f == tau_p).all(dim=1)
    agree = same.float().mean().item()
    print(f"# fused_sweep: position agreement {agree:.6f}")
    gate(agree >= 0.99, "fused_sweep agrees with its plain version on >= 99% "
         "of positions")
    gate(torch.allclose(mix_f[same], mix_p[same], rtol=1e-4, atol=1e-5),
         "fused_sweep mix within rtol 1e-4 / atol 1e-5 on agreeing positions")
    err = worst(ll_err(ll_f, ll_p, agree),
                (mix_f[same] - mix_p[same]).abs().max().item())
    gate(torch.equal(tau_f, t1) and torch.equal(mix_f, m1)
         and torch.equal(ll_f[0], ll_old) and torch.equal(ll_f[1], ll2[1]),
         "fused_sweep is bitwise equal to tau_sweep -> swap(emit_ll) -> "
         "gamma_ll(with_old=False) on the card")
    gate(all(torch.equal(a, b) for a, b in zip(again, (tau_f, mix_f, ll_f))),
         "fused_sweep is bitwise the same from run to run")
    sha = kernel_bench.digest(tau_f, mix_f, ll_f)
    print(f"# fused_sweep sha256 {sha}")
    gate(sha == FUSED_SHA256[kernel_bench.METRIC],
         "fused_sweep's tau, mix and ll are bitwise the one-warp-per-position kernel's")

    def staged():
        t, m = ops.tau_sweep(*fargs[:6])
        t, m, _ = ops.swap(n, t, m, gamma, eta, gt, ht, logu, emit_ll=True)
        ops.gamma_ll(n, m, t, gp, eta, with_old=False)

    ms = median_ms(lambda: ops.fused_sweep(*fargs))
    plain_ms = median_ms(lambda: ops.fused_sweep_reference(*fargs))
    staged_ms = median_ms(staged)
    print(f"# fused_sweep median ms: kernel {ms:.4f}  plain {plain_ms:.4f}  "
          f"staged kernels {staged_ms:.4f}")
    records.append(record(
        "fused_sweep", "desman_tpu_torch/csrc/fused_sweep.cu",
        "desman_tpu/ops/fused_sweep.py:41", err, ms, plain_ms,
        lambda: ops.fused_sweep(*fargs), agreement=agree, staged_kernels_ms=staged_ms,
        sha256=sha, **resident_info("fused_sweep")))
    return records


def phase_scale():
    """The row-resident kernels and gamma_ll at the full-sweep scale, V=1e5
    S=96 G=16: outputs gated on the one-warp-per-position kernels' digests,
    device ms by CUDA events around 200 launches into preallocated outputs,
    against the bound. Returns {kernel: numbers}."""
    dev = torch.device("cuda")
    shape = kernel_bench.SCALE
    c = kernel_bench.card_inputs(*shape, dev)
    topk = {k: v.to(dev) for k, v in kernel_bench.topk_inputs(*shape).items()}
    lib = _build.load_library()
    ll = torch.empty((2, shape[1]), dtype=torch.float32, device=dev)
    out = {}
    for name, args, want in (
            ("tau_sweep", kernel_bench.tau_args(c), TAU_SHA256[shape]),
            ("fused_sweep", kernel_bench.fused_args(c), FUSED_SHA256[shape]),
            ("tau_sweep_topk", kernel_bench.topk_args(topk), TOPK_SHA256[shape]),
            ("gamma_ll", kernel_bench.gamma_ll_args(c), GAMMA_LL_SHA256[shape])):
        tau, mix = args[-5:-3] if name == "tau_sweep_topk" else args[1:3]
        if name == "gamma_ll":
            partial = _build.partial_scratch(lib, shape[0], 2, shape[1], dev)
            fn = lambda: gamma_kernel.launch(lib, *args, partial, ll)  # noqa: E731
            kept = [ll]
        else:
            outs = [torch.empty_like(tau), torch.empty_like(mix)]
            kept = outs
            if name == "tau_sweep":
                fn = lambda: tau_kernel.launch(lib, *args, *outs)  # noqa: E731
            elif name == "tau_sweep_topk":
                fn = lambda: tau_topk.launch(lib, *args, *outs)  # noqa: E731
            else:
                outs += [_build.partial_scratch(lib, shape[0], 2, shape[1], dev), ll]
                fn = lambda: fused_launch(lib, *args, *outs)  # noqa: E731
                kept = [outs[0], outs[1], ll]
        fn()
        torch.cuda.synchronize()
        sha = kernel_bench.digest(*kept)
        gate(sha == want, f"{name} at V={shape[0]} S={shape[1]} G={shape[2]} is bitwise "
             "the one-warp-per-position kernel's")
        device_ms = kernel_bench.event_ms(fn)
        b = kernel_bench.bound(name, *shape)
        out[name] = dict(V=shape[0], S=shape[1], G=shape[2], device_ms=device_ms,
                         bytes=b["bytes"], logs=b["logs"], bound_ms=b["bound_ms"],
                         bound_by=b["bound_by"], share_of_bound=b["bound_ms"] / device_ms,
                         bytes_per_s=b["bytes"] / device_ms * 1e3, sha256=sha)
        info = {}
        if name in kernel_bench.RESIDENT:
            info = tau_kernel.kernel_info(name, shape[1], shape[2])
            out[name].update(tile_plan={"buffers": info["buffers"],
                                        "smem_bytes": info["smem_bytes"]},
                             blocks_per_sm=info["blocks_per_sm"])
        print(f"# {name} V={shape[0]} S={shape[1]} G={shape[2]}: device {device_ms:.4f} "
              f"ms a launch (CUDA events, 200 launches), {b['bytes']} bytes = "
              f"{b['bytes'] / device_ms / 1e6:.1f} GB/s, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), share {b['bound_ms'] / device_ms:.3f}, {info}")
    return out


WIDE = (64, 4000, 4)   # V, S, G past the 3632 samples of shared-memory slots


def phase_wide():
    """A resident sweep past the shared memory of a block's reduction slots
    (S=4000): fused_sweep bitwise the staged chain, swap(emit_ll), gamma_ll
    and gamma_apply_eta against their plain versions to rtol 1e-5; then a
    10-sweep cuda_resident chain there, with the launch counts set to 0 just
    before it and read just after."""
    dev = torch.device("cuda")
    Vw, Sw, Gw = WIDE
    plan = tau_kernel.tile_plan(Sw, Gw, fused=True)
    print(f"# wide: V={Vw} S={Sw} G={Gw}, fused tile plan {plan}")
    gate(plan.device_slots == 1, f"S={Sw}: the fused plan puts the slots in device memory")
    t = synth.generate(V=Vw, S=Sw, G=Gw, coverage=30.0, seed=4)
    rng = np.random.default_rng(4)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32, device=dev)
    gamma = torch.as_tensor(t.gamma, dtype=torch.float32, device=dev)
    eta = torch.as_tensor(t.eta, dtype=torch.float32, device=dev)
    tau = torch.as_tensor(rng.integers(0, 4, size=(Vw, Gw)), dtype=torch.int32, device=dev)
    mix = mixture(one_hot_tau(tau), gamma)
    gz = torch.as_tensor(rng.gumbel(size=(Vw, Gw, 4)), dtype=torch.float32, device=dev)
    g = torch.tensor(Gw - 1, dtype=torch.int32, device=dev)
    h = torch.tensor(0, dtype=torch.int32, device=dev)
    logu = torch.as_tensor(np.log(rng.uniform(size=Vw)), dtype=torch.float32, device=dev)
    gp = torch.as_tensor(rng.dirichlet(np.ones(Gw), size=Sw), dtype=torch.float32, device=dev)
    accept = torch.as_tensor(rng.random(Sw) < 0.5, device=dev)
    fargs = (n, tau, mix, gamma, eta, gz, g, h, logu, gp)
    tau_f, mix_f, ll_f = ops.fused_sweep(*fargs)
    t1, m1 = ops.tau_sweep(*fargs[:6])
    t1, m1, ll_old = ops.swap(n, t1, m1, gamma, eta, g, h, logu, emit_ll=True)
    ll2 = ops.gamma_ll(n, m1, t1, gp, eta, with_old=False)
    torch.cuda.synchronize()
    gate(torch.equal(tau_f, t1) and torch.equal(mix_f, m1)
         and torch.equal(ll_f[0], ll_old) and torch.equal(ll_f[1], ll2[1]),
         f"S={Sw}: fused_sweep is bitwise tau_sweep -> swap(emit_ll) -> "
         "gamma_ll(with_old=False)")
    err = {}
    tau_k, mix_k, ll_k = ops.swap(n, tau, mix, gamma, eta, g, h, logu, emit_ll=True)
    tau_p, mix_p, ll_p = ops.swap_reference(n, tau, mix, gamma, eta, g, h, logu,
                                            emit_ll=True)
    agree = (tau_k == tau_p).all(dim=1).float().mean().item()
    gate(agree >= 0.99, f"S={Sw}: swap(emit_ll) agrees with its plain version on >= 99% "
         "of positions")
    err["swap_emit_ll"] = ll_err(ll_k, ll_p, agree)
    for with_old in (True, False):
        err[f"gamma_ll with_old={with_old}"] = ll_err(
            ops.gamma_ll(n, mix, tau, gp, eta, with_old=with_old),
            ops.gamma_ll_reference(n, mix, tau, gp, eta, with_old))
    mix_k, ll_k = ops.gamma_apply_eta(n, mix, tau, gp, accept, eta)
    mix_p, ll_p = ops.gamma_apply_eta_reference(n, mix, tau, gp, accept, eta)
    gate(torch.allclose(mix_k, mix_p, rtol=1e-5, atol=1e-7),
         f"S={Sw}: gamma_apply_eta mix within rtol 1e-5 / atol 1e-7")
    err["gamma_apply_eta"] = ll_err(ll_k, ll_p)
    print(f"# wide: max |kernel - plain| of the per-sample logliks {err}")

    cfg = sampler.SamplerConfig(G=Gw, burn=5, samples=5, nmf_iters=20)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ops.reset_launches()
    res = sampler.run_chain(n, cfg, gen, kernel="cuda_resident")
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"# wide: 10 cuda_resident sweeps, final loglik "
          f"{res.loglik_trace[-1].item():.6f}, launches {launches}")
    gate(bool(torch.isfinite(res.loglik_trace).all()) and launches["fused_sweep"] == 10
         and launches["gamma_apply_eta"] == 10,
         f"S={Sw}: a cuda_resident chain runs through fused_sweep and gamma_apply_eta")


LAUNCHED = ("tau_sweep", "swap", "gamma_ll", "gamma_apply_eta", "fused_sweep",
            "tau_sweep_topk")
OUTPUTS = ("fit.txt", "Gamma_mean.csv", "Gamma_star.csv", "Eta_mean.csv",
           "Eta_star.csv", "Filtered_Tau_star.csv", "Tau_mean.csv",
           "metrics.json", "loglik_trace.csv")


def read_launches() -> dict:
    """The launch counts since the last reset, added to PATH_LAUNCHES."""
    launches = {k: getattr(ops, k).launches for k in LAUNCHED}
    PATH_LAUNCHES.update(launches)
    return launches


def drive_cli(argv, out):
    """One `desman` CLI run with the launch counts set to 0 just before it
    and read just after; gates rc 0, every output file, a finite fit.txt."""
    ops.reset_launches()
    t0 = time.time()
    rc = cli.main(["desman", *argv, "-o", out])
    wall = time.time() - t0
    launches = read_launches()
    print(f"# cli {' '.join(argv[1:])}: rc {rc}, {wall:.2f} s wall, kernel "
          f"launches {launches}")
    gate(rc == 0, "desman CLI exits 0")
    for f in OUTPUTS:
        gate(os.path.exists(os.path.join(out, f)), f"{f} written")
    fit = io.read_fit_txt(os.path.join(out, "fit.txt"))
    gate(all(np.isfinite(fit[k]) for k in
             ("mean_deviance", "star_deviance", "star_loglik")),
         f"fit.txt finite: {fit}")
    return launches, fit


def variant_half(tmp) -> str:
    """TestData's true-variant positions as a counts CSV (once per run)."""
    csv = os.path.join(tmp, "variants.csv")
    if not os.path.exists(csv):
        data = io.read_counts_csv(os.path.join(TESTDATA, "variant_counts.csv"))
        io.write_counts_csv(csv, data.select(np.flatnonzero(data.positions < 1000)))
    return csv


def quickstart_gates(out, what):
    """tests/test_quickstart.py's gates on an output directory; returns
    metrics.json."""
    true_tau = io.read_tau_star_csv(os.path.join(TESTDATA, "true_tau.csv"))
    true_gamma = io.read_gamma_csv(os.path.join(TESTDATA, "true_gamma.csv"))
    pred, pc, pp = io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))
    true, tc, tp = true_tau
    rep = compare_tau(pred, true, list(zip(map(str, pc), map(int, pp))),
                      list(zip(map(str, tc), map(int, tp))))
    gmae, _ = match_gamma_perm(true_gamma,
                               io.read_gamma_csv(os.path.join(out, "Gamma_mean.csv")))
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    print(f"# cli {what}: SNP error rate {rep.error_rate:.6f}, gamma "
          f"MAE {gmae:.6f}, {metrics['sweeps_per_s']:.2f} sweeps/s on "
          f"{metrics['device']}")
    gate(rep.error_rate < 0.02, f"{what}: SNP error rate < 0.02")
    gate(gmae < 0.02, f"{what}: gamma MAE < 0.02")
    return metrics


def phase_cli(tmp):
    """The desman CLI on the card through each kernel path, gated like
    tests/test_quickstart.py."""
    csv = variant_half(tmp)
    eta = os.path.join(TESTDATA, "true_eta.csv")
    for kernel, path_kernels in (("cuda", ("tau_sweep", "swap")),
                                 ("cuda_resident", ("fused_sweep", "gamma_apply_eta"))):
        out = os.path.join(tmp, f"quickstart_{kernel}")
        launches, fit = drive_cli([csv, "-g", "5", "-e", eta, "-i", "150", "-s", "0",
                                   "--kernel", kernel], out)
        print(f"# cli --kernel {kernel}: star deviance {fit['star_deviance']:.6f}")
        quickstart_gates(out, f"--kernel {kernel}")
        gate(all(launches[k] > 0 for k in path_kernels),
             f"--kernel {kernel} launched {', '.join(path_kernels)}")

    # one strain: no swap to fuse, so the resident path takes the tau kernel
    # and gamma_ll with the carried mixture's term
    launches, _ = drive_cli([csv, "-g", "1", "-i", "40", "-s", "0",
                             "--kernel", "cuda_resident"],
                            os.path.join(tmp, "one_strain"))
    gate(launches["gamma_ll"] > 0 and launches["fused_sweep"] == 0,
         "-g 1 --kernel cuda_resident launched gamma_ll and not fused_sweep")
    SWEEP_LAUNCHES["gamma_ll"] = launches["gamma_ll"] / 40

    # the top-2 kernel refuses counts with 3-4 observed bases in a cell, and
    # nothing falls back to the full kernel
    ops.reset_launches()
    err = stdio.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["desman", os.path.join(TESTDATA, "variant_counts.csv"),
                       "-g", "5", "-i", "10", "--kernel", "cuda_topk",
                       "-o", os.path.join(tmp, "topk_refused")])
    said = err.getvalue().strip()
    print(f"# cli --kernel cuda_topk on TestData: rc {rc}: {said}")
    gate(rc != 0 and ">2 observed bases" in said,
         "--kernel cuda_topk on TestData exits non-zero naming the cells with "
         "more than 2 observed bases")
    gate(all(n == 0 for n in read_launches().values()),
         "--kernel cuda_topk on TestData launched no kernel")


def phase_north_star(tmp):
    """run() at the metric configuration with each kernel choice."""
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    for kernel in ops.KERNELS:
        if kernel == "cuda_topk":   # 3-4 observed bases per cell here
            continue
        out = os.path.join(tmp, f"north_star_{kernel}")
        rc = run.RunConfig(G=G, iterations=400, burn_frac=0.0, seed=0,
                           out_dir=out)
        ops.reset_launches()
        res = run.run(t.data, rc, device="cuda", kernel=kernel, nmf_iters=50)
        launches = read_launches()
        per_sweep = {k: v / 400 for k, v in launches.items() if v}
        print(f"# run --kernel {kernel}: launches a sweep {per_sweep}")
        for k, v in per_sweep.items():
            SWEEP_LAUNCHES[k] = v
        if kernel == "cuda_resident":
            SWEEP_LAUNCHES["swap_emit_ll"] = per_sweep["fused_sweep"]
        trace = res.loglik_trace.cpu().numpy()
        with open(os.path.join(out, "metrics.json")) as f:
            m = json.load(f)
        print(f"# run V={V} S={S} G={G} 400 sweeps --kernel {kernel}: "
              f"{m['sweeps_per_s']:.3f} sweeps/s, {m['elapsed_s']:.3f} s, "
              f"final loglik {m['final_loglik']:.6f}, star deviance "
              f"{m['star_deviance']:.6f}")
        gate(trace.shape == (400,) and bool(np.isfinite(trace).all()),
             f"--kernel {kernel}: 400 finite logliks")


PAPER = dict(V=7000, S=64, G=5, seeds=[0, 1, 2, 3, 4], g_max=8, iterations=250)


N_GENES = 1500


def gene_table(tmp, truth, data):
    """complete_example.py's accessory genes: presence/absence in each true
    strain, every gene in at least one, Poisson coverage from the true
    strain coverages. Returns (gene_cov.csv, etaG [D,G])."""
    rng = np.random.default_rng(2017)
    total = data.counts.sum(axis=2).mean(axis=0)
    etaG = rng.integers(0, 2, size=(N_GENES, PAPER["G"]))
    etaG[etaG.sum(axis=1) == 0, 0] = 1
    x = rng.poisson(np.maximum(etaG @ strain_coverage(truth.gamma, total), 1e-9))
    path = os.path.join(tmp, "gene_cov.csv")
    io.write_gene_table(path, [f"gene{d}" for d in range(N_GENES)],
                        ["n_positions", *data.samples],
                        [np.full(N_GENES, 1000), *x.T.astype(np.float64)])
    return path, etaG


def phase_grid(tmp):
    """The strain-count grid at complete_example.py's --paper scale through
    the pipeline CLI, (a) with cuda_resident at error rate 0.005, with the
    genes stage (phase 7), and (b) with cuda_topk at error rate 0."""
    for tag, error_rate, kernel in (("a", 0.005, "cuda_resident"),
                                    ("b", 0.0, "cuda_topk")):
        truth, data = synth.mock_community(V=PAPER["V"], S=PAPER["S"], G=PAPER["G"],
                                           error_rate=error_rate, seed=2017)
        counts = os.path.join(tmp, f"core_counts_{tag}.csv")
        io.write_counts_csv(counts, data)
        out = os.path.join(tmp, f"grid_{tag}")
        config = {"counts": counts, "output_dir": out,
                  "grid": {"g_min": 1, "g_max": PAPER["g_max"],
                           "seeds": PAPER["seeds"],
                           "iterations": PAPER["iterations"], "kernel": kernel}}
        if tag == "a":
            genes_csv, etaG = gene_table(tmp, truth, data)
            config["genes"] = {"coverage_csv": genes_csv}
        config_path = os.path.join(tmp, f"pipeline_{tag}.json")
        with open(config_path, "w") as f:
            json.dump(config, f)
        ops.reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(stdio.StringIO()):
            rc = cli.main(["pipeline", config_path])
        wall = time.time() - t0
        launches = read_launches()
        gate(rc == 0, f"pipeline ({tag}) exits 0")
        with open(os.path.join(out, "pipeline_summary.json")) as f:
            summary = json.load(f)
        best = summary["best_run_dir"]
        pred, pc, pp = io.read_tau_star_csv(os.path.join(best, "Filtered_Tau_star.csv"))
        rep = compare_tau(pred, truth.tau_idx,
                          list(zip(map(str, pc), map(int, pp))),
                          [("synth", i) for i in range(PAPER["V"])])
        gamma_inf = io.read_gamma_csv(os.path.join(best, "Gamma_mean.csv"))
        gmae, (ti, pi) = match_gamma_perm(truth.gamma, gamma_inf)
        print(f"# grid ({tag}) error rate {error_rate} kernel {kernel}: "
              f"{summary['V_selected']}/{summary['V_total']} positions selected, "
              f"G={summary['selected_G']} (seed {summary['best_seed']}), SNP error "
              f"rate {rep.error_rate:.6f}, gamma MAE {gmae:.6f}; pipeline wall "
              f"{wall:.2f} s, grid {summary['grid_wall_s']:.2f} s for "
              f"{summary['grid_sweeps']} sweeps = "
              f"{summary['grid_sweeps'] / summary['grid_wall_s']:.2f} sweeps/s; "
              f"launches {launches}")
        gate(summary["selected_G"] == PAPER["G"],
             f"grid ({tag}) selects G={PAPER['G']}")
        gate(rep.error_rate < 0.02, f"grid ({tag}) SNP error rate < 0.02")
        gate(gmae < 0.02, f"grid ({tag}) gamma MAE < 0.02")
        if tag == "a":
            gate(launches["fused_sweep"] > 0 and launches["gamma_apply_eta"] > 0,
                 "grid (a) launched fused_sweep and gamma_apply_eta")
            picked = os.path.join(tmp, "resolvenhap_a.csv")
            with contextlib.redirect_stdout(stdio.StringIO()):
                rc = cli.main(["resolvenhap", os.path.join(out, "run_*"), "-o", picked])
            with open(picked) as f, open(os.path.join(out, "best.txt")) as g:
                same = rc == 0 and f.read() == g.read()
            gate(same, "resolvenhap on grid (a)'s run dirs picks best.txt's run")
            # phase 7: the genes stage on the selected run's strains
            etaS = io.read_gene_cov_csv(os.path.join(out, "geneassign_etaS_df.csv"))
            acc = float((etaS.values[:, pi] == etaG[:, ti]).mean())
            print(f"# genes: {summary['genes_assigned']} accessory genes x "
                  f"{etaS.values.shape[1]} strains, presence accuracy {acc:.6f}, "
                  f"stage wall {summary['genes_wall_s']:.3f} s")
            gate(summary["genes_assigned"] == N_GENES and acc > 0.9,
                 f"genes stage: presence accuracy > 0.9 over {N_GENES} genes")
        else:
            gate(launches["tau_sweep_topk"] > 0 and launches["tau_sweep"] == 0,
                 "grid (b) launched tau_sweep_topk and never tau_sweep")
            same_chain(out)


def same_chain(out):
    """A G=5 seed-0 chain on grid (b)'s selected counts and eta: its loglik
    trace with cuda_topk is the one with cuda, bit for bit."""
    dev = torch.device("cuda")
    sel = io.read_counts_csv(os.path.join(out, "sel_var.csv"))
    n = torch.as_tensor(sel.counts, dtype=torch.float32, device=dev)
    eta = torch.as_tensor(io.read_eta_csv(os.path.join(out, "tran_df.csv")),
                          dtype=torch.float32, device=dev)
    burn = PAPER["iterations"] // 2
    cfg = sampler.SamplerConfig(G=PAPER["G"], burn=burn,
                                samples=PAPER["iterations"] - burn, fix_eta=True)
    traces = {}
    for kernel in ("cuda_topk", "cuda"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        ops.reset_launches()
        traces[kernel] = sampler.run_chain(n, cfg, gen, eta_init=eta,
                                           kernel=kernel).loglik_trace
        torch.cuda.synchronize()
        launches = read_launches()
        if kernel == "cuda_topk":
            SWEEP_LAUNCHES["tau_sweep_topk"] = (launches["tau_sweep_topk"]
                                                / PAPER["iterations"])
    print(f"# G={PAPER['G']} seed-0 chain on grid (b)'s counts: final loglik cuda_topk "
          f"{traces['cuda_topk'][-1].item():.6f}, cuda {traces['cuda'][-1].item():.6f}")
    gate(torch.equal(traces["cuda_topk"], traces["cuda"]),
         "a cuda_topk chain's loglik trace is torch.equal to the cuda chain's")


def phase_assign_tau():
    """assign_gene_tau at the metric configuration with the true gamma and
    eta: the annealed Gibbs path (4^8 > 4096) through the tau kernel and
    its plain version from one generator seed, and G=5's exact
    enumeration."""
    dev = torch.device("cuda")
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    for sweeps, bar in ((50, None), (1600, 0.02)):
        rates, stars = {}, {}
        for kernel in ("cuda", "torch"):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.time()
            star, mean = assign_gene_tau(t.data.counts, t.gamma, t.eta, sweeps=sweeps,
                                         seed=0, device=dev, kernel=kernel)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = read_launches()
            stars[kernel] = star.cpu().numpy()
            rates[kernel] = float((stars[kernel] != t.tau_idx).mean())
            print(f"# assign_gene_tau V={V} S={S} G={G} {sweeps} sweeps kernel "
                  f"{kernel}: tau error rate {rates[kernel]:.6f}, {wall:.3f} s wall, "
                  f"tau_sweep launches {launches['tau_sweep']}")
            gate(launches["tau_sweep"] == (sweeps if kernel == "cuda" else 0),
                 f"assign_gene_tau kernel={kernel}: tau kernel launched "
                 f"{sweeps if kernel == 'cuda' else 0} times")
            gate(bool(torch.isfinite(mean).all()) and star.shape == (V, G),
                 f"assign_gene_tau kernel={kernel}: finite [V,G,4] posterior")
            if bar is not None:
                gate(rates[kernel] <= bar,
                     f"assign_gene_tau {sweeps} sweeps kernel={kernel}: "
                     f"<= {bar:.0%} tau errors")
        print(f"# assign_gene_tau {sweeps} sweeps: kernel and plain calls agree on "
              f"{(stars['cuda'] == stars['torch']).mean():.6f} of the cells")
        gate(abs(rates["cuda"] - rates["torch"]) <= 0.005,
             f"assign_gene_tau {sweeps} sweeps: kernel and plain error rates "
             "within 0.5 points")
    t5 = synth.generate(V=V, S=S, G=5, coverage=50.0, seed=0)
    t0 = time.time()
    star, _ = assign_gene_tau(t5.data.counts, t5.gamma, t5.eta, device=dev)
    torch.cuda.synchronize()
    rate = float((star.cpu().numpy() != t5.tau_idx).mean())
    print(f"# assign_gene_tau V={V} S={S} G=5 (enumeration of 1024 states): "
          f"tau error rate {rate:.6f}, {time.time() - t0:.3f} s wall")
    gate(rate <= 0.02, "assign_gene_tau G=5 enumeration: <= 2% tau errors")


def phase_run_modes(tmp):
    """The desman run modes on TestData's true-variant half, as phase 4
    runs the CLI, each held to the quickstart gates."""
    csv = variant_half(tmp)
    eta = os.path.join(TESTDATA, "true_eta.csv")
    true_tau = os.path.join(TESTDATA, "true_tau.csv")
    base = [csv, "-g", "5", "-i", "150", "-s", "0", "-e", eta]

    out = os.path.join(tmp, "mode_rows")
    launches, _ = drive_cli(base + ["--sample_eta", "--eta_update", "rows",
                                    "--kernel", "cuda"], out)
    m = quickstart_gates(out, "--eta_update rows --sample_eta")
    gate(m["accept_eta"] > 0 and launches["tau_sweep"] > 0 and launches["swap"] > 0,
         f"--eta_update rows: accept_eta {m['accept_eta']:.4f} > 0, tau and swap "
         "kernels launched")

    out = os.path.join(tmp, "mode_store")
    launches, _ = drive_cli(base + ["--store_every", "5", "--kernel", "cuda"], out)
    m = quickstart_gates(out, "--store_every 5")
    draws = io.read_draws(os.path.join(out, "draws.npz"))
    print(f"# --store_every 5: draws tau {draws['tau'].shape} {draws['tau'].dtype}, "
          f"gamma_ess_min {m.get('gamma_ess_min')}")
    gate(draws["tau"].shape == (15, 1000, 5) and draws["gamma"].shape == (15, 16, 5)
         and "gamma_ess_min" in m and launches["tau_sweep"] > 0,
         "--store_every 5: draws.npz holds 15 draws, metrics carry gamma_ess_min")

    out = os.path.join(tmp, "mode_tau_init")
    launches, _ = drive_cli(base + ["-t", true_tau, "--kernel", "cuda_resident"], out)
    quickstart_gates(out, "-t --kernel cuda_resident")
    gate(launches["fused_sweep"] > 0 and launches["gamma_apply_eta"] > 0,
         "-t --kernel cuda_resident launched fused_sweep and gamma_apply_eta")

    out = os.path.join(tmp, "mode_tau_fixed")
    launches, _ = drive_cli(base + ["-f", true_tau, "--kernel", "cuda"], out)
    quickstart_gates(out, "-f")
    got, gc, gp = io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))
    want, wc, wp = io.read_tau_star_csv(true_tau)
    row = {(str(c), int(p)): i for i, (c, p) in enumerate(zip(wc, wp))}
    same = np.array_equal(got, want[[row[(str(c), int(p))] for c, p in zip(gc, gp)]])
    gate(same and launches["tau_sweep"] == 0 and launches["swap"] == 0,
         "-f: Filtered_Tau_star.csv is the file's haplotypes, no tau or swap launch")

    ops.reset_launches()
    err = stdio.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["desman", *base, "-f", true_tau, "--kernel", "cuda_resident",
                       "-o", os.path.join(tmp, "mode_refused")])
    said = err.getvalue().strip()
    print(f"# cli -f --kernel cuda_resident: rc {rc}: {said}")
    gate(rc == 2 and "--kernel cuda" in said
         and all(n == 0 for n in read_launches().values()),
         "-f --kernel cuda_resident exits 2 naming --kernel cuda, no launch")


CK_SWEEPS = 400
# the files a resumed run must write byte for byte as the uninterrupted one
RESUMED = ("fit.txt", "Filtered_Tau_star.csv", "Gamma_star.csv", "Gamma_mean.csv",
           "Eta_star.csv", "Eta_mean.csv", "Tau_mean.csv", "loglik_trace.csv")


def read_metrics(out) -> dict:
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


def same_files(a, b) -> bool:
    return same_files_of(a, b, RESUMED)


def same_files_of(a, b, names) -> bool:
    for f in names:
        with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                print(f"# {f} differs between {a} and {b}")
                return False
    return True


def desman_process(argv) -> subprocess.Popen:
    """`python -m desman_tpu_torch desman ...` from the checkout, on the card
    (no --device: it exits 2 without CUDA)."""
    return subprocess.Popen([sys.executable, "-m", "desman_tpu_torch", "desman", *argv],
                            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, timeout=600):
    """Wait for a process; kill it if it outlives the timeout. Returns
    (rc, stderr)."""
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode, err


def snapshot_it(ck):
    if not os.path.exists(ck):
        return None
    with np.load(ck) as z:
        return int(z["it"])


def run_together(runs):
    """Start the checkpointed desman subprocesses of `runs` ((what, argv, ck,
    signal or None) each) together; send each its signal once its snapshot
    shows 0 < it < CK_SWEEPS, and gate that it landed there (a run without
    a signal must exit 0). Returns each run's (rc, stderr)."""
    t0 = time.time()
    procs = [desman_process(argv) for _, argv, _, _ in runs]
    pending = {i for i, (_, _, _, sig) in enumerate(runs) if sig is not None}
    seen = {}
    try:
        deadline = time.time() + 600
        while pending and time.time() < deadline:
            for i in sorted(pending):
                it = snapshot_it(runs[i][2])
                if procs[i].poll() is not None:
                    pending.discard(i)
                elif it is not None and 0 < it < CK_SWEEPS:
                    procs[i].send_signal(runs[i][3])
                    seen[i] = it
                    pending.discard(i)
            time.sleep(0.002)
    finally:
        results = [finish(proc) for proc in procs]
    print(f"# {len(runs)} desman subprocesses side by side: {time.time() - t0:.2f} s wall")
    for i, ((what, _, ck, sig), (rc, err)) in enumerate(zip(runs, results)):
        at = snapshot_it(ck)
        print(f"# {what}: rc {rc}, snapshot on disk it={at}"
              + (f", signal at it={seen.get(i)}" if sig is not None else ""))
        if sig is None:
            gate(rc == 0, f"{what} exits 0 ({err.strip()[-300:]})")
        else:
            gate(i in seen and at is not None and 0 < at < CK_SWEEPS,
                 f"{what} landed mid-run (0 < it < {CK_SWEEPS})")
    return results


def refused(argv, what, words=("single-device speed mode", "--kernel cuda")):
    """A desman CLI refusal: exit 2 with the JAX CLI's message (holding
    `words`), no launch."""
    ops.reset_launches()
    err = stdio.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["desman", *argv])
    said = err.getvalue().strip()
    print(f"# cli {what}: rc {rc}: {said}")
    gate(rc == 2 and all(w in said for w in words)
         and all(n == 0 for n in read_launches().values()),
         f"{what} exits 2 with the JAX CLI's message, no launch")


def checkpoint_cost(tmp, data):
    """What checkpointing costs at V=1e4 S=64 G=8: run() of 400 sweeps with
    and without --checkpoint_every 50, in turns (plain, checkpointed,
    checkpointed, plain; the kernels warm), and the median of 5
    checkpoint.save calls of that chain's state."""
    from desman_tpu_torch import checkpoint

    rates = {"plain": [], "checkpoint_every 50": []}
    for i, mode in enumerate(("plain", "checkpoint_every 50", "checkpoint_every 50",
                              "plain")):
        out = os.path.join(tmp, f"len_rate_{i}")
        rcfg = run.RunConfig(G=G, iterations=CK_SWEEPS, seed=0, out_dir=out)
        if mode != "plain":
            rcfg.checkpoint_path = os.path.join(tmp, f"rate_{i}.npz")
        run.run(data, rcfg, device="cuda", kernel="cuda")
        rates[mode].append(read_metrics(out)["sweeps_per_s"])
    print(f"# run() V={V} S={S} G={G} {CK_SWEEPS} sweeps (NMF start included), in turns "
          f"plain, checkpointed, checkpointed, plain: sweeps/s {rates}")
    dev = torch.device("cuda")
    n = torch.as_tensor(data.counts, dtype=torch.float32, device=dev)
    gen = sampler.chain_generator(0, dev)
    state = sampler.init_state(n, sampler.SamplerConfig(G=G, nmf_iters=50), gen)
    accum = sampler.init_accum(V, S, G, dev)
    path = os.path.join(tmp, "snapshot_timing.npz")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(path, state, accum, CK_SWEEPS, np.zeros(CK_SWEEPS, np.float32), [gen])
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    print(f"# snapshot write at V={V} S={S} G={G}: {os.path.getsize(path)} bytes, "
          f"median {times[2]:.3f} ms of 5 ({times})")


def phase_run_length(tmp):
    """Phase 10: checkpoint/resume and auto-length runs (see the module
    docstring)."""
    t_phase = time.time()
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    csv = os.path.join(tmp, "metric_counts.csv")
    io.write_counts_csv(csv, t.data)
    base = [csv, "-g", str(G), "-i", str(CK_SWEEPS), "-s", "0", "--kernel", "cuda"]

    # (a) and (b): SIGKILL / SIGTERM mid-run, then rerun: byte-identical to
    # the uninterrupted checkpointed run and to the in-process run without
    # --checkpoint; the subprocesses run side by side (each takes seconds
    # to reach the card)
    inproc = os.path.join(tmp, "len_inproc")
    launches, _ = drive_cli(base, inproc)
    gate(launches["tau_sweep"] == CK_SWEEPS and launches["swap"] == CK_SWEEPS,
         f"the in-process run launched tau_sweep and swap {CK_SWEEPS} times")
    ck_args = ["--checkpoint_every", "50", "--checkpoint"]
    runs = {}
    for name, sig in (("whole", None), ("killed", signal.SIGKILL),
                      ("termed", signal.SIGTERM)):
        out, ck = os.path.join(tmp, f"len_{name}"), os.path.join(tmp, f"{name}.npz")
        runs[name] = (f"--checkpoint_every 50 run, {name}",
                      base + ["-o", out] + ck_args + [ck], ck, sig)
    (_, _), (rc_killed, _), (rc_termed, err) = run_together(list(runs.values()))
    print(f"# SIGTERM stderr: {err.strip()[-200:]}")
    gate(rc_killed == -signal.SIGKILL, "the killed run died of SIGKILL")
    gate(rc_termed == 75 and "preempted" in err, "SIGTERM: exit 75 naming the preemption")
    run_together([(f"rerun of the {name} run", *runs[name][1:3], None)
                  for name in ("killed", "termed")])
    whole = os.path.join(tmp, "len_whole")
    gate(same_files(os.path.join(tmp, "len_killed"), whole) and same_files(whole, inproc),
         "the SIGKILLed and resumed run's files are byte-identical to the "
         "uninterrupted run's and to the in-process run's without --checkpoint")
    gate(same_files(os.path.join(tmp, "len_termed"), whole), "the preempted and "
         "resumed run's files are byte-identical to the uninterrupted run's")
    checkpoint_cost(tmp, t.data)

    # (c) auto length, in-process
    auto = ["--auto_burn", "--auto_samples", "100"]
    out = os.path.join(tmp, "len_auto")
    launches, _ = drive_cli([csv, "-g", str(G), "-i", "200", "-s", "0", "--kernel", "cuda",
                             *auto], out)
    m = read_metrics(out)
    burn = m["sweeps"] - m["sampling_sweeps"]
    print(f"# --auto_burn --auto_samples 100 V=1e4: burn {burn}, sampling "
          f"{m['sampling_sweeps']}, loglik_ess_bulk {m.get('loglik_ess_bulk')}, "
          f"{m['sweeps_per_s']:.3f} sweeps/s, chain wall {m['elapsed_s']:.3f} s")
    gate(launches["tau_sweep"] > 0 and launches["swap"] > 0,
         "auto run launched tau_sweep and swap")
    gate(100 <= burn <= 2000, "auto run: 100 <= burn <= --auto_max_burn")
    gate(m.get("loglik_ess_bulk", 0.0) >= 100 or m["sampling_sweeps"] == 2000,
         "auto run: loglik_ess_bulk >= 100, or sampling at its cap")
    half = variant_half(tmp)
    eta = os.path.join(TESTDATA, "true_eta.csv")
    out = os.path.join(tmp, "len_auto_half")
    drive_cli([half, "-g", "5", "-e", eta, "-i", "200", "-s", "0", *auto], out)
    quickstart_gates(out, "--auto_burn --auto_samples 100")
    out = os.path.join(tmp, "len_auto_topk")
    launches, _ = drive_cli([os.path.join(tmp, "grid_b", "sel_var.csv"), "-g", "5", "-i",
                             "200", "-s", "0", "--kernel", "cuda_topk", *auto], out)
    m = read_metrics(out)
    print(f"# --kernel cuda_topk auto on grid (b)'s counts: burn "
          f"{m['sweeps'] - m['sampling_sweeps']}, sampling {m['sampling_sweeps']}, "
          f"{m['sweeps_per_s']:.3f} sweeps/s")
    gate(launches["tau_sweep_topk"] > 0 and launches["tau_sweep"] == 0,
         "cuda_topk auto run launched tau_sweep_topk and never tau_sweep")

    # (d) chains on TestData's half
    for extra, what in ((["--checkpoint", os.path.join(tmp, "chains.npz")],
                         "--chains 4 --checkpoint"),
                        (["--auto_burn"], "--auto_burn --chains 4")):
        out = os.path.join(tmp, f"len_chains_{extra[0].strip('-')}")
        drive_cli([half, "-g", "5", "-e", eta, "-i", "150", "-s", "0", "--chains", "4",
                   *extra], out)
        quickstart_gates(out, what)
        with open(os.path.join(out, "chains.json")) as f:
            chains = json.load(f)
        gate(chains["seeds"] == [0, 1, 2, 3], f"{what}: chains.json of 4 chains")

    # (e) the ESS-targeted grid on phase 6 (a)'s counts, then its resume
    config = {"counts": os.path.join(tmp, "core_counts_a.csv"),
              "output_dir": os.path.join(tmp, "grid_e"),
              "grid": {"g_min": 1, "g_max": PAPER["g_max"], "seeds": PAPER["seeds"],
                       "iterations": PAPER["iterations"], "kernel": "cuda",
                       "auto_samples": 100, "auto_max_samples": 500}}
    config_path = os.path.join(tmp, "pipeline_e.json")
    with open(config_path, "w") as f:
        json.dump(config, f)
    truth, _ = synth.mock_community(V=PAPER["V"], S=PAPER["S"], G=PAPER["G"],
                                    error_rate=0.005, seed=2017)
    for attempt in ("first", "rerun"):
        ops.reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(stdio.StringIO()):
            rc = cli.main(["pipeline", config_path])
        wall = time.time() - t0
        launches = read_launches()
        gate(rc == 0, f"ESS grid ({attempt}) exits 0")
        if attempt == "rerun":
            print(f"# ESS grid rerun: {wall:.2f} s, launches {launches}")
            gate(launches["tau_sweep"] == 0 and launches["swap"] == 0,
                 "the ESS grid's rerun does no new sweep (elastic resume)")
            break
        with open(os.path.join(config["output_dir"], "pipeline_summary.json")) as f:
            summary = json.load(f)
        best = summary["best_run_dir"]
        pred, pc, pp = io.read_tau_star_csv(os.path.join(best, "Filtered_Tau_star.csv"))
        rep = compare_tau(pred, truth.tau_idx, list(zip(map(str, pc), map(int, pp))),
                          [("synth", i) for i in range(PAPER["V"])])
        gmae, _ = match_gamma_perm(truth.gamma, io.read_gamma_csv(
            os.path.join(best, "Gamma_mean.csv")))
        sampling = [read_metrics(os.path.join(config["output_dir"], f"run_{g}_{s}"))
                    ["sampling_sweeps"] for g in range(1, PAPER["g_max"] + 1)
                    for s in PAPER["seeds"]]
        print(f"# ESS grid (auto_samples 100, cap 500, kernel cuda): G="
              f"{summary['selected_G']}, SNP error rate {rep.error_rate:.6f}, gamma MAE "
              f"{gmae:.6f}; sampling sweeps a run min {min(sampling)} median "
              f"{sorted(sampling)[len(sampling) // 2]} max {max(sampling)}; pipeline "
              f"wall {wall:.2f} s, grid {summary['grid_wall_s']:.2f} s for "
              f"{summary['grid_sweeps']} sweeps = "
              f"{summary['grid_sweeps'] / summary['grid_wall_s']:.2f} sweeps/s; "
              f"launches {launches}")
        gate(summary["selected_G"] == PAPER["G"], f"ESS grid selects G={PAPER['G']}")
        gate(rep.error_rate < 0.02 and gmae < 0.02,
             "ESS grid: SNP error rate < 0.02, gamma MAE < 0.02")
        floor = PAPER["iterations"] - PAPER["iterations"] // 2
        gate(len(sampling) == PAPER["g_max"] * len(PAPER["seeds"])
             and min(sampling) >= floor, f"every ESS grid run sampled >= {floor} sweeps")

    # (f) the resident kernel refuses both modes
    refused([half, "-g", "5", "-i", "10", "--kernel", "cuda_resident", "--checkpoint",
             os.path.join(tmp, "refused.npz"), "-o", os.path.join(tmp, "len_refused")],
            "--checkpoint --kernel cuda_resident")
    refused([half, "-g", "5", "-i", "10", "--kernel", "cuda_resident", "--auto_burn",
             "-o", os.path.join(tmp, "len_refused")], "--auto_burn --kernel cuda_resident")
    print(f"# phase 10 wall {time.time() - t_phase:.2f} s")


PT_R = 4


def pt_turns(data):
    """ms a sweep of the plain chain and ms an ensemble sweep of PT_R
    replicas at V=1e4 S=64 G=8 on cuda, 400 sweeps each after its start, in
    turns plain, PT, PT, plain (CUDA-synchronised host clock; launches not
    counted: every count is reset before the next path)."""
    dev = torch.device("cuda")
    n = torch.as_tensor(data.counts, dtype=torch.float32, device=dev)
    cfg = sampler.SamplerConfig(G=G, burn=CK_SWEEPS // 2, samples=CK_SWEEPS // 2,
                                nmf_iters=50)
    ks = ops.resolve("cuda", n)
    times = {"plain": [], "pt": []}
    for mode in ("plain", "pt", "pt", "plain"):
        if mode == "plain":
            gen = sampler.chain_generator(0, dev)
            args = (sampler.init_state(n, cfg, gen), sampler.init_accum(V, S, G, dev), 0,
                    CK_SWEEPS, sampler.TorchNoise(gen), ks)
            fn = sampler.run_segment
        else:
            gens = sampler.pt_generators(0, PT_R, dev)
            noises, exchange = sampler.pt_noises(gens)
            args = (*sampler.pt_init(n, cfg, gens[:PT_R]), 0, CK_SWEEPS, noises,
                    exchange, 8.0, ks)
            fn = sampler.run_pt_segment
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n, cfg, *args)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3 / CK_SWEEPS)
    ops.reset_launches()
    return times


def crossing_case():
    """tests/test_pt.py::test_pt_crosses_modes_plain_gibbs_cannot's counts,
    truth and half label-swapped start."""
    rng = np.random.default_rng(3)
    Vc, Sc = 40, 4
    tau_idx = rng.integers(0, 4, size=(Vc, 2))
    same = tau_idx[:, 0] == tau_idx[:, 1]
    tau_idx[same, 1] = (tau_idx[same, 0] + 1) % 4
    gamma = np.tile(np.array([0.8, 0.2]), (Sc, 1))
    eta = np.full((4, 4), 0.01 / 3) + np.eye(4) * (0.99 - 0.01 / 3)
    probs = np.einsum("vsa,ab->vsb",
                      np.einsum("vga,sg->vsa", np.eye(4)[tau_idx], gamma), eta)
    counts = rng.poisson(5.0 * probs)
    tau0 = tau_idx.copy()
    tau0[Vc // 2:] = tau0[Vc // 2:, ::-1]
    return counts, tau_idx, tau0, gamma, eta


def phase_pt(tmp):
    """Phase 11: parallel tempering (see the module docstring)."""
    from desman_tpu_torch import checkpoint
    from desman_tpu_torch.utils import snp_distance_perm

    t_phase = time.time()
    dev = torch.device("cuda")
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    # (a) run() at full width, then the plain chain and PT in turns
    out = os.path.join(tmp, "pt_run")
    rc = run.RunConfig(G=G, iterations=CK_SWEEPS, seed=0, out_dir=out,
                       pt_replicas=PT_R, pt_max_temp=8.0)
    ops.reset_launches()
    res = run.run(t.data, rc, device="cuda", kernel="cuda", nmf_iters=50)
    launches = read_launches()
    m = read_metrics(out)
    trace = res.loglik_trace.cpu().numpy()
    print(f"# run --pt {PT_R} V={V} S={S} G={G} {CK_SWEEPS} sweeps: pt_swap_accept "
          f"{m['pt_swap_accept']:.6f}, final loglik {m['final_loglik']:.6f}, star "
          f"deviance {m['star_deviance']:.6f}, {m['sweeps_per_s']:.3f} ensemble "
          f"sweeps/s, launches {launches}")
    gate(launches["tau_sweep"] == PT_R * CK_SWEEPS and launches["swap"] == PT_R * CK_SWEEPS,
         f"--pt {PT_R}: tau_sweep and swap launched {PT_R} x {CK_SWEEPS} times")
    gate(0.0 < m["pt_swap_accept"] <= 1.0, "0 < pt_swap_accept <= 1")
    gate(trace.shape == (CK_SWEEPS,) and bool(np.isfinite(trace).all()),
         f"--pt {PT_R}: {CK_SWEEPS} finite cold logliks")
    times = pt_turns(t.data)
    print(f"# in turns plain, PT, PT, plain at V={V} S={S} G={G}, {CK_SWEEPS} sweeps: "
          f"ms an ensemble sweep of {PT_R} {times['pt']}, {PT_R} x ms a plain sweep "
          f"{[PT_R * x for x in times['plain']]} (ratio of the sums "
          f"{sum(times['pt']) / (PT_R * sum(times['plain'])):.4f})")

    # one record at V=1e5 S=96 G=16: wall and peak memory
    big = synth.generate(V=100_000, S=96, G=16, coverage=50.0, seed=0)
    out = os.path.join(tmp, "pt_big")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.time()
    res = run.run(big.data, run.RunConfig(G=16, iterations=40, seed=0, out_dir=out,
                                          pt_replicas=PT_R),
                  device="cuda", kernel="cuda", nmf_iters=50)
    wall = time.time() - t0
    launches = read_launches()
    m = read_metrics(out)
    peak = torch.cuda.max_memory_allocated()
    print(f"# run --pt {PT_R} V=1e5 S=96 G=16, 40 sweeps: wall {wall:.3f} s (chain "
          f"{m['elapsed_s']:.3f} s, {m['sweeps_per_s']:.3f} ensemble sweeps/s), peak "
          f"device memory {peak} bytes, pt_swap_accept {m['pt_swap_accept']:.6f}")
    gate(launches["tau_sweep"] == PT_R * 40
         and bool(torch.isfinite(res.loglik_trace).all()),
         "V=1e5 PT run: 160 tau launches, finite cold logliks")
    del res, big

    # (b) accuracy through the CLI
    half = variant_half(tmp)
    eta = os.path.join(TESTDATA, "true_eta.csv")
    out = os.path.join(tmp, "pt_half")
    launches, _ = drive_cli([half, "-g", "5", "-e", eta, "-i", "200", "-s", "0",
                             "--pt", str(PT_R)], out)
    m = quickstart_gates(out, f"--pt {PT_R}")
    gate(launches["tau_sweep"] == PT_R * 200 and 0.0 < m["pt_swap_accept"] <= 1.0,
         f"--pt {PT_R} on TestData's half: {PT_R * 200} tau launches, "
         f"pt_swap_accept {m['pt_swap_accept']:.6f}")
    out = os.path.join(tmp, "pt_topk")
    launches, _ = drive_cli([os.path.join(tmp, "grid_b", "sel_var.csv"), "-g", "5", "-i",
                             "200", "-s", "0", "--kernel", "cuda_topk", "--pt",
                             str(PT_R)], out)
    print(f"# --pt {PT_R} --kernel cuda_topk on grid (b)'s counts: pt_swap_accept "
          f"{read_metrics(out)['pt_swap_accept']:.6f}")
    gate(launches["tau_sweep_topk"] == PT_R * 200 and launches["tau_sweep"] == 0,
         "--pt --kernel cuda_topk launched tau_sweep_topk and never tau_sweep")

    # (c) mode crossing: PT's star within 2 SNPs of the truth, plain's worse
    counts, truth, tau0, gamma, eta_c = crossing_case()
    n = torch.as_tensor(counts, dtype=torch.float32, device=dev)
    init = dict(eta_init=torch.as_tensor(eta_c, dtype=torch.float32, device=dev),
                gamma_init=torch.as_tensor(gamma, dtype=torch.float32, device=dev),
                tau_init=torch.as_tensor(tau0, dtype=torch.int32, device=dev))
    cfg = sampler.SamplerConfig(G=2, burn=200, samples=200, nmf_iters=0,
                                anneal_temp0=1.0, swap_moves=False, fix_gamma=True,
                                fix_eta=True)
    d_pt, d_plain = [], []
    ops.reset_launches()
    for seed in range(4):   # a plain chain crosses now and then: four seeds
        plain = sampler.run_chain(n, cfg, sampler.chain_generator(seed, dev), **init)
        pt = sampler.run_chain_pt(n, cfg, seed, n_replicas=6, max_temp=16.0, **init)
        d_plain.append(snp_distance_perm(truth, plain.tau_star.cpu().numpy()))
        d_pt.append(snp_distance_perm(truth, pt.tau_star.cpu().numpy()))
    launches = read_launches()
    print(f"# mode crossing (V=40, 6 rungs to T=16, seeds 0-3): star SNP distances PT "
          f"{d_pt}, plain {d_plain}; launches {launches}")
    gate(max(d_pt) <= 2 and sum(d_plain) > sum(d_pt)
         and launches["tau_sweep"] == 4 * (400 + 6 * 400),
         "PT's stars within 2 SNPs of the truth, plain Gibbs's further from it")

    # (d) resume: --pt --checkpoint subprocesses SIGKILLed / SIGTERMed and rerun
    csv = os.path.join(tmp, "metric_counts.csv")
    base = [csv, "-g", str(G), "-i", str(CK_SWEEPS), "-s", "0", "--kernel", "cuda",
            "--pt", str(PT_R), "--checkpoint_every", "50", "--checkpoint"]
    runs = {}
    for name, sig in (("whole", None), ("killed", signal.SIGKILL),
                      ("termed", signal.SIGTERM)):
        out, ck = os.path.join(tmp, f"pt_{name}"), os.path.join(tmp, f"pt_{name}.npz")
        runs[name] = (f"--pt {PT_R} --checkpoint run, {name}", base + [ck, "-o", out],
                      ck, sig)
    (_, _), (rc_killed, _), (rc_termed, err) = run_together(list(runs.values()))
    gate(rc_killed == -signal.SIGKILL, "the killed PT run died of SIGKILL")
    gate(rc_termed == 75 and "preempted" in err,
         "SIGTERM: the PT run exits 75 naming the preemption")
    run_together([(f"rerun of the {name} PT run", *runs[name][1:3], None)
                  for name in ("killed", "termed")])
    whole = os.path.join(tmp, "pt_whole")
    gate(same_files(os.path.join(tmp, "pt_killed"), whole)
         and same_files(os.path.join(tmp, "pt_termed"), whole),
         "the SIGKILLed and the SIGTERMed PT runs resume byte-identical to the "
         "uninterrupted run")
    small = synth.generate(V=2000, S=32, G=4, coverage=50.0, seed=2)
    n = torch.as_tensor(small.data.counts, dtype=torch.float32, device=dev)
    cfg = sampler.SamplerConfig(G=4, burn=30, samples=30, nmf_iters=50,
                                store_samples=True, store_thin=5)
    ops.reset_launches()
    ref = sampler.run_chain_pt(n, cfg, 3, n_replicas=PT_R)
    got = checkpoint.run_chain_pt_checkpointed(n, cfg, 3, os.path.join(tmp, "pt_in.npz"),
                                               checkpoint_every=20, n_replicas=PT_R)
    read_launches()
    gate(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(ref, got)),
         "in process, run_chain_pt_checkpointed is bitwise run_chain_pt (stored "
         "cold draws included)")

    # (e) auto length on TestData's half
    out = os.path.join(tmp, "pt_auto")
    drive_cli([half, "-g", "5", "-e", eta, "-i", "200", "-s", "0", "--pt", str(PT_R),
               "--auto_burn", "--auto_samples", "100"], out)
    m = quickstart_gates(out, f"--pt {PT_R} --auto_burn --auto_samples 100")
    print(f"# --pt {PT_R} --auto_burn --auto_samples 100 on TestData's half: burn "
          f"{m['sweeps'] - m['sampling_sweeps']}, sampling {m['sampling_sweeps']}, "
          f"loglik_ess_bulk {m.get('loglik_ess_bulk')}")

    # (f) the JAX CLI's refusals
    pt = ["--pt", str(PT_R), "-o", os.path.join(tmp, "pt_refused")]
    single = ("composes only single-chain",)
    refused([half, "-g", "5", "-i", "10", *pt, "--auto_burn", "--checkpoint",
             os.path.join(tmp, "pt_refused.npz")], "--pt --auto_burn --checkpoint", single)
    refused([half, "-g", "5", "-i", "10", *pt, "--auto_samples", "50", "--chains", "2"],
            "--pt --auto_samples --chains 2", single)
    refused([half, "-g", "5", "-i", "10", *pt, "--kernel", "cuda_resident"],
            "--pt --kernel cuda_resident",
            ("single-device speed mode", "--kernel cuda for --pt"))
    print(f"# phase 11 wall {time.time() - t_phase:.2f} s")


MB_BINS, MB_G, MB_SWEEPS = 12, 5, 250
# the multibin path's launches of each kernel (phase 12 (a))
MULTIBIN_LAUNCHES = {}
# the tau and swap kernels against their plain versions at its inputs
MULTIBIN_CHECK = {}
SAMPLED = ("Filtered_Tau_star.csv", "Gamma_mean.csv", "Gamma_star.csv",
           "Eta_mean.csv", "Eta_star.csv", "fit.txt")


def multibin_bins():
    """Phase 12's genome bins: 12 of S=64, true G=5, V from 1000 to 1e4 in
    equal steps, each on contigs of its own (2500 positions a contig,
    1-based positions three apart)."""
    bins = []
    for b, vb in enumerate(np.linspace(V // 10, V, MB_BINS).round().astype(int)):
        t = synth.generate(V=int(vb), S=S, G=MB_G, coverage=50.0, seed=200 + b)
        v = np.arange(vb)
        t.data.contigs = np.array([f"bin{b}_contig{k}" for k in v // 2500], dtype=object)
        t.data.positions = (1 + 3 * (v % 2500)).astype(np.int64)
        bins.append(t)
    return bins


def multibin_kernels(counts, b, v_max):
    """The tau and swap kernels against their plain versions at the
    multibin path's inputs: bin b's counts padded with zero rows to v_max
    at G=MB_G, from the state its chain starts in, on that chain's own
    Gumbel and swap noise. On the zero rows (log-likelihood 0) the kernel
    must give the plain version's tau bit for bit: Gumbel argmax there,
    always accepted swap; elsewhere the >= 99% agreement of phase 3. The
    swap starts from the tau sweep's result with strains g and h exchanged
    at every other data row, so both its branches run there."""
    dev = torch.device("cuda")
    Vb = counts.shape[0]
    n = torch.zeros((v_max, S, 4), dtype=torch.float32, device=dev)
    n[:Vb] = torch.as_tensor(counts, dtype=torch.float32, device=dev)
    cfg = sampler.SamplerConfig(G=MB_G, burn=MB_SWEEPS // 2,
                                samples=MB_SWEEPS - MB_SWEEPS // 2)
    gen = sampler.chain_generator(sampler.spawn_seeds(0, MB_BINS)[b], dev)
    st = sampler.init_state(n, cfg, gen)
    gz = ops.draw_gumbel(gen, v_max, MB_G)
    g, h, logu = ops.draw_swap_proposal(gen, v_max, MB_G)
    what = f"bin {b} (V={Vb}) padded to V={v_max} at G={MB_G}"
    tau_s = None
    for name in ("tau_sweep", "swap"):
        if tau_s is None:
            tau0, args = st.tau, (n, st.tau, st.mix, st.gamma, st.eta, gz)
        else:
            tau0 = tau_s
            args = (n, tau_s, mixture(one_hot_tau(tau_s), st.gamma), st.gamma, st.eta,
                    g, h, logu)
        tau_k, mix_k = getattr(ops, name)(*args)
        tau_p, mix_p = getattr(ops, f"{name}_reference")(*args)
        same = (tau_k == tau_p).all(dim=1)
        agree = same.float().mean().item()
        err = (mix_k[same] - mix_p[same]).abs().max().item()
        changed = (tau_k != tau0).any(dim=1).float()
        moved, moved_zero = changed[:Vb].mean().item(), changed[Vb:].mean().item()
        rec = MULTIBIN_CHECK.setdefault(name, {"agreement": 1.0, "max_abs_err": 0.0})
        rec["agreement"] = min(rec["agreement"], agree)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"# multibin {name} on {what}: position agreement {agree:.6f}, changed "
              f"share {moved:.4f} of the data rows and {moved_zero:.4f} of the zero rows, "
              f"max |mix kernel - plain| on agreeing positions {err:.3e}")
        gate(torch.equal(tau_k[Vb:], tau_p[Vb:]),
             f"{name} on {what}: the zero rows' tau is bitwise the plain version's")
        gate(agree >= 0.99, f"{name} on {what}: agrees with its plain version on "
             ">= 99% of positions")
        gate(torch.allclose(mix_k, mixture(one_hot_tau(tau_k), st.gamma), rtol=1e-5,
                            atol=1e-6), f"{name} on {what}: mix == mixture(onehot(tau), gamma)")
        if name == "tau_sweep":
            gate(0 < moved_zero, f"tau_sweep on {what}: the zero rows drew their bases")
            tau_s, ex = tau_p.clone(), torch.arange(0, Vb, 2, device=dev)
            tau_s[ex, g], tau_s[ex, h] = tau_p[ex, h], tau_p[ex, g]
        else:
            gate(0.1 < moved < 0.6 and 0 < moved_zero,
                 f"swap on {what}: accepted where the strains were exchanged, "
                 "and on the zero rows")
    ops.reset_launches()


def same_counts(a, b) -> bool:
    return (np.array_equal(a.counts, b.counts) and np.array_equal(a.positions, b.positions)
            and list(map(str, a.contigs)) == list(map(str, b.contigs)))


def phase_multibin(tmp):
    """Phase 12: the rest of the single-card surface (see the module
    docstring)."""
    from torch.profiler import profile

    from desman_tpu_torch import multibin, pileup, strainfasta
    from desman_tpu_torch.profiling import TRACE_FILE, activities

    t_phase = time.time()
    dev = torch.device("cuda")
    bins = multibin_bins()
    big = bins[-1]
    files = []
    for b, t in enumerate(bins):
        files.append(os.path.join(tmp, f"bin{b:02d}.csv"))
        io.write_counts_csv(files[-1], t.data)
    print(f"# multibin: {MB_BINS} bins, V {[t.data.V for t in bins]}, S={S}, true "
          f"G={MB_G}; one bin's padded counts at a time on the card, {V * S * 4 * 4} "
          "bytes f32")

    # (a) run() on the V=1e4 bin, the multibin CLI, run() again
    def run_big(k):
        ops.reset_launches()
        t0 = time.time()
        run.run(big.data, run.RunConfig(G=MB_G, iterations=MB_SWEEPS, seed=0,
                                        out_dir=os.path.join(tmp, f"mb_run{k}")),
                device="cuda", kernel="cuda")
        torch.cuda.synchronize()
        return time.time() - t0

    walls = [run_big(0)]
    stub = os.path.join(tmp, "mb_")
    ops.reset_launches()
    t0 = time.time()
    rc = cli.main(["multibin", *files, "-g", str(MB_G), "-i", str(MB_SWEEPS), "-s", "0",
                   "--kernel", "cuda", "-o", stub])
    mb_wall = time.time() - t0
    launches = read_launches()
    MULTIBIN_LAUNCHES.update(launches)
    walls.append(run_big(1))
    ops.reset_launches()
    print(f"# multibin -g {MB_G} -i {MB_SWEEPS} --kernel cuda: rc {rc}, {mb_wall:.3f} s "
          f"wall, {mb_wall / MB_BINS:.3f} s a bin; run() on the V={V} bin in turns "
          f"before and after: {walls[0]:.3f} s, {walls[1]:.3f} s; launches {launches}")
    gate(rc == 0, "multibin exits 0")
    gate(launches["tau_sweep"] == MB_BINS * MB_SWEEPS
         and launches["swap"] == MB_BINS * MB_SWEEPS,
         f"multibin launched tau_sweep and swap {MB_BINS} x {MB_SWEEPS} times each")
    for b, t in enumerate(bins):
        out = f"{stub}bin{b:02d}"
        fit = io.read_fit_txt(os.path.join(out, "fit.txt"))
        pred, _, pp = io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))
        rep = compare_tau(pred, t.tau_idx)
        gmae, _ = match_gamma_perm(t.gamma, io.read_gamma_csv(
            os.path.join(out, "Gamma_mean.csv")))
        print(f"# multibin bin {b} (V={t.data.V}): SNP error rate {rep.error_rate:.6f}, "
              f"gamma MAE {gmae:.6f}, star deviance {fit['star_deviance']:.6f}")
        gate(fit["V"] == t.data.V and np.array_equal(pp, t.data.positions),
             f"bin {b}: fit.txt and the calls carry the bin's own {t.data.V} positions")
        gate(rep.error_rate < 0.02 and gmae < 0.02,
             f"bin {b}: SNP error rate < 0.02 and gamma MAE < 0.02")
    # the smallest bin is bitwise run_chain of its padded counts
    V0 = bins[0].data.V
    padded = torch.as_tensor(multibin.pad_bins([bins[0].data.counts, big.data.counts])[0],
                             device=dev)
    cfg = sampler.SamplerConfig(G=MB_G, burn=MB_SWEEPS // 2,
                                samples=MB_SWEEPS - MB_SWEEPS // 2)
    one = sampler.run_chain(padded, cfg, sampler.chain_generator(
        sampler.spawn_seeds(0, MB_BINS)[0], dev), kernel="cuda")
    ops.reset_launches()
    out = f"{stub}bin00"
    tau = io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))[0]
    trace = np.loadtxt(os.path.join(out, "loglik_trace.csv"))
    gstar = io.read_gamma_csv(os.path.join(out, "Gamma_star.csv")).astype(np.float32)
    gate(np.array_equal(tau, one.tau_star[:V0].cpu().numpy())
         and np.array_equal(trace, one.loglik_trace.cpu().numpy().astype(np.float64))
         and np.array_equal(gstar, one.gamma_star.cpu().numpy()),
         f"bin 0 is bitwise run_chain of its counts padded to V={V} (tau star, loglik "
         "trace, gamma star)")
    del padded, one
    for b, v_max in ((0, V), (1, V), (1, V - 1)):
        multibin_kernels(bins[b].data.counts, b, v_max)
    err = stdio.StringIO()
    ops.reset_launches()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["multibin", *files[:2], "-g", str(MB_G), "--kernel", "cuda_topk",
                       "-o", os.path.join(tmp, "mb_topk_")])
    print(f"# multibin --kernel cuda_topk: rc {rc}: {err.getvalue().strip()}")
    gate(rc == 2 and "cuda_topk binds to one counts tensor" in err.getvalue()
         and all(n == 0 for n in read_launches().values()),
         "multibin --kernel cuda_topk exits 2 and launches nothing")

    # (b) extract: the V=1e4 bin as a pileup through the C++ scanner
    pl = os.path.join(tmp, "bin11.pileup")
    t0 = time.time()
    pileup.write_pileup(pl, big.data, seed=0)
    t_write = time.time() - t0
    names = os.path.join(tmp, "samples.txt")
    with open(names, "w") as f:
        f.write("\n".join(big.data.samples) + "\n")
    out_csv = os.path.join(tmp, "extracted.csv")
    t0 = time.time()
    rc = cli.main(["extract", pl, "-n", names, "-o", out_csv])
    t_extract = time.time() - t0
    got = io.read_counts_csv(out_csv)
    gate(rc == 0 and same_counts(got, big.data) and got.samples == big.data.samples,
         f"extract of the V={V} S={S} pileup gives the bin's counts, positions and contigs")
    mb = os.path.getsize(pl) / 1e6
    t0 = time.time()
    pileup.read_pileup(pl)
    t_native = time.time() - t0
    csv_mb = os.path.getsize(files[-1]) / 1e6
    t0 = time.time()
    io.read_counts_csv(files[-1])
    t_csv_native = time.time() - t0
    t0 = time.time()
    io.read_counts_csv(files[-1], prefer_native=False)
    t_csv_py = time.time() - t0
    # a V=1000 slice: the Python parser, .gz input and the gene stage
    small = big.data.select(np.arange(V // 10))
    spl = os.path.join(tmp, "slice.pileup")
    pileup.write_pileup(spl, small, seed=1)
    with open(spl, "rb") as src, gzip.open(spl + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    t0 = time.time()
    py = pileup.read_pileup(spl, prefer_native=False)
    t_py = time.time() - t0
    smb = os.path.getsize(spl) / 1e6
    gate(same_counts(py, small) and same_counts(pileup.read_pileup(spl), small)
         and same_counts(pileup.read_pileup(spl + ".gz"), small),
         f"on a V={small.V} slice the Python parser, the C++ scanner and .gz input agree")
    print(f"# pileup of V={V} S={S}: {mb:.3f} MB written in {t_write:.3f} s; extract "
          f"{t_extract:.3f} s; C++ scanner {t_native:.3f} s ({mb / t_native:.1f} MB/s); "
          f"Python parser on the V={small.V} slice ({smb:.3f} MB) {t_py:.3f} s "
          f"({smb / t_py:.2f} MB/s); counts CSV of {csv_mb:.3f} MB: C++ reader "
          f"{t_csv_native:.3f} s ({csv_mb / t_csv_native:.1f} MB/s), Python reader "
          f"{t_csv_py:.3f} s ({csv_mb / t_csv_py:.2f} MB/s) (host times)")
    genes = os.path.join(tmp, "slice_genes.csv")
    rng = np.random.default_rng(7)
    starts = rng.integers(1, 3 * small.V - 100, size=15)
    with open(genes, "w") as f:
        f.write("gene,contig,start,end\n")
        for k, a in enumerate(starts):
            f.write(f"gene{k},{small.contigs[0]},{a},{a + rng.integers(20, 400)}\n")
        f.write("gene_absent,bin11_contig9,1,100\n")
    slice_csv = os.path.join(tmp, "slice.csv")
    io.write_counts_csv(slice_csv, small)
    gc_extract, gc_genecov = (os.path.join(tmp, f"gc_{w}.csv") for w in ("extract", "genecov"))
    sub_csv = os.path.join(tmp, "slice_genes_counts.csv")
    rc = cli.main(["extract", spl, "-n", names, "-G", genes, "--gene_cov", gc_extract,
                   "-o", sub_csv])
    rc2 = cli.main(["genecov", slice_csv, "-G", genes, "-o", gc_genecov])
    with open(gc_extract, "rb") as a, open(gc_genecov, "rb") as b:
        same_cov = a.read() == b.read()
    from desman_tpu_torch.genecov import read_gene_table
    want, _ = pileup.restrict_to_genes(small, read_gene_table(genes))
    gate(rc == 0 and rc2 == 0 and same_cov and 0 < want.V < small.V
         and same_counts(io.read_counts_csv(sub_csv), want),
         "extract -G --gene_cov: the gene coverage genecov writes, the gene positions' counts")

    # (c) strainfasta on bin 0's calls
    tau_csv = os.path.join(stub + "bin00", "Filtered_Tau_star.csv")
    tau, contigs, positions = io.read_tau_star_csv(tau_csv)
    fa = os.path.join(tmp, "strains_variants.fasta")
    rc = cli.main(["strainfasta", tau_csv, "-o", fa])
    seqs = strainfasta.read_fasta(fa)
    gate(rc == 0 and all(seqs[f"hap{g + 1}"] == "".join("ACGT"[x] for x in tau[:, g])
                         for g in range(MB_G)),
         "strainfasta, variants only: each strain's string is its tau column")
    rng = np.random.default_rng(12)
    ref = {c: rng.choice(list("ACGT"), int(positions[contigs == c].max()) + 50)
           for c in sorted(set(contigs))}
    ref_fa, fa = os.path.join(tmp, "bin00.fasta"), os.path.join(tmp, "strains_full.fasta")
    with open(ref_fa, "w") as f:
        for c, seq in ref.items():
            f.write(f">{c}\n" + "".join(
                "".join(seq[i:i + 70]) + "\n" for i in range(0, len(seq), 70)))
    rc = cli.main(["strainfasta", tau_csv, "-f", ref_fa, "-o", fa])
    full = strainfasta.read_fasta(fa)
    ok = rc == 0 and len(full) == MB_G * len(ref)
    for g in range(MB_G):
        for c, seq in ref.items():
            want = seq.copy()
            at = contigs == c
            want[positions[at] - 1] = np.array(list("ACGT"))[tau[at, g]]
            ok = ok and full.get(f"{c}_hap{g + 1}") == "".join(want)
    gate(ok, "strainfasta -f: the called positions carry the calls, every other "
         "base is the reference's")

    # (d) desman --profile at the metric configuration, with and without
    csv = os.path.join(tmp, "metric_counts.csv")
    base = ["desman", csv, "-g", str(G), "-i", "100", "-s", "0", "--kernel", "cuda"]
    runs = {}
    for name, extra in (("untraced", []),
                        ("traced", ["--profile", os.path.join(tmp, "trace")])):
        out = os.path.join(tmp, f"profile_{name}")
        ops.reset_launches()
        t0 = time.time()
        rc = cli.main([*base, "-o", out, *extra])
        runs[name] = (rc, time.time() - t0, read_launches(), read_metrics(out)["elapsed_s"])
    trace_path = os.path.join(tmp, "trace", TRACE_FILE)
    with open(trace_path) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    counted = {"tau_sweep": sum("tau_sweep_kernel" in k for k in kernels),
               "swap": sum("swap_kernel" in k for k in kernels)}
    (rc_u, wall_u, _, chain_u), (rc_t, wall_t, launches, chain_t) = runs.values()
    print(f"# desman --profile at V={V} S={S} G={G} -i 100: wall {wall_t:.3f} s traced, "
          f"{wall_u:.3f} s untraced (chain {chain_t:.3f} s against {chain_u:.3f} s, "
          f"{chain_t / chain_u:.3f} x); trace {os.path.getsize(trace_path)} bytes, "
          f"{len(kernels)} kernel events, named {counted}; launches {launches}")
    gate(rc_u == 0 and rc_t == 0
         and same_files_of(os.path.join(tmp, "profile_traced"),
                           os.path.join(tmp, "profile_untraced"), SAMPLED),
         "desman --profile writes the sampled files of the untraced run byte for byte")
    gate(counted == {k: launches[k] for k in counted} and counted["tau_sweep"] == 100
         and counted["swap"] == 100,
         "the trace names the tau and swap kernels, 100 launches each, as the "
         "wrappers counted")
    # where the traced wall goes: 100 sweeps of the same counts untraced, then
    # traced by a second profiler session of this process, then its export
    n = torch.as_tensor(io.read_counts_csv(csv).counts, dtype=torch.float32, device=dev)
    cfg = sampler.SamplerConfig(G=G, burn=50, samples=50, nmf_iters=50)
    gen = sampler.chain_generator(0, dev)
    start = (sampler.init_state(n, cfg, gen), sampler.init_accum(V, S, G, dev))
    ks = ops.resolve("cuda", n)

    def hundred_sweeps():
        t0 = time.perf_counter()
        sampler.run_segment(n, cfg, *start, 0, 100, sampler.TorchNoise(gen), ks)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    untraced = hundred_sweeps()
    with profile(activities=activities(dev)) as prof:
        traced = hundred_sweeps()
    t0 = time.perf_counter()
    prof.export_chrome_trace(os.path.join(tmp, "second_trace.json"))
    export = time.perf_counter() - t0
    ops.reset_launches()
    print(f"# 100 sweeps at V={V} S={S} G={G}: {untraced:.3f} s untraced, {traced:.3f} s "
          f"traced ({traced / untraced:.3f} x; a second profiler session of the process), "
          f"export {export:.3f} s; of the {chain_t - chain_u:.3f} s tracing added to the "
          f"CLI's chain, {chain_t - chain_u - (traced - untraced) - export:.3f} s are "
          "neither (the first session's start, the traced NMF start)")
    print(f"# phase 12 wall {time.time() - t_phase:.2f} s")


# phase 13: the mesh path's launches of each kernel over every rank, and
# the kernels against their plain versions on a shard's block
MESH_SWEEPS = 200
MESH_LAUNCHES = Counter()
MESH_CHECK = {}


def mesh_block_kernels():
    """The tau, swap and top-2 kernels against their plain versions on a
    shard's block as a 1x4 mesh gives it: V = 1e4 - 2 padded to 1e4, the
    last rank's rows [7500, 1e4): 2500 rows (a tail tile of 4) ending in 2
    zero pad rows, from the state a chain starts in with every other data
    row's bases one off, on that chain's own Gumbel and swap noise cut to
    the block (``parallel.ShardNoise``: the pad rows' swap thresholds
    +inf). On the pad rows the kernel must give
    the plain version's tau bit for bit; elsewhere >= 99% agreement. The
    swap starts from the tau sweep's result with strains g and h exchanged
    at every other data row, so both its branches run."""
    from desman_tpu_torch.parallel import Mesh, ShardNoise, pad_positions

    dev = torch.device("cuda")
    mesh, true_v = Mesh(1, 4), V - 2
    cfg = sampler.SamplerConfig(G=G, burn=MESH_SWEEPS // 2, samples=MESH_SWEEPS // 2)
    cases = (("tau_sweep", synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)),
             ("swap", None),
             ("tau_sweep_topk", synth.generate(V=V, S=S, G=G, coverage=50.0,
                                               error_rate=0.0, max_alleles=2, seed=0)))
    tau_s = None
    for name, t in cases:
        if t is not None:
            padded, _ = pad_positions(t.data.counts[:true_v].astype(np.float32), 4)
            lo, hi = mesh.block(padded.shape[0], 3)
            n_full = torch.as_tensor(padded, device=dev)
            gen = sampler.chain_generator(0, dev)
            st = sampler.init_state(n_full, cfg, gen)
            noise = ShardNoise(sampler.TorchNoise(gen), lo, hi, padded.shape[0], true_v)
            gz = noise.gumbel(0, hi - lo, G)
            g, h, logu = noise.swap(0, hi - lo, G)
            n, tau, mix = n_full[lo:hi], st.tau[lo:hi], st.mix[lo:hi]
            pad = true_v - lo
            # every other data row one base off, so the sweep has calls to make
            tau = tau.clone()
            tau[0:pad:2] = (tau[0:pad:2] + 1) % 4
            mix = mixture(one_hot_tau(tau), st.gamma)
        if name == "swap":
            tau0, args = tau_s, (n, tau_s, mixture(one_hot_tau(tau_s), st.gamma),
                                 st.gamma, st.eta, g, h, logu)
        elif name == "tau_sweep":
            tau0, args = tau, (n, tau, mix, st.gamma, st.eta, gz)
        else:
            layout = tau_topk.topk_layout(padded[lo:hi], dev)
            tau0, args = tau, (layout.n_val, layout.b_idx, tau, mix, st.gamma, st.eta, gz)
        tau_k, mix_k = getattr(ops, name)(*args)
        tau_p, mix_p = getattr(ops, f"{name}_reference")(*args)
        same = (tau_k == tau_p).all(dim=1)
        agree = same.float().mean().item()
        err = (mix_k[same] - mix_p[same]).abs().max().item()
        changed = (tau_k != tau0).any(dim=1).float()
        MESH_CHECK[name] = {"agreement": agree, "max_abs_err": err}
        what = f"{name} on a 1x4 shard's block (rows {lo}-{hi} of V={true_v} padded to {hi})"
        print(f"# mesh {what}: agreement {agree:.6f}, changed share {changed[:pad].mean():.4f} "
              f"of the data rows and {changed[pad:].mean():.4f} of the pad rows, max |mix "
              f"kernel - plain| on agreeing positions {err:.3e}")
        gate(torch.equal(tau_k[pad:], tau_p[pad:]),
             f"{what}: the pad rows' tau bitwise the plain version's")
        gate(agree >= 0.99, f"{what}: >= 99% agreement with its plain version")
        gate(torch.allclose(mix_k, mixture(one_hot_tau(tau_k), st.gamma), rtol=1e-5,
                            atol=1e-6), f"{what}: mix == mixture(onehot(tau), gamma)")
        if name != "swap":
            gate(0.3 < changed[:pad].mean().item() < 0.7, f"{what}: the sweep moved "
                 "the rows started one base off")
        if name == "tau_sweep":
            tau_s, ex = tau_p.clone(), torch.arange(0, pad, 2, device=dev)
            tau_s[ex, g], tau_s[ex, h] = tau_p[ex, h], tau_p[ex, g]
        elif name == "swap":
            gate(0.1 < changed[:pad].mean().item() < 0.6 and not changed[pad:].any(),
                 f"{what}: accepted where the strains were exchanged, never on the "
                 "pad rows (+inf thresholds)")
    ops.reset_launches()


def mesh_collective_us(out):
    """A rank of a two-rank world (gloo on one card, NCCL on two): host µs
    of one [2,S] sum through the collective layer, 1000 calls after 20;
    rank 0 writes it to `out`."""
    from desman_tpu_torch.parallel import Mesh, distributed

    distributed.maybe_initialize("cuda")
    dev = distributed.rank_device("cuda")
    axes = distributed.mesh_axes(Mesh(1, 2), dev)
    x = torch.ones((2, S), device=dev)
    for _ in range(20):
        axes.data.sum(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        axes.data.sum(x)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 1e3
    if distributed.is_coordinator():
        with open(out, "w") as f:
            json.dump({"us": us, "backend": distributed.backend()}, f)
    return 0


@contextlib.contextmanager
def one_rank_world():
    """A world of one rank on this card, joined as torchrun's environment
    describes it (``maybe_initialize``); the group is left and the
    environment restored afterwards."""
    from desman_tpu_torch.parallel import distributed

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(distributed.free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        gate(distributed.maybe_initialize("cuda"), "a world of one rank joined")
        yield
    finally:
        distributed.leave()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_manifest_it(ck):
    try:
        with open(os.path.join(ck, "manifest.json")) as f:
            return int(json.load(f)["it"])
    except (OSError, ValueError):
        return None


def mesh_cli_runs(tmp, csv, bi_csv):
    """(c)-(e): the mesh CLI runs, side by side on the card (each a world
    of two ranks sharing cuda:0), the checkpointed one SIGTERMed once its
    manifest shows 0 < it < MESH_SWEEPS. Returns {name: (rc, stderr)}."""
    base = ["-g", str(G), "-i", str(MESH_SWEEPS), "-s", "0"]
    runs = {
        "1x2": [csv, *base, "--mesh", "1x2", "-o", os.path.join(tmp, "mesh_1x2")],
        "2x1": [csv, *base, "--mesh", "2x1", "--chains", "2",
                "-o", os.path.join(tmp, "mesh_2x1")],
        "topk": [bi_csv, *base, "--mesh", "1x2", "--kernel", "cuda_topk",
                 "-o", os.path.join(tmp, "mesh_topk")],
        "termed": [csv, *base, "--mesh", "1x2", "--checkpoint_every", "25",
                   "--checkpoint", os.path.join(tmp, "mesh_ck"),
                   "-o", os.path.join(tmp, "mesh_termed")],
    }
    t0 = time.time()
    procs = {k: desman_process(argv) for k, argv in runs.items()}
    ck, seen = os.path.join(tmp, "mesh_ck"), None
    try:
        deadline = time.time() + 600
        while seen is None and procs["termed"].poll() is None and time.time() < deadline:
            it = mesh_manifest_it(ck)
            if it is not None and 0 < it < MESH_SWEEPS:
                procs["termed"].send_signal(signal.SIGTERM)
                seen = it
            time.sleep(0.002)
    finally:
        results = {k: finish(p) for k, p in procs.items()}
    print(f"# {len(runs)} desman --mesh runs side by side: {time.time() - t0:.2f} s wall; "
          f"SIGTERM at it={seen}")
    for k, (rc, err) in results.items():
        print(f"# desman --mesh {k}: rc {rc} {err.strip()[-300:] if rc else ''}")
    return results, seen


def phase_mesh(tmp):
    """Phase 13: position sharding over a mesh of ranks (see the module
    docstring)."""
    from desman_tpu_torch.parallel import Shard, distributed, launch, make_mesh
    from desman_tpu_torch.utils import snp_distance_perm

    t_phase = time.time()
    dev = torch.device("cuda")
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    bi = synth.generate(V=V, S=S, G=G, coverage=50.0, error_rate=0.0, max_alleles=2,
                        seed=0)
    csv, bi_csv = os.path.join(tmp, "mesh_counts.csv"), os.path.join(tmp, "mesh_bi.csv")
    io.write_counts_csv(csv, t.data)
    io.write_counts_csv(bi_csv, bi.data)

    # the single-device partners: seeds 0 and 1 with cuda, seed 0 with cuda_topk
    cfg = run.sampler_config(run.RunConfig(G=G, iterations=MESH_SWEEPS))
    n = torch.as_tensor(t.data.counts, dtype=torch.float32, device=dev)
    ref = sampler.run_chains(n, cfg, [0, 1], kernel="cuda")
    n_bi = torch.as_tensor(bi.data.counts, dtype=torch.float32, device=dev)
    ref_topk = sampler.run_chains(n_bi, cfg, [0], kernel="cuda_topk")
    ops.reset_launches()

    def agreement(out, want, truth, what):
        tau, _, _ = io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))
        want = want.cpu().numpy()
        agree = (tau == want).all(axis=1).mean()
        snp, snp_ref = snp_distance_perm(truth, tau), snp_distance_perm(truth, want)
        print(f"# {what}: tau_star agreement {agree:.6f} with the single-device chain, "
              f"SNP errors {snp} of {tau.size} against the truth (that chain: {snp_ref})")
        gate(agree >= 0.99 and snp <= snp_ref, f"{what}: agreement >= 0.99, SNP errors "
             f"no more than the single-device chain's ({snp_ref})")

    def record_of(out, what, kernel, chains, d, ranks=2):
        m = read_metrics(out)
        runs = chains * d * MESH_SWEEPS
        print(f"# {what}: backend {m['backend']}, {m['ranks']} ranks, launches "
              f"{m['launches']}, collectives a sweep {m['collectives_per_sweep']}, "
              f"{m['sweeps_per_s']:.3f} sweeps/s")
        gate(m["backend"] == backend_of(ranks) and m["ranks"] == ranks,
             f"{what}: {ranks} ranks over {backend_of(ranks)}")
        gate(m["launches"][kernel] == runs and m["launches"]["swap"] == runs
             and all(v == 0 for k, v in m["launches"].items() if k not in (kernel, "swap")),
             f"{what}: {kernel} and swap launched exactly {runs} times over the ranks")
        gate(m["collectives_per_sweep"] <= 3, f"{what}: <= 3 collectives a sweep")
        MESH_LAUNCHES.update(m["launches"])

    def backend_of(ranks):
        """The backend rule: NCCL when each rank has a card of its own."""
        return "nccl" if ranks <= torch.cuda.device_count() else "gloo"

    # (f) the kernels on a shard's block
    mesh_block_kernels()

    # (c)-(e) the CLI: 1x2, 2x1 --chains 2, cuda_topk, the preempted run
    results, seen = mesh_cli_runs(tmp, csv, bi_csv)
    for k in ("1x2", "2x1", "topk"):
        gate(results[k][0] == 0, f"desman --mesh {k} exits 0")
    rc_t, err_t = results["termed"]
    gate(rc_t == 75 and "preempted" in err_t and seen is not None,
         "desman --mesh 1x2 --checkpoint: SIGTERM mid-run exits 75 naming the preemption")
    record_of(os.path.join(tmp, "mesh_1x2"), "--mesh 1x2", "tau_sweep", 1, 2)
    record_of(os.path.join(tmp, "mesh_2x1"), "--mesh 2x1 --chains 2", "tau_sweep", 2, 1)
    record_of(os.path.join(tmp, "mesh_topk"), "--mesh 1x2 --kernel cuda_topk",
              "tau_sweep_topk", 1, 2)
    agreement(os.path.join(tmp, "mesh_1x2"), ref.tau_star[0], t.tau_idx, "--mesh 1x2")
    with open(os.path.join(tmp, "mesh_2x1", "chains.json")) as f:
        best = json.load(f)["best_seed"]
    agreement(os.path.join(tmp, "mesh_2x1"), ref.tau_star[best], t.tau_idx,
              f"--mesh 2x1 --chains 2 (best seed {best})")
    agreement(os.path.join(tmp, "mesh_topk"), ref_topk.tau_star[0], bi.tau_idx,
              "--mesh 1x2 --kernel cuda_topk")
    # the preempted run resumed on a 1x1 mesh, in process
    at = mesh_manifest_it(os.path.join(tmp, "mesh_ck"))
    termed = os.path.join(tmp, "mesh_termed")
    launches, _ = drive_cli([csv, "-g", str(G), "-i", str(MESH_SWEEPS), "-s", "0",
                             "--mesh", "1x1", "--checkpoint_every", "25", "--checkpoint",
                             os.path.join(tmp, "mesh_ck")], termed)
    MESH_LAUNCHES.update(launches)
    gate(launches["tau_sweep"] == launches["swap"] == MESH_SWEEPS - at,
         f"the 1x1 resume from it={at} launched tau and swap {MESH_SWEEPS - at} times")
    agreement(termed, ref.tau_star[0], t.tau_idx, f"--mesh 1x2 preempted at {at}, "
              "resumed on 1x1")

    # the host µs of a collective, two ranks on cuda:0 over gloo
    us_file = os.path.join(tmp, "mesh_us.json")
    gate(launch(mesh_collective_us, 2, (us_file,)) == 0, "the collective timing ran")
    with open(us_file) as f:
        two_us = json.load(f)
    print(f"# a [2,{S}] sum through the collective layer (one all_reduce), 2 ranks over "
          f"{two_us['backend']}: {two_us['us']:.2f} µs host a call")

    # (g) with two cards or more: --mesh 1x2 alone over NCCL, one card a
    # rank; with four or more, --mesh 2x2 --chains 2 too
    multi = [("1x2", 1, 2)] if torch.cuda.device_count() >= 2 else []
    if torch.cuda.device_count() >= 4:
        multi.append(("2x2", 2, 2))
    for shape, chains, d in multi:
        out = os.path.join(tmp, f"mesh_nccl_{shape}")
        extra = ["--chains", str(chains)] if chains > 1 else []
        rc, err = finish(desman_process([csv, "-g", str(G), "-i", str(MESH_SWEEPS), "-s",
                                         "0", "--mesh", shape, *extra, "-o", out]))
        what = f"--mesh {shape}{' --chains 2' if chains > 1 else ''} over NCCL"
        gate(rc == 0, f"desman {what} exits 0 ({err.strip()[-300:]})")
        record_of(out, what, "tau_sweep", chains, d, ranks=chains * d)
        gate(read_metrics(out)["collectives_per_sweep"] >= 1,
             f"{what}: the sweeps' sums crossed the ranks over NCCL")
        best = 0
        if chains > 1:
            with open(os.path.join(out, "chains.json")) as f:
                best = json.load(f)["best_seed"]
        agreement(out, ref.tau_star[best], t.tau_idx, f"{what} (best seed {best})")

    # (a), (b): a 1x1 mesh over NCCL, in process
    with one_rank_world():
        gate(distributed.backend() == "nccl", "a world of one rank on its own card: NCCL")
        out = os.path.join(tmp, "mesh_nccl")
        rc = run.RunConfig(G=G, iterations=MESH_SWEEPS, seed=0, out_dir=out)
        ops.reset_launches()
        res = run.run_multi(t.data, rc, 1, device="cuda", kernel="cuda",
                            mesh=make_mesh(1, 1))
        launches = read_launches()
        MESH_LAUNCHES.update(launches)
        m = read_metrics(out)
        print(f"# 1x1 mesh over {m['backend']}: launches {launches}, collectives a sweep "
              f"{m['collectives_per_sweep']}, {m['sweeps_per_s']:.3f} sweeps/s")
        gate(launches["tau_sweep"] == launches["swap"] == MESH_SWEEPS,
             f"1x1 mesh: tau and swap launched {MESH_SWEEPS} times")
        gate(m["collectives_per_sweep"] <= 3, "1x1 mesh: <= 3 collectives a sweep")
        trace, want = res.loglik_trace.cpu(), ref.loglik_trace[0].cpu()
        bitwise = torch.equal(res.tau_star.cpu(), ref.tau_star[0].cpu()) and torch.equal(
            trace, want)
        print(f"# 1x1 mesh against run_chain: bitwise {bitwise}, trace max rel "
              f"{((trace - want).abs() / want.abs()).max().item():.3e}")
        gate(torch.equal(res.tau_star.cpu(), ref.tau_star[0].cpu())
             and torch.allclose(trace, want, rtol=1e-5, atol=0),
             "1x1 mesh: tau_star equal to run_chain's, trace within rtol 1e-5")

        # the host µs of the layer's all_reduce over NCCL (a 1-rank axis
        # makes none in a sweep: timed on the world group directly)
        sh = Shard(t.data.counts, make_mesh(1, 1), "cuda", "cuda")
        buf = torch.ones((1, 2, S), device=dev)
        for _ in range(20):
            distributed.exchange(buf, sh.world)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            distributed.exchange(buf, sh.world)
        torch.cuda.synchronize()
        nccl_us = (time.perf_counter() - t0) * 1e3
        print(f"# one [1,2,{S}] all_reduce through the layer's exchange, 1 rank over "
              f"NCCL: {nccl_us:.2f} µs host a call")
        times = {"plain": [], "mesh": []}
        for mode in ("plain", "mesh", "mesh", "plain") * 2:
            gen = sampler.chain_generator(0, dev)
            torch.cuda.synchronize()
            if mode == "plain":
                st = sampler.init_state(n, cfg, gen)
                t0 = time.perf_counter()
                sampler.run_segment(n, cfg, st, sampler.init_accum(V, S, G, dev), 0,
                                    MESH_SWEEPS, sampler.TorchNoise(gen), sh.ks)
            else:
                st = sh.init(cfg, [gen])[0]
                t0 = time.perf_counter()
                sh.segment(cfg, st, sh.accum(cfg), 0, MESH_SWEEPS, sh.noise(gen))
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3 / MESH_SWEEPS)
        ops.reset_launches()
        print(f"# ms a sweep at V={V} S={S} G={G}, {MESH_SWEEPS} sweeps, in turns: plain "
              f"{times['plain']}, 1x1 mesh {times['mesh']}; median ratio "
              f"{np.median(times['mesh']) / np.median(times['plain']):.4f}")
    print(f"# phase 13 wall {time.time() - t_phase:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"# device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    try:
        t0 = time.time()
        lib = _build.build()
        _build.load_library()
        print(f"# build: {time.time() - t0:.2f} s -> "
              f"{os.path.relpath(lib, HERE)}")
        records = phase_kernels()
        scale = phase_scale()
        for r in records:
            if r["name"] in scale:
                r["scale"] = scale[r["name"]]
        phase_wide()
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(tmp)
            phase_north_star(tmp)
            phase_grid(tmp)
            phase_assign_tau()
            phase_run_modes(tmp)
            phase_run_length(tmp)
            phase_pt(tmp)
            phase_multibin(tmp)
            phase_mesh(tmp)
        for r in records:
            r["launches"] = PATH_LAUNCHES[r.get("launched_in", r["name"])]
            r["launches_per_sweep"] = SWEEP_LAUNCHES.get(r["name"])
            if r["name"] in MESH_CHECK:
                r["mesh_launches"] = MESH_LAUNCHES[r["name"]]
                r["mesh_agreement"] = MESH_CHECK[r["name"]]["agreement"]
                r["mesh_max_abs_err"] = MESH_CHECK[r["name"]]["max_abs_err"]
                gate(r["mesh_launches"] > 0, f"{r['name']} launched on the mesh path")
            if r["name"] in ("tau_sweep", "swap"):
                r["multibin_launches"] = MULTIBIN_LAUNCHES[r["name"]]
                r["multibin_agreement"] = MULTIBIN_CHECK[r["name"]]["agreement"]
                r["multibin_max_abs_err"] = MULTIBIN_CHECK[r["name"]]["max_abs_err"]
            gate(r["launches"] > 0, f"{r['name']} launched on a main path")
    except GateFailed as e:
        print(f"chip_smoke: gate failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
