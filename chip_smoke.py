#!/usr/bin/env python3
"""Smoke run of the PyTorch port (desman_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own '# ...' lines:

1. device: require CUDA (exit 2 without it); print the card's name and
   power limit as nvidia-smi reports them;
2. build: compile the CUDA kernels from desman_tpu_torch/csrc;
3. kernels vs their plain PyTorch versions on the card at V=1e4, S=64,
   G=8: agreement, mixture consistency, per-sample loglik sums to rtol
   1e-5, the fused front-half kernel bitwise equal to the staged kernels
   and to itself from run to run, the top-2 tau kernel (on biallelic,
   error-free counts) bitwise equal to the tau kernel and to itself from
   run to run, median times;
4. the main paths, each with the launch counts set to 0 just before it and
   read just after: the `desman` CLI on TestData's true-variant half with
   `--kernel cuda` and with `--kernel cuda_resident`, each held to the
   quickstart's accuracy gates, and a one-strain `--kernel cuda_resident`
   run (the path without a swap to fuse); `--kernel cuda_topk` on TestData
   (cells of 3-4 observed bases) must exit non-zero and say why;
5. a V=1e4, S=64, G=8 run() of 400 sweeps with each kernel choice that
   takes such counts (cuda, cuda_resident, torch), printing sweeps/s and
   the final loglik;
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
   launch); `-f --kernel cuda_resident` must exit 2.

Any failed gate exits 1 before the result lines; outside a checkout of the
repository the imports fail and nothing runs. On success the last three
lines are the kernels' JSON record, one record per TPU kernel (each
kernel's launches summed over every path driven in phases 4 and 6-9, each
with the counts set to 0 just before it and read just after; the swap's
emit_ll mode runs inside fused_sweep there and carries its launches), the
card's name and power limit, and
{"ok": true, "device": {...}}.
"""
import contextlib
import io as stdio
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from desman_tpu_torch import cli, io, ops, run, sampler, synth
from desman_tpu_torch.geneassign import assign_gene_tau, strain_coverage
from desman_tpu_torch.likelihood import mixture
from desman_tpu_torch.ops import _build
from desman_tpu_torch.utils import match_gamma_perm, one_hot_tau
from desman_tpu_torch.validation import compare_tau

V, S, G = 10_000, 64, 8          # the port's metric configuration
TIMING_CALLS = 20
HERE = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(HERE, "TestData")
# each kernel's launches over every main path driven (counts set to 0 just
# before a path and read just after)
PATH_LAUNCHES = Counter()


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


def phase_kernels():
    """Each kernel against its plain version on the same inputs."""
    dev = torch.device("cuda")
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    rng = np.random.default_rng(0)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32, device=dev)
    gamma = torch.as_tensor(t.gamma, dtype=torch.float32, device=dev)
    eta = torch.as_tensor(t.eta, dtype=torch.float32, device=dev)
    tau = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32,
                          device=dev)
    mix = mixture(one_hot_tau(tau), gamma)
    gz = torch.as_tensor(rng.gumbel(size=(V, G, 4)), dtype=torch.float32,
                         device=dev)
    print(f"# kernels at V={V} S={S} G={G}: counts and mixture "
          f"{n.numel() * 4 / 1e6:.2f} MB f32 each")
    records = []

    tau_k, mix_k = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    tau_p, mix_p = ops.tau_sweep_reference(n, tau, mix, gamma, eta, gz)
    torch.cuda.synchronize()
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
    records.append(dict(
        name="tau_sweep", route="cuda",
        source="desman_tpu_torch/csrc/tau_kernel.cu",
        replaces="desman_tpu/ops/tau_pallas.py:66", max_abs_err=err,
        agreement=agree, ms=ms, plain_ms=plain_ms))

    # swap: the true haplotypes with strains g and h exchanged at half the
    # positions, so both the accept and the reject branch run
    g, h = 1, 6
    tau_s = t.tau_idx.copy()
    flip = rng.random(V) < 0.5
    tau_s[flip, g], tau_s[flip, h] = t.tau_idx[flip, h], t.tau_idx[flip, g]
    tau_s = torch.as_tensor(tau_s, dtype=torch.int32, device=dev)
    mix_s = mixture(one_hot_tau(tau_s), gamma)
    gt = torch.tensor(g, dtype=torch.int32, device=dev)
    ht = torch.tensor(h, dtype=torch.int32, device=dev)
    logu = torch.as_tensor(np.log(rng.uniform(size=V)), dtype=torch.float32,
                           device=dev)
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
    records.append(dict(
        name="swap", route="cuda",
        source="desman_tpu_torch/csrc/swap_kernel.cu",
        replaces="desman_tpu/ops/swap_pallas.py:54", max_abs_err=err,
        agreement=agree, ms=ms, plain_ms=plain_ms))
    more = resident_kernels(n, gamma, eta, tau_s, mix_s, gt, ht, logu, gz, rng)
    return records + more + [topk_kernel(rng)]


def topk_kernel(rng):
    """The top-2 tau kernel on biallelic, error-free counts (every cell
    observes at most two bases): against its plain version, against the
    full tau kernel (bitwise), and against itself (bitwise)."""
    dev = torch.device("cuda")
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, error_rate=0.0,
                       max_alleles=2, seed=0)
    n = torch.as_tensor(t.data.counts, dtype=torch.float32, device=dev)
    layout = ops.tau_topk.topk_layout(t.data.counts, dev)
    gamma = torch.as_tensor(t.gamma, dtype=torch.float32, device=dev)
    # a non-trivial error matrix: with the data's own eta (the identity)
    # most logs would sit at the 1e-12 floor
    eta = torch.as_tensor(synth.make_eta(0.01), dtype=torch.float32, device=dev)
    tau = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32,
                          device=dev)
    mix = mixture(one_hot_tau(tau), gamma)
    gz = torch.as_tensor(rng.gumbel(size=(V, G, 4)), dtype=torch.float32,
                         device=dev)
    args = (layout.n_val, layout.b_idx, tau, mix, gamma, eta, gz)
    tau_k, mix_k = ops.tau_sweep_topk(*args)
    tau_p, mix_p = ops.tau_sweep_topk_reference(*args)
    tau_f, mix_f = ops.tau_sweep(n, tau, mix, gamma, eta, gz)
    again = ops.tau_sweep_topk(*args)
    torch.cuda.synchronize()
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
    return dict(
        name="tau_sweep_topk", route="cuda",
        source="desman_tpu_torch/csrc/tau_topk.cu",
        replaces="desman_tpu/ops/tau_topk.py:81", max_abs_err=err,
        agreement=agree, ms=ms, plain_ms=plain_ms, tau_sweep_ms=full_ms)


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


def resident_kernels(n, gamma, eta, tau, mix, gt, ht, logu, gz, rng):
    """The resident sweep's kernels against their plain versions: the swap
    with emit_ll, gamma_ll (both with_old), gamma_apply_eta (both
    with_eta) and the fused front half."""
    dev = n.device
    gp = torch.as_tensor(rng.dirichlet(np.ones(G), size=S), dtype=torch.float32,
                         device=dev)
    accept = torch.as_tensor(rng.random(S) < 0.5, device=dev)
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
    records.append(dict(
        name="swap_emit_ll", route="cuda", source="desman_tpu_torch/csrc/swap_kernel.cu",
        replaces="desman_tpu/ops/swap_pallas.py:111", max_abs_err=err,
        agreement=agree, ms=ms, plain_ms=plain_ms, launched_in="fused_sweep"))

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
    records.append(dict(
        name="gamma_ll", route="cuda", source="desman_tpu_torch/csrc/gamma_kernel.cu",
        replaces="desman_tpu/ops/gamma_pallas.py:78", max_abs_err=err,
        ms=times[True][0], plain_ms=times[True][1],
        without_old_ms=times[False][0], without_old_plain_ms=times[False][1]))

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
    records.append(dict(
        name="gamma_apply_eta", route="cuda",
        source="desman_tpu_torch/csrc/gamma_kernel.cu",
        replaces="desman_tpu/ops/gamma_pallas.py:134", max_abs_err=err,
        ms=times[True][0], plain_ms=times[True][1],
        without_eta_ms=times[False][0], without_eta_plain_ms=times[False][1]))

    # kernel 5: the fused front half, from the random tau of phase 3's start
    tau0 = torch.as_tensor(rng.integers(0, 4, size=(V, G)), dtype=torch.int32,
                           device=dev)
    fargs = (n, tau0, mixture(one_hot_tau(tau0), gamma), gamma, eta, gz, gt, ht,
             logu, gp)
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

    def staged():
        t, m = ops.tau_sweep(*fargs[:6])
        t, m, _ = ops.swap(n, t, m, gamma, eta, gt, ht, logu, emit_ll=True)
        ops.gamma_ll(n, m, t, gp, eta, with_old=False)

    ms = median_ms(lambda: ops.fused_sweep(*fargs))
    plain_ms = median_ms(lambda: ops.fused_sweep_reference(*fargs))
    staged_ms = median_ms(staged)
    print(f"# fused_sweep median ms: kernel {ms:.4f}  plain {plain_ms:.4f}  "
          f"staged kernels {staged_ms:.4f}")
    records.append(dict(
        name="fused_sweep", route="cuda", source="desman_tpu_torch/csrc/fused_sweep.cu",
        replaces="desman_tpu/ops/fused_sweep.py:41", max_abs_err=err,
        agreement=agree, ms=ms, plain_ms=plain_ms, staged_kernels_ms=staged_ms))
    return records


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
        res = run.run(t.data, rc, device="cuda", kernel=kernel, nmf_iters=50)
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
        traces[kernel] = sampler.run_chain(n, cfg, gen, eta_init=eta,
                                           kernel=kernel).loglik_trace
    torch.cuda.synchronize()
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
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(tmp)
            phase_north_star(tmp)
            phase_grid(tmp)
            phase_assign_tau()
            phase_run_modes(tmp)
        for r in records:
            r["launches"] = PATH_LAUNCHES[r.get("launched_in", r["name"])]
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
