#!/usr/bin/env python3
"""Smoke run of the PyTorch port (desman_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own '# ...' lines:

1. device: require CUDA (exit 2 without it); print the card's name and
   power limit as nvidia-smi reports them;
2. build: compile the CUDA kernels from desman_tpu_torch/csrc;
3. kernels vs their plain PyTorch versions on the card at V=1e4, S=64,
   G=8: agreement, mixture consistency, median times;
4. the main path: the `desman` CLI on TestData's true-variant half, held to
   the quickstart's accuracy gates, counting the kernel launches it made;
5. a V=1e4, S=64, G=8 run() of 400 sweeps with the kernels and with the
   plain versions, printing sweeps/s and the final loglik.

Any failed gate exits 1 before the result lines; outside a checkout of the
repository the imports fail and nothing runs. On success the last two
lines are the kernels' JSON record and {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from desman_tpu_torch import cli, io, ops, run, synth
from desman_tpu_torch.likelihood import mixture
from desman_tpu_torch.ops import _build
from desman_tpu_torch.utils import match_gamma_perm, one_hot_tau
from desman_tpu_torch.validation import compare_tau

V, S, G = 10_000, 64, 8          # the port's metric configuration
TIMING_CALLS = 20
HERE = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(HERE, "TestData")


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
    return records


def phase_cli(tmp):
    """The desman CLI on the card, gated like tests/test_quickstart.py."""
    data = io.read_counts_csv(os.path.join(TESTDATA, "variant_counts.csv"))
    data = data.select(np.flatnonzero(data.positions < 1000))
    csv = os.path.join(tmp, "variants.csv")
    io.write_counts_csv(csv, data)
    out = os.path.join(tmp, "quickstart")
    ops.reset_launches()
    t0 = time.time()
    rc = cli.main(["desman", csv, "-g", "5", "-e",
                   os.path.join(TESTDATA, "true_eta.csv"), "-o", out,
                   "-i", "150", "-s", "0"])
    wall = time.time() - t0
    launches = {"tau_sweep": ops.tau_sweep.launches, "swap": ops.swap.launches}
    print(f"# cli: rc {rc}, {wall:.2f} s wall, kernel launches {launches}")
    gate(rc == 0, "desman CLI exits 0")
    for f in ("fit.txt", "Gamma_mean.csv", "Gamma_star.csv", "Eta_mean.csv",
              "Eta_star.csv", "Filtered_Tau_star.csv", "Tau_mean.csv",
              "metrics.json", "loglik_trace.csv"):
        gate(os.path.exists(os.path.join(out, f)), f"{f} written")
    fit = io.read_fit_txt(os.path.join(out, "fit.txt"))
    gate(all(np.isfinite(fit[k]) for k in
             ("mean_deviance", "star_deviance", "star_loglik")),
         f"fit.txt finite: {fit}")
    pred, pc, pp = io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))
    true, tc, tp = io.read_tau_star_csv(os.path.join(TESTDATA, "true_tau.csv"))
    rep = compare_tau(pred, true, list(zip(map(str, pc), map(int, pp))),
                      list(zip(map(str, tc), map(int, tp))))
    gmae, _ = match_gamma_perm(
        io.read_gamma_csv(os.path.join(TESTDATA, "true_gamma.csv")),
        io.read_gamma_csv(os.path.join(out, "Gamma_mean.csv")))
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    print(f"# cli: SNP error rate {rep.error_rate:.6f}, gamma MAE {gmae:.6f}, "
          f"star deviance {fit['star_deviance']:.6f}, "
          f"{metrics['sweeps_per_s']:.2f} sweeps/s on {metrics['device']}")
    gate(rep.error_rate < 0.02, "SNP error rate < 0.02")
    gate(gmae < 0.02, "gamma MAE < 0.02")
    gate(launches["tau_sweep"] > 0 and launches["swap"] > 0,
         "the main path launched both kernels")
    return launches


def phase_north_star(tmp):
    """run() at the metric configuration, with and without the kernels."""
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    for kernel in ("cuda", "torch"):
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
            launches = phase_cli(tmp)
            phase_north_star(tmp)
    except GateFailed as e:
        print(f"chip_smoke: gate failed: {e}", file=sys.stderr)
        return 1
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
