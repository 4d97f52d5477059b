"""Benchmark: Gibbs sweeps a second on one card at the north-star configuration.

    python -m desman_tpu_torch.bench [--kernel cuda_resident|cuda] [--device cuda|cpu]

The counterpart of the repository's root ``bench.py``, which runs the JAX
package. It prints ONE JSON line on stdout, with the same four keys and
the same metric name:

  {"metric": "gibbs_sweeps_per_sec_per_chip_V1e4_S64_G8", "value": N,
   "unit": "sweeps/s", "vs_baseline": N}

Its '#' lines go to stderr: the card's name and power limit, each timed
run's seconds, the final loglik and the baseline's time.

Configuration: V=1e4 variant positions x S=64 samples x G=8 strains from
``synth.generate(coverage=50, seed=0)``; ``SamplerConfig(G=8, burn=0,
samples=400, nmf_iters=50)``. value = full Gibbs sweeps (tau exact update +
swap + gamma MH + eta MH + loglik) a second: one untimed warm run (which
also builds the kernels), then three timed ``sampler.run_chain`` calls on
generator seeds 1-3, each from the NMF start to its loglik trace on the
host, and the median of the three. ``--kernel cuda_resident`` (the
default, the counterpart of JAX's resident sweep) runs the fused front-half
and apply/eta kernels, two launches a sweep; ``--kernel cuda`` the tau,
swap, gamma_ll and apply/eta kernels, four launches a sweep, with the gamma
and eta MH decisions as PyTorch ops.

vs_baseline: the ratio against ``baseline_numpy``, the same O(V*G*4*S)
sweep in vectorized numpy standing in for the reference's single-core
Cython+GSL sampler, on JAX's draws (tau, gamma, eta from
``default_rng(0)``; one warm sweep on ``default_rng(1)``; two timed sweeps
on ``default_rng(2)``). It runs in a child process whose environment sets
OMP_NUM_THREADS, OPENBLAS_NUM_THREADS and MKL_NUM_THREADS to 1 before
numpy loads, so its BLAS has one thread whatever this process's has.

Without a card it exits 2 unless given ``--device cpu``, where the
wrappers run their plain PyTorch versions: a CPU rate is no card's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import synth
from .cli import _add_device, _cuda_missing
from .sampler import SamplerConfig, chain_generator, run_chain

METRIC = "gibbs_sweeps_per_sec_per_chip_V1e4_S64_G8"
V, S, G = 10_000, 64, 8
SWEEPS = 400
REPEATS = 3
BASELINE_SWEEPS = 2
KERNELS = ("cuda_resident", "cuda")
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def counts(V: int = V, S: int = S, G: int = G) -> np.ndarray:
    """The benchmark's counts, [V,S,4] int32."""
    return synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0).data.counts


def measure(V: int = V, S: int = S, G: int = G, sweeps: int = SWEEPS,
            kernel: str = "cuda_resident", device="cuda",
            repeats: int = REPEATS) -> dict:
    """Sweeps a second of ``run_chain`` on `device`: one warm run, then
    `repeats` timed runs, each from its NMF start until its loglik trace is
    on the host. Returns the seconds of each timed run, their median, the
    rate and the last run's final loglik."""
    device = torch.device(device)
    n = torch.as_tensor(counts(V, S, G), dtype=torch.float32, device=device)
    cfg = SamplerConfig(G=G, burn=0, samples=sweeps, nmf_iters=50)

    def one(seed):
        t0 = time.perf_counter()
        res = run_chain(n, cfg, chain_generator(seed, device), kernel=kernel)
        trace = res.loglik_trace.cpu()   # waits for the device
        return time.perf_counter() - t0, trace

    one(0)
    times, trace = [], None
    for i in range(repeats):
        t, trace = one(i + 1)
        times.append(t)
    median = sorted(times)[len(times) // 2]
    return {"times": times, "seconds": median, "sweeps_per_s": sweeps / median,
            "final_loglik": float(trace[-1])}


def baseline_inputs(V: int, S: int, G: int):
    """bench.py's starting state for the numpy sweep: tau, gamma, eta."""
    rng = np.random.default_rng(0)
    tau = rng.integers(0, 4, size=(V, G))
    gamma = rng.dirichlet(np.ones(G), size=S)
    eta = np.full((4, 4), 0.01 / 3) + np.eye(4) * (0.99 - 0.01 / 3)
    return tau, gamma, eta


def baseline_child(V: int, S: int, G: int, sweeps: int) -> None:
    """The baseline's timing, run in the child process ``baseline`` starts:
    prints the seconds of `sweeps` numpy sweeps and the thread variables
    this process saw, as one JSON line."""
    from . import baseline_numpy

    nb = counts(V, S, G).astype(np.float64)
    tau, gamma, eta = baseline_inputs(V, S, G)
    baseline_numpy.sweep(nb, tau.copy(), gamma.copy(), eta.copy(),
                         np.random.default_rng(1))   # warm caches
    t0 = time.perf_counter()
    r = np.random.default_rng(2)
    for _ in range(sweeps):
        tau, gamma, eta, _ = baseline_numpy.sweep(nb, tau, gamma, eta, r)
    seconds = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds,
                      "threads": {k: os.environ.get(k) for k in THREAD_VARS}}))


def baseline(V: int = V, S: int = S, G: int = G,
             sweeps: int = BASELINE_SWEEPS) -> dict:
    """Time the single-core numpy baseline in a child process with one BLAS
    thread. Returns its seconds, sweeps a second and the thread variables
    the child saw."""
    env = dict(os.environ, **{k: "1" for k in THREAD_VARS})
    code = (f"from desman_tpu_torch import bench; "
            f"bench.baseline_child({V}, {S}, {G}, {sweeps})")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"the baseline's child process failed: {done.stderr}")
    out = json.loads(done.stdout.strip().splitlines()[-1])
    out["sweeps_per_s"] = sweeps / out["seconds"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desman_tpu_torch.bench")
    ap.add_argument("--kernel", choices=KERNELS, default="cuda_resident")
    _add_device(ap)
    args = ap.parse_args(argv)
    if _cuda_missing("bench", args.device):
        return 2
    print(f"# device: {card() if args.device == 'cuda' else 'cpu'}", file=sys.stderr)

    m = measure(V, S, G, SWEEPS, args.kernel, args.device, REPEATS)
    print(f"# {args.kernel} on {args.device}: {SWEEPS} sweeps x{REPEATS}, times "
          f"{['%.3f' % t for t in m['times']]} -> {m['sweeps_per_s']:.2f} sweeps/s",
          file=sys.stderr)
    print(f"# final loglik: {m['final_loglik']:.1f}", file=sys.stderr)

    b = baseline(V, S, G, BASELINE_SWEEPS)
    print(f"# baseline (1-core numpy, {', '.join(f'{k}={v}' for k, v in b['threads'].items())}): "
          f"{BASELINE_SWEEPS} sweeps in {b['seconds']:.3f}s -> "
          f"{b['sweeps_per_s']:.2f} sweeps/s", file=sys.stderr)

    print(json.dumps({
        "metric": METRIC,
        "value": round(m["sweeps_per_s"], 3),
        "unit": "sweeps/s",
        "vs_baseline": round(m["sweeps_per_s"] / b["sweeps_per_s"], 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
