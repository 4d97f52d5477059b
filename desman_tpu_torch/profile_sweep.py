"""Where a sweep's time goes on the card, for each kernel choice.

    python -m desman_tpu_torch.profile_sweep

For each kernel choice: a chain at V=1e4, S=64, G=8 (synth data, 50 NMF
iterations, burn 0: no annealing or adaptation), joint eta sampled, swap
moves on. After 220 warm sweeps it times 200 unprofiled sweeps on the host
clock (synchronised at both ends), then traces 20 sweeps with
torch.profiler and prints one JSON line per choice: ms/sweep unprofiled,
device-busy ms/sweep (the sum of the device ops' own times), device ops per
sweep, and the idle share 1 - busy / unprofiled sweep time, followed by
the 12 largest device items. cuda, cuda_resident and torch run on the
default synth counts (3-4 observed bases in most cells); cuda_topk, which
refuses those, runs on biallelic error-free counts, and cuda runs again on
the same counts beside it. Needs a CUDA device; it does not fall back.

    python -m desman_tpu_torch.profile_sweep --pt 4

profiles one parallel-tempering ensemble sweep instead (R replicas in turn
and the exchange, ``sampler.make_pt_step``) on cuda with the synth counts,
ladder to 8: the same items a sweep become a PT ensemble sweep's, over a
quarter as many ensemble sweeps at R = 4 (WARM, WALL and TRACED / R).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import profile

from . import ops, synth
from .profiling import activities
from .sampler import (
    SamplerConfig, TorchNoise, init_accum, init_state, make_pt_step,
    make_sweep_fn, pt_generators, pt_init, pt_noises,
)


V, S, G = 10_000, 64, 8          # the port's metric configuration
WARM, WALL, TRACED, TOP = 220, 200, 20, 12


def _counts(biallelic: bool):
    t = (synth.generate(V=V, S=S, G=G, coverage=50.0, error_rate=0.0,
                        max_alleles=2, seed=0) if biallelic else
         synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0))
    return torch.as_tensor(t.data.counts, dtype=torch.float32,
                           device=torch.device("cuda"))


def _measure(run, per: int) -> dict:
    """Host ms a step of run(k) (k steps of `per` sweeps each), and the
    device items of TRACED sweeps' worth of steps by torch.profiler."""
    run(WARM // per)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(WALL // per)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (WALL // per)
    traced = TRACED // per
    with profile(activities=activities("cuda")) as prof:
        run(traced)
        torch.cuda.synchronize()
    items = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in items) / 1e3 / traced
    items.sort(key=lambda e: -e.self_device_time_total)
    return {"ms": ms, "busy": busy,
            "ops": sum(e.count for e in items) / traced,
            "top": [(e.key[:80], e.self_device_time_total / 1e3 / traced,
                     e.count / traced) for e in items[:TOP]]}


def profile_kernel(kernel: str, biallelic: bool = False) -> dict:
    n = _counts(biallelic)
    dev = n.device
    cfg = SamplerConfig(G=G, burn=0, samples=WARM + WALL + TRACED, nmf_iters=50)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_state(n, cfg, gen)
    accum = init_accum(V, S, G, dev)
    sweep = make_sweep_fn(cfg, ops.resolve(kernel, n))
    noise = TorchNoise(gen)
    it = 0

    def run(k):
        nonlocal state, accum, it
        for _ in range(k):
            state, accum, _ = sweep(n, state, accum, it, noise)
            it += 1

    m = _measure(run, 1)
    return {
        "kernel": kernel, "counts": "biallelic" if biallelic else "synth",
        "V": V, "S": S, "G": G,
        "ms_per_sweep": m["ms"], "device_busy_ms_per_sweep": m["busy"],
        "device_ops_per_sweep": m["ops"], "idle_share": 1.0 - m["busy"] / m["ms"],
        "top": m["top"],
    }


def profile_pt(R: int, max_temp: float = 8.0) -> dict:
    """One PT ensemble sweep (R replicas + the exchange) on cuda."""
    n = _counts(False)
    cfg = SamplerConfig(G=G, burn=0, samples=WARM + WALL + TRACED, nmf_iters=50)
    gens = pt_generators(0, R, n.device)
    states, accums, rung = pt_init(n, cfg, gens[:R])
    noises, exchange = pt_noises(gens)
    step = make_pt_step(n, cfg, R, max_temp, ops.resolve("cuda", n))
    it = 0

    def run(k):
        nonlocal states, accums, rung, it
        for _ in range(k):
            states, accums, rung, _, _, _ = step(states, accums, rung, it,
                                                  noises, exchange)
            it += 1

    m = _measure(run, R)
    return {
        "kernel": "cuda", "counts": "synth", "V": V, "S": S, "G": G,
        "pt_replicas": R, "pt_max_temp": max_temp,
        "ms_per_ensemble_sweep": m["ms"],
        "device_busy_ms_per_ensemble_sweep": m["busy"],
        "device_ops_per_ensemble_sweep": m["ops"],
        "idle_share": 1.0 - m["busy"] / m["ms"], "top": m["top"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_sweep")
    ap.add_argument("--pt", type=int, default=0, metavar="R",
                    help="profile a PT ensemble sweep of R >= 2 replicas")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    if args.pt:
        if args.pt < 2:
            ap.error("--pt needs R >= 2")
        print(json.dumps(profile_pt(args.pt)))
        return 0
    for kernel in ops.KERNELS:
        if kernel != "cuda_topk":
            print(json.dumps(profile_kernel(kernel)))
    for kernel in ("cuda", "cuda_topk"):
        print(json.dumps(profile_kernel(kernel, biallelic=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
