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

profiles one parallel-tempering ensemble sweep instead (the R replicas
as one sweep on the chain axis, then the exchange: ``sampler.make_pt_step``)
on cuda with the synth counts, ladder to 8: the same items a sweep become a
PT ensemble sweep's, over a quarter as many ensemble sweeps at R = 4
(WARM, WALL and TRACED / R).

    python -m desman_tpu_torch.profile_sweep --chains C [--kernel K]

profiles one sweep of C chains on the chain axis (``sampler.run_chains``'
sweep: one state with a leading [C] axis, seeds 0 .. C-1) with cuda on the
synth counts and with cuda and cuda_topk on the biallelic counts, each
beside the one-chain sweep of the same choice and counts, so the chain
sweep's ms, busy ms and ops stand beside C times the one chain's. --kernel
K profiles that choice alone (cuda_topk on the biallelic counts, the rest
on the synth counts), with or without --chains.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import profile

from . import ops, synth
from .profiling import activities
from .sampler import (
    ChainNoise, SamplerConfig, TorchNoise, chain_generator, init_accum, init_state,
    init_states, make_pt_step, make_sweep_fn, pt_generators, pt_init, pt_noises,
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


def profile_kernel(kernel: str, biallelic: bool = False,
                   chains: Optional[int] = None) -> dict:
    """One sweep of a chain (seed 0), or with chains=C of C chains on the
    chain axis (seeds 0 .. C-1)."""
    n = _counts(biallelic)
    dev = n.device
    cfg = SamplerConfig(G=G, burn=0, samples=WARM + WALL + TRACED, nmf_iters=50)
    if chains is None:
        gen = chain_generator(0, dev)
        state = init_state(n, cfg, gen)
        noise = TorchNoise(gen)
    else:
        gens = [chain_generator(c, dev) for c in range(chains)]
        state = init_states(n, cfg, gens)
        noise = ChainNoise(TorchNoise(g) for g in gens)
    accum = init_accum(V, S, G, dev, chains=chains)
    sweep = make_sweep_fn(cfg, ops.resolve(kernel, n))
    it = 0

    def run(k):
        nonlocal state, accum, it
        for _ in range(k):
            state, accum, _ = sweep(n, state, accum, it, noise)
            it += 1

    m = _measure(run, 1)
    return {
        "kernel": kernel, "counts": "biallelic" if biallelic else "synth",
        "V": V, "S": S, "G": G, "chains": chains or 1,
        "ms_per_sweep": m["ms"], "device_busy_ms_per_sweep": m["busy"],
        "device_ops_per_sweep": m["ops"], "idle_share": 1.0 - m["busy"] / m["ms"],
        "top": m["top"],
    }


def profile_pt(R: int, max_temp: float = 8.0) -> dict:
    """One PT ensemble sweep (R replicas + the exchange) on cuda."""
    n = _counts(False)
    cfg = SamplerConfig(G=G, burn=0, samples=WARM + WALL + TRACED, nmf_iters=50)
    gens = pt_generators(0, R, n.device)
    state, accum, rung = pt_init(n, cfg, gens[:R])
    noise, exchange = pt_noises(gens)
    step = make_pt_step(n, cfg, R, max_temp, ops.resolve("cuda", n))
    it = 0

    def run(k):
        nonlocal state, accum, rung, it
        for _ in range(k):
            state, accum, rung, _, _, _ = step(state, accum, rung, it, noise, exchange)
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
    ap.add_argument("--chains", type=int, default=0, metavar="C",
                    help="profile a sweep of C >= 1 chains on the chain axis, each "
                         "beside the one-chain sweep")
    ap.add_argument("--kernel", choices=ops.KERNELS,
                    help="profile this kernel choice alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    if args.pt:
        if args.pt < 2:
            ap.error("--pt needs R >= 2")
        print(json.dumps(profile_pt(args.pt)))
        return 0
    alone = None if args.kernel is None else ((args.kernel, args.kernel == "cuda_topk"),)
    if args.chains:
        if args.chains < 1:
            ap.error("--chains needs C >= 1")
        for kernel, biallelic in alone or (("cuda", False), ("cuda", True),
                                           ("cuda_topk", True)):
            for chains in (None, args.chains):
                print(json.dumps(profile_kernel(kernel, biallelic, chains)))
        return 0
    if alone:
        print(json.dumps(profile_kernel(*alone[0])))
        return 0
    for kernel in ops.KERNELS:
        if kernel != "cuda_topk":
            print(json.dumps(profile_kernel(kernel)))
    for kernel in ("cuda", "cuda_topk"):
        print(json.dumps(profile_kernel(kernel, biallelic=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
