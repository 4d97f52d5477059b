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
"""
from __future__ import annotations

import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import ops, synth
from .sampler import SamplerConfig, TorchNoise, init_accum, init_state, make_sweep_fn


V, S, G = 10_000, 64, 8          # the port's metric configuration
WARM, WALL, TRACED, TOP = 220, 200, 20, 12


def profile_kernel(kernel: str, biallelic: bool = False) -> dict:
    dev = torch.device("cuda")
    t = (synth.generate(V=V, S=S, G=G, coverage=50.0, error_rate=0.0,
                        max_alleles=2, seed=0) if biallelic else
         synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0))
    n = torch.as_tensor(t.data.counts, dtype=torch.float32, device=dev)
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

    run(WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(WALL)
    torch.cuda.synchronize()
    ms_sweep = (time.perf_counter() - t0) * 1e3 / WALL

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(TRACED)
        torch.cuda.synchronize()
    items = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in items) / 1e3 / TRACED
    n_ops = sum(e.count for e in items) / TRACED
    items.sort(key=lambda e: -e.self_device_time_total)
    return {
        "kernel": kernel, "counts": "biallelic" if biallelic else "synth",
        "V": V, "S": S, "G": G,
        "ms_per_sweep": ms_sweep, "device_busy_ms_per_sweep": busy,
        "device_ops_per_sweep": n_ops, "idle_share": 1.0 - busy / ms_sweep,
        "top": [(e.key[:80], e.self_device_time_total / 1e3 / TRACED,
                 e.count / TRACED) for e in items[:TOP]],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    for kernel in ops.KERNELS:
        if kernel != "cuda_topk":
            print(json.dumps(profile_kernel(kernel)))
    for kernel in ("cuda", "cuda_topk"):
        print(json.dumps(profile_kernel(kernel, biallelic=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
