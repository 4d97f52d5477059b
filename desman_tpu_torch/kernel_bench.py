"""Device time and output bits of the port's kernels (chiefly the
row-resident ones: the tau sweep, the fused front half and the top-2 tau
sweep), beside the same kernels of another checkout; and the inputs,
digests, bounds and timers that chip_smoke.py uses.

    python -m desman_tpu_torch.kernel_bench [--against ROOT] [--out FILE]

Times this package's ``ops.tau_sweep``, ``ops.fused_sweep``,
``ops.tau_sweep_topk`` (on biallelic counts, ``topk_inputs``) and
``ops.gamma_ll`` (with_old) at V=1e4 S=64 G=8 (chip_smoke.py's phase-3
inputs) and V=1e5 S=96 G=16, ``ops.gamma_ll`` also at V=1e4 S=64 G=1, the
shape the resident path launches it at, and ``ops.swap`` (with and without
emit_ll) and ``ops.gamma_apply_eta`` at V=1e4 S=64 G=8. With --against, the same
public wrappers of the ``desman_tpu_torch`` package in the checkout at ROOT
(another commit, unpacked by ``git archive`` into a git-ignored directory)
are loaded beside this package under another name, build their kernels
into ROOT's own ``build/``, and run on the same inputs, in the order
against, this, this, against. For each tree and kernel:

- device ms a call: CUDA events around 200 back-to-back calls, divided by
  200, and torch.profiler's self device time of each kernel over 50 calls;
  the host microseconds to enqueue one call;
- SHA-256 of the outputs, and whether the trees agree bit for bit. The
  inputs are built on the CPU from numpy seeds (the mixture by an ordered
  f32 sum, no BLAS) and then moved to the card, so nothing but the kernel
  decides the bits;
- registers and spill bytes of each kernel function (``nvcc -Xptxas -v``
  over the tree's ``csrc/``).

The chain-axis kernels (all six wrappers) are also timed at V=1e4 S=64
G=8 with C = 5 and 40 chains in one launch (``chain_inputs``), beside C
solo launches; their bound counts the shared counts once and every
chain's other bytes and logs C times.

Then the paths the chain axis carries, through each tree's own modules in
the same order (``measure_paths``): one PT ensemble sweep of four
replicas (that tree's ``profile_sweep.profile_pt(4)``: host ms, device-busy
ms, device ops and idle share); ``sampler.run_chains`` of seeds 0-4 with
``cuda_resident`` at V=1e4 S=64 G=8, 400 sweeps, NMF starts included
(wall, chain-sweeps/s); and ``multibin.run_bins`` of 12 bins of S=64 (synth
seeds 200-211, true G=5, V from 1000 to 1e4 in equal steps, padded to
1e4), 250 sweeps with ``cuda`` (wall, and the peak device bytes above the
start from ``torch.cuda.max_memory_allocated``). Host times are taken
around work that ends in ``torch.cuda.synchronize``.

And the SASS instructions of one IEEE ``logf`` and of one ``log_normal``
(probe kernels with and without them), the check of ``log_normal`` against
``logf`` on every float of [1e-12, FLT_MAX], and this tree's tile plan, registers and resident blocks of
each row-resident kernel (``ops.tau_kernel.kernel_info``). Each kernel row
also gives, for each tree, ``logf_sites``: the IEEE ``logf`` expansions left
in its kernel function's SASS (``LOGF_SITE``, in cuobjdump's output of the
tree's library), 0 where every log is ``log_normal``. One JSON line per
measurement, all of them also in FILE with --out. Needs a CUDA device and
nvcc; it does not fall back.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import ops, synth
from .ops import _build

# The card's rates behind every bound_ms (H100 SXM: 132 SMs, 16 MUFU results
# per clock per SM at the 1.98 GHz boost clock, 3.35 TB/s of HBM3).
LOG_RATE = 132 * 16 * 1.98e9     # logs/s
MEM_RATE = 3.35e12               # bytes/s
INSTR_RATE = 132 * 4 * 1.98e9    # warp instructions/s (4 schedulers a SM)
METRIC = (10_000, 64, 8)         # the port's metric configuration
ONE_STRAIN = (10_000, 64, 1)     # gamma_ll's shape on the resident path (G=1)
SCALE = (100_000, 96, 16)        # the full-sweep scale (ROADMAP item 13)
# the row-resident kernels (ops.tau_kernel's plans), and the kernels
# measure() times at each shape
RESIDENT = ("tau_sweep", "fused_sweep", "tau_sweep_topk")
KERNELS = {METRIC: RESIDENT + ("gamma_ll", "swap", "swap_emit_ll", "gamma_apply_eta"),
           ONE_STRAIN: ("gamma_ll",),
           SCALE: RESIDENT + ("gamma_ll",)}
# the kernels with a chain axis, and the chains measure() launches them with
CHAIN_AXIS = ("tau_sweep", "swap", "tau_sweep_topk", "gamma_ll", "gamma_apply_eta",
              "fused_sweep")
CHAIN_COUNTS = (5, 40)
EVENT_LAUNCHES, PROFILED_LAUNCHES = 200, 50
# measure_paths: resident run_chains' seeds and sweeps; multibin's bins
PATH_SEEDS, PATH_SWEEPS = (0, 1, 2, 3, 4), 400
BINS, BIN_G, BIN_SWEEPS = 12, 5, 250


# ---------------------------------------------------------------- inputs

def host_mixture(tau: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """mix[v,s,a] = sum_g [tau[v,g] == a] gamma[s,g] in f32, strains added
    in order by elementwise numpy: the same bits on every host."""
    V, G = tau.shape
    gam = gamma.astype(np.float32)
    mix = np.zeros((V, gam.shape[0], 4), dtype=np.float32)
    for g in range(G):
        for a in range(4):
            mix[:, :, a] += (tau[:, g] == a).astype(np.float32)[:, None] * gam[None, :, g]
    return mix


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32))


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32))


def phase3_inputs(V: int, S: int, G: int) -> dict:
    """chip_smoke.py's phase-3 inputs as CPU tensors, drawn in its order
    from synth.generate(seed=0) and numpy's default_rng(0).

    tau/mix/gz: the tau sweep's; tau_s/mix_s/g/h/logu: the swap's (the
    truth with strains g, h exchanged at half the positions); gp/accept:
    the gamma proposal and accepts; tau0/mix0: the fused kernel's start."""
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    rng = np.random.default_rng(0)
    d = dict(n=_f32(t.data.counts), gamma=_f32(t.gamma), eta=_f32(t.eta))
    tau = rng.integers(0, 4, size=(V, G))
    d.update(tau=_i32(tau), mix=_f32(host_mixture(tau, t.gamma)),
             gz=_f32(rng.gumbel(size=(V, G, 4))))
    g, h = 1, G - 2
    tau_s = t.tau_idx.copy()
    flip = rng.random(V) < 0.5
    tau_s[flip, g], tau_s[flip, h] = t.tau_idx[flip, h], t.tau_idx[flip, g]
    d.update(tau_s=_i32(tau_s), mix_s=_f32(host_mixture(tau_s, t.gamma)),
             g=torch.tensor(g, dtype=torch.int32), h=torch.tensor(h, dtype=torch.int32),
             logu=_f32(np.log(rng.uniform(size=V))))
    d.update(gp=_f32(rng.dirichlet(np.ones(G), size=S)),
             accept=torch.as_tensor(rng.random(S) < 0.5))
    tau0 = rng.integers(0, 4, size=(V, G))
    d.update(tau0=_i32(tau0), mix0=_f32(host_mixture(tau0, t.gamma)))
    return d


def chain_inputs(V: int, S: int, G: int, C: int, topk: bool = False) -> dict:
    """C chains' inputs of the chain-axis kernels as CPU tensors with a
    leading [C] axis, on counts the chains share: chain 0's are
    phase3_inputs (topk: topk_inputs), so its outputs carry the digests;
    chain c > 0 has its own random tau, gz and swap start (the truth with a
    pair of its own exchanged at half the positions, g = c mod G and h its
    neighbour), gamma from a flat Dirichlet and eta with its entries scaled
    by 1 + U(0, 0.1) and its rows renormalised, then the resident kernels'
    gamma proposal, accepts and fused start tau0, from numpy's
    default_rng(1000 + c); every chain's eta_prop is its eta with the rows
    reversed (CALLS' apply).
    Keys: the counts (n, and with topk n_val/b_idx) and tau, mix, gamma,
    eta, gz, tau_s, mix_s, g, h, logu, gp, accept, tau0, mix0, eta_prop
    (topk: the first six)."""
    first = topk_inputs(V, S, G) if topk else phase3_inputs(V, S, G)
    truth = None if topk else synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    keys = ("tau", "mix", "gamma", "eta", "gz")
    if not topk:
        keys += ("tau_s", "mix_s", "g", "h", "logu", "gp", "accept", "tau0", "mix0")
    chains = [{k: first[k] for k in keys}]
    for c in range(1, C):
        rng = np.random.default_rng(1000 + c)
        tau = rng.integers(0, 4, size=(V, G))
        gamma = rng.dirichlet(np.ones(G), size=S).astype(np.float32)
        eta = first["eta"].numpy() * (1.0 + 0.1 * rng.random((4, 4)))
        d = dict(tau=_i32(tau), mix=_f32(host_mixture(tau, gamma)), gamma=_f32(gamma),
                 eta=_f32(eta / eta.sum(axis=1, keepdims=True)),
                 gz=_f32(rng.gumbel(size=(V, G, 4))))
        if not topk:
            g, h = c % G, (c + 1) % G
            tau_s = truth.tau_idx.copy()
            flip = rng.random(V) < 0.5
            tau_s[flip, g], tau_s[flip, h] = truth.tau_idx[flip, h], truth.tau_idx[flip, g]
            d.update(tau_s=_i32(tau_s), mix_s=_f32(host_mixture(tau_s, gamma)),
                     g=torch.tensor(g, dtype=torch.int32),
                     h=torch.tensor(h, dtype=torch.int32),
                     logu=_f32(np.log(rng.uniform(size=V))))
            tau0 = rng.integers(0, 4, size=(V, G))
            d.update(gp=_f32(rng.dirichlet(np.ones(G), size=S)),
                     accept=torch.as_tensor(rng.random(S) < 0.5),
                     tau0=_i32(tau0), mix0=_f32(host_mixture(tau0, gamma)))
        chains.append(d)
    out = {k: torch.stack([d[k] for d in chains]) for k in keys}
    if not topk:
        out["eta_prop"] = out["eta"].flip(1).contiguous()
    out.update({k: first[k] for k in (("n", "n_val", "b_idx") if topk else ("n",))})
    return out


def tau_args(d: dict) -> tuple:
    """(n, tau, mix, gamma, eta, gz) of the tau sweep."""
    return tuple(d[k] for k in ("n", "tau", "mix", "gamma", "eta", "gz"))


def fused_args(d: dict) -> tuple:
    """(n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop) of the fused
    kernel, from the fused kernel's own start tau0."""
    return tuple(d[k] for k in ("n", "tau0", "mix0", "gamma", "eta", "gz", "g", "h",
                                "logu", "gp"))


def topk_inputs(V: int, S: int, G: int) -> dict:
    """The top-2 kernel's inputs as CPU tensors, built as chip_smoke.py's
    top-2 phase uses them: biallelic, error-free counts (every cell observes
    at most two bases) from synth.generate(error_rate=0, max_alleles=2,
    seed=0) with n (the [V,S,4] counts, for the tau kernel) beside their
    top-2 layout n_val/b_idx; eta = synth.make_eta(0.01) (with the data's
    own eta, the identity, most logs would sit at the 1e-12 floor); tau and
    gz from numpy's default_rng(2), the mixture by host_mixture."""
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, error_rate=0.0, max_alleles=2,
                       seed=0)
    rng = np.random.default_rng(2)
    tau = rng.integers(0, 4, size=(V, G))
    layout = ops.tau_topk.topk_layout(t.data.counts, "cpu")
    return dict(n=_f32(t.data.counts), n_val=layout.n_val, b_idx=layout.b_idx,
                tau=_i32(tau), mix=_f32(host_mixture(tau, t.gamma)), gamma=_f32(t.gamma),
                eta=_f32(synth.make_eta(0.01)), gz=_f32(rng.gumbel(size=(V, G, 4))))


def topk_args(d: dict) -> tuple:
    """(n_val, b_idx, tau, mix, gamma, eta, gz) of the top-2 sweep."""
    return tuple(d[k] for k in ("n_val", "b_idx", "tau", "mix", "gamma", "eta", "gz"))


def gamma_ll_args(d: dict) -> tuple:
    """(n, mix, tau, gamma_prop, eta) of gamma_ll, on the tau sweep's start."""
    return tuple(d[k] for k in ("n", "mix", "tau", "gp", "eta"))


def swap_args(d: dict) -> tuple:
    """(n, tau, mix, gamma, eta, g, h, logu) of the swap, on the truth with
    strains g, h exchanged at half the positions."""
    return tuple(d[k] for k in ("n", "tau_s", "mix_s", "gamma", "eta", "g", "h", "logu"))


def topk_chain_args(d: dict) -> tuple:
    """(n_val, b_idx, tau, mix, gamma, eta, gz) of the top-2 sweep on
    chain_inputs(topk=True)."""
    return tuple(d[k] for k in ("n_val", "b_idx", "tau", "mix", "gamma", "eta", "gz"))


# each kernel's call on measure()'s inputs (the top-2 kernel's: topk_inputs;
# with a chain axis, chain_inputs')
CALLS = {
    "tau_sweep": lambda o, d: o.tau_sweep(*tau_args(d)),
    "fused_sweep": lambda o, d: o.fused_sweep(*fused_args(d)),
    "tau_sweep_topk": lambda o, d: o.tau_sweep_topk(*topk_args(d)),
    "gamma_ll": lambda o, d: o.gamma_ll(*gamma_ll_args(d)),
    "swap": lambda o, d: o.swap(*swap_args(d)),
    "swap_emit_ll": lambda o, d: o.swap(*swap_args(d), emit_ll=True),
    "gamma_apply_eta": lambda o, d: o.gamma_apply_eta(
        *(d[k] for k in ("n", "mix", "tau", "gp", "accept")), d["eta"].flip(0).contiguous()),
}


def digest(*tensors: torch.Tensor) -> str:
    """SHA-256 over the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------- bounds

def kernel_work(name: str, V: int, S: int, G: int, C: int = 1) -> tuple[int, int]:
    """(logs, bytes) a call of kernel `name` needs at these shapes: every
    log the function takes, each input read once and each output written
    once (f32/i32: 4 bytes; [V,S,4] rows 16 bytes a cell). With C chains in
    one launch the counts, which the chains share, are read once and every
    other byte and every log counts C times."""
    cells = V * S
    row = 16 * cells                     # one [V,S,4] f32 tensor
    tau, gz, gam = 4 * V * G, 16 * V * G, 4 * S * G
    if name == "tau_sweep":              # n; mix, tau, gz, gamma, eta in; tau, mix out
        logs, counts, chain = 16 * G * cells, row, 2 * row + 2 * tau + gz + gam + 64
    elif name == "tau_sweep_topk":       # n_val, b_idx (8 B a cell each) instead of n
        logs, counts, chain = 8 * G * cells, 16 * cells, 2 * row + 2 * tau + gz + gam + 64
    elif name == "fused_sweep":          # + logu, gamma_prop in; ll [2,S] out
        logs, counts = (16 * G + 12) * cells, row
        chain = 2 * row + 2 * tau + gz + 2 * gam + 64 + 4 * V + 8 * S
    elif name in ("swap", "swap_emit_ll"):  # n; mix, tau, gamma, logu in; tau, mix (ll) out
        ll = 4 * S if name == "swap_emit_ll" else 0
        logs, counts, chain = 8 * cells, row, 2 * row + 2 * tau + gam + 4 * V + 64 + ll
    elif name == "gamma_ll":             # with_old: n; mix, tau, gamma_prop in; ll [2,S]
        logs, counts, chain = 8 * cells, row, row + tau + gam + 64 + 8 * S
    elif name == "gamma_apply_eta":      # with_eta: n; mix, tau, gp, accept, eta_prop; mix, ll
        logs, counts, chain = 4 * cells, row, 2 * row + tau + gam + S + 64 + 4 * S
    else:
        raise ValueError(f"no work model for kernel {name!r}")
    return C * logs, counts + C * chain


def log_issue_ms(name: str, V: int, S: int, G: int, instructions: dict) -> float:
    """The least time the card's schedulers take to issue kernel `name`'s
    logs alone: its logs times the SASS instructions of one log
    (log_instructions' log_normal: every kernel's log, csrc/warp.cuh's
    safe_log), over 32 lanes a warp instruction and INSTR_RATE."""
    return kernel_work(name, V, S, G)[0] * instructions["log_normal"] / 32 / INSTR_RATE * 1e3


def bound(name: str, V: int, S: int, G: int, C: int = 1) -> dict:
    """The least time the card could take for kernel `name` (over C chains
    in one launch): the larger of its bytes over the memory rate and its
    logs over the SFU rate."""
    logs, nbytes = kernel_work(name, V, S, G, C)
    t_logs, t_bytes = logs / LOG_RATE * 1e3, nbytes / MEM_RATE * 1e3
    return dict(logs=logs, bytes=nbytes, bound_ms=max(t_logs, t_bytes),
                bound_by="operations" if t_logs >= t_bytes else "bytes")


# ---------------------------------------------------------------- timing

def event_ms(fn, launches: int = EVENT_LAUNCHES) -> float:
    """Device ms per call: CUDA events around `launches` back-to-back calls
    (after 10 warm-up calls), divided by their number."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def host_us(fn, launches: int = EVENT_LAUNCHES) -> float:
    """Host microseconds to enqueue one call: the wall time of `launches`
    back-to-back calls without a synchronise, divided by their number."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / launches


def profiled_ms(fn, launches: int = PROFILED_LAUNCHES) -> dict:
    """torch.profiler's self device ms per call of each kernel fn launches,
    over `launches` calls; key "total" is their sum. Each kernel's time is
    the mean over the records the trace holds times its launches a call (at
    least 1), so a record the tracer drops does not pull the mean down;
    key "records" counts the records of each kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count]
    out = {e.key[:60]: e.self_device_time_total / 1e3 / e.count
           * max(1, round(e.count / launches)) for e in kernels}
    out["total"] = sum(out.values())
    out["records"] = {e.key[:60]: e.count for e in kernels}
    return out


# ---------------------------------------------------------------- trees

def load_ops(root: Path, name: str = "desman_tpu_torch_against"):
    """The ``ops`` module of the desman_tpu_torch package at ROOT, imported
    under `name` beside this package (its modules import one another
    relatively, and its kernels build into ROOT's build/)."""
    pkg = Path(root).resolve() / "desman_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops")


# the sources and kernel functions ptxas_registers reports
REGISTER_KERNELS = {"tau_kernel.cu": "tau_sweep_kernel", "fused_sweep.cu": "fused_sweep_kernel",
                    "tau_topk.cu": "tau_topk_kernel", "gamma_kernel.cu": "gamma_ll_kernel",
                    "swap_kernel.cu": "swap_kernel"}


def ptxas_registers(csrc: Path, workdir: Path) -> dict:
    """nvcc -Xptxas -v of the tau, fused, top-2, gamma and swap kernels' sources in
    csrc, with the package's flags: {kernel function: {registers,
    spill_stores, spill_loads}} for the kernel functions of
    REGISTER_KERNELS."""
    out = {}
    for src in REGISTER_KERNELS:
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                              "-o", str(workdir / f"{src}.o"), str(Path(csrc) / src)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{res.stderr}")
        fn = None
        for line in res.stderr.splitlines():
            m = re.search(r"Function properties for (\w+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                out.setdefault(fn, {}).update(spill_stores=int(m.group(1)),
                                              spill_loads=int(m.group(2)))
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                out.setdefault(fn, {})["registers"] = int(m.group(1))
    return {k: v for k, v in out.items()
            if "registers" in v and any(name in k for name in REGISTER_KERNELS.values())}


# the kernel function of each wrapper measure() times
KERNEL_FUNCTIONS = {"tau_sweep": "tau_sweep_kernel", "fused_sweep": "fused_sweep_kernel",
                    "tau_sweep_topk": "tau_topk_kernel", "gamma_ll": "gamma_ll_kernel",
                    "swap": "swap_kernel", "swap_emit_ll": "swap_kernel",
                    "gamma_apply_eta": "apply_eta_kernel"}
# An IEEE logf expansion's subnormal scaling, x * 2^23 where x < FLT_MIN:
# one FMUL by 8388608 a logf, inlined or not; csrc/warp.cuh's log_normal
# has none (the log_instructions probes: logf_probe 1, log_normal_probe 0).
LOGF_SITE = re.compile(r"\bFMUL\S*\s+R\d+,\s*R\d+(?:\.\w+)*,\s*8388608(?![\w.])")
SASS_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP)\S")


def function_name(symbol: str) -> str:
    """The unqualified name of a SASS function: the last component of an
    Itanium-mangled nested name (_ZN6desman...16tau_sweep_kernelILb1E...),
    an extern "C" symbol as it stands."""
    if not symbol.startswith("_ZN"):
        return symbol
    i, name = 3, symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while j < len(symbol) and symbol[j].isdigit():
            j += 1
        name = symbol[j:j + int(symbol[i:j])]
        i = j + int(symbol[i:j])
    return name


def sass_instructions(text: str) -> dict:
    """cuobjdump -sass output as {function symbol: its instruction lines}
    (NOPs left out)."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
        elif fn and SASS_INSTRUCTION.match(line):
            out[fn].append(line)
    return out


def logf_sites(text: str) -> dict:
    """IEEE logf expansions (LOGF_SITE) in cuobjdump -sass output, by
    function name, summed over a template's instances."""
    out = {}
    for fn, lines in sass_instructions(text).items():
        name = function_name(fn)
        out[name] = out.get(name, 0) + sum(bool(LOGF_SITE.search(x)) for x in lines)
    return out


def sass(binary: Path) -> str:
    """cuobjdump -sass of a cubin or of a library that embeds its kernels."""
    return subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
                           "-sass", str(binary)], check=True, capture_output=True,
                          text=True).stdout


def log_instructions(workdir: Path) -> dict:
    """SASS instructions of one IEEE logf and of one csrc/warp.cuh
    log_normal: probe kernels y = logf(x) and y = log_normal(x) against the
    same kernel with y = x, built with the package's flags (NOPs not
    counted); and the probes' logf_sites (the signature holds where
    logf_probe reads 1 and log_normal_probe 0)."""
    src = workdir / "log_probe.cu"
    src.write_text(
        "#include \"warp.cuh\"\n"
        "extern \"C\" __global__ void copy_probe(const float* x, float* y) {\n"
        "  y[threadIdx.x] = x[threadIdx.x];\n}\n"
        "extern \"C\" __global__ void logf_probe(const float* x, float* y) {\n"
        "  y[threadIdx.x] = logf(x[threadIdx.x]);\n}\n"
        "extern \"C\" __global__ void log_normal_probe(const float* x, float* y) {\n"
        "  y[threadIdx.x] = desman::log_normal(x[threadIdx.x]);\n}\n")
    cubin = workdir / "log_probe.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-I", str(_build.CSRC), "-cubin", "-o", str(cubin),
                    str(src)], check=True, capture_output=True, text=True)
    text = sass(cubin)
    count = {fn: len(lines) for fn, lines in sass_instructions(text).items()}
    sites = logf_sites(text)
    return {"logf": count["logf_probe"] - count["copy_probe"],
            "log_normal": count["log_normal_probe"] - count["copy_probe"],
            "logf_sites": {k: sites[k] for k in ("logf_probe", "log_normal_probe")}}


def log_mismatches() -> dict:
    """csrc/warp.cuh's log_normal against the IEEE logf on the card, on
    every float of [1e-12, FLT_MAX] (the range safe_log hands it;
    csrc/log_check.cu): the floats checked, how many differ in any bit, and
    the least that does (None if none)."""
    lo = int(np.array(1e-12, dtype=np.float32).view(np.uint32))
    hi = int(np.array(np.finfo(np.float32).max, dtype=np.float32).view(np.uint32))
    lib = _build.load_library()
    out = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64, device="cuda")
    _build.check(lib, lib.desman_log_mismatches(lo, hi, out.data_ptr(),
                                                _build.stream_of(out)), "log check")
    count, first = (int(x) for x in out.cpu())
    first &= 0xFFFFFFFF
    return dict(floats=hi - lo + 1, mismatches=count,
                first=None if count == 0 else float(np.array(first, np.uint32).view(np.float32)))


# ---------------------------------------------------------------- runs

def card_inputs(V: int, S: int, G: int, dev) -> dict:
    """The metric configuration's inputs are chip_smoke's phase-3 inputs;
    at other shapes the same draws from synth.generate(seed=1)."""
    if (V, S, G) == METRIC:
        d = phase3_inputs(V, S, G)
    else:
        t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=1)
        rng = np.random.default_rng(1)
        tau0 = rng.integers(0, 4, size=(V, G))
        d = dict(n=_f32(t.data.counts), gamma=_f32(t.gamma), eta=_f32(t.eta),
                 tau0=_i32(tau0), mix0=_f32(host_mixture(tau0, t.gamma)),
                 gz=_f32(rng.gumbel(size=(V, G, 4))),
                 g=torch.tensor(1, dtype=torch.int32),
                 h=torch.tensor(G - 2, dtype=torch.int32),
                 logu=_f32(np.log(rng.uniform(size=V))),
                 gp=_f32(rng.dirichlet(np.ones(G), size=S)))
        d["tau"], d["mix"] = d["tau0"], d["mix0"]
    return {k: v.to(dev) for k, v in d.items()}


# the chain-axis inputs of each kernel but the top-2 kernel, after the counts
CHAIN_KEYS = {
    "tau_sweep": ("tau", "mix", "gamma", "eta", "gz"),
    "swap": ("tau_s", "mix_s", "gamma", "eta", "g", "h", "logu"),
    "gamma_ll": ("mix", "tau", "gp", "eta"),
    "gamma_apply_eta": ("mix", "tau", "gp", "accept", "eta_prop"),
    "fused_sweep": ("tau0", "mix0", "gamma", "eta", "gz", "g", "h", "logu", "gp"),
}


def chain_calls(o, name: str, d: dict):
    """(the chain-axis call, one(c): the call on chain c's inputs alone) of
    kernel `name` of ops module `o` (or any namespace of its functions, such
    as the plain versions) on chain_inputs' d, whose counts may carry a
    chain axis of their own."""
    if name == "tau_sweep_topk":
        args = topk_chain_args(d)
        shared, chained = args[:2], args[2:]
    else:
        shared, chained = (d["n"],), tuple(d[k] for k in CHAIN_KEYS[name])
    fn = getattr(o, name)
    # chain c's inputs copied out of the stack: a slice need not start on
    # the 16 bytes the kernels take (a [V,G] i32 slice where V*G % 4 != 0)
    return (lambda: fn(*shared, *chained)), (
        lambda c: fn(*(k if k.dim() == 3 else k[c].clone() for k in shared),
                     *(x[c].clone() for x in chained)))


def measure_chains(trees: dict, rows: list) -> None:
    """Each chain-axis kernel of each tree whose wrapper takes the axis at
    METRIC with CHAIN_COUNTS chains: CUDA-event ms of one launch of C chains
    and of C solo launches in turn, in the order of `trees` and back,
    against the bound at C."""
    V, S, G = METRIC
    dev = torch.device("cuda")
    for C in CHAIN_COUNTS:
        inputs = {topk: {k: v.to(dev) for k, v in chain_inputs(V, S, G, C, topk).items()}
                  for topk in (False, True)}
        for kernel in CHAIN_AXIS:
            d = inputs[kernel == "tau_sweep_topk"]
            axis = {name: o for name, o in trees.items()
                    if hasattr(getattr(o, kernel), "chain_launches")}
            calls = {name: chain_calls(o, kernel, d) for name, o in axis.items()}
            ev = {name: {"batched": [], "solo": []} for name in axis}
            for name in list(axis) + list(reversed(axis)):
                batched, one = calls[name]
                ev[name]["batched"].append(event_ms(batched))
                ev[name]["solo"].append(event_ms(lambda: [one(c) for c in range(C)]))
            row = dict(kernel=kernel, V=V, S=S, G=G, C=C, **bound(kernel, V, S, G, C),
                       event_ms=ev)
            rows.append(row)
            print(json.dumps(row), flush=True)


def measure(trees: dict, shape, rows: list) -> None:
    """Each of KERNELS[shape] of each tree at `shape`: digests, then
    CUDA-event times in the order of `trees` and back, then profiler times,
    host time and the digests again."""
    V, S, G = shape
    dev = torch.device("cuda")
    d = card_inputs(V, S, G, dev)
    for kernel in KERNELS[shape]:
        k_in = ({k: v.to(dev) for k, v in topk_inputs(V, S, G).items()}
                if kernel == "tau_sweep_topk" else d)
        calls = {name: (lambda o=o: CALLS[kernel](o, k_in)) for name, o in trees.items()}

        def sha(name):
            out = calls[name]()
            torch.cuda.synchronize()
            return digest(*(out if isinstance(out, tuple) else (out,)))

        digests = {name: sha(name) for name in trees}
        ev = {name: [] for name in trees}
        for name in list(trees) + list(reversed(trees)):
            ev[name].append(event_ms(calls[name]))
        plan, grid = (ops.tau_kernel.resident_grid(kernel, V, S, G, dev.index or 0)
                      if kernel in RESIDENT else (None, None))
        row = dict(kernel=kernel, V=V, S=S, G=G, **bound(kernel, V, S, G),
                   plan=plan and plan._asdict(), grid=grid, event_ms=ev,
                   profiled_ms={name: profiled_ms(calls[name]) for name in trees},
                   host_us={name: host_us(calls[name]) for name in trees},
                   sha256=digests,
                   repeatable={name: sha(name) == digests[name] for name in trees},
                   bitwise_equal=len(set(digests.values())) == 1)
        rows.append(row)
        print(json.dumps(row), flush=True)


# ---------------------------------------------------------------- paths

def tree_module(o, name: str):
    """Module `name` of the package whose ``ops`` module is `o` (this
    package's, or one ``load_ops`` loaded)."""
    return importlib.import_module(f"{o.__name__.rsplit('.', 1)[0]}.{name}")


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _paths(o) -> dict:
    """The chain axis's paths through the modules of ops module o's
    package (the module docstring's three)."""
    sampler, multibin = tree_module(o, "sampler"), tree_module(o, "multibin")
    V, S, G = METRIC
    dev = torch.device("cuda")
    pt = tree_module(o, "profile_sweep").profile_pt(4)
    out = {"pt": {k: pt[k] for k in ("ms_per_ensemble_sweep",
                                      "device_busy_ms_per_ensemble_sweep",
                                      "device_ops_per_ensemble_sweep", "idle_share")}}
    n = torch.as_tensor(synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0).data.counts,
                        dtype=torch.float32, device=dev)
    cfg = sampler.SamplerConfig(G=G, burn=PATH_SWEEPS // 2, samples=PATH_SWEEPS // 2,
                                nmf_iters=50)
    wall = _wall(lambda: sampler.run_chains(n, cfg, PATH_SEEDS, kernel="cuda_resident"))
    out["resident_chains"] = {"wall_s": wall,
                              "chain_sweeps_per_s": len(PATH_SEEDS) * PATH_SWEEPS / wall}
    bins = [synth.generate(V=int(vb), S=S, G=BIN_G, coverage=50.0, seed=200 + b).data.counts
            for b, vb in enumerate(np.linspace(V // 10, V, BINS).round().astype(int))]
    cfg = sampler.SamplerConfig(G=BIN_G, burn=BIN_SWEEPS // 2,
                                samples=BIN_SWEEPS - BIN_SWEEPS // 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    wall = _wall(lambda: multibin.run_bins(bins, cfg, seed=0, kernel="cuda", device="cuda"))
    out["multibin"] = {"wall_s": wall, "s_per_bin": wall / BINS,
                       "peak_bytes": torch.cuda.max_memory_allocated() - base}
    return out


def measure_paths(trees: dict, rows: list) -> None:
    """``_paths`` of each tree, in the order of `trees` and back: one row a
    path and a tree."""
    for name in list(trees) + list(reversed(trees)):
        for path, m in _paths(trees[name]).items():
            row = {"path": path, "tree": name, **m}
            rows.append(row)
            print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desman_tpu_torch.kernel_bench")
    ap.add_argument("--against", help="root of another checkout whose desman_tpu_torch "
                                      "kernels run beside this package's")
    ap.add_argument("--out", help="file for all of the measurements as one JSON object")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"# {smi}", flush=True)
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    trees = {"this": ops}
    csrc = {"this": _build.CSRC}
    if args.against:
        trees = {"against": load_ops(Path(args.against)), **trees}
        csrc["against"] = Path(args.against) / "desman_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        report["log_instructions"] = log_instructions(Path(tmp))
        report["ptxas"] = {name: ptxas_registers(path, Path(tmp)) for name, path in csrc.items()}
    report["log_normal"] = log_mismatches()
    print(json.dumps({k: report[k] for k in ("log_instructions", "ptxas", "log_normal")}),
          flush=True)
    report["runtime"] = {f"S{shape[1]}_G{shape[2]}": {
        k: ops.tau_kernel.kernel_info(k, *shape[1:])
        for k in KERNELS[shape] if k in RESIDENT} for shape in KERNELS}
    print(json.dumps({"runtime": report["runtime"]}), flush=True)
    rows = report["rows"] = []
    for shape in KERNELS:
        measure(trees, shape, rows)
    # the trees whose wrappers take a chain axis (a checkout before it has none)
    chained = {k: o for k, o in trees.items() if hasattr(o.tau_sweep, "chain_launches")}
    if chained:
        measure_chains(chained, rows)
    sites = report["logf_sites"] = {
        name: logf_sites(sass(tree_module(o, "ops._build").build()))
        for name, o in trees.items()}
    print(json.dumps({"logf_sites": sites}), flush=True)
    for row in rows:
        row["log_issue_ms"] = log_issue_ms(row["kernel"], row["V"], row["S"], row["G"],
                                           report["log_instructions"])
        row["logf_sites"] = {name: sites[name][KERNEL_FUNCTIONS[row["kernel"]]]
                             for name in trees if name in row["event_ms"]}
    measure_paths(trees, report.setdefault("paths", []))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
