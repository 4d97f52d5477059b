"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell, its
configuration and its metrics are found by name: the cell in
``benchmark/workloads/<cell>.json`` (its entry, traffic parameters, the
limits of its checks), the configuration in the file ``BENCHMARK.json``
names, the entry the cell drives in ``benchmark/entries/<entry>.py``, the
configuration's input generator in ``benchmark/generators/<kind>.py``,
each metric's reader in ``benchmark/metrics/<metric>.py``. Adding a cell,
a configuration, an entry or a metric is adding files and entries.

A run draws its inputs from the seed, warms up (set-up, ``setup_s``), then
runs the cell's entry in a closed loop (``entries``): it starts a new item
only while the time left of ``--seconds`` exceeds the last item's time,
and always runs one. The window is the time from the first item's start to
the last one's end. With ``--trace 1`` the loop runs the cell's
``trace_items`` under torch.profiler instead and reports the per-layer
metrics. A cell with an end-to-end metric read from the device trace runs
its ``--trace 0`` window under the profiler too. Then, with the window
closed and the peak device bytes read, the judge compares the items'
answers with the plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with --trace 1
``breakdown``, and last ``checks`` (each number compared, with its limit),
which also end standard error. Without CUDA or with fewer cards than the
cell asks for, and if the process holds JAX or the JAX package once the
window has closed, it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# what the measured process may not hold once the window has closed, by
# top-level module name compared whole (the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "desman_tpu")


@dataclass
class Window:
    """What the closed loop did, for the metric readers."""

    seconds: float = 0.0                 # first item's start to last item's end
    item_s: list = field(default_factory=list)
    sweeps: int = 0                      # all sweeps of the finished items
    setup_s: float = 0.0
    trace: object = None                 # trace.DeviceTrace of a profiled window
    spans: dict = field(default_factory=dict)
    shape: tuple = ()                    # (V, S, G) of a chain cell
    observed: int = 0                    # counts > 0 of a chain cell

    @property
    def items(self) -> int:
        return len(self.item_s)


def load(name: str, bench: dict | None = None):
    """(BENCHMARK.json, its cell entry, the cell's workload file, the
    configuration file) of cell `name`."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    return bench, cell, wl, config


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The cell's metrics: end-to-end ones that list it (or list no cells)
    untraced, per-layer ones that list it (or list none and move one of its
    end-to-end metrics) traced."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def reader(metric: str):
    """The read(window) function of benchmark/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop(entry, seconds: float, max_items: int | None, log) -> tuple:
    """The closed loop: (window seconds, [item seconds], sweeps, failed)."""
    item_s, sweeps, failed = [], 0, 0
    first = end = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        try:
            sweeps += entry.item(k)
        except Exception:
            failed += 1
            log(traceback.format_exc())
            break
        end = time.perf_counter()
        item_s.append(end - t0)
        k += 1
        if max_items is not None and k >= max_items:
            break
        if seconds - (end - first) <= item_s[-1]:
            break
    return end - first, item_s, sweeps, failed


def _card(log) -> None:
    """The card's name, power limit and clocks, on standard error."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        log(f"# card: {out}")
    except (OSError, subprocess.SubprocessError) as e:
        log(f"# card: nvidia-smi unavailable ({e})")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             bench=None, wl=None, config=None, log=None) -> dict:
    """One run of cell `name`; returns the result object. A test may hand in
    its own BENCHMARK.json, workload and configuration (small sizes, a CPU
    device)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench_, _, wl_, config_ = load(name, bench)
    wl, config = wl or wl_, config or config_
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from . import entries
    from . import trace as tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    log(f"# setup imports_done_s {time.perf_counter() - T_START}")
    entry = entries.entry(wl["entry"])(wl, config, seed, dev)
    log(f"# setup inputs_done_s {time.perf_counter() - T_START}")
    win = Window(shape=entry.shape, observed=entry.observed)
    entry.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    win.setup_s = time.perf_counter() - T_START
    log(f"# setup_s {win.setup_s}")

    profiled = trace or any(m["source"] == "device_trace"
                            for m in metrics_of(bench_, name, False))
    gc.collect()
    with tracing.profiler(dev) if profiled else contextlib.nullcontext() as prof:
        win.seconds, win.item_s, win.sweeps, failed = loop(
            entry, float("inf") if trace else seconds,
            wl["trace_items"] if trace else None, log)
    if profiled:
        win.trace = tracing.from_profiler(prof, win.seconds)
    log(f"# window_s {win.seconds} items {win.items} sweeps {win.sweeps}")
    log("# item_s " + " ".join(repr(s) for s in win.item_s))
    win.spans = entry.spans()

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"# memory_peak_bytes {peak}")
    if dev.type == "cuda":
        _card(log)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}")

    metrics = {}
    for m in metrics_of(bench_, name, trace):
        value = reader(m["name"])(win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    entry.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from . import judge

    numbers = entry.judge()
    entry.close()
    ok, checks = judge.verdict(numbers, wl["limits"])
    correct = ok and failed == 0 and win.items > 0
    result = {
        "correct": correct, "attempted": win.items + failed, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
                   "count": int(wl.get("chips", 1)), "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"].update(busy_s=win.trace.busy_s(), window_s=win.trace.window_s)
        result["breakdown"] = {"device_ops": win.trace.device_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    for k in sorted(set(numbers) - set(wl["limits"])):
        log(f"# info {k} {numbers[k]!r} (not compared)")
    for k, v, lim in checks:
        log(f"check {k} {v!r} limit {lim!r}")
    return result


def held_forbidden() -> list:
    """The forbidden top-level modules this process holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _ = load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = held_forbidden()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
