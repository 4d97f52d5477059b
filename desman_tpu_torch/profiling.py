"""Profiling hooks (counterpart of ``desman_tpu.profiling``).

``device_trace`` captures a ``torch.profiler`` trace of a run (``desman
--profile DIR``, ``RunConfig.profile_dir``) as a Chrome trace,
``DIR/trace.json``, viewable in Perfetto or chrome://tracing;
``SweepTimer`` keeps structured sweep-throughput segments. ``activities``
is the profiler's activity set, shared with ``profile_sweep``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"


def activities(device) -> list:
    """CPU activity, plus the card's kernels when `device` is CUDA."""
    if torch.device(device).type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], device="cpu"):
    """Trace the block with torch.profiler into trace_dir/trace.json
    (a no-op when trace_dir is None). On a CUDA device the trace ends after
    the device has finished the block's work."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.device(device).type == "cuda"
    with profile(activities=activities(device)) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


@dataclass
class SweepTimer:
    """Wall-clock segments -> sweeps/sec summary (JSONL-appendable)."""

    segments: List[dict] = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.time()

    def stop(self, n_sweeps: int, label: str = "segment"):
        dt = time.time() - self._t0
        self.segments.append({
            "label": label, "sweeps": n_sweeps, "seconds": dt,
            "sweeps_per_s": n_sweeps / dt if dt > 0 else None,
        })

    def summary(self) -> dict:
        total_sweeps = sum(s["sweeps"] for s in self.segments)
        total_time = sum(s["seconds"] for s in self.segments)
        return {
            "total_sweeps": total_sweeps,
            "total_seconds": total_time,
            "sweeps_per_s": total_sweeps / total_time if total_time else None,
            "segments": self.segments,
        }

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
