"""Profiling hooks (counterpart of ``desman_tpu.profiling``).

``device_trace`` captures a ``torch.profiler`` trace of a run (``desman
--profile DIR``, ``RunConfig.profile_dir``) as a Chrome trace,
``DIR/trace.json``, viewable in Perfetto or chrome://tracing, with the
program's spans on a track of their own. ``activities`` is the profiler's
activity set, shared with ``profile_sweep``.

``span`` marks a stage of the program (the pipeline's, the grid's, a
chain's). It always times its block; while a torch profiler is active it
also records it: its name, start and end on the profiler's clock (Unix-epoch
nanoseconds, as kineto's ``start_ns()``) and its attributes. ``take_spans``
hands the recorded spans over and forgets them. A span never waits for the
device, and what the program computes and writes does not depend on it.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"
SPAN_TRACK = "desman spans"   # the spans' track: thread 0 of this process


class Span(NamedTuple):
    """One recorded span."""

    name: str
    start_ns: int
    end_ns: int
    attrs: dict


_recorded: list = []     # finished spans, in the order they ended


class span:
    """``with span(name, **attrs) as s:`` times the block (``s.seconds``
    afterwards) and records it while a torch profiler is active (the check
    ``record_function`` makes). Not a ``record_function``: that would put
    ranges on the device timeline. Attributes known only inside the block
    go into ``s.attrs``."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "_recording")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "span":
        self._recording = _autograd_profiler._is_profiler_enabled
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        if self._recording:
            _recorded.append(Span(self.name, self.start_ns, self.end_ns, self.attrs))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def take_spans() -> list:
    """The spans recorded since the last call, in the order they ended."""
    spans = list(_recorded)
    _recorded.clear()
    return spans


def activities(device) -> list:
    """CPU activity, plus the card's kernels when `device` is CUDA."""
    if torch.device(device).type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str], device="cpu"):
    """Trace the block with torch.profiler into trace_dir/trace.json
    (a no-op when trace_dir is None), the spans it recorded included. On a
    CUDA device the trace ends after the device has finished the block's
    work."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.device(device).type == "cuda"
    with profile(activities=activities(device)) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _add_spans(path, take_spans())


def _add_spans(path: str, spans: list) -> None:
    """Append `spans` to the Chrome trace at `path` as complete events on a
    track of their own, on the trace's time base (``baseTimeNanoseconds``,
    0 in a trace without one: absolute microseconds)."""
    if not spans:
        return
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), 0
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": SPAN_TRACK}})
    for s in spans:
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": tid,
            "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": s.attrs})
    with open(path, "w") as f:
        json.dump(trace, f)
