"""The device trace of a traced run: torch.profiler's CUDA activity (kernels,
copies, sets) over whole items, reduced to what the per-layer metrics and
the result's ``breakdown`` read.

Only CUDA activity is recorded: recording every host operator as well
would slow the host-bound sweep it measures. An idle gap is therefore named
by the device operation that ends it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

TOP = 10


@dataclass
class DeviceTrace:
    intervals: list                  # [(start_s, end_s, name)] sorted by start
    window_s: float                  # host seconds of the traced window
    by_name: dict = field(default_factory=dict)

    @property
    def events(self) -> int:
        return len(self.intervals)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the events' intervals."""
        busy, end = 0.0, float("-inf")
        for s, e, _ in self.intervals:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def idle_gaps(self, k: int = TOP) -> list:
        """The k longest gaps between the union's segments, each named by
        the operation that ends it: [[name, seconds], ...]."""
        gaps, end = [], None
        for s, e, name in self.intervals:
            if end is not None and s > end:
                gaps.append((s - end, name))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: -g[0])
        return [[f"before {name[:80]}", sec] for sec, name in gaps[:k]]

    def device_ops(self, k: int = TOP) -> list:
        """The k operations that took most device time: [[name, seconds]]."""
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], sec] for name, sec in top]


def _times(ev):
    """(start_s, duration_s) of a profiler event, by whichever clock
    accessor this torch offers."""
    if hasattr(ev, "start_ns"):
        return ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
    return ev.start_us() * 1e-6, ev.duration_us() * 1e-6


def from_profiler(prof, window_s: float) -> DeviceTrace:
    """The device events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    intervals, by_name = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start, dur = _times(ev)
        name = ev.name()
        intervals.append((start, start + dur, name))
        by_name[name] = by_name.get(name, 0.0) + dur
    intervals.sort()
    return DeviceTrace(intervals=intervals, window_s=window_s, by_name=by_name)


def profiler(device):
    """A profiler of the card's activity alone (of the host's on a CPU
    device, where no event is the card's: the tests' small runs)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                               else ProfilerActivity.CPU])
