"""The arithmetic of the program's spans, on the reference's side: it
imports nothing of the program. A span is a record with ``name``,
``start_ns`` and ``end_ns`` (Unix-epoch nanoseconds: the device trace's
clock) and ``attrs``, as ``desman_tpu_torch.profiling.take_spans`` hands
them over.
"""
from __future__ import annotations


def seconds(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-9


def per_item_s(spans, name: str, items: int):
    """Seconds of the spans named `name` over the window's items; None
    where there are no such spans."""
    named = [seconds(s) for s in spans or () if s.name == name]
    return sum(named) / items if named and items else None


def per_unit_ms(spans, name: str, unit: str):
    """Milliseconds of the spans named `name` over the sum of their
    attribute `unit` (a sweep's host milliseconds: ``chains.sweeps`` over
    its ``sweeps``); None where there are none."""
    named = [s for s in spans or () if s.name == name]
    units = sum(s.attrs.get(unit, 0) for s in named)
    return sum(seconds(s) for s in named) * 1e3 / units if units else None
