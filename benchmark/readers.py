"""What the metric readers of ``metrics/`` share: each reads a finished
``run.Window`` and returns a number, or None where its run has nothing to
read (no trace, no device event, no span), and the harness then leaves
the metric out of the line."""
from __future__ import annotations

from statistics import mean

from . import peaks


def per_item_s(w):
    """Window seconds over the items finished."""
    return w.seconds / w.items if w.items else None


def sweeps_per_s(w):
    return w.sweeps / w.seconds if w.sweeps and w.seconds > 0 else None


def span_mean(w, key: str):
    values = w.spans.get(key) or []
    return mean(values) if values else None


def _busy(w):
    if w.trace is None:
        return None
    busy = w.trace.busy_s()
    return busy if busy > 0 else None


def idle_share(w):
    busy = _busy(w)
    return None if busy is None else 1.0 - busy / w.trace.window_s


def busy_per_item_s(w):
    """The device's busy seconds over the items finished."""
    busy = _busy(w)
    return None if busy is None or not w.items else busy / w.items


def events_per_sweep(w):
    if _busy(w) is None or not w.sweeps:
        return None
    return w.trace.events / w.sweeps


def busy_ms_per_sweep(w):
    busy = _busy(w)
    return None if busy is None or not w.sweeps else busy * 1e3 / w.sweeps


def _least_s(w):
    """The least seconds all the window's sweeps need (``peaks``)."""
    if not w.shape or not w.sweeps:
        return None
    return peaks.sweep_least_s(*w.shape, w.observed) * w.sweeps


def roofline_pct(w):
    """The sweeps' least time over the device's busy time, in percent."""
    busy, least = _busy(w), _least_s(w)
    return None if busy is None or least is None else 100.0 * least / busy
