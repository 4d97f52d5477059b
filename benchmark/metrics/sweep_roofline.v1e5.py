"""The sweeps' least time (peaks.sweep_least_s) over the device's busy time, percent."""
from benchmark import readers


def read(w):
    return readers.roofline_pct(w)
