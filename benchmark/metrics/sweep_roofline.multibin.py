"""The least time of the sweeps' work on the bins' own rows
(peaks.sweep_least_s; padded rows count nothing) over the device's busy
time, percent."""
from benchmark import readers


def read(w):
    return readers.roofline_pct(w)
