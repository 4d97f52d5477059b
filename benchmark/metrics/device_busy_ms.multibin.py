"""Device-busy milliseconds (the union of the device's events) a sweep of
every bin."""
from benchmark import readers


def read(w):
    return readers.busy_ms_per_sweep(w)
