"""Device operations (kernels, copies, sets) of the traced chains over their sweeps."""
from benchmark import readers


def read(w):
    return readers.events_per_sweep(w)
