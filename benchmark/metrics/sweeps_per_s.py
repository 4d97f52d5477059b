"""Chain-sweeps a second: every sweep of the finished chains over the window."""
from benchmark import readers


def read(w):
    return readers.sweeps_per_s(w)
