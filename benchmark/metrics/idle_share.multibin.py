"""1 - the device's busy time over the traced window's wall."""
from benchmark import readers


def read(w):
    return readers.idle_share(w)
