"""Device seconds a genome bin: the union of the card's busy intervals over
the window, over the bins it finished."""
from benchmark import readers


def read(w):
    return readers.busy_per_item_s(w)
