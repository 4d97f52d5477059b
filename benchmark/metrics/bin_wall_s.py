"""Wall seconds a genome bin: the window over the bins it finished."""
from benchmark import readers


def read(w):
    return readers.per_item_s(w)
