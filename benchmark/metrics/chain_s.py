"""Wall seconds a chain: the window over the chains it finished."""
from benchmark import readers


def read(w):
    return readers.per_item_s(w)
