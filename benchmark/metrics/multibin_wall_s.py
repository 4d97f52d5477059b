"""Wall seconds a multibin run of every bin: the window over the runs it
finished."""
from benchmark import readers


def read(w):
    return readers.per_item_s(w)
