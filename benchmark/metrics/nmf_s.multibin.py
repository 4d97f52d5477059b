"""Seconds a multibin run in its bins' NMF starts (one a bin, in turn): the
program's chains.init spans over the runs."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "chains.init", w.items)
