"""Seconds a genome bin in its chains' NMF starts (one a G for all seeds): the
program's chains.init spans over the bins."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "chains.init", w.items)
