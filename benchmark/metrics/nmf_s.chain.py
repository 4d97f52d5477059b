"""Seconds a chain in its NMF start: the program's chains.init spans over the
chains."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "chains.init", w.items)
