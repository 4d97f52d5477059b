"""Seconds a genome bin in the counts CSV read: the program's
pipeline.read_counts spans over the bins."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "pipeline.read_counts", w.items)
