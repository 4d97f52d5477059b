"""Seconds a genome bin in writing the filter's files (the selected
positions' counts CSV and the eta, p and q tables): the program's
pipeline.write_filter spans over the bins."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "pipeline.write_filter", w.items)
