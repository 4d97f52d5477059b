"""Seconds a genome bin in the variant filter: the program's pipeline.filter
spans over the bins."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "pipeline.filter", w.items)
