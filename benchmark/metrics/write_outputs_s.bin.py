"""Seconds a genome bin in its grid runs' output files (40 runs): the program's
write_outputs spans over the bins."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "write_outputs", w.items)
