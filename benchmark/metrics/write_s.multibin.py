"""Seconds a multibin run in its bins' output files (one directory a bin):
the program's write_outputs spans over the runs."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "write_outputs", w.items)
