"""Seconds a multibin run in reading the bins' counts CSVs and checking
their samples: the program's multibin.read_counts spans over the runs."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "multibin.read_counts", w.items)
