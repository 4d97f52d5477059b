"""Seconds a genome bin in its grid runs' host float64 star log-likelihoods
(40 runs, inside write_outputs): the program's write_outputs.star_ll spans
over the bins."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_item_s(program_spans.of(w), "write_outputs.star_ll", w.items)
