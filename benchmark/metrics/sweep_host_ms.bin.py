"""Host milliseconds a grid sweep (all of a G's seeds): the program's
chains.sweeps spans over their sweeps."""
from benchmark import spans
from benchmark.entries import program_spans


def read(w):
    return spans.per_unit_ms(program_spans.of(w), "chains.sweeps", "sweeps")
