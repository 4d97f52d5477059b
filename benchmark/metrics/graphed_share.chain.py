"""The share of the chains' sweeps replayed from CUDA graphs: the program's
chains.sweeps spans' ``graphed`` over their ``sweeps``. None where no span
says how many sweeps it replayed (a program without graphs)."""
from benchmark.entries import program_spans


def read(w):
    named = [s for s in program_spans.of(w) or () if s.name == "chains.sweeps"]
    sweeps = sum(s.attrs.get("sweeps", 0) for s in named)
    if not sweeps or not any("graphed" in s.attrs for s in named):
        return None
    return sum(s.attrs.get("graphed", 0) for s in named) / sweeps
