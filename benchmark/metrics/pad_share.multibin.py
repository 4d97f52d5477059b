"""The rows the padded bins sweep over the bins' own rows: the program's
multibin spans' ``padded_rows`` over their ``rows``. None where no span
says (a program without the multibin span)."""
from benchmark.entries import program_spans


def read(w):
    named = [s for s in program_spans.of(w) or () if s.name == "multibin"]
    rows = sum(s.attrs.get("rows", 0) for s in named)
    return sum(s.attrs.get("padded_rows", 0) for s in named) / rows if rows else None
