"""Not an entry: the program's own spans of a finished window, for the
span metrics (``metrics/read_s.bin.py`` and the others that import this).
They are taken once from ``desman_tpu_torch.profiling.take_spans`` and kept
on the window as ``w.spans["program"]``. A program without spans gives
None, and the harness leaves the metrics that read them out of the line.
"""
from __future__ import annotations


def of(w):
    """The program's spans recorded in window `w` (a list), or None."""
    if "program" not in w.spans:
        try:
            from desman_tpu_torch.profiling import take_spans
        except ImportError:     # a program that records no spans
            w.spans["program"] = None
        else:
            w.spans["program"] = take_spans()
    return w.spans["program"]
