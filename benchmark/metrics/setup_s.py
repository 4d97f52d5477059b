"""Seconds from the process's start to the window's: imports, inputs, warm-up."""


def read(w):
    return w.setup_s
