"""The program's entries that a cell's closed loop drives, one module an
entry, found by the name a workload's ``entry`` gives:
``benchmark/entries/<entry>.py`` holds the class ``Entry``. Adding an entry
is adding a file.

An ``Entry(wl, config, seed, device)`` draws its inputs from the seed
(``gen``) and has:

- ``shape``, ``observed``: (V, S, G) and the counts above 0 of a chain's
  sweep, for its least time (``peaks``); () and 0 where no one sweep shape;
- ``warm()``: the shapes of its cell and no others;
- ``item(k) -> sweeps``: item k of the closed loop;
- ``spans() -> dict``: the program's own walls of the finished items;
- ``free()``, ``close()``: the program's state, then the inputs, let go;
- ``judge() -> dict``: the numbers that decide ``correct`` (``judge``);
- ``control(prec, items) -> dict``: the same numbers with the plain
  reference in ``prec`` in the program's place (``control.py``).

These modules are the only ones that import the program.
"""
import importlib


def entry(name: str):
    """The Entry class of benchmark/entries/<name>.py."""
    return importlib.import_module(f"{__name__}.{name}").Entry
