"""The pipeline's own wall around fit_grid (its runs' files written), mean over the bins."""
from benchmark import readers


def read(w):
    return readers.span_mean(w, "grid_wall_s")
