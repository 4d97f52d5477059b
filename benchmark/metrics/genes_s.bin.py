"""The pipeline's own wall of the GeneAssign stage, mean over the bins."""
from benchmark import readers


def read(w):
    return readers.span_mean(w, "genes_wall_s")
