"""desman_tpu_torch — the PyTorch/CUDA port of desman_tpu for NVIDIA Hopper.

Strain deconvolution with DESMAN's tau/gamma/eta Gibbs sampler, in eager
PyTorch with hand-written CUDA kernels for the tau sweep and the swap move.
The JAX package ``desman_tpu`` beside it is the reference it is tested
against; this package imports neither jax nor pandas.
"""

from .io import CountsData, read_counts_csv
from .sampler import (
    SamplerConfig, SamplerResult, run_chain, run_chain_pt, run_chains,
)

__version__ = "0.1.0"

__all__ = [
    "CountsData",
    "read_counts_csv",
    "SamplerConfig",
    "SamplerResult",
    "run_chain",
    "run_chain_pt",
    "run_chains",
]
