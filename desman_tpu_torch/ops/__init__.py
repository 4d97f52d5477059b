"""Hand-written CUDA kernels of the sampler's hot path, with their plain
PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version for CPU tensors; it keeps a ``launches`` count of kernel launches.
"""
from .swap_kernel import draw_swap_proposal, swap, swap_reference
from .tau_kernel import draw_gumbel, tau_sweep, tau_sweep_reference


def resolve(kernel: str):
    """Kernel choice -> (tau sweep fn, swap fn).

    ``cuda``: the kernel wrappers (their plain versions on CPU tensors).
    ``torch``: the plain versions on every device.
    """
    if kernel == "cuda":
        return tau_sweep, swap
    if kernel == "torch":
        return tau_sweep_reference, swap_reference
    raise ValueError(f"unknown kernel {kernel!r}; one of 'cuda', 'torch'")


def reset_launches() -> None:
    tau_sweep.launches = 0
    swap.launches = 0


__all__ = [
    "draw_gumbel", "draw_swap_proposal", "reset_launches",
    "resolve", "swap", "swap_reference", "tau_sweep", "tau_sweep_reference",
]
