"""Hand-written CUDA kernels of the sampler's hot path, with their plain
PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version for CPU tensors; it keeps a ``launches`` count of kernel launches.
Every wrapper takes a leading chain axis (C chains in one launch; the
swap's emit_ll mode takes one chain) and also counts ``chain_launches``,
the chains its launches swept.
"""
from typing import Callable, NamedTuple, Optional

import torch

from .fused_sweep import fused_sweep, fused_sweep_reference
from .gamma_kernel import (
    gamma_apply_eta, gamma_apply_eta_reference, gamma_ll, gamma_ll_reference,
)
from .swap_kernel import draw_swap_proposal, swap, swap_reference
from .tau_kernel import draw_gumbel, tau_sweep, tau_sweep_reference
from .tau_topk import (
    TopkInapplicable, bind_tau_sweep_topk, compress_counts, tau_sweep_topk,
    tau_sweep_topk_reference,
)

KERNELS = ("cuda", "cuda_resident", "cuda_topk", "torch")


class Kernels(NamedTuple):
    """The sweep's [V]-sized steps for one kernel choice."""

    tau_sweep: Callable
    swap: Callable
    gamma_ll: Callable
    gamma_apply_eta: Callable
    fused_sweep: Callable
    resident: bool   # the sweep's front half runs on the resident kernels


_WRAPPERS = (tau_sweep, swap, gamma_ll, gamma_apply_eta, fused_sweep)
_PLAIN = (tau_sweep_reference, swap_reference, gamma_ll_reference,
          gamma_apply_eta_reference, fused_sweep_reference)


def resolve(kernel: str, n: Optional[torch.Tensor] = None) -> Kernels:
    """Kernel choice -> the sweep's steps.

    ``cuda``: the kernel wrappers (their plain versions on CPU tensors),
    with gamma and eta MH as plain PyTorch ops. ``cuda_resident``: the same
    wrappers, with the sweep's front half on the resident kernels (fused
    tau + swap + gamma-MH loglik, then gamma apply + eta loglik).
    ``cuda_topk``: ``cuda`` with the tau sweep on the top-2 kernel, bound
    here to the counts n (the layout is built once; raises
    TopkInapplicable when a cell observes more than two bases).
    ``torch``: the plain versions on every device.
    """
    if kernel == "cuda":
        return Kernels(*_WRAPPERS, resident=False)
    if kernel == "cuda_resident":
        return Kernels(*_WRAPPERS, resident=True)
    if kernel == "cuda_topk":
        if n is None:
            raise ValueError("kernel 'cuda_topk' is bound to the counts: "
                             "resolve it with n")
        return Kernels(bind_tau_sweep_topk(n), *_WRAPPERS[1:], resident=False)
    if kernel == "torch":
        return Kernels(*_PLAIN, resident=False)
    raise ValueError(f"unknown kernel {kernel!r}; one of {', '.join(KERNELS)}")


# the wrappers with a chain axis: every one
CHAIN_AXIS = _WRAPPERS + (tau_sweep_topk,)


def reset_launches() -> None:
    """Set every wrapper's launch count and chain count to 0."""
    for wrapper in CHAIN_AXIS:
        wrapper.launches = 0
        wrapper.chain_launches = 0


__all__ = [
    "CHAIN_AXIS", "KERNELS", "Kernels", "TopkInapplicable", "compress_counts",
    "draw_gumbel", "draw_swap_proposal", "fused_sweep", "fused_sweep_reference",
    "gamma_apply_eta", "gamma_apply_eta_reference", "gamma_ll",
    "gamma_ll_reference", "reset_launches", "resolve", "swap",
    "swap_reference", "tau_sweep", "tau_sweep_reference", "tau_sweep_topk",
    "tau_sweep_topk_reference",
]
