"""The resident sweep's front half in one kernel: tau sweep, strain-pair swap
with its post-swap loglik, and the gamma proposal's loglik.

``fused_sweep`` runs ``csrc/fused_sweep.cu`` on CUDA tensors and the plain
version ``fused_sweep_reference`` on CPU tensors; on any other device it
raises. The plain version is the staged chain the kernel is bitwise equal
to on the card, tau_sweep -> swap(emit_ll) -> gamma_ll(with_old=False), not
a second copy of the math.
"""
from __future__ import annotations

import torch

from ..utils import NBASES
from ._build import (
    check, load_library, partial_scratch, ptr, require, slot_scratch, stream_of,
)
from .gamma_kernel import gamma_ll_reference
from .swap_kernel import swap_reference
from .tau_kernel import resident_grid, tau_sweep_reference


def _check(n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop):
    dev = n.device
    require("n", n, torch.float32, (-1, -1, NBASES), dev)
    V, S, _ = n.shape
    require("tau", tau, torch.int32, (V, -1), dev)
    G = tau.shape[1]
    require("mix", mix, torch.float32, (V, S, NBASES), dev)
    require("gamma", gamma, torch.float32, (S, G), dev)
    require("eta", eta, torch.float32, (NBASES, NBASES), dev)
    require("gz", gz, torch.float32, (V, G, NBASES), dev)
    require("g", g, torch.int32, (), dev)
    require("h", h, torch.int32, (), dev)
    require("logu", logu, torch.float32, (V,), dev)
    require("gamma_prop", gamma_prop, torch.float32, (S, G), dev)
    return V, S, G


def launch(lib, n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop, tau_out,
           mix_out, partial, ll, max_blocks=0):
    """Launch the fused kernel and its reduction on checked CUDA tensors
    into preallocated outputs and scratch; max_blocks > 0 caps the
    persistent grid (the result does not depend on it). Raises on a launch
    error."""
    V, S, _ = n.shape
    G = tau.shape[1]
    plan, grid = resident_grid("fused_sweep", V, S, G, n.device.index, max_blocks)
    slots = slot_scratch(grid, S, n.device)
    with torch.cuda.device(n.device):
        err = lib.desman_fused_sweep(
            n.data_ptr(), tau.data_ptr(), mix.data_ptr(), gamma.data_ptr(),
            eta.data_ptr(), gz.data_ptr(), g.data_ptr(), h.data_ptr(),
            logu.data_ptr(), gamma_prop.data_ptr(), tau_out.data_ptr(),
            mix_out.data_ptr(), partial.data_ptr(), ptr(slots), ll.data_ptr(), V,
            S, G, plan.buffers, plan.smem_bytes, grid, stream_of(n))
    check(lib, err, "fused_sweep")


def fused_sweep(n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop):
    """(tau [V,G] i32, mix [V,S,4], ll [2,S]): the tau sweep with noise gz,
    the swap of (g, h) against logu, and ll = [post-swap per-sample loglik
    (the gamma MH's ll_old), gamma_prop's per-sample loglik (ll_new)] on
    the post-swap tau. Inputs are not modified.
    """
    V, S, G = _check(n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop)
    if n.device.type == "cpu":
        return fused_sweep_reference(n, tau, mix, gamma, eta, gz, g, h, logu,
                                     gamma_prop)
    if n.device.type != "cuda":
        raise ValueError(f"fused_sweep: no kernel for device {n.device}")
    lib = load_library()
    tau_out = torch.empty_like(tau)
    mix_out = torch.empty_like(mix)
    ll = torch.empty((2, S), dtype=torch.float32, device=n.device)
    partial = partial_scratch(lib, V, 2, S, n.device)
    launch(lib, n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop, tau_out,
           mix_out, partial, ll)
    fused_sweep.launches += 1
    return tau_out, mix_out, ll


fused_sweep.launches = 0


def fused_sweep_reference(n, tau, mix, gamma, eta, gz, g, h, logu,
                          gamma_prop):
    """The staged chain of plain versions the fused kernel replaces."""
    tau, mix = tau_sweep_reference(n, tau, mix, gamma, eta, gz)
    tau, mix, ll_old = swap_reference(n, tau, mix, gamma, eta, g, h, logu,
                                      emit_ll=True)
    ll = gamma_ll_reference(n, mix, tau, gamma_prop, eta, with_old=False)
    return tau, mix, torch.stack([ll_old, ll[1]])
