"""The resident sweep's front half in one kernel: tau sweep, strain-pair swap
with its post-swap loglik, and the gamma proposal's loglik.

``fused_sweep`` runs ``csrc/fused_sweep.cu`` on CUDA tensors and the plain
version ``fused_sweep_reference`` on CPU tensors; on any other device it
raises. The plain version is the staged chain the kernel is bitwise equal
to on the card, tau_sweep -> swap(emit_ll) -> gamma_ll(with_old=False), not
a second copy of the math. Both take a leading chain axis: C chains in one
launch (the JAX package's vmap over chains), chain c bitwise its own call.
"""
from __future__ import annotations

import torch

from ..utils import NBASES
from ._build import (
    chains_of, check, load_library, partial_scratch, per_chain, ptr, require,
    require_counts, slot_scratch, stream_of,
)
from .gamma_kernel import gamma_ll_reference
from .swap_kernel import swap_reference
from .tau_kernel import resident_grid, tau_sweep_reference


def _check(n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop):
    """(V, S, G, C, the counts' chain stride): C None for one chain."""
    dev = n.device
    C = chains_of(tau)
    lead = () if C is None else (C,)
    V, S, stride = require_counts("n", n, torch.float32, NBASES, C, dev)
    require("tau", tau, torch.int32, (*lead, V, -1), dev)
    G = tau.shape[-1]
    require("mix", mix, torch.float32, (*lead, V, S, NBASES), dev)
    require("gamma", gamma, torch.float32, (*lead, S, G), dev)
    require("eta", eta, torch.float32, (*lead, NBASES, NBASES), dev)
    require("gz", gz, torch.float32, (*lead, V, G, NBASES), dev)
    require("g", g, torch.int32, lead, dev)
    require("h", h, torch.int32, lead, dev)
    require("logu", logu, torch.float32, (*lead, V), dev)
    require("gamma_prop", gamma_prop, torch.float32, (*lead, S, G), dev)
    return V, S, G, C, stride


def launch(lib, n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop, tau_out,
           mix_out, partial, ll, max_blocks=0):
    """Launch the fused kernel and its reduction on checked CUDA tensors
    (one chain, or a leading chain axis) into preallocated outputs and
    scratch; max_blocks > 0 caps the persistent grid's blocks a chain (the
    result does not depend on it). Raises on a launch error."""
    chains = chains_of(tau) or 1
    V, G = tau.shape[-2:]
    S = mix.shape[-2]
    stride = V * S if n.dim() == 4 else 0
    plan, grid = resident_grid("fused_sweep", V, S, G, n.device.index, max_blocks,
                               chains)
    slots = slot_scratch(grid * chains, S, n.device)
    with torch.cuda.device(n.device):
        err = lib.desman_fused_sweep(
            n.data_ptr(), tau.data_ptr(), mix.data_ptr(), gamma.data_ptr(),
            eta.data_ptr(), gz.data_ptr(), g.data_ptr(), h.data_ptr(),
            logu.data_ptr(), gamma_prop.data_ptr(), tau_out.data_ptr(),
            mix_out.data_ptr(), partial.data_ptr(), ptr(slots), ll.data_ptr(), V,
            S, G, plan.buffers, plan.smem_bytes, grid, chains, stride, stream_of(n))
    check(lib, err, "fused_sweep")


def fused_sweep(n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop):
    """(tau [V,G] i32, mix [V,S,4], ll [2,S]): the tau sweep with noise gz,
    the swap of (g, h) against logu, and ll = [post-swap per-sample loglik
    (the gamma MH's ll_old), gamma_prop's per-sample loglik (ll_new)] on
    the post-swap tau. Inputs are not modified.

    Chains: tau [C,V,G], mix [C,V,S,4], gamma and gamma_prop [C,S,G], eta
    [C,4,4], gz [C,V,G,4], g and h [C] and logu [C,V] sweep C chains in one
    launch (ll [C,2,S]), on counts n shared by the chains ([V,S,4]) or their
    own ([C,V,S,4]). ``launches`` counts the launches and
    ``chain_launches`` the chains they swept.
    """
    V, S, G, C, _ = _check(n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop)
    if n.device.type == "cpu":
        return fused_sweep_reference(n, tau, mix, gamma, eta, gz, g, h, logu,
                                     gamma_prop)
    if n.device.type != "cuda":
        raise ValueError(f"fused_sweep: no kernel for device {n.device}")
    lib = load_library()
    lead = () if C is None else (C,)
    tau_out = torch.empty_like(tau)
    mix_out = torch.empty_like(mix)
    ll = torch.empty((*lead, 2, S), dtype=torch.float32, device=n.device)
    partial = partial_scratch(lib, V, 2, S, n.device, C or 1)
    launch(lib, n, tau, mix, gamma, eta, gz, g, h, logu, gamma_prop, tau_out,
           mix_out, partial, ll)
    fused_sweep.launches += 1
    fused_sweep.chain_launches += C or 1
    return tau_out, mix_out, ll


fused_sweep.launches = 0
fused_sweep.chain_launches = 0


def fused_sweep_reference(n, tau, mix, gamma, eta, gz, g, h, logu,
                          gamma_prop):
    """The staged chain of plain versions the fused kernel replaces. Over a
    chain axis, each chain in turn."""
    if tau.dim() == 3:
        return per_chain(fused_sweep_reference, (n,), tau, mix, gamma, eta, gz, g, h,
                         logu, gamma_prop)
    tau, mix = tau_sweep_reference(n, tau, mix, gamma, eta, gz)
    tau, mix, ll_old = swap_reference(n, tau, mix, gamma, eta, g, h, logu,
                                      emit_ll=True)
    ll = gamma_ll_reference(n, mix, tau, gamma_prop, eta, with_old=False)
    return tau, mix, torch.stack([ll_old, ll[1]])
