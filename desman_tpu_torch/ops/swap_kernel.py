"""The strain-pair swap move: CUDA kernel wrapper, its plain PyTorch version,
and the move's proposal.

``swap`` runs ``csrc/swap_kernel.cu`` on CUDA tensors and the plain version
``swap_reference`` on CPU tensors; on any other device it raises. The
proposal ``(g, h, logu)`` is drawn outside (``draw_swap_proposal``) and
stays on the device: g and h are 0-d int32 tensors the kernel reads by
pointer, so the sweep never waits for the host to pass them. With
``emit_ll`` both also return the post-swap per-sample loglik, the oracle of
the fused front-half kernel's ll_old row. Without it both take a leading
chain axis: C chains in one launch, each with its own pair, chain c bitwise
its own move.
"""
from __future__ import annotations

import torch

from ..utils import NBASES, one_hot_tau, safe_log
from ._build import (
    chains_of, check, load_library, partial_scratch, per_chain, ptr, require,
    require_counts, slot_scratch, stream_of,
)


def _check(n, tau, mix, gamma, eta, g, h, logu):
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
    require("g", g, torch.int32, lead, dev)
    require("h", h, torch.int32, lead, dev)
    require("logu", logu, torch.float32, (*lead, V), dev)
    return V, S, G, C, stride


def swap(n, tau, mix, gamma, eta, g, h, logu, emit_ll=False):
    """Per-position swap MH of strains g and h: (tau [V,G] i32, mix [V,S,4]),
    and with emit_ll also ll [S], the post-swap per-sample loglik.

    g, h: 0-d int32 tensors in [0, G); logu: [V] log-uniform thresholds
    (already divided by any tempering beta). A position accepts where
    logu < dll; g == h never accepts. Inputs are not modified.

    Chains (without emit_ll): tau [C,V,G], mix [C,V,S,4], gamma [C,S,G],
    eta [C,4,4], g and h [C] and logu [C,V] move C chains in one launch, on
    counts n shared by the chains ([V,S,4]) or their own ([C,V,S,4]); chain
    c's outputs are bitwise its move alone. ``launches`` counts the
    launches and ``chain_launches`` the chains they moved.
    """
    V, S, G, C, stride = _check(n, tau, mix, gamma, eta, g, h, logu)
    if C is not None and emit_ll:
        raise ValueError("swap: emit_ll takes one chain")
    if n.device.type == "cpu":
        return swap_reference(n, tau, mix, gamma, eta, g, h, logu, emit_ll)
    if n.device.type != "cuda":
        raise ValueError(f"swap: no kernel for device {n.device}")
    lib = load_library()
    tau_out = torch.empty_like(tau)
    mix_out = torch.empty_like(mix)
    ll = torch.empty(S, dtype=torch.float32, device=n.device) if emit_ll else None
    partial = partial_scratch(lib, V, 1, S, n.device) if emit_ll else None
    slots = slot_scratch(partial.shape[0], S, n.device) if emit_ll else None
    with torch.cuda.device(n.device):
        err = lib.desman_swap(
            n.data_ptr(), tau.data_ptr(), mix.data_ptr(), gamma.data_ptr(),
            eta.data_ptr(), g.data_ptr(), h.data_ptr(), logu.data_ptr(),
            tau_out.data_ptr(), mix_out.data_ptr(), ptr(partial), ptr(slots),
            ptr(ll), V, S, G, C or 1, stride, stream_of(n))
    check(lib, err, "swap")
    swap.launches += 1
    swap.chain_launches += C or 1
    return (tau_out, mix_out, ll) if emit_ll else (tau_out, mix_out)


swap.launches = 0
swap.chain_launches = 0


def swap_reference(n, tau, mix, gamma, eta, g, h, logu, emit_ll=False):
    """Plain PyTorch swap move (the JAX package's ``tau_swap_move`` with the
    proposal pre-drawn). The proposal is rank-1 in the mixture, so the MH
    log-ratio is one pass of sum n * (log p' - log p). emit_ll: also the
    post-swap per-sample loglik from those logs, sum over (v, b) of
    n*log p + accept * n*(log p' - log p) (swap_pallas's emit_ll). Over a
    chain axis (without emit_ll), each chain in turn."""
    if tau.dim() == 3:
        if emit_ll:
            raise ValueError("swap: emit_ll takes one chain")
        return per_chain(swap_reference, (n,), tau, mix, gamma, eta, g, h, logu)
    V, G = tau.shape
    gi = g.long().reshape(1)
    hi = h.long().reshape(1)
    tau_g = tau.index_select(1, gi)[:, 0]
    tau_h = tau.index_select(1, hi)[:, 0]
    dgam = gamma.index_select(1, gi)[:, 0] - gamma.index_select(1, hi)[:, 0]
    doh = one_hot_tau(tau_h) - one_hot_tau(tau_g)                 # [V,4]
    w = doh @ eta                                                 # [V,4]
    p = torch.einsum("vsa,ab->vsb", mix, eta)
    p_prop = p + dgam[None, :, None] * w[:, None, :]
    logp = safe_log(p)
    term = n * (safe_log(p_prop) - logp)
    dll = torch.sum(term, dim=(1, 2))
    accept = (logu < dll) & (g != h)                              # [V]
    acc_f = accept.to(mix.dtype)

    cols = torch.arange(G, device=tau.device)[None, :]
    swapped = torch.where(cols == g, tau_h[:, None],
                          torch.where(cols == h, tau_g[:, None], tau))
    tau = torch.where(accept[:, None], swapped, tau)
    mix = mix + acc_f[:, None, None] * (dgam[None, :, None] * doh[:, None, :])
    if not emit_ll:
        return tau, mix
    t_fin = n * logp + acc_f[:, None, None] * term
    return tau, mix, torch.sum(t_fin, dim=(0, 2))


def draw_swap_proposal(generator: torch.Generator, V: int, G: int):
    """(g, h, logu [V]) on the generator's device: a uniformly random
    unordered pair g != h and per-position log-uniform thresholds.

    G == 1 has no pair to swap: g == h and +inf thresholds never accept.
    """
    dev = generator.device
    if G < 2:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return zero, zero.clone(), torch.full((V,), float("inf"), device=dev)
    g = torch.randint(0, G, (), generator=generator, device=dev,
                      dtype=torch.int32)
    off = torch.randint(1, G, (), generator=generator, device=dev,
                        dtype=torch.int32)
    h = (g + off) % G
    logu = safe_log(torch.rand((V,), generator=generator, device=dev))
    return g, h, logu
