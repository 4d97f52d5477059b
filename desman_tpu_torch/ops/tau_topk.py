"""The top-2 tau Gibbs sweep: CUDA kernel wrapper, its plain PyTorch version,
and the counts layout it runs on (counterpart of ``desman_tpu.ops.tau_topk``).

The tau conditional ``cand[v,c] = sum_{s,b} n[v,s,b] * log(q[v,s,b] +
gamma[s,g] * eta[c,b])`` gets nothing from a base a cell did not observe
(n = 0), so on counts where every (position, sample) cell observes at most
two bases the sweep needs the logs at those two bases only: half the logs of
``ops.tau_sweep``. ``compress_counts`` builds the static per-cell selection
once per counts tensor, and refuses counts with a cell of three or more
observed bases; the kernel choice ``cuda_topk`` then does not run.

``tau_sweep_topk`` runs ``csrc/tau_topk.cu`` on CUDA tensors and the plain
version ``tau_sweep_topk_reference`` on CPU tensors; on any other device it
raises. On counts it accepts, the kernel is bitwise equal to ``tau_sweep``'s
kernel on the same inputs (see the source's header), and the plain version
agrees with ``tau_sweep_reference`` up to f32 summation order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import NBASES, one_hot_tau, safe_log
from ._build import (
    chains_of, check, load_library, per_chain, require, require_counts, stream_of,
)
from .tau_kernel import resident_grid

K_SLOTS = 2


class TopkInapplicable(ValueError):
    """Counts with a cell of more than two observed bases."""


def compress_counts(counts: np.ndarray):
    """Static top-2 layout: (n_val [V, 2S] f32, b_idx [V, 2S] int32), the
    JAX package's arrays.

    Slot-major lanes (lane = k*S + s), slots in descending count order
    (stable, so ties keep base order). Raises TopkInapplicable, a
    ValueError, when any cell observes more than two bases: the compressed
    evaluation would drop real counts. Cells with fewer than two observed
    bases pad with (n_val=0, b_idx=0), which adds an exact zero.
    """
    n = np.asarray(counts)
    V, S, B = n.shape
    if B != NBASES:
        raise ValueError(f"counts: expected [V, S, {NBASES}], got {n.shape}")
    nnz = (n > 0).sum(axis=2)
    if int(nnz.max(initial=0)) > K_SLOTS:
        frac = float((nnz > K_SLOTS).mean())
        raise TopkInapplicable(
            f"counts have {frac:.1%} of cells with >{K_SLOTS} observed "
            "bases; the top-2 compressed kernel is exact only on <=2-base "
            "cells — use the full kernel"
        )
    order = np.argsort(-n, axis=2, kind="stable")[:, :, :K_SLOTS]  # [V,S,2]
    vals = np.take_along_axis(n, order, axis=2).astype(np.float32)
    idx = np.where(vals > 0, order, 0).astype(np.int32)
    n_val = np.transpose(vals, (0, 2, 1)).reshape(V, K_SLOTS * S)
    b_idx = np.transpose(idx, (0, 2, 1)).reshape(V, K_SLOTS * S)
    return n_val, b_idx


class TopkLayout(NamedTuple):
    """The kernel's layout of the top-2 counts, built once per counts
    tensor: one (count, base) pair per slot of each cell, the two slots in
    ascending base order (the order the kernel adds them in)."""

    n_val: torch.Tensor   # f32 [V,S,2]
    b_idx: torch.Tensor   # int32 [V,S,2]


def topk_layout(counts: np.ndarray, device) -> TopkLayout:
    """compress_counts, then the kernel's layout on `device`."""
    from ..convert import topk_layout_from_numpy

    return topk_layout_from_numpy(*compress_counts(counts), device=device)


def _check(n_val, b_idx, tau, mix, gamma, eta, gz):
    """(V, S, G, C, the layout's chain stride): C None for one chain."""
    dev = n_val.device
    C = chains_of(tau)
    lead = () if C is None else (C,)
    V, S, stride = require_counts("n_val", n_val, torch.float32, K_SLOTS, C, dev)
    require("b_idx", b_idx, torch.int32, n_val.shape, dev)
    require("tau", tau, torch.int32, (*lead, V, -1), dev)
    G = tau.shape[-1]
    require("mix", mix, torch.float32, (*lead, V, S, NBASES), dev)
    require("gamma", gamma, torch.float32, (*lead, S, G), dev)
    require("eta", eta, torch.float32, (*lead, NBASES, NBASES), dev)
    require("gz", gz, torch.float32, (*lead, V, G, NBASES), dev)
    if stride % 2:
        raise ValueError("n_val: a chain's layout of odd V*S cells would not start "
                         "on 16 bytes for the kernel")
    return V, S, G, C, stride


def launch(lib, n_val, b_idx, tau, mix, gamma, eta, gz, tau_out, mix_out,
           max_blocks=0):
    """Launch the top-2 kernel on checked CUDA tensors (one chain, or a
    leading chain axis) into preallocated outputs; max_blocks > 0 caps the
    persistent grid's blocks a chain (the result does not depend on it).
    Raises on a launch error."""
    chains = chains_of(tau) or 1
    V, G = tau.shape[-2:]
    S = mix.shape[-2]
    stride = V * S if n_val.dim() == 4 else 0
    plan, grid = resident_grid("tau_sweep_topk", V, S, G, n_val.device.index,
                               max_blocks, chains)
    with torch.cuda.device(n_val.device):
        err = lib.desman_tau_sweep_topk(
            n_val.data_ptr(), b_idx.data_ptr(), tau.data_ptr(), mix.data_ptr(),
            gamma.data_ptr(), eta.data_ptr(), gz.data_ptr(), tau_out.data_ptr(),
            mix_out.data_ptr(), V, S, G, plan.buffers, plan.smem_bytes, grid,
            chains, stride, stream_of(n_val))
    check(lib, err, "tau_sweep_topk")


def tau_sweep_topk(n_val, b_idx, tau, mix, gamma, eta, gz):
    """One full Gibbs sweep over strains on the top-2 layout: (tau [V,G]
    i32, mix [V,S,4]).

    n_val, b_idx: a TopkLayout's tensors; the rest as ``ops.tau_sweep``
    (gz: [V,G,4] Gumbel noise already multiplied by the temperature). All
    contiguous, on one device. Inputs are not modified.

    Chains: with a leading [C] axis on tau, mix, gamma, eta and gz, as
    ``ops.tau_sweep``; the layout is shared by the chains ([V,S,2]) or
    theirs ([C,V,S,2]). ``launches`` counts the launches and
    ``chain_launches`` the chains they swept.
    """
    V, S, G, C, _ = _check(n_val, b_idx, tau, mix, gamma, eta, gz)
    if n_val.device.type == "cpu":
        return tau_sweep_topk_reference(n_val, b_idx, tau, mix, gamma, eta, gz)
    if n_val.device.type != "cuda":
        raise ValueError(f"tau_sweep_topk: no kernel for device {n_val.device}")
    tau_out = torch.empty_like(tau)
    mix_out = torch.empty_like(mix)
    launch(load_library(), n_val, b_idx, tau, mix, gamma, eta, gz, tau_out, mix_out)
    tau_sweep_topk.launches += 1
    tau_sweep_topk.chain_launches += C or 1
    return tau_out, mix_out


tau_sweep_topk.launches = 0
tau_sweep_topk.chain_launches = 0


def tau_sweep_topk_reference(n_val, b_idx, tau, mix, gamma, eta, gz):
    """Plain PyTorch top-2 sweep (the JAX package's ``tau_topk._kernel``
    with the noise pre-drawn): for each strain g in order, remove it from
    the mixture, gather q at each cell's two selected bases, score the 4
    candidates from 2 logs per cell each, draw by Gumbel-argmax (first
    maximum wins) and put the new base back. Over a chain axis, each chain
    in turn."""
    if tau.dim() == 3:
        return per_chain(tau_sweep_topk_reference, (n_val, b_idx), tau, mix, gamma,
                         eta, gz)
    G = tau.shape[1]
    tau = tau.clone()
    # e_sel[v,s,k,a] = eta[a, b_k(v,s)]: the eta column at each slot's base
    e_sel = eta.t()[b_idx.long()]                                  # [V,S,2,4]
    for g in range(G):
        gam = gamma[:, g]                                          # [S]
        rest = mix - gam[None, :, None] * one_hot_tau(tau[:, g])[:, None, :]
        q = torch.einsum("vsa,vska->vsk", rest, e_sel)             # [V,S,2]
        # cand[v,c] = sum_{s,k} n_val * log(q_k + gamma[s,g] eta[c, b_k])
        terms = safe_log(q[..., None] + gam[None, :, None, None] * e_sel)
        cand = torch.einsum("vsk,vskc->vc", n_val, terms)          # [V,4]
        new = torch.argmax(cand + gz[:, g, :], dim=1)
        mix = rest + gam[None, :, None] * one_hot_tau(new)[:, None, :]
        tau[:, g] = new.to(torch.int32)
    return tau, mix


def bind_tau_sweep_topk(n: torch.Tensor):
    """The top-2 sweep bound to counts n [V,S,4], with ``ops.tau_sweep``'s
    signature (the JAX package's ``make_tau_sweep_topk``). The layout is
    built here, once: raises TopkInapplicable before any sweep when a cell
    observes more than two bases. The bound sweep takes its counts from the
    layout and refuses an ``n`` of another shape or device."""
    layout = topk_layout(n.detach().cpu().numpy(), n.device)
    shape, device = n.shape, n.device
    # the bound sweep takes a chain axis on tau, mix, gamma, eta and gz, as
    # ops.tau_sweep does, with the layout shared by the chains

    def tau_sweep_bound(n, tau, mix, gamma, eta, gz):
        if n.shape != shape or n.device != device:
            raise ValueError(
                f"cuda_topk was bound to counts {tuple(shape)} on {device}, "
                f"called with {tuple(n.shape)} on {n.device}")
        return tau_sweep_topk(layout.n_val, layout.b_idx, tau, mix, gamma,
                              eta, gz)

    return tau_sweep_bound
