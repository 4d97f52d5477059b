"""The tau Gibbs sweep: CUDA kernel wrapper, its plain PyTorch version, and
the sweep's Gumbel noise.

``tau_sweep`` runs ``csrc/tau_kernel.cu`` on CUDA tensors and the plain
version ``tau_sweep_reference`` on CPU tensors; on any other device it
raises. The plain version is the ``--kernel torch`` sweep and the oracle the
kernel is held against. Both take the categorical noise pre-drawn
(``draw_gumbel``, multiplied by the temperature by the caller), so the same
noise gives the same draws up to float near-ties.
"""
from __future__ import annotations

import torch

from ..utils import NBASES, one_hot_tau, safe_log
from ._build import check, load_library, require, stream_of


def _check(n, tau, mix, gamma, eta, gz):
    dev = n.device
    require("n", n, torch.float32, (-1, -1, NBASES), dev)
    V, S, _ = n.shape
    require("tau", tau, torch.int32, (V, -1), dev)
    G = tau.shape[1]
    require("mix", mix, torch.float32, (V, S, NBASES), dev)
    require("gamma", gamma, torch.float32, (S, G), dev)
    require("eta", eta, torch.float32, (NBASES, NBASES), dev)
    require("gz", gz, torch.float32, (V, G, NBASES), dev)
    return V, S, G


def tau_sweep(n, tau, mix, gamma, eta, gz):
    """One full Gibbs sweep over strains: (tau [V,G] i32, mix [V,S,4]).

    n, mix: [V,S,4] f32; tau: [V,G] int32; gamma: [S,G]; eta: [4,4];
    gz: [V,G,4] Gumbel noise already multiplied by the temperature. All
    contiguous, on one device. Inputs are not modified.
    """
    V, S, G = _check(n, tau, mix, gamma, eta, gz)
    if n.device.type == "cpu":
        return tau_sweep_reference(n, tau, mix, gamma, eta, gz)
    if n.device.type != "cuda":
        raise ValueError(f"tau_sweep: no kernel for device {n.device}")
    lib = load_library()
    tau_out = torch.empty_like(tau)
    mix_out = torch.empty_like(mix)
    with torch.cuda.device(n.device):
        err = lib.desman_tau_sweep(
            n.data_ptr(), tau.data_ptr(), mix.data_ptr(), gamma.data_ptr(),
            eta.data_ptr(), gz.data_ptr(), tau_out.data_ptr(),
            mix_out.data_ptr(), V, S, G, stream_of(n))
    check(lib, err, "tau_sweep")
    tau_sweep.launches += 1
    return tau_out, mix_out


tau_sweep.launches = 0


def tau_sweep_reference(n, tau, mix, gamma, eta, gz):
    """Plain PyTorch tau sweep (the JAX package's ``tau_sweep_xla`` with
    the noise pre-drawn): for each strain g in order, remove it from the
    mixture, score the 4 candidate bases, draw by Gumbel-argmax (first
    maximum wins) and put the new base back."""
    G = tau.shape[1]
    tau = tau.clone()
    for g in range(G):
        gam = gamma[:, g]                                          # [S]
        rest = mix - gam[None, :, None] * one_hot_tau(tau[:, g])[:, None, :]
        q = torch.einsum("vsa,ab->vsb", rest, eta)                 # [V,S,4]
        # cand[v,c] = sum_{s,b} n[v,s,b] * log(q[v,s,b] + gamma[s,g] eta[c,b])
        terms = safe_log(q[:, :, None, :]
                         + gam[None, :, None, None] * eta[None, None, :, :])
        cand = torch.einsum("vsb,vscb->vc", n, terms)              # [V,4]
        new = torch.argmax(cand + gz[:, g, :], dim=1)
        mix = rest + gam[None, :, None] * one_hot_tau(new)[:, None, :]
        tau[:, g] = new.to(torch.int32)
    return tau, mix


def draw_gumbel(generator: torch.Generator, V: int, G: int) -> torch.Tensor:
    """Standard Gumbel noise [V,G,4] on the generator's device."""
    u = torch.rand((V, G, NBASES), generator=generator,
                   device=generator.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
