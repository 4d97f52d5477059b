"""The resident sweep's gamma-MH passes: CUDA kernel wrappers and their plain
PyTorch versions.

- ``gamma_ll``: the per-sample loglik pair [2,S] of the gamma MH, row 0 of
  the carried mixture (``with_old``; zeros otherwise), row 1 of the
  proposal mixture rebuilt from (tau, gamma_prop) and never stored.
- ``gamma_apply_eta``: the accepted samples take the proposal mixture
  (``mix + accept * (mp - mix)``, the Pallas formula), and, with
  ``with_eta``, the per-sample loglik [S] of the joint eta proposal against
  the new mixture (zeros without it: fixed-eta runs take no logs).

Each runs ``csrc/gamma_kernel.cu`` on CUDA tensors and its plain version on
CPU tensors; on any other device it raises. ``accept`` stays an [S] bool
device tensor, so the sweep never waits for the host. Past S = 3632 both
kernels keep their reduction slots in a device-memory scratch. Both take a
leading chain axis (C chains in one launch, the JAX package's vmap over
chains), on counts shared by the chains or their own; chain c bitwise its
own call. ``launches`` counts the launches and ``chain_launches`` the
chains they took.
"""
from __future__ import annotations

import torch

from ..likelihood import mixture
from ..utils import NBASES, one_hot_tau, safe_log
from ._build import (
    chains_of, check, load_library, partial_scratch, per_chain, ptr, require,
    require_counts, slot_scratch, stream_of,
)


def _check(n, mix, tau, gamma_prop, eta):
    """(V, S, G, C, the counts' chain stride): C None for one chain."""
    dev = n.device
    C = chains_of(tau)
    lead = () if C is None else (C,)
    V, S, stride = require_counts("n", n, torch.float32, NBASES, C, dev)
    require("mix", mix, torch.float32, (*lead, V, S, NBASES), dev)
    require("tau", tau, torch.int32, (*lead, V, -1), dev)
    G = tau.shape[-1]
    require("gamma_prop", gamma_prop, torch.float32, (*lead, S, G), dev)
    require("eta", eta, torch.float32, (*lead, NBASES, NBASES), dev)
    return V, S, G, C, stride


def _sample_loglik(n, mix, eta):
    """[S]: sum over (v, b) of n * log max(mix @ eta, 1e-12)."""
    return torch.sum(n * safe_log(torch.einsum("vsa,ab->vsb", mix, eta)),
                     dim=(0, 2))


def launch(lib, n, mix, tau, gamma_prop, eta, partial, ll, with_old=True):
    """Launch the gamma_ll kernel and its reduction on checked CUDA tensors
    (one chain, or a leading chain axis) into a preallocated ll ([2,S] or
    [C,2,S]) and partial scratch. Raises on a launch error."""
    chains = chains_of(tau) or 1
    V, S = mix.shape[-3:-1]
    stride = V * S if n.dim() == 4 else 0
    slots = slot_scratch(partial.shape[0] * chains, S, n.device)
    with torch.cuda.device(n.device):
        err = lib.desman_gamma_ll(
            n.data_ptr(), mix.data_ptr(), tau.data_ptr(), gamma_prop.data_ptr(),
            eta.data_ptr(), partial.data_ptr(), ptr(slots), ll.data_ptr(), V, S,
            tau.shape[-1], int(with_old), chains, stride, stream_of(n))
    check(lib, err, "gamma_ll")


def gamma_ll(n, mix, tau, gamma_prop, eta, with_old=True):
    """Per-sample loglik [2,S] of the carried mixture (row 0, zeros unless
    with_old) and of the gamma proposal (row 1).

    n, mix: [V,S,4] f32; tau: [V,G] int32; gamma_prop: [S,G]; eta: [4,4].
    Chains: mix [C,V,S,4], tau [C,V,G], gamma_prop [C,S,G] and eta [C,4,4]
    give ll [C,2,S] in one launch, on counts n shared ([V,S,4]) or the
    chains' own ([C,V,S,4]).
    """
    V, S, G, C, _ = _check(n, mix, tau, gamma_prop, eta)
    if n.device.type == "cpu":
        return gamma_ll_reference(n, mix, tau, gamma_prop, eta, with_old)
    if n.device.type != "cuda":
        raise ValueError(f"gamma_ll: no kernel for device {n.device}")
    lib = load_library()
    lead = () if C is None else (C,)
    ll = torch.empty((*lead, 2, S), dtype=torch.float32, device=n.device)
    launch(lib, n, mix, tau, gamma_prop, eta,
           partial_scratch(lib, V, 2, S, n.device, C or 1), ll, with_old)
    gamma_ll.launches += 1
    gamma_ll.chain_launches += C or 1
    return ll


gamma_ll.launches = 0
gamma_ll.chain_launches = 0


def gamma_ll_reference(n, mix, tau, gamma_prop, eta, with_old=True):
    """Plain PyTorch gamma_ll: the two likelihood terms gamma_step stacks.
    Over a chain axis, each chain in turn."""
    if tau.dim() == 3:
        return per_chain(lambda *a: (gamma_ll_reference(*a, with_old),), (n,),
                         mix, tau, gamma_prop, eta)[0]
    new = _sample_loglik(n, mixture(one_hot_tau(tau), gamma_prop), eta)
    old = _sample_loglik(n, mix, eta) if with_old else torch.zeros_like(new)
    return torch.stack([old, new])


def gamma_apply_eta(n, mix, tau, gamma_prop, accept, eta_prop, with_eta=True):
    """(mix [V,S,4], ll_eta [S]): the accepted samples' proposal mixture
    applied, and the joint eta proposal's per-sample loglik against it
    (zeros unless with_eta).

    accept: [S] bool; eta_prop: [4,4]. Chains: as ``gamma_ll``'s, with
    accept [C,S] and eta_prop [C,4,4]; mix [C,V,S,4] and ll_eta [C,S] out.
    Inputs are not modified.
    """
    V, S, G, C, _ = _check(n, mix, tau, gamma_prop, eta_prop)
    lead = () if C is None else (C,)
    require("accept", accept, torch.bool, (*lead, S), n.device)
    if n.device.type == "cpu":
        return gamma_apply_eta_reference(n, mix, tau, gamma_prop, accept,
                                         eta_prop, with_eta)
    if n.device.type != "cuda":
        raise ValueError(f"gamma_apply_eta: no kernel for device {n.device}")
    lib = load_library()
    chains = C or 1
    mix_out = torch.empty_like(mix)
    if with_eta:
        ll = torch.empty((*lead, S), dtype=torch.float32, device=n.device)
        partial = partial_scratch(lib, V, 1, S, n.device, chains)
        slots = slot_scratch(partial.shape[0] * chains, S, n.device)
    else:
        ll = torch.zeros((*lead, S), dtype=torch.float32, device=n.device)
        partial = slots = None
    with torch.cuda.device(n.device):
        err = lib.desman_gamma_apply_eta(
            n.data_ptr(), mix.data_ptr(), tau.data_ptr(), gamma_prop.data_ptr(),
            accept.data_ptr(), eta_prop.data_ptr(), mix_out.data_ptr(),
            ptr(partial), ptr(slots), ll.data_ptr() if with_eta else None, V, S, G,
            int(with_eta), chains, V * S if n.dim() == 4 else 0, stream_of(n))
    check(lib, err, "gamma_apply_eta")
    gamma_apply_eta.launches += 1
    gamma_apply_eta.chain_launches += chains
    return mix_out, ll


gamma_apply_eta.launches = 0
gamma_apply_eta.chain_launches = 0


def gamma_apply_eta_reference(n, mix, tau, gamma_prop, accept, eta_prop,
                              with_eta=True):
    """Plain PyTorch gamma_apply_eta. Over a chain axis, each chain in
    turn."""
    if tau.dim() == 3:
        return per_chain(lambda *a: gamma_apply_eta_reference(*a, with_eta), (n,),
                         mix, tau, gamma_prop, accept, eta_prop)
    mp = mixture(one_hot_tau(tau), gamma_prop)
    mix = mix + accept.to(mix.dtype)[None, :, None] * (mp - mix)
    if not with_eta:
        return mix, torch.zeros(n.shape[1], dtype=torch.float32,
                                device=n.device)
    return mix, _sample_loglik(n, mix, eta_prop)
