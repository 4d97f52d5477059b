"""The resident front half of a sweep (counterpart of
``desman_tpu.resident.make_resident_sweep``): every [V]-sized pass of the
sweep in two kernel launches.

    fused_sweep: tau sweep + strain-pair swap + both gamma-MH loglik terms
        (the swap's post-swap loglik is the gamma MH's ll_old)
    -> gamma MH decisions on [S]-sized terms (PyTorch ops)
    -> gamma_apply_eta: accepted gamma applied to the mixture + the joint
       eta proposal's per-sample loglik
    -> eta MH decision on the summed loglik (PyTorch ops)

With one strain or with swaps off there is no swap to fuse: the tau sweep
kernel runs, then ``gamma_ll`` with the carried mixture's term.

``sampler.make_sweep_fn(cfg, kernel="cuda_resident")`` runs ``front`` in
place of the staged front half; adaptation and accumulators are shared.
Noise is drawn in the staged sweep's order (gumbel, swap, gamma_prop,
gamma_u, eta_prop, eta_u), so the ``cuda`` and ``cuda_resident`` chains of
one seed take the same draws and differ only at float near-ties.

Unlike the JAX package the port keeps [V,S,4] and masks the ragged edge in
the kernels: no base-major layout and no pad rows.

A state with a leading [C] axis (``sampler.run_chains``, the JAX package's
``run_chains_resident``) sweeps C chains in the same launches: the kernels
take the chain axis, the draws come from a ``ChainNoise`` in the order
above, and the acceptance mean and the eta loglik's total run per chain
(``sampler._each``), so chain c is bitwise its own resident sweep.
"""
from __future__ import annotations

import torch

from .sampler import (
    SamplerConfig, SamplerState, _chains, _each, _eta_accept, _eta_proposal,
    _gamma_accept, _gamma_proposal,
)


def check_supported(cfg: SamplerConfig) -> None:
    """Raise ValueError for the configurations the JAX package's resident
    path refuses (``resident._check_supported``)."""
    bad = []
    if cfg.fix_tau:
        bad.append("fix_tau")
    if cfg.fix_gamma:
        bad.append("fix_gamma")
    if cfg.store_samples:
        bad.append("store_samples")
    if not cfg.fix_eta and cfg.eta_update != "joint":
        bad.append(f"eta_update={cfg.eta_update!r}")
    if bad:
        raise ValueError(
            "the resident kernel path supports the default sampling "
            f"configuration only (unsupported here: {', '.join(bad)}); "
            "use --kernel cuda for these modes")


def front(cfg: SamplerConfig, ks, n, state: SamplerState, it: int, noise,
          temp: float):
    """One sweep's tau, gamma and eta updates on the resident kernels.

    ks: the ``ops.Kernels`` of the kernel choice. Returns (tau, mix, gamma,
    eta, loglik, acc_gamma, acc_eta), as the staged front does. A state with
    a chain axis sweeps every chain in each launch; n is then the counts
    the chains share ([V,S,4]) or their own ([C,V,S,4]).
    """
    V, S, _ = n.shape[-3:]
    G = cfg.G
    C = _chains(state.gamma, 2)
    gz = noise.gumbel(it, V, G)
    if temp != 1.0:
        gz = gz * temp
    swaps = cfg.swap_moves and G > 1
    if swaps:
        g, h, logu = noise.swap(it, V, G)
    gamma, eta = state.gamma, state.eta
    # the proposal does not depend on the sweep's output: draw it first so
    # that its loglik is taken in the same visit as the tau sweep
    gamma_prop, alpha_fwd, alpha_rev = _gamma_proposal(
        cfg, gamma, state.kappa_gamma, noise, it)
    if swaps:
        tau, mix, ll = ks.fused_sweep(n, state.tau, state.mix, gamma, eta, gz,
                                      g, h, logu, gamma_prop)
    else:
        tau, mix = ks.tau_sweep(n, state.tau, state.mix, gamma, eta, gz)
        ll = ks.gamma_ll(n, mix, tau, gamma_prop, eta, with_old=True)

    accept, gamma, loglik = _gamma_accept(gamma, gamma_prop, alpha_fwd, alpha_rev,
                                          ll[..., 0, :], ll[..., 1, :], noise, it)
    acc_g = _each(C, torch.mean, accept.to(torch.float32))

    if cfg.fix_eta:
        mix, _ = ks.gamma_apply_eta(n, mix, tau, gamma_prop, accept, eta,
                                    with_eta=False)
        return tau, mix, gamma, eta, loglik, acc_g, torch.zeros(
            loglik.shape, device=n.device)
    eta_prop, alpha_fwd_e, alpha_rev_e = _eta_proposal(
        cfg, eta, state.kappa_eta, noise, it)
    mix, ll_eta = ks.gamma_apply_eta(n, mix, tau, gamma_prop, accept,
                                     eta_prop)
    eta, loglik, acc_e = _eta_accept(cfg, eta, eta_prop, alpha_fwd_e,
                                     alpha_rev_e, _each(C, torch.sum, ll_eta), loglik,
                                     noise, it)
    return tau, mix, gamma, eta, loglik, acc_g, acc_e
