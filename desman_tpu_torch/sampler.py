"""The tau/gamma/eta Gibbs sampler in eager PyTorch (counterpart of
``desman_tpu.sampler``).

One sweep =

  1. **tau update** — exact Gibbs over strains in turn, all positions in
     parallel (``ops.tau_sweep``: the CUDA kernel, or its plain version),
     then one strain-pair swap MH move at every position (``ops.swap``).
  2. **gamma update** — MH-within-Gibbs with a Dirichlet(kappa*gamma)
     random-walk proposal, all S samples accepted in parallel.
  3. **eta update** — one blocked Dirichlet MH step on the whole 4x4 matrix
     (``eta_update="rows"``: four per-row steps in turn; skipped when eta is
     fixed from the filter's tran_df).

The JAX package's ``lax.scan`` is a Python loop over sweeps here. Whatever
depends only on the sweep index (the anneal temperature, whether kappa is
still adapting, whether the sweep is a sample) is a host float or bool;
whatever depends on device state (accept masks, the star snapshot, the swap
pair) stays on the device through ``torch.where``, so a sweep never waits
for the device. All randomness comes from a noise source passed to the
sweep: ``TorchNoise`` draws from the chain's ``torch.Generator``.

Chains: the JAX package vmaps independent chains into one device program;
here ``run_chains`` sweeps them as one state with a leading [C] axis (tau
[C,V,G], mix [C,V,S,4], gamma [C,S,G], eta [C,4,4], loglik and kappas [C];
the counts [V,S,4] are shared, or each chain's own [C,V,S,4], as
``multibin``'s bins). One sweep launches the tau (or top-2) and swap
kernels, or the resident kernels, once for all C chains, and runs the
elementwise ops once on the stacked state. Its draws come from
``ChainNoise``, chain c's from chain c's own generator, and every
reduction and matrix product runs per chain on chain c's contiguous
slice (``_each``, ``_each_n``), since torch may sum a stacked
tensor in another order: so chain c of a batched run is bitwise
``run_chain`` of its seed. The host branches on the sweep index (anneal,
adaptation, accumulation) are shared by the chains; the decisions on data
(MH accepts, the star, the swap pair) are per-chain masks.

With ``kernel="cuda_resident"`` steps 1-3 run as two kernel launches a
sweep (``resident.front``), with the same draws in the same order; only
the [S]- and [4,4]-sized MH arithmetic stays as PyTorch ops.

Parallel tempering (``run_chain_pt``): R replicas on a temperature ladder,
each a sweep with a fixed ``temp`` and a likelihood power ``beta``, then an
exchange of adjacent rungs. The JAX package vmaps the replicas; here they
are the chain axis: one sweep of all R (temps and betas [R], one per
chain), each replica drawing from its own generator, and the exchange
from one more (``pt_seeds``). ``run_chains_pt`` puts C runs of R replicas
on one [C*R] axis, each run with its own exchange.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .likelihood import mixture
from .nmf import em_gamma, nmf_init
from .ops import Kernels, draw_gumbel, draw_swap_proposal, resolve
from .ops.tau_kernel import gumbel_of
from .profiling import span
from .utils import NBASES, one_hot_tau, safe_log

_GAMMA_FLOOR = 1e-10


@dataclass(frozen=True)
class SamplerConfig:
    """Sampler hyperparameters; the same fields and defaults as the JAX
    package's ``SamplerConfig`` (see its notes on the kappa warm start)."""

    G: int
    burn: int = 100
    samples: int = 100
    # MH proposal concentrations. 0.0 (default) = warm-start from the data's
    # posterior curvature at init: kappa_gamma = (n.sum()/S) / 32 and
    # kappa_eta = n.sum(). Explicit positive values pin the start.
    kappa_gamma: float = 0.0
    kappa_eta: float = 0.0
    adapt_kappa: bool = True      # tune proposal scales during burn-in
    target_accept: float = 0.3
    adapt_rate: float = 0.15
    proposal_floor: float = 0.1
    eta_prior_diag: float = 10.0
    eta_prior_off: float = 1.0
    fix_eta: bool = False
    # "joint" (one blocked MH on the whole 4x4) | "rows" (4 sequential
    # per-row MH steps; same stationary distribution)
    eta_update: str = "joint"
    fix_gamma: bool = False       # freeze abundances (known mixtures / tests)
    fix_tau: bool = False         # freeze haplotypes, fit gamma/eta
    store_samples: bool = False   # keep post-burn (tau, gamma, eta) draws
    store_thin: int = 1           # keep every k-th draw (must divide samples)
    swap_moves: bool = True       # per-position strain-pair swap MH each sweep
    anneal_temp0: float = 3.0     # tempered tau updates early in burn-in
    anneal_frac: float = 0.5      # fraction of burn spent annealing T0 -> 1
    nmf_iters: int = 300

    @property
    def total_sweeps(self) -> int:
        return self.burn + self.samples


class SamplerState(NamedTuple):
    """Per-chain carry. mix caches M[v,s,a] = sum_g gamma[s,g] tau[v,g,a]."""

    tau: torch.Tensor          # int32 [V,G]
    gamma: torch.Tensor        # f32 [S,G]
    eta: torch.Tensor          # f32 [4,4]
    mix: torch.Tensor          # f32 [V,S,4]
    loglik: torch.Tensor       # f32 0-d (no multinomial coeff)
    kappa_gamma: torch.Tensor  # f32 0-d — adaptive proposal concentration
    kappa_eta: torch.Tensor


class SamplerAccum(NamedTuple):
    sum_tau: torch.Tensor      # f32 [V,G,4]
    sum_gamma: torch.Tensor    # f32 [S,G]
    sum_eta: torch.Tensor      # f32 [4,4]
    sum_loglik: torch.Tensor   # f32 0-d
    n_samples: torch.Tensor    # f32 0-d
    star_loglik: torch.Tensor  # f32 0-d
    star_tau: torch.Tensor     # int32 [V,G]
    star_gamma: torch.Tensor   # f32 [S,G]
    star_eta: torch.Tensor     # f32 [4,4]
    acc_gamma: torch.Tensor    # f32 0-d — summed acceptance fraction (all sweeps)
    acc_eta: torch.Tensor
    acc_gamma_post: torch.Tensor  # summed acceptance, post-burn only
    acc_eta_post: torch.Tensor


class SamplerResult(NamedTuple):
    tau_mean: torch.Tensor     # [V,G,4] posterior base probabilities
    tau_star: torch.Tensor     # [V,G] int
    gamma_mean: torch.Tensor
    gamma_star: torch.Tensor
    eta_mean: torch.Tensor
    eta_star: torch.Tensor
    mean_loglik: torch.Tensor  # posterior mean loglik (no coeff)
    star_loglik: torch.Tensor
    loglik_trace: torch.Tensor  # [total_sweeps]
    accept_gamma: torch.Tensor  # mean acceptance rate over all sweeps
    accept_eta: torch.Tensor
    accept_gamma_post: torch.Tensor  # post-burn acceptance rate
    accept_eta_post: torch.Tensor
    # post-burn draws, every store_thin-th sweep (store_samples), else None
    tau_samples: Optional[torch.Tensor] = None    # int8 [samples/thin,V,G]
    gamma_samples: Optional[torch.Tensor] = None  # [samples/thin,S,G]
    eta_samples: Optional[torch.Tensor] = None    # [samples/thin,4,4]
    # replica exchange only (run_chain_pt): mean adjacent-swap acceptance
    pt_swap_accept: Optional[torch.Tensor] = None


DRAW_FIELDS = ("tau_samples", "gamma_samples", "eta_samples")


class TorchNoise:
    """The sweep's random draws from one chain's ``torch.Generator``.

    Every method takes the sweep index ``it`` so that a replay source can
    rebuild another package's counter-based streams; this one ignores it.
    ``gamma_prop``/``eta_prop`` return Gamma(alpha) variates, which the
    sampler floors and normalizes into a Dirichlet draw.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def gumbel(self, it: int, V: int, G: int) -> torch.Tensor:
        return draw_gumbel(self.generator, V, G)

    def swap(self, it: int, V: int, G: int):
        return draw_swap_proposal(self.generator, V, G)

    def gamma_prop(self, it: int, alpha: torch.Tensor) -> torch.Tensor:
        return torch._standard_gamma(alpha, generator=self.generator)

    def gamma_u(self, it: int, S: int) -> torch.Tensor:
        return torch.rand((S,), generator=self.generator,
                          device=self.generator.device)

    def eta_prop(self, it: int, alpha: torch.Tensor) -> torch.Tensor:
        return torch._standard_gamma(alpha, generator=self.generator)

    def eta_u(self, it: int) -> torch.Tensor:
        return torch.rand((), generator=self.generator,
                          device=self.generator.device)

    def eta_row_prop(self, it: int, a: int, alpha: torch.Tensor) -> torch.Tensor:
        return torch._standard_gamma(alpha, generator=self.generator)

    def eta_row_u(self, it: int, a: int) -> torch.Tensor:
        return torch.rand((), generator=self.generator,
                          device=self.generator.device)


class ChainNoise:
    """The draws of C chains, stacked on a leading [C] axis: chain c's from
    its own source (a ``TorchNoise``, or any source with its methods, such
    as a replay of another package's streams), so chain c's streams are
    those of its source alone. Where every source is a ``TorchNoise``, each
    chain's uniforms are drawn into its slice of one [C, ...] buffer and the
    elementwise transforms (the Gumbel's logs, the swap's log) run once on
    the stack: the same bits as each chain's own draw, in fewer launches."""

    def __init__(self, sources):
        self.sources = list(sources)
        self.generators = ([s.generator for s in self.sources]
                           if all(type(s) is TorchNoise for s in self.sources)
                           else None)

    def _stack(self, draw):
        return _stacked([draw(c, s) for c, s in enumerate(self.sources)])

    def _rand(self, shape) -> torch.Tensor:
        """[C, *shape] uniforms, slice c drawn by torch.rand from generator c."""
        dev = self.generators[0].device
        out = torch.empty((len(self.generators), *shape), device=dev)
        for c, g in enumerate(self.generators):
            torch.rand(shape, generator=g, device=dev, out=out[c])
        return out

    def gumbel(self, it: int, V: int, G: int) -> torch.Tensor:
        if self.generators is None:
            return self._stack(lambda c, s: s.gumbel(it, V, G))
        return gumbel_of(self._rand((V, G, NBASES)))

    def swap(self, it: int, V: int, G: int):
        if self.generators is None or G < 2:
            return tuple(_stacked(list(x)) for x in zip(
                *(s.swap(it, V, G) for s in self.sources)))
        # draw_swap_proposal's draws, chain by chain in its order
        dev = self.generators[0].device
        g = torch.empty(len(self.generators), dtype=torch.int32, device=dev)
        off, u = torch.empty_like(g), torch.empty((len(g), V), device=dev)
        for c, gen in enumerate(self.generators):
            torch.randint(0, G, (), generator=gen, device=dev, out=g[c])
            torch.randint(1, G, (), generator=gen, device=dev, out=off[c])
            torch.rand((V,), generator=gen, device=dev, out=u[c])
        return g, (g + off) % G, safe_log(u)

    def gamma_prop(self, it: int, alpha: torch.Tensor) -> torch.Tensor:
        return self._stack(lambda c, s: s.gamma_prop(it, alpha[c]))

    def gamma_u(self, it: int, S: int) -> torch.Tensor:
        if self.generators is None:
            return self._stack(lambda c, s: s.gamma_u(it, S))
        return self._rand((S,))

    def eta_prop(self, it: int, alpha: torch.Tensor) -> torch.Tensor:
        return self._stack(lambda c, s: s.eta_prop(it, alpha[c]))

    def eta_u(self, it: int) -> torch.Tensor:
        if self.generators is None:
            return self._stack(lambda c, s: s.eta_u(it))
        return self._rand(())

    def eta_row_prop(self, it: int, a: int, alpha: torch.Tensor) -> torch.Tensor:
        return self._stack(lambda c, s: s.eta_row_prop(it, a, alpha[c]))

    def eta_row_u(self, it: int, a: int) -> torch.Tensor:
        if self.generators is None:
            return self._stack(lambda c, s: s.eta_row_u(it, a))
        return self._rand(())


def _stacked(xs: list) -> torch.Tensor:
    """Tensors stacked on a new leading axis; one tensor as a view (no copy)."""
    return xs[0].unsqueeze(0) if len(xs) == 1 else torch.stack(xs)


def _chains(x: torch.Tensor, rank: int):
    """The chains C of x, a tensor of `rank` dims a chain: None without a
    chain axis."""
    return x.shape[0] if x.dim() > rank else None


def _each(C, fn, *xs):
    """fn of one chain's tensors: fn(*xs) without a chain axis (C None);
    over one, fn of each chain's slices x[c], stacked. The sweep's
    reductions and matrix products go through here: torch may sum a stacked
    tensor in another order than chain c's alone (the CUDA reduction's
    block shape follows the number of outputs, a full sum splits across
    blocks), and chain c must keep ``run_chain``'s bits."""
    if C is None:
        return fn(*xs)
    return _stacked([fn(*(x[c] for x in xs)) for c in range(C)])


def _each_n(C, fn, n, *xs):
    """``_each`` of fn(n, *xs), with chain c's counts: the shared n
    ([V,S,4]) or slice c of a chain axis of its own ([C,V,S,4])."""
    if C is None:
        return fn(n, *xs)
    if n.dim() == 4:
        return _each(C, fn, n, *xs)
    return _each(C, lambda *ys: fn(n, *ys), *xs)


def _per(x, like: torch.Tensor):
    """A per-chain value x ([C]) shaped to broadcast against like ([C,...]);
    a 0-d x (one chain) or a host number as it is."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _tempered(x) -> bool:
    """False only for the host float 1.0: an untempered step skips the
    multiply or divide (a 0-d device temp or beta, as PT passes them,
    always tempers)."""
    return isinstance(x, torch.Tensor) or x != 1.0


def _dirichlet_logpdf(x, alpha, C=None):
    """Row-wise Dirichlet log-density; x, alpha [..., K] -> [...] (C: the
    chains of a leading chain axis, whose sums run per chain)."""
    def rows(t):
        return torch.sum(t, dim=-1)

    return (
        _each(C, rows, (alpha - 1.0) * safe_log(x))
        + torch.lgamma(_each(C, rows, alpha))
        - _each(C, rows, torch.lgamma(alpha))
    )


def _dirichlet(gammas, C=None):
    """Dirichlet draw from Gamma variates, floored away from the boundary."""
    g = torch.clamp_min(gammas, _GAMMA_FLOOR)
    return g / _each(C, lambda t: torch.sum(t, dim=-1, keepdim=True), g)


def _own(x):
    """The one-device reduction over positions: the local sum is the sum."""
    return x


# desman --debug: the NaN trap (``set_nan_trap``); off, no sweep is checked
_NAN_TRAP = False
_CHECKED = ("loglik", "gamma", "eta", "mix")


def set_nan_trap(on: bool) -> None:
    """Turn the NaN trap on or off (``desman --debug``, the JAX package's
    ``jax_debug_nans``). On, every sweep of every chain or replica is
    followed by ``check_finite`` of its state, which waits for the device;
    off (the default), a sweep checks nothing and waits for nothing."""
    global _NAN_TRAP
    _NAN_TRAP = bool(on)


def nan_trap() -> bool:
    """Whether the NaN trap is on."""
    return _NAN_TRAP


def check_finite(it: int, states, agree=None) -> None:
    """Raise FloatingPointError naming sweep `it` and the field when the
    loglik, gamma, eta or mix of any of `states` (each one chain's, or
    chains' with a leading axis) holds a non-finite value.
    agree: the sum of the [4] int32 flags over the ranks of a sharded run
    (``parallel.distributed.Axis.sum`` on the world), so that every rank
    raises at the same sweep and none is left waiting in a collective."""
    flags = torch.stack([
        torch.stack([~torch.isfinite(getattr(s, f)).all() for f in _CHECKED])
        for s in states]).any(0).to(torch.int32)
    if agree is not None:
        flags = agree(flags)
    for name, bad in zip(_CHECKED, flags.tolist()):
        if bad:
            raise FloatingPointError(f"sweep {it}: non-finite {name} (desman --debug)")


def _loglik(n, mix, eta, psum=_own):
    """sum n * log(mix @ eta) (per chain over a chain axis: [C], on the
    shared counts or each chain's own); psum adds the position shards'
    sums (``parallel.distributed``), the identity on one device."""
    return psum(_each_n(_chains(eta, 2), lambda k, m, e: torch.sum(
        k * safe_log(torch.einsum("vsa,ab->vsb", m, e))), n, mix, eta))


def _eta_prior(cfg: SamplerConfig, device) -> torch.Tensor:
    return (torch.full((NBASES, NBASES), cfg.eta_prior_off, device=device)
            + torch.eye(NBASES, device=device)
            * (cfg.eta_prior_diag - cfg.eta_prior_off))


def _gamma_proposal(cfg: SamplerConfig, gamma, kappa, noise, it: int):
    """The per-sample Dirichlet random-walk proposal:
    (gamma_prop, alpha_fwd, alpha_rev)."""
    kappa = _per(kappa, gamma)
    alpha_fwd = kappa * gamma + cfg.proposal_floor                    # [S,G]
    gamma_prop = _dirichlet(noise.gamma_prop(it, alpha_fwd), _chains(gamma, 2))
    alpha_rev = kappa * gamma_prop + cfg.proposal_floor
    return gamma_prop, alpha_fwd, alpha_rev


def _gamma_accept(gamma, gamma_prop, alpha_fwd, alpha_rev, ll_old, ll_new,
                  noise, it: int, beta=1.0):
    """The per-sample MH decisions from the per-sample likelihood pair:
    (accept [S] bool, gamma, loglik). The old/new terms of the ratio
    already give the post-update total loglik. beta tempers the likelihood
    term only; the returned loglik is the untempered one."""
    C = _chains(gamma, 2)
    dll = ll_new - ll_old
    if _tempered(beta):
        dll = _per(beta, dll) * dll
    # symmetric Dirichlet(1) prior on gamma rows -> prior ratio = 0
    log_ratio = (
        dll
        + _dirichlet_logpdf(gamma, alpha_rev, C)
        - _dirichlet_logpdf(gamma_prop, alpha_fwd, C)
    )
    accept = safe_log(noise.gamma_u(it, gamma.shape[-2])) < log_ratio
    gamma = torch.where(accept[..., None], gamma_prop, gamma)
    loglik = _each(C, torch.sum, torch.where(accept, ll_new, ll_old))
    return accept, gamma, loglik


def gamma_step(cfg: SamplerConfig, n, tau, mix, gamma, eta, kappa, noise,
               it: int, beta=1.0, psum=_own, mix_out=None):
    """Parallel per-sample Dirichlet-random-walk MH on gamma; beta < 1
    tempers the likelihood term only (replica exchange's target
    prior * L^beta); psum adds the position shards' [2,S] sums. mix_out: a
    buffer the new mix is written into (a CUDA graph's static carry), or
    None.

    Returns (gamma, mix, accept_rate, loglik): the per-sample old/new
    likelihood terms of the MH ratio already give the post-update total
    loglik, so the sweep needs no separate likelihood pass.
    """
    C = _chains(gamma, 2)
    gamma_prop, alpha_fwd, alpha_rev = _gamma_proposal(cfg, gamma, kappa,
                                                       noise, it)
    mix_prop = _each(C, mixture, one_hot_tau(tau), gamma_prop)        # [V,S,4]

    def ll_pair(n, mix, mix_prop, eta):
        both = torch.stack([mix, mix_prop])                           # [2,V,S,4]
        return torch.sum(
            n[None] * safe_log(torch.einsum("kvsa,ab->kvsb", both, eta)),
            dim=(1, 3))                                               # [2,S]

    ll = psum(_each_n(C, ll_pair, n, mix, mix_prop, eta))
    accept, gamma, loglik = _gamma_accept(gamma, gamma_prop, alpha_fwd, alpha_rev,
                                          ll[..., 0, :], ll[..., 1, :], noise, it, beta)
    mix = torch.where(accept[..., None, :, None], mix_prop, mix, out=mix_out)
    return gamma, mix, _each(C, torch.mean, accept.to(torch.float32)), loglik


def _eta_proposal(cfg: SamplerConfig, eta, kappa, noise, it: int):
    """The joint Dirichlet proposal of all four rows:
    (eta_prop, alpha_fwd, alpha_rev)."""
    kappa = _per(kappa, eta)
    alpha_fwd = kappa * eta + cfg.proposal_floor                      # [4,4]
    eta_prop = _dirichlet(noise.eta_prop(it, alpha_fwd), _chains(eta, 2))
    alpha_rev = kappa * eta_prop + cfg.proposal_floor
    return eta_prop, alpha_fwd, alpha_rev


def _eta_accept(cfg: SamplerConfig, eta, eta_prop, alpha_fwd, alpha_rev,
                ll_new, loglik, noise, it: int, beta=1.0):
    """The one MH decision of the joint eta step: (eta, loglik, accepted
    as f32); beta tempers the likelihood term only."""
    C = _chains(eta, 2)
    prior_alpha = _eta_prior(cfg, eta.device)
    dll = ll_new - loglik
    if _tempered(beta):
        dll = beta * dll
    log_ratio = (
        dll
        + _each(C, torch.sum, (prior_alpha - 1.0) * (safe_log(eta_prop) - safe_log(eta)))
        + _each(C, torch.sum, _dirichlet_logpdf(eta, alpha_rev, C))
        - _each(C, torch.sum, _dirichlet_logpdf(eta_prop, alpha_fwd, C))
    )
    accept = safe_log(noise.eta_u(it)) < log_ratio
    eta = torch.where(_per(accept, eta), eta_prop, eta)
    loglik = torch.where(accept, ll_new, loglik)
    return eta, loglik, accept.to(torch.float32)


def eta_step_joint(cfg: SamplerConfig, n, mix, eta, loglik, kappa, noise,
                   it: int, beta=1.0, psum=_own):
    """Blocked MH on the whole 4x4 error matrix: all four rows proposed at
    once, one accept/reject, one likelihood pass; beta tempers the
    likelihood term only."""
    eta_prop, alpha_fwd, alpha_rev = _eta_proposal(cfg, eta, kappa, noise, it)
    return _eta_accept(cfg, eta, eta_prop, alpha_fwd, alpha_rev,
                       _loglik(n, mix, eta_prop, psum), loglik, noise, it, beta)


def eta_step(cfg: SamplerConfig, n, mix, eta, loglik, kappa, noise, it: int,
             beta=1.0, psum=_own):
    """Sequential per-row Dirichlet MH on the 4x4 error matrix
    (``eta_update="rows"``): for each row in turn one proposal, one
    likelihood pass, that row's prior term and one MH decision.

    beta tempers the likelihood term only; the returned loglik is the
    untempered one. Returns (eta, loglik, accept rate over the four rows).
    """
    C = _chains(eta, 2)
    prior_alpha = _eta_prior(cfg, eta.device)
    n_acc = torch.zeros(loglik.shape, device=eta.device)
    kappa = _per(kappa, eta[..., 0, :])
    for a in range(NBASES):
        row = eta[..., a, :]
        alpha_fwd = kappa * row + cfg.proposal_floor
        row_prop = _dirichlet(noise.eta_row_prop(it, a, alpha_fwd), C)
        alpha_rev = kappa * row_prop + cfg.proposal_floor
        eta_prop = eta.clone()
        eta_prop[..., a, :] = row_prop
        ll_new = _loglik(n, mix, eta_prop, psum)
        log_ratio = (
            beta * (ll_new - loglik)
            + _each(C, torch.sum, (prior_alpha[a] - 1.0)
                    * (safe_log(row_prop) - safe_log(row)))
            + _dirichlet_logpdf(row, alpha_rev, C)
            - _dirichlet_logpdf(row_prop, alpha_fwd, C)
        )
        accept = safe_log(noise.eta_row_u(it, a)) < log_ratio
        eta = torch.where(_per(accept, eta), eta_prop, eta)
        loglik = torch.where(accept, ll_new, loglik)
        n_acc = n_acc + accept.to(torch.float32)
    return eta, loglik, n_acc / NBASES


def _staged_front(cfg: SamplerConfig, ks, n, state: SamplerState, it: int,
                  noise, temp, beta=1.0, psum=_own, into=None):
    """The sweep's tau, gamma and eta updates as separate steps: the tau
    sweep and swap kernels (or their plain versions), then gamma_step and
    eta_step_joint (or eta_step) as plain PyTorch ops.

    temp scales the Gumbel noise (a host float, or PT's device tensor: 0-d,
    or [C], one a chain); beta tempers every MH ratio, the swap's as a
    threshold logu / beta (the JAX package's Pallas swap; its XLA swap
    compares logu < beta * dll, the same decision but at float near-ties).
    psum adds the position shards' likelihood sums (the identity on one
    device). Returns (tau, mix, gamma, eta, loglik, acc_gamma, acc_eta). A
    state with a chain axis sweeps every chain in one tau and one swap
    launch. into: a state whose tau and mix buffers the swap and the gamma
    step write their outputs into (``make_sweep_fn``'s step), or None.
    """
    V, S, _ = n.shape[-3:]
    G = cfg.G
    if cfg.fix_tau:
        tau, mix = state.tau, state.mix
    else:
        gz = noise.gumbel(it, V, G)
        if _tempered(temp):
            gz = gz * _per(temp, gz)
        tau, mix = ks.tau_sweep(n, state.tau, state.mix, state.gamma,
                                state.eta, gz)
        if cfg.swap_moves and G > 1:
            g, h, logu = noise.swap(it, V, G)
            if _tempered(beta):
                logu = logu / _per(beta, logu)
            tau, mix = ks.swap(n, tau, mix, state.gamma, state.eta, g, h, logu,
                               tau_out=_field(into, "tau"))
    if cfg.fix_gamma:
        gamma = state.gamma
        acc_g = torch.zeros(state.loglik.shape, device=n.device)
        loglik = _loglik(n, mix, state.eta, psum)
    else:
        gamma, mix, acc_g, loglik = gamma_step(
            cfg, n, tau, mix, state.gamma, state.eta, state.kappa_gamma,
            noise, it, beta, psum, _field(into, "mix"))
    if cfg.fix_eta:
        eta, acc_e = state.eta, torch.zeros(state.loglik.shape, device=n.device)
    else:
        eta_fn = eta_step_joint if cfg.eta_update == "joint" else eta_step
        eta, loglik, acc_e = eta_fn(
            cfg, n, mix, state.eta, loglik, state.kappa_eta, noise, it, beta,
            psum)
    return tau, mix, gamma, eta, loglik, acc_g, acc_e


def _field(into, name: str):
    """Field `name` of a destination state or accumulators, None for none."""
    return None if into is None else getattr(into, name)


# the resident path's refusal of run modes it cannot honor (the JAX
# package's run-level wording)
RESIDENT_PLAIN_ONLY = (
    "the resident kernel supports plain/--chains runs only — "
    "auto_burn/auto_samples/pt/checkpoint need the composable 'cuda' kernel")
# and of a mesh (the JAX package's fit_grid wording, in the port's names)
RESIDENT_SINGLE_DEVICE = ("kernel 'cuda_resident' is single-device; "
                          "use 'cuda' with a mesh")


def make_sweep_fn(cfg: SamplerConfig, kernel="cuda", psum=_own):
    """Build the (n, state, accum, it, noise, burn=None, temp=None,
    beta=1.0) -> (state, accum, loglik) step; ``burn`` replaces cfg.burn in
    the kappa-adaptation and accumulation gates for that sweep (the anneal
    follows cfg.burn). A given ``temp`` replaces the anneal schedule with a
    fixed tau temperature, and ``beta`` tempers every MH acceptance
    (likelihood term only): together the sweep targets prior * L^beta, the
    per-replica kernel of ``run_chain_pt`` (temp = 1/beta). Both may be 0-d
    device tensors; temp=None, beta=1.0 is the plain chain, bit for bit.

    kernel: a kernel choice's name or its resolved ``ops.Kernels``. "cuda"
    runs the tau sweep and the swap move through the CUDA kernel wrappers
    (their plain versions on CPU tensors); "cuda_resident" runs the whole
    front half of the sweep on the resident kernels (``resident.front``:
    two launches a sweep); "cuda_topk" is "cuda" with the top-2 tau kernel,
    which is bound to the counts, so it comes as ``ops.resolve("cuda_topk",
    n)``; "torch" runs the plain versions everywhere. The kernel choice
    changes only the front half: adaptation and accumulators are this
    function's, for every choice.

    psum: the sum over position shards of a sharded chain
    (``parallel.sharded``: n, tau and mix hold one block of positions, and
    every likelihood sum goes through psum); the identity on one device.
    The resident kernels take no shards.

    A state and accumulators with a leading [C] axis (``init_states``,
    ``init_accum(chains=C)``) with a ``ChainNoise`` sweep C chains at once,
    on every kernel choice: chain c bitwise its own sweep. temp and beta
    may then be [C] device tensors, one a chain (PT's replicas), and n the
    chains' own counts [C,V,S,4].

    The sweep carries the function that does its work as ``sweep.step``,
    with the host's three decisions of sweep `it` made by the caller, and
    the anneal schedule as ``sweep.temperature(it)`` (a host float): the
    CUDA graphs of ``sweep_graph`` capture ``step`` once a phase.
    """
    ks = kernel if isinstance(kernel, Kernels) else resolve(kernel)
    if ks.resident and psum is not _own:
        raise ValueError(RESIDENT_SINGLE_DEVICE)
    if ks.resident:
        from . import resident

        resident.check_supported(cfg)
        front = resident.front
    else:
        front = _staged_front
    anneal = cfg.anneal_temp0 > 1.0 and cfg.burn > 0
    anneal_sweeps = max(int(cfg.burn * cfg.anneal_frac), 1)

    def temperature(it: int) -> float:
        # tempered burn-in: tau from p^(1/T), T annealing T0 -> 1 over the
        # first anneal_frac of burn (computed in f32, as the JAX sweep does)
        if not anneal:
            return 1.0
        t = np.float32(cfg.anneal_temp0) ** (
            np.float32(1.0) - np.float32(it) / np.float32(anneal_sweeps))
        return max(1.0, float(t))

    def step(n, state: SamplerState, accum: SamplerAccum, it: int, noise, temp,
             adapt: bool, accumulate: bool, beta=1.0, into=None):
        """Sweep `it` with the host's decisions made: temp (the tau
        temperature, a host float or a device tensor), whether kappa
        adapts, whether the sweep accumulates. into: the (state, accum)
        whose buffers the last writers of tau, mix, sum_tau and star_tau
        write into (a CUDA graph's static carry, which may be state and
        accum themselves: each of those is read before it is written), or
        None."""
        dst, dacc = (None, None) if into is None else into
        # positional: the benchmark's faults stand in for the front halves
        args = (cfg, ks, n, state, it, noise, temp)
        tau, mix, gamma, eta, loglik, acc_g, acc_e = (
            front(*args, dst) if ks.resident else front(*args, beta, psum, dst))

        # diminishing adaptation, burn-in only: larger kappa -> smaller
        # Dirichlet steps -> higher acceptance (frozen post-burn)
        kg, ke = state.kappa_gamma, state.kappa_eta
        if cfg.adapt_kappa:
            if adapt:
                kg = kg * torch.exp(cfg.adapt_rate * (cfg.target_accept - acc_g))
                ke = ke * torch.exp(cfg.adapt_rate * (cfg.target_accept - acc_e))
            kg = torch.clamp(kg, 10.0, 1e9)
            ke = torch.clamp(ke, 10.0, 1e10)

        new_state = SamplerState(tau=tau, gamma=gamma, eta=eta, mix=mix,
                                 loglik=loglik, kappa_gamma=kg, kappa_eta=ke)

        is_star = loglik > accum.star_loglik
        upd = dict(
            star_loglik=torch.where(is_star, loglik, accum.star_loglik),
            star_tau=torch.where(_per(is_star, tau), tau, accum.star_tau,
                                 out=_field(dacc, "star_tau")),
            star_gamma=torch.where(_per(is_star, gamma), gamma, accum.star_gamma),
            star_eta=torch.where(_per(is_star, eta), eta, accum.star_eta),
            acc_gamma=accum.acc_gamma + acc_g,
            acc_eta=accum.acc_eta + acc_e,
        )
        if accumulate:
            upd.update(
                sum_tau=torch.add(accum.sum_tau, one_hot_tau(tau),
                                  out=_field(dacc, "sum_tau")),
                sum_gamma=accum.sum_gamma + gamma,
                sum_eta=accum.sum_eta + eta,
                sum_loglik=accum.sum_loglik + loglik,
                n_samples=accum.n_samples + 1.0,
                acc_gamma_post=accum.acc_gamma_post + acc_g,
                acc_eta_post=accum.acc_eta_post + acc_e,
            )
        return new_state, accum._replace(**upd), loglik

    def sweep(n, state: SamplerState, accum: SamplerAccum, it: int, noise,
              burn: Optional[int] = None, temp=None, beta=1.0):
        burn = cfg.burn if burn is None else burn
        if ks.resident and (temp is not None or _tempered(beta)):
            raise ValueError(RESIDENT_PLAIN_ONLY)
        temp = temperature(it) if temp is None else temp
        return step(n, state, accum, it, noise, temp, it < burn, it >= burn, beta)

    sweep.step = step
    sweep.temperature = temperature
    return sweep


def init_state(
    n: torch.Tensor,
    cfg: SamplerConfig,
    generator: torch.Generator,
    eta_init: Optional[torch.Tensor] = None,
    tau_init: Optional[torch.Tensor] = None,
    gamma_init: Optional[torch.Tensor] = None,
    block: Optional[tuple] = None,
    psum=_own,
) -> SamplerState:
    """NMF-initialized (or user-supplied) chain state on n's device.

    With tau_init and no gamma_init (known haplotypes, desman -t/-f) gamma
    starts from ``nmf.em_gamma`` and no NMF runs, so the generator is not
    drawn from.

    block = (lo, hi): a position shard's state (``parallel.sharded``). The
    NMF or EM start runs on the full counts n, as on one device, so the
    generator is drawn from alike; tau and mix keep rows [lo, hi), and the
    loglik and the kappa warm start's total sum through psum.
    """
    dev = n.device
    if eta_init is None:
        eta = (torch.full((NBASES, NBASES), 0.01 / 3.0, device=dev)
               + torch.eye(NBASES, device=dev) * (0.99 - 0.01 / 3.0))
    else:
        eta = torch.as_tensor(eta_init, dtype=torch.float32,
                              device=dev).contiguous()
    with span("chains.init"):   # the NMF or EM start
        if tau_init is not None and gamma_init is None:
            tau = torch.as_tensor(tau_init, device=dev).to(torch.int32)
            gamma = em_gamma(n, tau, eta)
        elif tau_init is None or gamma_init is None:
            tau, gamma = nmf_init(n, cfg.G, generator, iters=cfg.nmf_iters)
            if gamma_init is not None:
                gamma = gamma_init
        else:
            tau, gamma = tau_init, gamma_init
    tau = torch.as_tensor(tau, device=dev).to(torch.int32).contiguous()
    gamma = torch.as_tensor(gamma, device=dev).to(torch.float32).contiguous()
    if block is not None:
        lo, hi = block
        n, tau = n[lo:hi], tau[lo:hi].contiguous()
    mix = mixture(one_hot_tau(tau), gamma)
    loglik = _loglik(n, mix, eta, psum)
    # curvature warm start, floored at the classic fixed scales so tiny
    # datasets keep usable step sizes
    total = psum(torch.sum(n))
    if cfg.kappa_gamma > 0:
        kg0 = torch.tensor(cfg.kappa_gamma, dtype=torch.float32, device=dev)
    else:
        kg0 = torch.clamp_min(total / n.shape[1] / 32.0, 100.0)
    if cfg.kappa_eta > 0:
        ke0 = torch.tensor(cfg.kappa_eta, dtype=torch.float32, device=dev)
    else:
        ke0 = torch.clamp_min(total, 1000.0)
    return SamplerState(tau=tau, gamma=gamma, eta=eta, mix=mix, loglik=loglik,
                        kappa_gamma=kg0, kappa_eta=ke0)


def init_states(n: torch.Tensor, cfg: SamplerConfig, generators,
                eta_init: Optional[torch.Tensor] = None,
                tau_init: Optional[torch.Tensor] = None,
                gamma_init: Optional[torch.Tensor] = None) -> SamplerState:
    """The starts of len(generators) chains, stacked on a leading [C] axis:
    chain c's ``init_state`` from generator c (its NMF start drawn from it,
    as ``run_chain`` draws it) on the shared counts n [V,S,4], or on chain
    c's own n[c] of [C,V,S,4]."""
    states = [init_state(n if n.dim() == 3 else n[c], cfg, g, eta_init, tau_init,
                         gamma_init) for c, g in enumerate(generators)]
    return SamplerState(*(torch.stack(f) for f in zip(*states)))


def init_accum(V: int, S: int, G: int, device, chains: Optional[int] = None
               ) -> SamplerAccum:
    """Fresh accumulators of one chain, or with chains=C of C chains on a
    leading [C] axis."""
    f32 = dict(dtype=torch.float32, device=device)
    lead = () if chains is None else (chains,)

    def scalar(x):
        return torch.full(lead, x, **f32)

    return SamplerAccum(
        sum_tau=torch.zeros((*lead, V, G, NBASES), **f32),
        sum_gamma=torch.zeros((*lead, S, G), **f32),
        sum_eta=torch.zeros((*lead, NBASES, NBASES), **f32),
        sum_loglik=scalar(0.0),
        n_samples=scalar(0.0),
        star_loglik=scalar(-float("inf")),
        star_tau=torch.zeros((*lead, V, G), dtype=torch.int32, device=device),
        star_gamma=torch.zeros((*lead, S, G), **f32),
        star_eta=torch.zeros((*lead, NBASES, NBASES), **f32),
        acc_gamma=scalar(0.0),
        acc_eta=scalar(0.0),
        acc_gamma_post=scalar(0.0),
        acc_eta_post=scalar(0.0),
    )


def _result_from_accum(accum: SamplerAccum, cfg: SamplerConfig,
                       trace: torch.Tensor, **draws) -> SamplerResult:
    """Posterior means + star snapshot from a finished accumulator (one
    chain's, or chains' with a leading axis) and the stored draws, when
    there are any."""
    with span("chains.summaries"):
        n_s = torch.clamp_min(accum.n_samples, 1.0)
        return SamplerResult(
            tau_mean=accum.sum_tau / _per(n_s, accum.sum_tau),
            tau_star=accum.star_tau,
            gamma_mean=accum.sum_gamma / _per(n_s, accum.sum_gamma),
            gamma_star=accum.star_gamma,
            eta_mean=accum.sum_eta / _per(n_s, accum.sum_eta),
            eta_star=accum.star_eta,
            mean_loglik=accum.sum_loglik / n_s,
            star_loglik=accum.star_loglik,
            loglik_trace=trace,
            accept_gamma=accum.acc_gamma / cfg.total_sweeps,
            accept_eta=accum.acc_eta / cfg.total_sweeps,
            accept_gamma_post=accum.acc_gamma_post / n_s,
            accept_eta_post=accum.acc_eta_post / n_s,
            **draws,
        )


def stored_slots(start_it: int, n_sweeps: int, burn: int, thin: int) -> list:
    """Local indices of the draws a segment [start_it, start_it+n_sweeps)
    keeps: the state after absolute sweep a with a >= burn and
    (a - burn + 1) % thin == 0, the grid of a whole chain's stored draws."""
    thin = max(int(thin), 1)
    return [j for j in range(n_sweeps)
            if start_it + j >= burn and (start_it + j - burn + 1) % thin == 0]


def run_segment(n: torch.Tensor, cfg: SamplerConfig, state: SamplerState,
                accum: SamplerAccum, start_it: int, n_sweeps: int, noise,
                kernel="cuda", burn: Optional[int] = None, store: bool = False,
                psum=_own, agree=None):
    """Advance a chain n_sweeps sweeps from absolute sweep index start_it.

    Returns (state, accum, trace): the [n_sweeps] loglik trace is
    preallocated on n's device and filled sweep by sweep, so nothing waits
    for the device. With ``store`` a fourth item holds the (tau int8, gamma,
    eta) draws [k, ...] of the k sweeps ``stored_slots`` selects (burn: the
    override or cfg.burn; thin: cfg.store_thin), copied into buffers on the
    device; storing reads the state and changes nothing. ``burn`` has the
    sweep's meaning (``make_sweep_fn``), and so has psum; agree has
    ``check_finite``'s (the NaN trap, when on). Segments run in order from
    one noise source give the draws and the trajectory of one long segment.
    A state with a leading [C] axis and a ``ChainNoise`` advance C chains in
    one sweep: the trace is [C, n_sweeps] and the draws [C, k, ...]; n may
    then hold each chain's own counts [C,V,S,4].

    On a CUDA device, with no position shards, draws from torch.Generators
    alone and the NaN trap off, each sweep is one replay of a CUDA graph of
    its phase (``sweep_graph``), bit for bit the eager sweep; elsewhere the
    sweeps run eagerly. The ``chains.sweeps`` span says which: ``graphed``
    sweeps were replayed, ``captures`` graphs captured in the segment.
    """
    from . import sweep_graph   # it imports this module

    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    sweep = make_sweep_fn(cfg, kernel, psum)
    V, S, _ = n.shape[-3:]
    dev = n.device
    lead = state.loglik.shape   # () or the chains' (C,)
    trace = torch.empty((*lead, n_sweeps), dtype=torch.float32, device=dev)
    slots = (stored_slots(start_it, n_sweeps, cfg.burn if burn is None else burn,
                          cfg.store_thin) if store else [])
    k = len(slots)
    draws = (torch.empty((*lead, k, V, cfg.G), dtype=torch.int8, device=dev),
             torch.empty((*lead, k, S, cfg.G), dtype=torch.float32, device=dev),
             torch.empty((*lead, k, NBASES, NBASES), dtype=torch.float32, device=dev))
    graphs = (sweep_graph.lookup(cfg, kernel, n, state, accum, noise, psum)
              if n_sweeps else None)
    advance = sweep if graphs is None else graphs.segment(cfg, sweep, noise)
    with span("chains.sweeps", sweeps=n_sweeps, chains=state.loglik.numel()) as s:
        j = 0
        for i in range(n_sweeps):
            state, accum, ll = advance(n, state, accum, start_it + i, noise, burn=burn)
            if _NAN_TRAP:
                check_finite(start_it + i, [state], agree)
            trace[..., i] = ll
            if j < k and slots[j] == i:
                for buf, x in zip(draws, (state.tau, state.gamma, state.eta)):
                    buf[..., j, :, :] = x
                j += 1
        if graphs is None:
            s.attrs.update(graphed=0, captures=0)
        else:
            state, accum = advance.release(state, accum)
            s.attrs.update(graphed=advance.replayed, captures=advance.captured)
    return (state, accum, trace, draws) if store else (state, accum, trace)


def check_store_thin(cfg: SamplerConfig) -> None:
    thin = max(int(cfg.store_thin), 1)
    if cfg.store_samples and cfg.samples % thin != 0:
        raise ValueError(f"store_thin={thin} must divide samples={cfg.samples}")


def run_chain(
    n: torch.Tensor,
    cfg: SamplerConfig,
    generator: torch.Generator,
    eta_init: Optional[torch.Tensor] = None,
    tau_init: Optional[torch.Tensor] = None,
    gamma_init: Optional[torch.Tensor] = None,
    kernel="cuda",
    noise=None,
) -> SamplerResult:
    """Run one chain end to end (init -> one segment of every sweep ->
    summaries) on n's device. n: [V,S,4] counts, cast to f32 once.
    kernel: a kernel choice's name (bound here to n) or an ``ops.Kernels``
    already resolved for n.

    Nothing is fetched to the host until the caller asks. With
    cfg.store_samples the state after every store_thin-th post-burn sweep
    (draw j after sweep burn + (j+1)*thin - 1) is kept on the device, and
    the trajectory is bitwise the one without storage.
    """
    with span("chains", chains=1):
        n = n.to(torch.float32)
        if not isinstance(kernel, Kernels):
            kernel = resolve(kernel, n)
        make_sweep_fn(cfg, kernel)   # the resident path's refusals, before the start
        check_store_thin(cfg)
        V, S, _ = n.shape
        state = init_state(n, cfg, generator, eta_init, tau_init, gamma_init)
        accum = init_accum(V, S, cfg.G, n.device)
        noise = TorchNoise(generator) if noise is None else noise
        out = run_segment(n, cfg, state, accum, 0, cfg.total_sweeps, noise, kernel,
                          store=cfg.store_samples)
        draws = dict(zip(DRAW_FIELDS, out[3])) if cfg.store_samples else {}
        return _result_from_accum(out[1], cfg, out[2], **draws)


def chain_generator(seed: int, device) -> torch.Generator:
    """A chain's generator on `device`, seeded `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def run_chains(
    n: torch.Tensor,
    cfg: SamplerConfig,
    seeds,
    eta_init: Optional[torch.Tensor] = None,
    kernel="cuda",
    tau_init: Optional[torch.Tensor] = None,
) -> SamplerResult:
    """Independent chains over seeds, stacked on a leading axis (the JAX
    package's ``run_chains``, whose vmap is the chain axis here).

    Chain i draws from its own ``torch.Generator`` on n's device, seeded
    with seeds[i]; the chains start from their own NMF starts and then
    advance together, one sweep of all of them at a time (``ChainNoise``,
    the chain-axis kernels, the resident ones included), so chain i is
    bitwise ``run_chain`` of that seed. The kernel choice is resolved once
    for all chains. n: the counts [V,S,4] the chains share, or each chain's
    own [C,V,S,4] (``multibin``'s padded bins: chain i is then
    ``run_chain`` of n[i]). Fields that are None (no stored draws) stay
    None.
    """
    with span("chains", chains=len(seeds)):
        n = n.to(torch.float32)
        if not isinstance(kernel, Kernels):
            kernel = resolve(kernel, n)
        make_sweep_fn(cfg, kernel)   # the resident path's refusals, before the start
        check_store_thin(cfg)
        V, S, _ = n.shape[-3:]
        generators = [chain_generator(seed, n.device) for seed in seeds]
        state = init_states(n, cfg, generators, eta_init, tau_init)
        accum = init_accum(V, S, cfg.G, n.device, chains=len(generators))
        noise = ChainNoise(TorchNoise(g) for g in generators)
        out = run_segment(n, cfg, state, accum, 0, cfg.total_sweeps, noise, kernel,
                          store=cfg.store_samples)
        draws = dict(zip(DRAW_FIELDS, out[3])) if cfg.store_samples else {}
        return _result_from_accum(out[1], cfg, out[2], **draws)


def chain_result(res: SamplerResult, i: int) -> SamplerResult:
    """Chain i of ``run_chains``' stacked result (None fields stay None)."""
    return SamplerResult(*(None if x is None else x[i] for x in res))


# --------------------------------------------------------------------------
# parallel tempering (replica exchange)
# --------------------------------------------------------------------------

class ExchangeNoise:
    """The replica exchange's uniforms, from a generator of their own.
    ``exchange_u`` takes the sweep index, as ``TorchNoise``'s methods do, so
    that a replay source can rebuild another package's stream."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def exchange_u(self, it: int, R: int) -> torch.Tensor:
        return torch.rand((R,), generator=self.generator,
                          device=self.generator.device)


def spawn_seeds(seed: int, k: int) -> list:
    """k generator seeds from one seed: the first 64-bit word of each child
    of ``np.random.SeedSequence(seed).spawn(k)``. The children of distinct
    seeds are distinct streams."""
    children = np.random.SeedSequence(int(seed)).spawn(k)
    return [int(c.generate_state(1, np.uint64)[0]) for c in children]


def pt_seeds(seed: int, R: int) -> list:
    """The R + 1 generator seeds of a PT run from its seed:
    ``spawn_seeds(seed, R + 1)``, children 0..R-1 for the replicas and
    child R for the exchange, so the runs of --chains (seeds seed .. seed +
    C - 1) share no generator."""
    return spawn_seeds(seed, R + 1)


def pt_generators(seed: int, R: int, device) -> list:
    """The R replica generators and the exchange generator of ``pt_seeds``."""
    return [chain_generator(s, device) for s in pt_seeds(seed, R)]


def pt_ladder(R: int, max_temp: float, device) -> torch.Tensor:
    """Geometric temperature ladder [R] f32, rung 0 cold (T=1), computed on
    the CPU so that every device holds the same ladder."""
    r = torch.arange(R, dtype=torch.float32)
    ladder = torch.tensor(max_temp, dtype=torch.float32) ** (r / (R - 1))
    return ladder.to(device)


def pt_init(n, cfg: SamplerConfig, generators, eta_init=None, tau_init=None,
            gamma_init=None):
    """(state, accum, rung) of a replica-exchange run: the replicas' starts
    on a leading [R] axis, one a generator given (the R replicas', not the
    exchange's), each drawing its NMF start from it (``init_states``),
    fresh accumulators (``init_accum(chains=R)``), and rung [R] = arange(R)
    (int64 on n's device: replica i holds ladder rung rung[i])."""
    V, S, _ = n.shape
    R = len(generators)
    return (init_states(n, cfg, generators, eta_init, tau_init, gamma_init),
            init_accum(V, S, cfg.G, n.device, chains=R),
            torch.arange(R, device=n.device))


def _keep_cold(is_cold, new: SamplerAccum, old: SamplerAccum) -> SamplerAccum:
    """The sweep's accumulators where the replica held the cold rung
    (is_cold [R], one a replica), the pre-sweep ones elsewhere (the fields
    the sweep left alone pass as they are)."""
    return SamplerAccum(*(o if x is o else torch.where(_per(is_cold, x), x, o)
                          for x, o in zip(new, old)))


class ReplicaShard(NamedTuple):
    """This rank's part of a PT ensemble on a mesh (``parallel.sharded``):
    the global indices of the replicas it holds (its chain row's share of
    the R), psum over the row's position blocks, gather from the row's
    stacked [3, k] (loglik, kappa_gamma, kappa_eta) to the ensemble's
    [3, R] (the chain axis's one exchange a sweep; None on a chain axis of
    one rank) and agree, the NaN trap's sum over the world."""

    replicas: range
    psum: object
    gather: object
    agree: object


def make_pt_step(n, cfg: SamplerConfig, R: int, max_temp: float,
                 kernel="cuda", burn: Optional[int] = None,
                 shard: Optional[ReplicaShard] = None):
    """One PT ensemble sweep + exchange: the JAX package's ``make_pt_step``,
    whose vmap over the replicas is the chain axis here.

    Returns step(state, accum, rung, it, noise, exchange) -> (state, accum,
    rung, cold_ll, n_acc, n_heads). rung [..., R] holds a row a run: [R]
    for one run, [C,R] for C runs (``run_chains_pt``); exchange is a list
    of one source a row. state and accum hold the runs' replicas on one
    leading axis (run c's at c*R ...) and sweep once for all of them
    (``make_sweep_fn`` with a ``ChainNoise`` of the replicas' sources,
    temps and betas one a replica at the temperature of its rung: replica
    i bitwise its own sweep). Each run's exchange proposes swapping the
    temperatures of the replicas holding rungs (r, r+1), alternating
    parity by sweep, with its source's ``exchange_u(it, R)``. cold_ll is
    the loglik of the replica that was cold during the sweep, n_acc the
    accepted exchanges (f32 on the device; both rung.shape[:-1]), n_heads
    the proposals (a host int: it depends on it and R only). ``rung``
    stays on the device and nothing waits for it. ``burn`` has the sweep's
    meaning. Run c is bitwise the step of run c alone.

    ``shard``: the step of one rank of a mesh, n its block of positions.
    state, accum and noise are those of ``shard.replicas``; the exchange
    takes every replica's loglik and kappas through ``shard.gather``, so
    every rank holds the same [R] vectors, draws the same uniforms from its
    copy of the exchange generator and computes the same rung. None: all R
    replicas here, the one-device step.
    """
    ks = kernel if isinstance(kernel, Kernels) else resolve(kernel, n)
    if ks.resident:
        raise ValueError(RESIDENT_PLAIN_ONLY)
    local = None if shard is None else shard.replicas
    gather = None if shard is None else shard.gather
    sweep = make_sweep_fn(cfg, ks, _own if shard is None else shard.psum)
    dev = n.device
    ladder = pt_ladder(R, max_temp, dev)
    beta_ladder = 1.0 / ladder
    dbeta = beta_ladder - torch.roll(beta_ladder, -1)   # b_r - b_{r+1}
    idx = torch.arange(R, device=dev)
    up, down = idx + 1, idx - 1
    heads = [((idx % 2) == p) & (idx + 1 < R) for p in (0, 1)]
    n_heads = [sum(1 for i in range(R) if i % 2 == p and i + 1 < R)
               for p in (0, 1)]
    first = torch.zeros(1, dtype=torch.bool, device=dev)

    def mine(x):
        """This rank's replicas of an ensemble-wide [R] vector (all of them
        without a shard)."""
        return x if local is None else x[local.start:local.stop]

    # index_select and gather, not x[idx]: advanced indexing costs the host
    # several times more a call
    def step(state, accum, rung, it: int, noise, exchange):
        shape = rung.shape                       # [R], or the runs' [C,R]
        temps = ladder.index_select(0, rung.reshape(-1))
        betas = 1.0 / temps
        is_cold = rung == 0
        st, ac, lls = sweep(n, state, accum, it, noise, burn=burn,
                            temp=mine(temps), beta=mine(betas))
        # hot replicas draw from tempered targets: keep their pre-sweep
        # accumulators, star included
        ac = _keep_cold(mine(is_cold.reshape(-1)), ac, accum)
        kg, ke = st.kappa_gamma, st.kappa_eta
        if gather is not None:   # the other rows' replicas: one exchange
            lls, kg, ke = gather(torch.stack([lls, kg, ke]))
        lls, kg, ke = lls.reshape(shape), kg.reshape(shape), ke.reshape(shape)

        order = torch.argsort(rung, dim=-1)           # rung -> replica
        ll_by_rung = lls.gather(-1, order)
        delta = dbeta * (torch.roll(ll_by_rung, -1, -1) - ll_by_rung)
        is_head = heads[it % 2]
        u = torch.stack([e.exchange_u(it, R) for e in exchange]).reshape(shape)
        acc = is_head & (safe_log(u) < delta)
        acc_prev = torch.cat([first.expand(*shape[:-1], 1), acc[..., :-1]], dim=-1)
        # old rung -> new rung (disjoint adjacent transpositions)
        rung_perm = torch.where(acc, up, torch.where(acc_prev, down, idx))
        new_rung = rung_perm.gather(-1, rung)
        # adapted proposal scales belong to the rung, not the replica: the
        # new holder of rung new_rung[i] takes its old holder's kappas
        src = order.gather(-1, new_rung)
        st = st._replace(kappa_gamma=mine(kg.gather(-1, src).reshape(-1)),
                         kappa_eta=mine(ke.gather(-1, src).reshape(-1)))
        cold_ll = torch.sum(torch.where(is_cold, lls, 0.0), dim=-1)
        n_acc = torch.sum(acc.to(torch.float32), dim=-1)
        return st, ac, new_rung, cold_ll, n_acc, n_heads[it % 2]

    return step


def pt_noises(generators):
    """The replicas' noise (a ``ChainNoise`` of one ``TorchNoise`` a
    replica) and the exchange's (a list of the one run's
    ``ExchangeNoise``, as ``make_pt_step`` takes it), from the R + 1
    generators of ``pt_generators``."""
    return (ChainNoise(TorchNoise(g) for g in generators[:-1]),
            [ExchangeNoise(generators[-1])])


def run_pt_segment(n, cfg: SamplerConfig, state, accum, rung, start_it: int,
                   n_sweeps: int, noise, exchange, max_temp: float,
                   kernel="cuda", burn: Optional[int] = None, store: bool = False,
                   shard: Optional[ReplicaShard] = None):
    """Advance a PT ensemble n_sweeps from absolute sweep index start_it
    (state and accum with the replicas on a leading axis, ``make_pt_step``).

    Returns (state, accum, rung, trace, n_acc, n_heads): trace [n_sweeps]
    holds each sweep's cold_ll on n's device, n_acc the segment's accepted
    exchanges (0-d f32 on the device), n_heads its proposals (host int).
    With ``store`` a seventh item holds the (tau int8, gamma, eta) draws of
    the sweeps ``stored_slots`` selects, taken from the replica holding rung
    0 after the sweep's exchange. ``burn`` has the sweep's meaning.
    Segments run in order from the same noise sources give the draws and
    the trajectory of one long segment. C runs (rung [C,R]): trace [C,
    n_sweeps], n_acc [C] and the draws [C, k, ...], run c's each.

    ``shard``: one rank's part of the ensemble on a mesh (``make_pt_step``);
    the rung, trace and n_acc are the whole ensemble's on every rank, and a
    stored draw is the cold replica's where this rank holds it, zeros where
    another row does (``parallel.sharded`` adds the rows' draws).
    """
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    R = rung.shape[-1]
    runs = rung.shape[:-1]
    local = range(R) if shard is None else shard.replicas
    step = make_pt_step(n, cfg, R, max_temp, kernel, burn=burn, shard=shard)
    V, S, _ = n.shape
    dev = n.device
    trace = torch.empty((*runs, n_sweeps), dtype=torch.float32, device=dev)
    n_acc = torch.zeros(runs, dtype=torch.float32, device=dev)
    n_heads = 0
    slots = (stored_slots(start_it, n_sweeps, cfg.burn if burn is None else burn,
                          cfg.store_thin) if store else [])
    k = len(slots)
    draws = (torch.empty((*runs, k, V, cfg.G), dtype=torch.int8, device=dev),
             torch.empty((*runs, k, S, cfg.G), dtype=torch.float32, device=dev),
             torch.empty((*runs, k, NBASES, NBASES), dtype=torch.float32, device=dev))
    # each run's first replica on the flat axis
    run_base = torch.arange(0, rung.numel(), R, device=dev)
    agree = None if shard is None else shard.agree
    with span("chains.sweeps", sweeps=n_sweeps, chains=state.loglik.numel()):
        j = 0
        for i in range(n_sweeps):
            state, accum, rung, cold_ll, acc, heads = step(
                state, accum, rung, start_it + i, noise, exchange)
            if _NAN_TRAP:
                check_finite(start_it + i, [state], agree)
            trace[..., i] = cold_ll
            n_acc = n_acc + acc
            n_heads += heads
            if j < k and slots[j] == i:
                cold = torch.argmin(rung, dim=-1).reshape(-1)   # each run's rung 0
                if len(local) < R:   # on this row, or zeros
                    mine = (cold >= local.start) & (cold < local.stop)
                    cold = torch.clamp(cold - local.start, 0, len(local) - 1)
                else:
                    cold = cold + run_base
                for buf, field in zip(draws, ("tau", "gamma", "eta")):
                    x = getattr(state, field).index_select(0, cold)
                    if len(local) < R:
                        x = torch.where(mine, x[0], 0)
                    buf[..., j, :, :] = x.reshape(*runs, *x.shape[-2:])
                j += 1
    out = (state, accum, rung, trace, n_acc, n_heads)
    return out + (draws,) if store else out


def pt_merge_accums(accum: SamplerAccum) -> SamplerAccum:
    """Merge the replicas' cold-rung records (their accumulators on a
    leading [R] axis): sums add, the star is the replica's with the highest
    star loglik (the first on a tie)."""
    return pt_merge_stacked(accum, torch.argmax(accum.star_loglik).reshape(1))


def pt_merge_runs(accum: SamplerAccum, C: int) -> SamplerAccum:
    """``pt_merge_accums`` of each of C runs on a [C*R] axis, stacked on a
    leading [C] axis: run c's on a copy of its replicas' slice, so its sums
    run as run c's alone (a slice may not start where torch's vectorized
    reductions would start a tensor of its own)."""
    R = accum.star_loglik.shape[0] // C
    return SamplerAccum(*(torch.stack(f) for f in zip(*(
        pt_merge_accums(SamplerAccum(*(x[c * R:(c + 1) * R].clone() for x in accum)))
        for c in range(C)))))


def pt_merge_stacked(stacked: SamplerAccum, star: torch.Tensor) -> SamplerAccum:
    """``pt_merge_accums`` of the replicas' accumulators stacked on a
    leading [R] axis, the star replica's index given ([1]). Fields given as
    None stay None (a mesh merges its per-position fields itself)."""

    def pick(x):
        return None if x is None else x.index_select(0, star)[0]

    def total(x):
        return None if x is None else x.sum(0)

    # exactly one replica is cold each sweep, so the acceptance sums across
    # replicas already total one value a sweep
    return SamplerAccum(
        sum_tau=total(stacked.sum_tau), sum_gamma=stacked.sum_gamma.sum(0),
        sum_eta=stacked.sum_eta.sum(0), sum_loglik=stacked.sum_loglik.sum(0),
        n_samples=stacked.n_samples.sum(0),
        star_loglik=pick(stacked.star_loglik), star_tau=pick(stacked.star_tau),
        star_gamma=pick(stacked.star_gamma), star_eta=pick(stacked.star_eta),
        acc_gamma=stacked.acc_gamma.sum(0), acc_eta=stacked.acc_eta.sum(0),
        acc_gamma_post=stacked.acc_gamma_post.sum(0),
        acc_eta_post=stacked.acc_eta_post.sum(0))


def pt_swap_rate(n_acc: torch.Tensor, n_heads: float) -> torch.Tensor:
    """Accepted exchanges per proposal (sweeps whose parity has no pair
    propose nothing), the same f32 division on every path."""
    return n_acc / torch.tensor(max(float(n_heads), 1.0), dtype=torch.float32,
                                device=n_acc.device)


def run_chain_pt(
    n: torch.Tensor,
    cfg: SamplerConfig,
    seed: int,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    eta_init: Optional[torch.Tensor] = None,
    tau_init: Optional[torch.Tensor] = None,
    gamma_init: Optional[torch.Tensor] = None,
    kernel="cuda",
) -> SamplerResult:
    """Parallel tempering (replica exchange) on n's device.

    R replicas on the ladder T_r = max_temp^(r/(R-1)) (rung 0 cold) each
    target prior * L^(1/T_r): the Gumbel noise of the tau sweep is scaled
    by T_r and every MH ratio's likelihood term by 1/T_r. After every
    ensemble sweep (one sweep of all R replicas on the chain axis) adjacent
    rungs (alternating parity) exchange their temperatures with probability
    min(1, exp((b_r - b_{r+1}) (ll_{r+1} - ll_r))). Accumulators and the
    star record only while a replica holds the cold rung; with
    cfg.store_samples the stored draws are the cold replica's after each
    kept sweep's exchange. The loglik trace is the cold rung's. The
    generators come from ``pt_seeds(seed, R)``; R < 2 is ``run_chain`` with
    a generator seeded `seed`, bit for bit.
    """
    n = n.to(torch.float32)
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    R = int(n_replicas)
    if R < 2:
        return run_chain(n, cfg, chain_generator(seed, n.device), eta_init=eta_init,
                         tau_init=tau_init, gamma_init=gamma_init, kernel=kernel)
    with span("chains", chains=R):
        make_pt_step(n, cfg, R, max_temp, kernel)   # the refusals, before the start
        check_store_thin(cfg)
        generators = pt_generators(seed, R, n.device)
        state, accum, rung = pt_init(n, cfg, generators[:R], eta_init, tau_init,
                                     gamma_init)
        noise, exchange = pt_noises(generators)
        out = run_pt_segment(n, cfg, state, accum, rung, 0, cfg.total_sweeps,
                             noise, exchange, max_temp, kernel,
                             store=cfg.store_samples)
        draws = dict(zip(DRAW_FIELDS, out[6])) if cfg.store_samples else {}
        return _result_from_accum(pt_merge_accums(out[1]), cfg, out[3],
                                  pt_swap_accept=pt_swap_rate(out[4], out[5]), **draws)


def run_chains_pt(
    n: torch.Tensor,
    cfg: SamplerConfig,
    seeds,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    eta_init: Optional[torch.Tensor] = None,
    tau_init: Optional[torch.Tensor] = None,
    kernel="cuda",
) -> SamplerResult:
    """Independent PT runs over seeds, stacked on a leading axis (the JAX
    package's ``run_chains_pt``, a vmap over runs of the vmap over
    replicas): the C runs' R replicas sweep as one [C*R] chain axis, each
    run exchanging on its own rung row with its own exchange generator, so
    run i is bitwise ``run_chain_pt`` of seeds[i]. R < 2 is ``run_chains``
    of the seeds."""
    n = n.to(torch.float32)
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    R = int(n_replicas)
    if R < 2:
        return run_chains(n, cfg, seeds, eta_init=eta_init, kernel=kernel,
                          tau_init=tau_init)
    with span("chains", chains=R * len(seeds)):
        make_pt_step(n, cfg, R, max_temp, kernel)   # the refusals, before the start
        check_store_thin(cfg)
        runs = [pt_generators(seed, R, n.device) for seed in seeds]
        replicas = [g for gens in runs for g in gens[:R]]
        state, accum, _ = pt_init(n, cfg, replicas, eta_init, tau_init)
        rung = torch.arange(R, device=n.device).repeat(len(runs), 1)
        out = run_pt_segment(n, cfg, state, accum, rung, 0, cfg.total_sweeps,
                             ChainNoise(TorchNoise(g) for g in replicas),
                             [ExchangeNoise(gens[R]) for gens in runs], max_temp,
                             kernel, store=cfg.store_samples)
        draws = dict(zip(DRAW_FIELDS, out[6])) if cfg.store_samples else {}
        return _result_from_accum(pt_merge_runs(out[1], len(runs)), cfg, out[3],
                                  pt_swap_accept=pt_swap_rate(out[4], out[5]), **draws)
