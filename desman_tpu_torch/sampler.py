"""The tau/gamma/eta Gibbs sampler in eager PyTorch (counterpart of
``desman_tpu.sampler``).

One sweep =

  1. **tau update** — exact Gibbs over strains in turn, all positions in
     parallel (``ops.tau_sweep``: the CUDA kernel, or its plain version),
     then one strain-pair swap MH move at every position (``ops.swap``).
  2. **gamma update** — MH-within-Gibbs with a Dirichlet(kappa*gamma)
     random-walk proposal, all S samples accepted in parallel.
  3. **eta update** — one blocked Dirichlet MH step on the whole 4x4 matrix
     (skipped when eta is fixed from the filter's tran_df).

The JAX package's ``lax.scan`` is a Python loop over sweeps here. Whatever
depends only on the sweep index (the anneal temperature, whether kappa is
still adapting, whether the sweep is a sample) is a host float or bool;
whatever depends on device state (accept masks, the star snapshot, the swap
pair) stays on the device through ``torch.where``, so a sweep never waits
for the device. All randomness comes from a noise source passed to the
sweep: ``TorchNoise`` draws from the chain's ``torch.Generator``.

With ``kernel="cuda_resident"`` steps 1-3 run as two kernel launches a
sweep (``resident.front``), with the same draws in the same order; only
the [S]- and [4,4]-sized MH arithmetic stays as PyTorch ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .likelihood import mixture
from .nmf import nmf_init
from .ops import Kernels, draw_gumbel, draw_swap_proposal, resolve
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
    eta_update: str = "joint"     # "rows" is not ported yet
    fix_gamma: bool = False       # freeze abundances (known mixtures / tests)
    fix_tau: bool = False         # freeze haplotypes, fit gamma/eta
    store_samples: bool = False   # not ported yet
    store_thin: int = 1
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


def _dirichlet_logpdf(x, alpha):
    """Row-wise Dirichlet log-density; x, alpha [..., K] -> [...]."""
    return (
        torch.sum((alpha - 1.0) * safe_log(x), dim=-1)
        + torch.lgamma(torch.sum(alpha, dim=-1))
        - torch.sum(torch.lgamma(alpha), dim=-1)
    )


def _dirichlet(gammas):
    """Dirichlet draw from Gamma variates, floored away from the boundary."""
    g = torch.clamp_min(gammas, _GAMMA_FLOOR)
    return g / torch.sum(g, dim=-1, keepdim=True)


def _loglik(n, mix, eta):
    """sum n * log(mix @ eta)."""
    return torch.sum(n * safe_log(torch.einsum("vsa,ab->vsb", mix, eta)))


def _eta_prior(cfg: SamplerConfig, device) -> torch.Tensor:
    return (torch.full((NBASES, NBASES), cfg.eta_prior_off, device=device)
            + torch.eye(NBASES, device=device)
            * (cfg.eta_prior_diag - cfg.eta_prior_off))


def _gamma_proposal(cfg: SamplerConfig, gamma, kappa, noise, it: int):
    """The per-sample Dirichlet random-walk proposal:
    (gamma_prop, alpha_fwd, alpha_rev)."""
    alpha_fwd = kappa * gamma + cfg.proposal_floor                    # [S,G]
    gamma_prop = _dirichlet(noise.gamma_prop(it, alpha_fwd))
    alpha_rev = kappa * gamma_prop + cfg.proposal_floor
    return gamma_prop, alpha_fwd, alpha_rev


def _gamma_accept(gamma, gamma_prop, alpha_fwd, alpha_rev, ll_old, ll_new,
                  noise, it: int):
    """The per-sample MH decisions from the per-sample likelihood pair:
    (accept [S] bool, gamma, loglik). The old/new terms of the ratio
    already give the post-update total loglik."""
    # symmetric Dirichlet(1) prior on gamma rows -> prior ratio = 0
    log_ratio = (
        (ll_new - ll_old)
        + _dirichlet_logpdf(gamma, alpha_rev)
        - _dirichlet_logpdf(gamma_prop, alpha_fwd)
    )
    accept = safe_log(noise.gamma_u(it, gamma.shape[0])) < log_ratio
    gamma = torch.where(accept[:, None], gamma_prop, gamma)
    loglik = torch.sum(torch.where(accept, ll_new, ll_old))
    return accept, gamma, loglik


def gamma_step(cfg: SamplerConfig, n, tau, mix, gamma, eta, kappa, noise,
               it: int):
    """Parallel per-sample Dirichlet-random-walk MH on gamma.

    Returns (gamma, mix, accept_rate, loglik): the per-sample old/new
    likelihood terms of the MH ratio already give the post-update total
    loglik, so the sweep needs no separate likelihood pass.
    """
    gamma_prop, alpha_fwd, alpha_rev = _gamma_proposal(cfg, gamma, kappa,
                                                       noise, it)
    mix_prop = mixture(one_hot_tau(tau), gamma_prop)                  # [V,S,4]
    both = torch.stack([mix, mix_prop])                               # [2,V,S,4]
    ll = torch.sum(
        n[None] * safe_log(torch.einsum("kvsa,ab->kvsb", both, eta)),
        dim=(1, 3))                                                   # [2,S]
    accept, gamma, loglik = _gamma_accept(gamma, gamma_prop, alpha_fwd,
                                          alpha_rev, ll[0], ll[1], noise, it)
    mix = torch.where(accept[None, :, None], mix_prop, mix)
    return gamma, mix, accept.to(torch.float32).mean(), loglik


def _eta_proposal(cfg: SamplerConfig, eta, kappa, noise, it: int):
    """The joint Dirichlet proposal of all four rows:
    (eta_prop, alpha_fwd, alpha_rev)."""
    alpha_fwd = kappa * eta + cfg.proposal_floor                      # [4,4]
    eta_prop = _dirichlet(noise.eta_prop(it, alpha_fwd))
    alpha_rev = kappa * eta_prop + cfg.proposal_floor
    return eta_prop, alpha_fwd, alpha_rev


def _eta_accept(cfg: SamplerConfig, eta, eta_prop, alpha_fwd, alpha_rev,
                ll_new, loglik, noise, it: int):
    """The one MH decision of the joint eta step: (eta, loglik, accepted
    as f32)."""
    prior_alpha = _eta_prior(cfg, eta.device)
    log_ratio = (
        (ll_new - loglik)
        + torch.sum((prior_alpha - 1.0) * (safe_log(eta_prop) - safe_log(eta)))
        + torch.sum(_dirichlet_logpdf(eta, alpha_rev))
        - torch.sum(_dirichlet_logpdf(eta_prop, alpha_fwd))
    )
    accept = safe_log(noise.eta_u(it)) < log_ratio
    eta = torch.where(accept, eta_prop, eta)
    loglik = torch.where(accept, ll_new, loglik)
    return eta, loglik, accept.to(torch.float32)


def eta_step_joint(cfg: SamplerConfig, n, mix, eta, loglik, kappa, noise,
                   it: int):
    """Blocked MH on the whole 4x4 error matrix: all four rows proposed at
    once, one accept/reject, one likelihood pass."""
    eta_prop, alpha_fwd, alpha_rev = _eta_proposal(cfg, eta, kappa, noise, it)
    return _eta_accept(cfg, eta, eta_prop, alpha_fwd, alpha_rev,
                       _loglik(n, mix, eta_prop), loglik, noise, it)


def _staged_front(cfg: SamplerConfig, ks, n, state: SamplerState, it: int,
                  noise, temp: float):
    """The sweep's tau, gamma and eta updates as separate steps: the tau
    sweep and swap kernels (or their plain versions), then gamma_step and
    eta_step_joint as plain PyTorch ops.

    Returns (tau, mix, gamma, eta, loglik, acc_gamma, acc_eta).
    """
    V, S, _ = n.shape
    G = cfg.G
    if cfg.fix_tau:
        tau, mix = state.tau, state.mix
    else:
        gz = noise.gumbel(it, V, G)
        if temp != 1.0:
            gz = gz * temp
        tau, mix = ks.tau_sweep(n, state.tau, state.mix, state.gamma,
                                state.eta, gz)
        if cfg.swap_moves and G > 1:
            g, h, logu = noise.swap(it, V, G)
            tau, mix = ks.swap(n, tau, mix, state.gamma, state.eta, g, h, logu)
    if cfg.fix_gamma:
        gamma, acc_g = state.gamma, torch.zeros((), device=n.device)
        loglik = _loglik(n, mix, state.eta)
    else:
        gamma, mix, acc_g, loglik = gamma_step(
            cfg, n, tau, mix, state.gamma, state.eta, state.kappa_gamma,
            noise, it)
    if cfg.fix_eta:
        eta, acc_e = state.eta, torch.zeros((), device=n.device)
    else:
        eta, loglik, acc_e = eta_step_joint(
            cfg, n, mix, state.eta, loglik, state.kappa_eta, noise, it)
    return tau, mix, gamma, eta, loglik, acc_g, acc_e


def make_sweep_fn(cfg: SamplerConfig, kernel="cuda"):
    """Build the (n, state, accum, it, noise) -> (state, accum, loglik) step.

    kernel: a kernel choice's name or its resolved ``ops.Kernels``. "cuda"
    runs the tau sweep and the swap move through the CUDA kernel wrappers
    (their plain versions on CPU tensors); "cuda_resident" runs the whole
    front half of the sweep on the resident kernels (``resident.front``:
    two launches a sweep); "cuda_topk" is "cuda" with the top-2 tau kernel,
    which is bound to the counts, so it comes as ``ops.resolve("cuda_topk",
    n)``; "torch" runs the plain versions everywhere. The kernel choice
    changes only the front half: adaptation and accumulators are this
    function's, for every choice.
    """
    ks = kernel if isinstance(kernel, Kernels) else resolve(kernel)
    if ks.resident:
        from . import resident

        resident.check_supported(cfg)
        front = resident.front
    else:
        front = _staged_front
    if cfg.eta_update != "joint" and not cfg.fix_eta:
        raise NotImplementedError(
            "eta_update='rows' is not ported yet (ROADMAP queue 1 item 3)")
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

    def sweep(n, state: SamplerState, accum: SamplerAccum, it: int, noise):
        tau, mix, gamma, eta, loglik, acc_g, acc_e = front(
            cfg, ks, n, state, it, noise, temperature(it))

        # diminishing adaptation, burn-in only: larger kappa -> smaller
        # Dirichlet steps -> higher acceptance (frozen post-burn)
        kg, ke = state.kappa_gamma, state.kappa_eta
        if cfg.adapt_kappa:
            if it < cfg.burn:
                kg = kg * torch.exp(cfg.adapt_rate * (cfg.target_accept - acc_g))
                ke = ke * torch.exp(cfg.adapt_rate * (cfg.target_accept - acc_e))
            kg = torch.clamp(kg, 10.0, 1e9)
            ke = torch.clamp(ke, 10.0, 1e10)

        new_state = SamplerState(tau=tau, gamma=gamma, eta=eta, mix=mix,
                                 loglik=loglik, kappa_gamma=kg, kappa_eta=ke)

        is_star = loglik > accum.star_loglik
        upd = dict(
            star_loglik=torch.where(is_star, loglik, accum.star_loglik),
            star_tau=torch.where(is_star, tau, accum.star_tau),
            star_gamma=torch.where(is_star, gamma, accum.star_gamma),
            star_eta=torch.where(is_star, eta, accum.star_eta),
            acc_gamma=accum.acc_gamma + acc_g,
            acc_eta=accum.acc_eta + acc_e,
        )
        if it >= cfg.burn:
            upd.update(
                sum_tau=accum.sum_tau + one_hot_tau(tau),
                sum_gamma=accum.sum_gamma + gamma,
                sum_eta=accum.sum_eta + eta,
                sum_loglik=accum.sum_loglik + loglik,
                n_samples=accum.n_samples + 1.0,
                acc_gamma_post=accum.acc_gamma_post + acc_g,
                acc_eta_post=accum.acc_eta_post + acc_e,
            )
        return new_state, accum._replace(**upd), loglik

    return sweep


def init_state(
    n: torch.Tensor,
    cfg: SamplerConfig,
    generator: torch.Generator,
    eta_init: Optional[torch.Tensor] = None,
    tau_init: Optional[torch.Tensor] = None,
    gamma_init: Optional[torch.Tensor] = None,
) -> SamplerState:
    """NMF-initialized (or user-supplied) chain state on n's device."""
    dev = n.device
    if eta_init is None:
        eta = (torch.full((NBASES, NBASES), 0.01 / 3.0, device=dev)
               + torch.eye(NBASES, device=dev) * (0.99 - 0.01 / 3.0))
    else:
        eta = torch.as_tensor(eta_init, dtype=torch.float32,
                              device=dev).contiguous()
    if tau_init is not None and gamma_init is None:
        raise NotImplementedError(
            "a known-haplotype start (nmf.em_gamma, desman -t/-f) is not "
            "ported yet (ROADMAP queue 1 item 5)")
    if tau_init is None or gamma_init is None:
        tau, gamma = nmf_init(n, cfg.G, generator, iters=cfg.nmf_iters)
        if gamma_init is not None:
            gamma = gamma_init
    else:
        tau, gamma = tau_init, gamma_init
    tau = torch.as_tensor(tau, device=dev).to(torch.int32).contiguous()
    gamma = torch.as_tensor(gamma, device=dev).to(torch.float32).contiguous()
    mix = mixture(one_hot_tau(tau), gamma)
    loglik = _loglik(n, mix, eta)
    # curvature warm start, floored at the classic fixed scales so tiny
    # datasets keep usable step sizes
    total = torch.sum(n)
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


def init_accum(V: int, S: int, G: int, device) -> SamplerAccum:
    f32 = dict(dtype=torch.float32, device=device)

    def scalar(x):
        return torch.tensor(x, **f32)

    return SamplerAccum(
        sum_tau=torch.zeros((V, G, NBASES), **f32),
        sum_gamma=torch.zeros((S, G), **f32),
        sum_eta=torch.zeros((NBASES, NBASES), **f32),
        sum_loglik=scalar(0.0),
        n_samples=scalar(0.0),
        star_loglik=scalar(-float("inf")),
        star_tau=torch.zeros((V, G), dtype=torch.int32, device=device),
        star_gamma=torch.zeros((S, G), **f32),
        star_eta=torch.zeros((NBASES, NBASES), **f32),
        acc_gamma=scalar(0.0),
        acc_eta=scalar(0.0),
        acc_gamma_post=scalar(0.0),
        acc_eta_post=scalar(0.0),
    )


def _result_from_accum(accum: SamplerAccum, cfg: SamplerConfig,
                       trace: torch.Tensor) -> SamplerResult:
    """Posterior means + star snapshot from a finished accumulator."""
    n_s = torch.clamp_min(accum.n_samples, 1.0)
    return SamplerResult(
        tau_mean=accum.sum_tau / n_s,
        tau_star=accum.star_tau,
        gamma_mean=accum.sum_gamma / n_s,
        gamma_star=accum.star_gamma,
        eta_mean=accum.sum_eta / n_s,
        eta_star=accum.star_eta,
        mean_loglik=accum.sum_loglik / n_s,
        star_loglik=accum.star_loglik,
        loglik_trace=trace,
        accept_gamma=accum.acc_gamma / cfg.total_sweeps,
        accept_eta=accum.acc_eta / cfg.total_sweeps,
        accept_gamma_post=accum.acc_gamma_post / n_s,
        accept_eta_post=accum.acc_eta_post / n_s,
    )


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
    """Run one chain end to end (init -> one sweep per iteration ->
    summaries) on n's device. n: [V,S,4] counts, cast to f32 once.
    kernel: a kernel choice's name (bound here to n) or an ``ops.Kernels``
    already resolved for n.

    The loglik trace is preallocated on the device and filled sweep by
    sweep; nothing is fetched to the host until the caller asks.
    """
    n = n.to(torch.float32)
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    sweep = make_sweep_fn(cfg, kernel)   # the resident path's refusals first
    if cfg.store_samples:
        raise NotImplementedError(
            "store_samples (desman --store_every) is not ported yet "
            "(ROADMAP queue 1 item 3)")
    V, S, _ = n.shape
    state = init_state(n, cfg, generator, eta_init, tau_init, gamma_init)
    accum = init_accum(V, S, cfg.G, n.device)
    noise = TorchNoise(generator) if noise is None else noise
    trace = torch.empty(cfg.total_sweeps, dtype=torch.float32, device=n.device)
    for it in range(cfg.total_sweeps):
        state, accum, ll = sweep(n, state, accum, it, noise)
        trace[it] = ll
    return _result_from_accum(accum, cfg, trace)


def run_chains(
    n: torch.Tensor,
    cfg: SamplerConfig,
    seeds,
    eta_init: Optional[torch.Tensor] = None,
    kernel="cuda",
) -> SamplerResult:
    """Independent chains over seeds, stacked on a leading axis (the JAX
    package's ``run_chains``, whose vmap becomes a loop here).

    Chain i runs one after another on its own ``torch.Generator`` on n's
    device, seeded with seeds[i], so it is bitwise ``run_chain`` of that
    seed. The kernel choice is resolved once for all chains.
    """
    n = n.to(torch.float32)
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    results = []
    for seed in seeds:
        generator = torch.Generator(device=n.device)
        generator.manual_seed(int(seed))
        results.append(run_chain(n, cfg, generator, eta_init=eta_init,
                                 kernel=kernel))
    return SamplerResult(*(torch.stack(field) for field in zip(*results)))
