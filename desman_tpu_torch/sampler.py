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

With ``kernel="cuda_resident"`` steps 1-3 run as two kernel launches a
sweep (``resident.front``), with the same draws in the same order; only
the [S]- and [4,4]-sized MH arithmetic stays as PyTorch ops.

Parallel tempering (``run_chain_pt``): R replicas on a temperature ladder,
each a sweep with a fixed ``temp`` and a likelihood power ``beta``, then an
exchange of adjacent rungs. The JAX package vmaps the replicas; here they
run one after another, each on its own generator, and the exchange draws
from one more (``pt_seeds``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .likelihood import mixture
from .nmf import em_gamma, nmf_init
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


def _tempered(x) -> bool:
    """False only for the host float 1.0: an untempered step skips the
    multiply or divide (a 0-d device temp or beta, as PT passes them,
    always tempers)."""
    return isinstance(x, torch.Tensor) or x != 1.0


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


def _own(x):
    """The one-device reduction over positions: the local sum is the sum."""
    return x


def _loglik(n, mix, eta, psum=_own):
    """sum n * log(mix @ eta); psum adds the position shards' sums
    (``parallel.distributed``), the identity on one device."""
    return psum(torch.sum(n * safe_log(torch.einsum("vsa,ab->vsb", mix, eta))))


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
                  noise, it: int, beta=1.0):
    """The per-sample MH decisions from the per-sample likelihood pair:
    (accept [S] bool, gamma, loglik). The old/new terms of the ratio
    already give the post-update total loglik. beta tempers the likelihood
    term only; the returned loglik is the untempered one."""
    dll = ll_new - ll_old
    if _tempered(beta):
        dll = beta * dll
    # symmetric Dirichlet(1) prior on gamma rows -> prior ratio = 0
    log_ratio = (
        dll
        + _dirichlet_logpdf(gamma, alpha_rev)
        - _dirichlet_logpdf(gamma_prop, alpha_fwd)
    )
    accept = safe_log(noise.gamma_u(it, gamma.shape[0])) < log_ratio
    gamma = torch.where(accept[:, None], gamma_prop, gamma)
    loglik = torch.sum(torch.where(accept, ll_new, ll_old))
    return accept, gamma, loglik


def gamma_step(cfg: SamplerConfig, n, tau, mix, gamma, eta, kappa, noise,
               it: int, beta=1.0, psum=_own):
    """Parallel per-sample Dirichlet-random-walk MH on gamma; beta < 1
    tempers the likelihood term only (replica exchange's target
    prior * L^beta); psum adds the position shards' [2,S] sums.

    Returns (gamma, mix, accept_rate, loglik): the per-sample old/new
    likelihood terms of the MH ratio already give the post-update total
    loglik, so the sweep needs no separate likelihood pass.
    """
    gamma_prop, alpha_fwd, alpha_rev = _gamma_proposal(cfg, gamma, kappa,
                                                       noise, it)
    mix_prop = mixture(one_hot_tau(tau), gamma_prop)                  # [V,S,4]
    both = torch.stack([mix, mix_prop])                               # [2,V,S,4]
    ll = psum(torch.sum(
        n[None] * safe_log(torch.einsum("kvsa,ab->kvsb", both, eta)),
        dim=(1, 3)))                                                  # [2,S]
    accept, gamma, loglik = _gamma_accept(gamma, gamma_prop, alpha_fwd,
                                          alpha_rev, ll[0], ll[1], noise, it, beta)
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
                ll_new, loglik, noise, it: int, beta=1.0):
    """The one MH decision of the joint eta step: (eta, loglik, accepted
    as f32); beta tempers the likelihood term only."""
    prior_alpha = _eta_prior(cfg, eta.device)
    dll = ll_new - loglik
    if _tempered(beta):
        dll = beta * dll
    log_ratio = (
        dll
        + torch.sum((prior_alpha - 1.0) * (safe_log(eta_prop) - safe_log(eta)))
        + torch.sum(_dirichlet_logpdf(eta, alpha_rev))
        - torch.sum(_dirichlet_logpdf(eta_prop, alpha_fwd))
    )
    accept = safe_log(noise.eta_u(it)) < log_ratio
    eta = torch.where(accept, eta_prop, eta)
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
    prior_alpha = _eta_prior(cfg, eta.device)
    n_acc = torch.zeros((), device=eta.device)
    for a in range(NBASES):
        row = eta[a]
        alpha_fwd = kappa * row + cfg.proposal_floor
        row_prop = _dirichlet(noise.eta_row_prop(it, a, alpha_fwd))
        alpha_rev = kappa * row_prop + cfg.proposal_floor
        eta_prop = eta.clone()
        eta_prop[a] = row_prop
        ll_new = _loglik(n, mix, eta_prop, psum)
        log_ratio = (
            beta * (ll_new - loglik)
            + torch.sum((prior_alpha[a] - 1.0)
                        * (safe_log(row_prop) - safe_log(row)))
            + _dirichlet_logpdf(row, alpha_rev)
            - _dirichlet_logpdf(row_prop, alpha_fwd)
        )
        accept = safe_log(noise.eta_row_u(it, a)) < log_ratio
        eta = torch.where(accept, eta_prop, eta)
        loglik = torch.where(accept, ll_new, loglik)
        n_acc = n_acc + accept.to(torch.float32)
    return eta, loglik, n_acc / NBASES


def _staged_front(cfg: SamplerConfig, ks, n, state: SamplerState, it: int,
                  noise, temp, beta=1.0, psum=_own):
    """The sweep's tau, gamma and eta updates as separate steps: the tau
    sweep and swap kernels (or their plain versions), then gamma_step and
    eta_step_joint (or eta_step) as plain PyTorch ops.

    temp scales the Gumbel noise (a host float, or PT's 0-d device
    tensor); beta tempers every MH ratio, the swap's as a threshold
    logu / beta (the JAX package's Pallas swap; its XLA swap compares
    logu < beta * dll, the same decision but at float near-ties). psum
    adds the position shards' likelihood sums (the identity on one device).
    Returns (tau, mix, gamma, eta, loglik, acc_gamma, acc_eta).
    """
    V, S, _ = n.shape
    G = cfg.G
    if cfg.fix_tau:
        tau, mix = state.tau, state.mix
    else:
        gz = noise.gumbel(it, V, G)
        if _tempered(temp):
            gz = gz * temp
        tau, mix = ks.tau_sweep(n, state.tau, state.mix, state.gamma,
                                state.eta, gz)
        if cfg.swap_moves and G > 1:
            g, h, logu = noise.swap(it, V, G)
            if _tempered(beta):
                logu = logu / beta
            tau, mix = ks.swap(n, tau, mix, state.gamma, state.eta, g, h, logu)
    if cfg.fix_gamma:
        gamma, acc_g = state.gamma, torch.zeros((), device=n.device)
        loglik = _loglik(n, mix, state.eta, psum)
    else:
        gamma, mix, acc_g, loglik = gamma_step(
            cfg, n, tau, mix, state.gamma, state.eta, state.kappa_gamma,
            noise, it, beta, psum)
    if cfg.fix_eta:
        eta, acc_e = state.eta, torch.zeros((), device=n.device)
    else:
        eta_fn = eta_step_joint if cfg.eta_update == "joint" else eta_step
        eta, loglik, acc_e = eta_fn(
            cfg, n, mix, state.eta, loglik, state.kappa_eta, noise, it, beta,
            psum)
    return tau, mix, gamma, eta, loglik, acc_g, acc_e


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

    def sweep(n, state: SamplerState, accum: SamplerAccum, it: int, noise,
              burn: Optional[int] = None, temp=None, beta=1.0):
        burn = cfg.burn if burn is None else burn
        if ks.resident and (temp is not None or _tempered(beta)):
            raise ValueError(RESIDENT_PLAIN_ONLY)
        temp = temperature(it) if temp is None else temp
        args = (cfg, ks, n, state, it, noise, temp)
        tau, mix, gamma, eta, loglik, acc_g, acc_e = (
            front(*args) if ks.resident else front(*args, beta, psum))

        # diminishing adaptation, burn-in only: larger kappa -> smaller
        # Dirichlet steps -> higher acceptance (frozen post-burn)
        kg, ke = state.kappa_gamma, state.kappa_eta
        if cfg.adapt_kappa:
            if it < burn:
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
        if it >= burn:
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
                       trace: torch.Tensor, **draws) -> SamplerResult:
    """Posterior means + star snapshot from a finished accumulator (and the
    stored draws, when there are any)."""
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
                psum=_own):
    """Advance a chain n_sweeps sweeps from absolute sweep index start_it.

    Returns (state, accum, trace): the [n_sweeps] loglik trace is
    preallocated on n's device and filled sweep by sweep, so nothing waits
    for the device. With ``store`` a fourth item holds the (tau int8, gamma,
    eta) draws [k, ...] of the k sweeps ``stored_slots`` selects (burn: the
    override or cfg.burn; thin: cfg.store_thin), copied into buffers on the
    device; storing reads the state and changes nothing. ``burn`` has the
    sweep's meaning (``make_sweep_fn``), and so has psum. Segments run in
    order from one noise source give the draws and the trajectory of one
    long segment.
    """
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    sweep = make_sweep_fn(cfg, kernel, psum)
    V, S, _ = n.shape
    dev = n.device
    trace = torch.empty(n_sweeps, dtype=torch.float32, device=dev)
    slots = (stored_slots(start_it, n_sweeps, cfg.burn if burn is None else burn,
                          cfg.store_thin) if store else [])
    k = len(slots)
    draws = (torch.empty((k, V, cfg.G), dtype=torch.int8, device=dev),
             torch.empty((k, S, cfg.G), dtype=torch.float32, device=dev),
             torch.empty((k, NBASES, NBASES), dtype=torch.float32, device=dev))
    j = 0
    for i in range(n_sweeps):
        state, accum, ll = sweep(n, state, accum, start_it + i, noise, burn=burn)
        trace[i] = ll
        if j < k and slots[j] == i:
            draws[0][j], draws[1][j], draws[2][j] = state.tau, state.gamma, state.eta
            j += 1
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
    package's ``run_chains``, whose vmap becomes a loop here).

    Chain i runs one after another on its own ``torch.Generator`` on n's
    device, seeded with seeds[i], so it is bitwise ``run_chain`` of that
    seed. The kernel choice is resolved once for all chains. Fields that
    are None (no stored draws) stay None.
    """
    n = n.to(torch.float32)
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    results = [run_chain(n, cfg, chain_generator(seed, n.device), eta_init=eta_init,
                         tau_init=tau_init, kernel=kernel) for seed in seeds]
    return SamplerResult(*(None if field[0] is None else torch.stack(field)
                           for field in zip(*results)))


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
    """(states, accums, rung) of a replica-exchange run: one state per
    generator given (the R replicas', not the exchange's), each drawing its
    NMF start from it, fresh accumulators, and rung [R] = arange(R) (int64
    on n's device: replica i holds ladder rung rung[i])."""
    V, S, _ = n.shape
    R = len(generators)
    states = [init_state(n, cfg, g, eta_init, tau_init, gamma_init)
              for g in generators]
    accums = [init_accum(V, S, cfg.G, n.device) for _ in range(R)]
    return states, accums, torch.arange(R, device=n.device)


def _keep_cold(is_cold, new: SamplerAccum, old: SamplerAccum) -> SamplerAccum:
    """The sweep's accumulators where the replica held the cold rung, the
    pre-sweep ones elsewhere (the fields the sweep left alone pass as they
    are)."""
    return SamplerAccum(*(o if x is o else torch.where(is_cold, x, o)
                          for x, o in zip(new, old)))


def make_pt_step(n, cfg: SamplerConfig, R: int, max_temp: float,
                 kernel="cuda", burn: Optional[int] = None):
    """One PT ensemble sweep + exchange: the JAX package's ``make_pt_step``
    with the replicas in turn.

    Returns step(states, accums, rung, it, noises, exchange) -> (states,
    accums, rung, cold_ll, n_acc, n_heads): replica i sweeps from
    noises[i] at the temperature of its rung; the exchange proposes
    swapping the temperatures of the replicas holding rungs (r, r+1),
    alternating parity by sweep, with ``exchange.exchange_u(it, R)``.
    cold_ll is the loglik of the replica that was cold during the sweep,
    n_acc the accepted exchanges (0-d f32 on the device), n_heads the
    proposals (a host int: it depends on it and R only). ``rung`` stays on
    the device and nothing waits for it. ``burn`` has the sweep's meaning.
    """
    ks = kernel if isinstance(kernel, Kernels) else resolve(kernel, n)
    if ks.resident:
        raise ValueError(RESIDENT_PLAIN_ONLY)
    sweep = make_sweep_fn(cfg, ks)
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

    # index_select, not x[idx]: advanced indexing costs the host several
    # times more a call, and the step makes six
    def step(states, accums, rung, it: int, noises, exchange):
        temps = ladder.index_select(0, rung)
        betas = 1.0 / temps
        is_cold = rung == 0
        new_states, new_accums, lls = [], [], []
        for i in range(R):
            st, ac, ll = sweep(n, states[i], accums[i], it, noises[i],
                               burn=burn, temp=temps[i], beta=betas[i])
            new_states.append(st)
            # hot replicas draw from tempered targets: keep their
            # pre-sweep accumulators, star included
            new_accums.append(_keep_cold(is_cold[i], ac, accums[i]))
            lls.append(ll)
        lls = torch.stack(lls)

        order = torch.argsort(rung)                  # rung -> replica
        ll_by_rung = lls.index_select(0, order)
        delta = dbeta * (torch.roll(ll_by_rung, -1) - ll_by_rung)
        is_head = heads[it % 2]
        u = exchange.exchange_u(it, R)
        acc = is_head & (safe_log(u) < delta)
        acc_prev = torch.cat([first, acc[:-1]])
        # old rung -> new rung (disjoint adjacent transpositions)
        rung_perm = torch.where(acc, up, torch.where(acc_prev, down, idx))
        new_rung = rung_perm.index_select(0, rung)
        # adapted proposal scales belong to the rung, not the replica: the
        # new holder of rung new_rung[i] takes its old holder's kappas
        src = order.index_select(0, new_rung)
        kg = torch.stack([s.kappa_gamma for s in new_states]).index_select(0, src)
        ke = torch.stack([s.kappa_eta for s in new_states]).index_select(0, src)
        new_states = [s._replace(kappa_gamma=kg[i], kappa_eta=ke[i])
                      for i, s in enumerate(new_states)]
        cold_ll = torch.sum(torch.where(is_cold, lls, 0.0))
        n_acc = torch.sum(acc.to(torch.float32))
        return new_states, new_accums, new_rung, cold_ll, n_acc, n_heads[it % 2]

    return step


def pt_noises(generators):
    """The replicas' noise sources and the exchange's, from the R + 1
    generators of ``pt_generators``."""
    return [TorchNoise(g) for g in generators[:-1]], ExchangeNoise(generators[-1])


def run_pt_segment(n, cfg: SamplerConfig, states, accums, rung, start_it: int,
                   n_sweeps: int, noises, exchange, max_temp: float,
                   kernel="cuda", burn: Optional[int] = None, store: bool = False):
    """Advance a PT ensemble n_sweeps from absolute sweep index start_it.

    Returns (states, accums, rung, trace, n_acc, n_heads): trace [n_sweeps]
    holds each sweep's cold_ll on n's device, n_acc the segment's accepted
    exchanges (0-d f32 on the device), n_heads its proposals (host int).
    With ``store`` a seventh item holds the (tau int8, gamma, eta) draws of
    the sweeps ``stored_slots`` selects, taken from the replica holding rung
    0 after the sweep's exchange. ``burn`` has the sweep's meaning.
    Segments run in order from the same noise sources give the draws and
    the trajectory of one long segment.
    """
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    R = len(states)
    step = make_pt_step(n, cfg, R, max_temp, kernel, burn=burn)
    V, S, _ = n.shape
    dev = n.device
    trace = torch.empty(n_sweeps, dtype=torch.float32, device=dev)
    n_acc = torch.zeros((), dtype=torch.float32, device=dev)
    n_heads = 0
    slots = (stored_slots(start_it, n_sweeps, cfg.burn if burn is None else burn,
                          cfg.store_thin) if store else [])
    k = len(slots)
    draws = (torch.empty((k, V, cfg.G), dtype=torch.int8, device=dev),
             torch.empty((k, S, cfg.G), dtype=torch.float32, device=dev),
             torch.empty((k, NBASES, NBASES), dtype=torch.float32, device=dev))
    j = 0
    for i in range(n_sweeps):
        states, accums, rung, cold_ll, acc, heads = step(
            states, accums, rung, start_it + i, noises, exchange)
        trace[i] = cold_ll
        n_acc = n_acc + acc
        n_heads += heads
        if j < k and slots[j] == i:
            cold = torch.argmin(rung).reshape(1)   # the holder of rung 0
            for buf, field in zip(draws, ("tau", "gamma", "eta")):
                stacked = torch.stack([getattr(s, field) for s in states])
                buf[j] = stacked.index_select(0, cold)[0]
            j += 1
    out = (states, accums, rung, trace, n_acc, n_heads)
    return out + (draws,) if store else out


def pt_merge_accums(accums) -> SamplerAccum:
    """Merge the replicas' cold-rung records: sums add, the star is the
    replica's with the highest star loglik (the first on a tie)."""
    stacked = SamplerAccum(*(torch.stack(f) for f in zip(*accums)))
    star = torch.argmax(stacked.star_loglik).reshape(1)

    def pick(x):
        return x.index_select(0, star)[0]

    # exactly one replica is cold each sweep, so the acceptance sums across
    # replicas already total one value a sweep
    return SamplerAccum(
        sum_tau=stacked.sum_tau.sum(0), sum_gamma=stacked.sum_gamma.sum(0),
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
    ensemble sweep adjacent rungs (alternating parity) exchange their
    temperatures with probability min(1, exp((b_r - b_{r+1}) (ll_{r+1} -
    ll_r))). Accumulators and the star record only while a replica holds
    the cold rung; with cfg.store_samples the stored draws are the cold
    replica's after each kept sweep's exchange. The loglik trace is the
    cold rung's. The generators come from ``pt_seeds(seed, R)``; R < 2 is
    ``run_chain`` with a generator seeded `seed`, bit for bit.
    """
    n = n.to(torch.float32)
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    R = int(n_replicas)
    if R < 2:
        return run_chain(n, cfg, chain_generator(seed, n.device), eta_init=eta_init,
                         tau_init=tau_init, gamma_init=gamma_init, kernel=kernel)
    make_pt_step(n, cfg, R, max_temp, kernel)   # the refusals, before the start
    check_store_thin(cfg)
    generators = pt_generators(seed, R, n.device)
    states, accums, rung = pt_init(n, cfg, generators[:R], eta_init, tau_init,
                                   gamma_init)
    noises, exchange = pt_noises(generators)
    out = run_pt_segment(n, cfg, states, accums, rung, 0, cfg.total_sweeps,
                         noises, exchange, max_temp, kernel,
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
    package's ``run_chains_pt``, whose vmap becomes a loop): run i is
    bitwise ``run_chain_pt`` of seeds[i]."""
    n = n.to(torch.float32)
    if not isinstance(kernel, Kernels):
        kernel = resolve(kernel, n)
    results = [run_chain_pt(n, cfg, seed, n_replicas, max_temp, eta_init=eta_init,
                            tau_init=tau_init, kernel=kernel) for seed in seeds]
    return SamplerResult(*(None if field[0] is None else torch.stack(field)
                           for field in zip(*results)))
