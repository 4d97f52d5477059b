"""Convergence-adaptive runs: stop burning in when the chain plateaus, and
optionally sample until an ESS target (counterpart of ``desman_tpu.converge``;
``run_chain_pt_auto`` for parallel tempering, ``run_chains_auto(mesh=)`` on
a mesh of ranks).

Burn-in advances in segments (``sampler.run_segment``) that accumulate
nothing until the segment-mean log-likelihood stops improving; then at
least cfg.samples sweeps are accumulated, extended in segments while the
sampling-phase ESS is below a target. Both verdicts are pure host functions
of the traces (``plateau_step``, ``_need_extension``). ``_run_auto`` drives
whichever chain set it is given: one device's (``checkpoint._Chains``) or
a mesh rank's (``parallel.sharded._ShardChains``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from .checkpoint import PREEMPTED_MESSAGE, Preempted, _Chains, _DrawBuf, prepare
from .diagnostics import ess_bulk
from .sampler import (
    SamplerConfig, _result_from_accum, chain_generator, chain_result, init_accum,
    make_pt_step, pt_generators, pt_init, pt_merge_accums, pt_noises, pt_swap_rate,
    run_pt_segment,
)

# phase 1's burn override: no sweep accumulates, kappa keeps adapting
_NEVER = int(np.iinfo(np.int32).max)

# consecutive plateau verdicts required before burn-in stops: one verdict on
# an autocorrelated segment mean is about a coin flip while the chain still
# climbs slowly; requiring two in a row suppresses those false stops
_PLATEAU_CONFIRMATIONS = 2


def _plateau_stderr(seg_trace: np.ndarray) -> np.ndarray:
    """Per-chain MC standard error of a segment-mean loglik, deflated by the
    segment's bulk effective sample size (the naive std/sqrt(seg) bar
    understates the error of an autocorrelated trace; the callers pair it
    with _PLATEAU_CONFIRMATIONS).

    seg_trace: [C, seg] -> [C] stderr values.
    """
    x = np.asarray(seg_trace, np.float64)
    out = np.empty(x.shape[0])
    n = x.shape[1]
    for c in range(x.shape[0]):
        ess = ess_bulk(x[c][None, :])
        if not np.isfinite(ess):
            ess = float(n)
        out[c] = x[c].std() / np.sqrt(max(min(ess, n), 1.0))
    return out


def plateau_step(seg_trace: np.ndarray, prev_mean: np.ndarray,
                 hits: np.ndarray, it: int, burn: int, rel_tol: float):
    """The plateau verdict on a burn-in segment that ends at sweep `it`.

    Per chain: the segment mean improved on the previous one (prev_mean,
    NaN before the first segment) by less than 2 ESS-deflated standard
    errors, or by less than rel_tol relative. From `burn` sweeps on, a
    verdict adds one to the chain's consecutive count `hits` and its absence
    resets it; before, nothing counts. Returns (mean, hits): the segment
    means (the next call's prev_mean) and the counts; a chain has plateaued
    at hits >= _PLATEAU_CONFIRMATIONS.
    """
    x = np.asarray(seg_trace, np.float32)
    mean = x.mean(axis=1).astype(np.float64)
    if it < burn:
        return mean, hits
    improvement = mean - prev_mean
    verdict = ~np.isnan(prev_mean) & (
        (improvement < 2.0 * _plateau_stderr(x))
        | (np.abs(improvement) < rel_tol * np.maximum(np.abs(prev_mean), 1.0)))
    return mean, np.where(verdict, hits + 1, 0)


def _post_ess(post_rows: np.ndarray, gamma_draws=None,
              target: Optional[float] = None) -> np.ndarray:
    """Per-chain sampling-phase ESS: bulk ESS of the post-burn loglik trace,
    min-ed with the per-entry gamma ESS when draws are stored (the loglik
    can decorrelate while an abundance still drifts).

    post_rows: [C, k] loglik draws; gamma_draws: [C, m, S, G] or None.
    ``target``: callers that need only a below/above verdict pass it, so
    the per-entry gamma scan stops at the first entry below it.
    """
    x = np.asarray(post_rows, np.float64)
    out = np.empty(x.shape[0])
    for c in range(x.shape[0]):
        e = ess_bulk(x[c][None, :])
        if not np.isfinite(e):
            e = 0.0
        if (gamma_draws is not None and gamma_draws.shape[1] >= 4
                and not (target is not None and e < target)):
            flat = np.asarray(gamma_draws[c], np.float64).reshape(
                gamma_draws.shape[1], -1).T
            for row in flat:
                g = ess_bulk(row[None, :])
                if np.isfinite(g):
                    e = min(e, g)
                if target is not None and e < target:
                    break
        out[c] = e
    return out


def _need_extension(post_rows, gamma_draws, ess_target: float) -> bool:
    """The extension verdict: True when any chain's sampling-phase ESS is
    still below the target."""
    return bool(_post_ess(post_rows, gamma_draws,
                          target=ess_target).min() < ess_target)


def run_chain_auto(
    n: torch.Tensor,
    cfg: SamplerConfig,
    generator: torch.Generator,
    eta_init=None,
    tau_init=None,
    check_every: int = 50,
    rel_tol: float = 1e-5,
    max_burn: int = 2000,
    kernel="cuda",
    ess_target: float = 0.0,
    max_samples: int = 0,
):
    """``run_chain`` with data-driven burn-in (and optionally sampling)
    length, from `generator`.

    Burn-in advances ``check_every`` sweeps at a time, accumulating nothing
    and adapting kappa, until the plateau verdict (``plateau_step``) holds
    twice in a row, but at least ``cfg.burn`` sweeps (the anneal still runs
    over cfg.burn * anneal_frac sweeps) and at most ``max_burn``. Then at
    least ``cfg.samples`` sweeps are accumulated with kappa frozen; with
    ``ess_target > 0`` sampling continues in ``check_every`` segments until
    the post-burn ESS (``_post_ess``) reaches the target, capped at
    ``max_samples``. Returns (SamplerResult, burn_used, samples_used): one
    chain of ``run_chains_auto``.
    """
    res, burn_used, samples_used = _run_auto(
        _Chains(n, cfg, [generator], eta_init, tau_init, kernel, None), cfg,
        check_every, rel_tol, max_burn, ess_target, max_samples)
    return chain_result(res, 0), burn_used, samples_used


def run_chains_auto(
    n,
    cfg: SamplerConfig,
    seeds: Sequence[int],
    eta_init=None,
    tau_init=None,
    check_every: int = 50,
    rel_tol: float = 1e-5,
    max_burn: int = 2000,
    kernel="cuda",
    checkpoint_path: Optional[str] = None,
    ess_target: float = 0.0,
    max_samples: int = 0,
    mesh=None,
    device="cuda",
):
    """Multi-chain ``run_chain_auto`` with optional checkpoint/resume.

    Chain i runs from its own generator, seeded seeds[i]. Burn-in advances
    every chain one ``check_every`` segment (one sweep of all the chains at
    a time; on a mesh, of a rank's chains at a time) until EVERY chain has
    plateaued (per-chain verdicts, the bar of run_chain_auto) or
    ``max_burn`` is reached; then at least ``cfg.samples`` sweeps are
    accumulated for all chains from that common point, extended in segments
    with ``ess_target > 0`` until EVERY chain's sampling-phase ESS reaches
    the target (capped at ``max_samples``). With ``checkpoint_path`` each
    segment is snapshotted (the plateau detector's state and the stored
    draws through the extras channel, every chain's generator state), a
    SIGTERM raises ``checkpoint.Preempted`` at the next segment boundary,
    and a resumed run reproduces an uninterrupted one. Returns (stacked
    SamplerResult, burn_used, samples_used).

    ``mesh``: run on a (chain, data) mesh of ranks (call on every rank
    with the same arguments; n is then the host counts and `device` each
    rank's by the device rule): positions over the data axis, the chains
    split over the chain axis (len(seeds) a multiple of it), as
    ``parallel.run_chains_sharded``. Every rank decides each plateau and
    ESS verdict on the whole [C, seg] trace, gathered over the chain axis,
    so all decide alike. ``checkpoint_path`` is then a directory of shard
    files (``parallel.shard_ckpt``, the detector's state in its extras
    channel; SIGTERM agreed at each segment head), and a step resumes on
    another mesh shape. Without a checkpoint the chains' gamma draws are
    gathered for the ESS verdict; with one they stay in the shard files and
    the loglik bulk ESS alone gates, as in the JAX package. The result is
    ``Shard.gather``'s: tau_mean, tau_star and the draws on the
    coordinator alone.
    """
    if mesh is None:
        chains = _Chains(n, cfg, [chain_generator(s, n.device) for s in seeds],
                         eta_init, tau_init, kernel, checkpoint_path)
    else:
        from .parallel.sharded import _ShardChains

        chains = _ShardChains(n, cfg, seeds, mesh, device, kernel, eta_init,
                              tau_init, checkpoint_path)
    return _run_auto(chains, cfg, check_every, rel_tol, max_burn, ess_target,
                     max_samples)


def _run_auto(chains: _Chains, cfg: SamplerConfig, check_every: int, rel_tol: float,
              max_burn: int, ess_target: float, max_samples: int):
    C = chains.n_chains
    max_burn = max(max_burn, cfg.burn)

    it = 0
    burn_used = -1  # -1: still in phase 1
    prev_mean = np.full(C, np.nan)
    done = np.zeros(C, bool)
    hits = np.zeros(C, np.int64)  # consecutive plateau verdicts per chain
    trace_parts = []
    resumed = chains.start()
    if resumed is not None:
        it, trace_done, ex = resumed
        burn_used = int(ex["burn_used"])
        prev_mean = np.asarray(ex["prev_mean"], np.float64)
        done = np.asarray(ex["done"]).astype(bool)
        hits = np.asarray(ex["hits"], np.int64)
        trace_parts = [np.asarray(trace_done)]
    checkpointed = bool(chains.path)

    def snapshot():
        if not checkpointed:
            return
        trace = (np.concatenate(trace_parts, axis=1) if trace_parts
                 else np.zeros((C, 0), np.float32))
        chains.snapshot(it, trace, {"burn_used": burn_used, "prev_mean": prev_mean,
                                    "done": done, "hits": hits})

    def segment_head():
        if checkpointed and chains.preempted():
            raise Preempted(PREEMPTED_MESSAGE)

    # phase 1: burn until every chain plateaus (the accums are scratch)
    while burn_used < 0:
        if done.all() or it >= max_burn:
            burn_used = it
            snapshot()
            break
        segment_head()
        seg = min(check_every, max_burn - it)
        trace = chains.advance(it, seg, _NEVER)
        it += seg
        trace_parts.append(trace)
        prev_mean, hits = plateau_step(trace, prev_mean, hits, it, cfg.burn,
                                       rel_tol)
        done |= hits >= _PLATEAU_CONFIRMATIONS
        if done.all() or it >= max_burn:
            burn_used = it
        snapshot()

    # phase 2: accumulate >= cfg.samples sweeps (burn=burn_used). The loop
    # re-derives the ESS-extension verdict at its head from the trace and
    # draws, which the snapshot carries, so a run resumed mid-extension
    # keeps extending and no extension state rides the snapshot.
    target = burn_used + cfg.samples
    cap = burn_used + max(int(max_samples), cfg.samples)
    while True:
        if it >= target:
            if not (ess_target > 0 and it < cap):
                break
            post = np.concatenate(trace_parts, axis=1)[:, burn_used:]
            if not _need_extension(post, chains.gamma_draws(), ess_target):
                break
            target = min(it + check_every, cap)
        segment_head()
        if it == burn_used:  # entering phase 2: drop the scratch accums
            chains.fresh_accums()
        seg = (min(check_every, target - it)
               if (checkpointed or ess_target > 0) else target - it)
        trace_parts.append(chains.advance(it, seg, burn_used, cfg.store_samples))
        it += seg
        snapshot()

    res_cfg = replace(cfg, burn=0, samples=it - burn_used)
    return (chains.result(res_cfg, np.concatenate(trace_parts, axis=1)), burn_used,
            it - burn_used)


def run_chain_pt_auto(
    n: torch.Tensor,
    cfg: SamplerConfig,
    seed: int,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    eta_init=None,
    tau_init=None,
    check_every: int = 50,
    rel_tol: float = 1e-5,
    max_burn: int = 2000,
    kernel="cuda",
    ess_target: float = 0.0,
    max_samples: int = 0,
    auto_burn: bool = True,
):
    """Parallel tempering with plateau-detected burn-in and/or ESS-targeted
    sampling (the JAX package's ``run_chain_pt_auto``), on the cold rung's
    trace: whichever replica holds rung 0, the cold loglik is one signal.

    Phase 1 advances the ensemble ``check_every`` sweeps at a time with
    nothing accumulated (burn = never) until the cold trace plateaus
    (``plateau_step``'s verdict twice in a row; at least cfg.burn, at most
    max_burn sweeps), or for exactly cfg.burn sweeps with auto_burn=False.
    Phase 2 starts fresh accumulators and samples at least cfg.samples
    sweeps; with ``ess_target > 0`` it extends in ``check_every`` segments
    until the post-burn cold ESS (min-ed with the stored cold draws' gamma
    ESS) reaches the target, capped at max_samples. Returns
    (SamplerResult, burn_used, samples_used); the result's acceptance rates
    are over the sampling sweeps. R < 2 is ``run_chain_auto`` with a
    generator seeded `seed`.
    """
    R = int(n_replicas)
    if R < 2:   # the same fallback as run_chain_pt; auto_burn=False pins burn
        return run_chain_auto(
            n, cfg, chain_generator(seed, n.device), eta_init=eta_init,
            tau_init=tau_init, check_every=check_every, rel_tol=rel_tol,
            max_burn=max_burn if auto_burn else cfg.burn, kernel=kernel,
            ess_target=ess_target, max_samples=max_samples)
    n, ks = prepare(n, cfg, kernel)
    make_pt_step(n, cfg, R, max_temp, ks)   # the refusals, before the start
    V, S, _ = n.shape
    max_burn = max(max_burn, cfg.burn) if auto_burn else cfg.burn
    generators = pt_generators(seed, R, n.device)
    state, accum, rung = pt_init(n, cfg, generators[:R], eta_init, tau_init)
    noise, exchange = pt_noises(generators)
    n_acc = torch.zeros((), dtype=torch.float32, device=n.device)
    head_sum = 0

    def segment(start, seg, burn, store=False):
        nonlocal state, accum, rung, n_acc, head_sum
        out = run_pt_segment(n, cfg, state, accum, rung, start, seg, noise,
                             exchange, max_temp, ks, burn=burn, store=store)
        state, accum, rung, trace, seg_acc, seg_heads = out[:6]
        n_acc = n_acc + seg_acc
        head_sum += seg_heads
        return trace.cpu().numpy(), (out[6] if store else None)

    # phase 1: burn until the cold trace plateaus (the accums are scratch)
    it = 0
    trace_parts = []
    prev_mean = np.full(1, np.nan)
    hits = np.zeros(1, np.int64)
    while it < max_burn:
        seg = min(check_every, max_burn - it)
        trace, _ = segment(it, seg, _NEVER)
        it += seg
        trace_parts.append(trace)
        if not auto_burn:
            continue
        prev_mean, hits = plateau_step(trace[None], prev_mean, hits, it,
                                       cfg.burn, rel_tol)
        if hits[0] >= _PLATEAU_CONFIRMATIONS:
            break
    burn_used = it

    # phase 2: fresh accumulators, >= cfg.samples cold-rung sweeps
    accum = init_accum(V, S, cfg.G, n.device, chains=R)
    draws = _DrawBuf()
    done_s = 0
    target = cfg.samples
    cap = max(int(max_samples), cfg.samples)
    while done_s < target:
        seg = (min(check_every, target - done_s) if ess_target > 0
               else target - done_s)
        trace, seg_draws = segment(burn_used + done_s, seg, burn_used,
                                   cfg.store_samples)
        if seg_draws is not None:
            draws.append(*(d.cpu().numpy() for d in seg_draws))
        done_s += seg
        trace_parts.append(trace)
        if ess_target > 0 and target <= done_s < cap:
            gd = draws.extras().get("draw_gamma")
            post = np.concatenate(trace_parts)[None, burn_used:]
            if _need_extension(post, None if gd is None else gd[None],
                               ess_target):
                target = min(done_s + check_every, cap)

    res = _result_from_accum(
        pt_merge_accums(accum), replace(cfg, burn=0, samples=done_s),
        torch.as_tensor(np.concatenate(trace_parts), device=n.device),
        pt_swap_accept=pt_swap_rate(n_acc, head_sum),
        **draws.result_fields(n.device))
    return res, burn_used, done_s
