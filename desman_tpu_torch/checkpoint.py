"""Checkpoint / exact resume for sampler chains and parallel-tempering
ensembles (counterpart of ``desman_tpu.checkpoint``).

A run executes as segments of sweeps (``sampler.run_segment``); between
segments the full chain state (tau, gamma, eta, mixture cache, adapted
kappas), the sweep index, the accumulators, the loglik trace so far and the
chain's generator state go to one .npz, in the JAX package's field names.

The JAX package folds the absolute sweep index into a chain key. Here every
draw comes in turn from the chain's ``torch.Generator`` (``TorchNoise``), so
a snapshot also holds ``generator.get_state()`` of every chain as
``generator_state`` ([C, ...] uint8; Philox's seed and offset on the card,
the mt19937 state on the CPU), and a resumed run restores it and never runs
``init_state`` again (the NMF start draws from the same generator). Segments
run the same sweeps in the same order from the same draws, so a resumed run
continues the exact trajectory of an uninterrupted one.

A PT snapshot (``save_pt``) holds the replicas' states and accumulators
with a leading [R] axis, ``rung``, ``it``, the cold trace, ``n_acc`` and
``n_heads`` (the JAX package's ``save_pt`` fields) and ``generator_state``
[R + 1, ...]: the replicas' generators, then the exchange's. Its stored
cold draws ride the same file's ``extra_*`` arrays, so one rename commits
both: the JAX package's separate ``.draws.npz`` and its truncation of a
draws file that ran one segment ahead have no counterpart here.
"""
from __future__ import annotations

import os
import signal
from typing import List, Optional, Sequence

import numpy as np
import torch

from .convert import accum_from_numpy, state_from_numpy
from .ops import Kernels, resolve
from .sampler import (
    DRAW_FIELDS, SamplerAccum, SamplerConfig, SamplerResult, SamplerState,
    TorchNoise, _result_from_accum, chain_generator, chain_result,
    check_store_thin, init_accum, init_state, make_pt_step, make_sweep_fn,
    pt_generators, pt_init, pt_merge_accums, pt_noises, pt_swap_rate,
    run_pt_segment, run_segment,
    stored_slots,  # noqa: F401 (checkpoint.stored_slots, as in the JAX package)
)

_STATE_FIELDS = SamplerState._fields
_ACCUM_FIELDS = SamplerAccum._fields


class Preempted(Exception):
    """Raised between segments after a SIGTERM: the checkpoint on disk is
    committed and the run is resumable (the CLI exits 75, EX_TEMPFAIL)."""


_PREEMPTED = False


def _on_sigterm(signum, frame):
    global _PREEMPTED
    _PREEMPTED = True


def install_preemption_handler() -> None:
    """SIGTERM = preemption notice: finish the in-flight segment, commit its
    checkpoint, then raise Preempted at the next segment boundary instead of
    dying mid-save. Installed by the CLI for checkpointed runs; safe to call
    more than once."""
    signal.signal(signal.SIGTERM, _on_sigterm)


PREEMPTED_MESSAGE = "SIGTERM received; checkpoint committed — rerun to resume"


def take_preempted() -> bool:
    """Whether a SIGTERM came since the last look (and forget it)."""
    global _PREEMPTED
    was, _PREEMPTED = _PREEMPTED, False
    return was


def check_preempted() -> None:
    if take_preempted():
        raise Preempted(PREEMPTED_MESSAGE)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save(path: str, state: SamplerState, accum: SamplerAccum, it: int,
         trace: np.ndarray, generators: Sequence[torch.Generator],
         extras: Optional[dict] = None, payload: Optional[dict] = None) -> None:
    """Serialize a chain snapshot atomically (write + rename).

    state/accum: one chain's, or the chains' stacked on a leading axis;
    generators: each chain's generator, in that order. ``extras``:
    caller-owned arrays saved alongside (converge.run_chains_auto's
    plateau-detector state, stored draws); read back with ``load_extras``.
    ``payload``: more top-level arrays, written as they are (``save_pt``).
    """
    payload = dict(payload or {})
    payload.update({f"state_{k}": _numpy(v) for k, v in zip(_STATE_FIELDS, state)})
    payload.update(
        {f"accum_{k}": _numpy(v) for k, v in zip(_ACCUM_FIELDS, accum)})
    payload["it"] = np.asarray(it, np.int64)
    payload["trace"] = np.asarray(trace, np.float32)
    payload["generator_state"] = np.stack(
        [g.get_state().numpy() for g in generators])
    for k, v in (extras or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    # np.savez appends .npz only when missing; tmp already ends with it
    os.replace(tmp, path)


def load(path: str, device="cpu"):
    """(state, accum, it, trace, generator_state) of a snapshot, the
    tensors on `device`; generator_state is [C, ...] uint8."""
    with np.load(path) as z:
        state = state_from_numpy(
            {k: z[f"state_{k}"] for k in _STATE_FIELDS}, device)
        accum = accum_from_numpy(
            {k: z[f"accum_{k}"] for k in _ACCUM_FIELDS}, device)
        return (state, accum, int(z["it"]), np.asarray(z["trace"]),
                np.asarray(z["generator_state"]))


def load_extras(path: str) -> dict:
    """The ``extras`` dict a snapshot was saved with (empty if none)."""
    with np.load(path) as z:
        return {k[len("extra_"):]: z[k] for k in z.files
                if k.startswith("extra_")}


def restore_generators(generators: Sequence[torch.Generator],
                       generator_state: np.ndarray) -> None:
    for g, s in zip(generators, generator_state):
        g.set_state(torch.from_numpy(np.ascontiguousarray(s)))


class _DrawBuf:
    """Host-side accumulator for thinned (tau, gamma, eta) draws across
    segments, persisted through the checkpoint ``extras`` channel."""

    KEYS = ("draw_tau", "draw_gamma", "draw_eta")

    def __init__(self, extras: Optional[dict] = None):
        ex = extras or {}
        self.parts = [[np.asarray(ex[k])] if k in ex else [] for k in self.KEYS]

    def append(self, tau_s, gamma_s, eta_s, axis: int = 0) -> None:
        """Keep a segment's draws (numpy; ``axis``: the draw axis, 0 for a
        single chain, 1 under a leading chain axis)."""
        if tau_s.shape[axis] == 0:
            return
        for part, x in zip(self.parts, (tau_s, gamma_s, eta_s)):
            part.append(np.asarray(x))

    def extras(self, axis: int = 0) -> dict:
        if not self.parts[0]:
            return {}
        return {k: np.concatenate(p, axis=axis)
                for k, p in zip(self.KEYS, self.parts)}

    def result_fields(self, device, axis: int = 0) -> dict:
        ex = self.extras(axis=axis)
        return {f: torch.as_tensor(ex[k], device=device)
                for f, k in zip(DRAW_FIELDS, self.KEYS) if k in ex}


def stack(items):
    """Per-chain states, accums or results -> one of each with a leading
    chain axis (fields that are None stay None)."""
    return type(items[0])(*(None if f[0] is None else torch.stack(f)
                            for f in zip(*items)))


def unstack(stacked) -> list:
    """The inverse of ``stack`` for states and accums."""
    return [type(stacked)(*(f[c] for f in stacked))
            for c in range(stacked[0].shape[0])]


def prepare(n, cfg: SamplerConfig, kernel):
    """The f32 counts and the kernel choice bound to them, after the
    refusals a run makes before its start."""
    n = n.to(torch.float32)
    ks = kernel if isinstance(kernel, Kernels) else resolve(kernel, n)
    make_sweep_fn(cfg, ks)   # the resident path's refusals, before the start
    check_store_thin(cfg)
    return n, ks


def init_chains(n, cfg: SamplerConfig, generators: Sequence[torch.Generator],
                eta_init=None, tau_init=None):
    """Per-chain (states, accums) lists for a fresh multi-chain run, each
    chain's NMF start drawn from its own generator."""
    V, S, _ = n.shape
    states = [init_state(n, cfg, g, eta_init, tau_init) for g in generators]
    accums = [init_accum(V, S, cfg.G, n.device) for _ in generators]
    return states, accums


def advance_chains(n, cfg: SamplerConfig, states: List[SamplerState],
                   accums: List[SamplerAccum], noises, it: int, n_sweeps: int,
                   kernel: Kernels, burn: Optional[int] = None,
                   store: bool = False):
    """Every chain one segment from sweep `it`, in turn (the lists are
    updated in place). Returns the host trace [C, n_sweeps] and, with
    store, the host draws [C, k, ...] (else None)."""
    traces, draws = [], []
    for c, noise in enumerate(noises):
        out = run_segment(n, cfg, states[c], accums[c], it, n_sweeps, noise,
                          kernel, burn=burn, store=store)
        states[c], accums[c] = out[:2]
        traces.append(out[2])
        if store:
            draws.append(out[3])
    stacked = None
    if store:
        stacked = tuple(_numpy(torch.stack(d)) for d in zip(*draws))
    return _numpy(torch.stack(traces)), stacked


def stacked_result(accums: List[SamplerAccum], cfg: SamplerConfig,
                   trace: np.ndarray, draws: _DrawBuf, device) -> SamplerResult:
    """The chains' results stacked on a leading axis, from their
    accumulators, the host trace [C, sweeps] and the stored draws."""
    trace = torch.as_tensor(trace, device=device)
    res = stack([_result_from_accum(ac, cfg, trace[c])
                 for c, ac in enumerate(accums)])
    return res._replace(**draws.result_fields(device, axis=1))


def run_chains_checkpointed(
    n: torch.Tensor,
    cfg: SamplerConfig,
    seeds: Sequence[int],
    checkpoint_path: str,
    checkpoint_every: int = 50,
    eta_init=None,
    tau_init=None,
    kernel="cuda",
) -> SamplerResult:
    """``sampler.run_chains`` with periodic checkpoints and automatic resume.

    Every chain advances one segment in turn, each from its own generator
    (seeded seeds[i]); then one npz holds every chain's state, accumulators
    and generator state with a leading chain axis. The result is bitwise
    ``run_chains`` of the same seeds however often the run was interrupted,
    the per-chain thinned draws ([C, k, ...]) of cfg.store_samples included.
    """
    generators = [chain_generator(s, n.device) for s in seeds]
    return _run_checkpointed(n, cfg, generators, checkpoint_path,
                             checkpoint_every, eta_init, tau_init, kernel)


def run_chain_checkpointed(
    n: torch.Tensor,
    cfg: SamplerConfig,
    generator: torch.Generator,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    eta_init=None,
    tau_init=None,
    kernel="cuda",
) -> SamplerResult:
    """``sampler.run_chain`` with periodic checkpoints and automatic resume:
    one chain of ``run_chains_checkpointed``, from `generator`.

    If checkpoint_path exists the run resumes from it (the generator's
    state included); otherwise it starts fresh. The result is bitwise
    ``run_chain`` with the same (n, cfg, generator seed) however often the
    run was interrupted, the thinned draws of cfg.store_samples included.
    """
    return chain_result(_run_checkpointed(
        n, cfg, [generator], checkpoint_path, checkpoint_every, eta_init,
        tau_init, kernel), 0)


def _run_checkpointed(n, cfg: SamplerConfig, generators, checkpoint_path: str,
                      checkpoint_every: int, eta_init, tau_init, kernel):
    n, ks = prepare(n, cfg, kernel)
    if os.path.exists(checkpoint_path):
        state, accum, it, trace_done, gen_state = load(checkpoint_path, n.device)
        states, accums = unstack(state), unstack(accum)
        restore_generators(generators, gen_state)
        trace_parts = [trace_done[:, :it]]
        draws = _DrawBuf(load_extras(checkpoint_path))
    else:
        states, accums = init_chains(n, cfg, generators, eta_init, tau_init)
        it = 0
        trace_parts = []
        draws = _DrawBuf()
    noises = [TorchNoise(g) for g in generators]

    while it < cfg.total_sweeps:
        check_preempted()
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        trace, seg_draws = advance_chains(n, cfg, states, accums, noises, it, seg,
                                          ks, store=cfg.store_samples)
        if seg_draws is not None:
            draws.append(*seg_draws, axis=1)
        it += seg
        trace_parts.append(trace)
        save(checkpoint_path, stack(states), stack(accums), it,
             np.concatenate(trace_parts, axis=1), generators,
             extras=draws.extras(axis=1))

    return stacked_result(accums, cfg, np.concatenate(trace_parts, axis=1),
                          draws, n.device)


# --------------------------------------------------------------------------
# parallel-tempering checkpoints (replica states + rung assignment)
# --------------------------------------------------------------------------

def save_pt(path: str, states, accums, rung, it: int, trace: np.ndarray,
            n_acc: float, n_heads: float, generators: Sequence[torch.Generator],
            extras: Optional[dict] = None) -> None:
    """Serialize a PT snapshot atomically (write + rename): the replicas'
    states and accumulators (lists, stacked here on a leading [R] axis),
    rung, it, the cold trace so far, the accepted exchanges and proposals,
    every generator's state (the R replicas', then the exchange's) and the
    caller's ``extras`` (stored cold draws)."""
    save(path, stack(states), stack(accums), it, trace, generators, extras,
         payload={"rung": _numpy(rung).astype(np.int32),
                  "n_acc": np.asarray(n_acc, np.float64),
                  "n_heads": np.asarray(n_heads, np.float64)})


def load_pt(path: str, device="cpu"):
    """(states, accums, rung, it, trace, n_acc, n_heads, generator_state) of
    a PT snapshot: per-replica lists, rung as int64 on `device`."""
    state, accum, it, trace, gen_state = load(path, device)
    with np.load(path) as z:
        rung = torch.as_tensor(z["rung"].astype(np.int64), device=device)
        n_acc, n_heads = float(z["n_acc"]), float(z["n_heads"])
    return (unstack(state), unstack(accum), rung, it, trace, n_acc, n_heads,
            gen_state)


def run_chain_pt_checkpointed(
    n: torch.Tensor,
    cfg: SamplerConfig,
    seed: int,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    eta_init=None,
    tau_init=None,
    kernel="cuda",
) -> SamplerResult:
    """``sampler.run_chain_pt`` with periodic checkpoints and automatic
    resume: the result is bitwise ``run_chain_pt`` of the same (n, cfg,
    seed, n_replicas, max_temp) however often the run was interrupted, the
    cold-rung thinned draws of cfg.store_samples included. A SIGTERM raises
    ``Preempted`` at the next segment head. R < 2 is
    ``run_chain_checkpointed`` with a generator seeded `seed`.
    """
    R = int(n_replicas)
    if R < 2:   # the same fallback as run_chain_pt
        return run_chain_checkpointed(n, cfg, chain_generator(seed, n.device),
                                      checkpoint_path, checkpoint_every,
                                      eta_init, tau_init, kernel)
    n, ks = prepare(n, cfg, kernel)
    make_pt_step(n, cfg, R, max_temp, ks)   # the refusals, before the start
    generators = pt_generators(seed, R, n.device)
    if os.path.exists(checkpoint_path):
        (states, accums, rung, it, trace_done, acc_sum, head_sum,
         gen_state) = load_pt(checkpoint_path, n.device)
        restore_generators(generators, gen_state)
        trace_parts = [trace_done[:it]]
        draws = _DrawBuf(load_extras(checkpoint_path))
    else:
        states, accums, rung = pt_init(n, cfg, generators[:R], eta_init, tau_init)
        it, acc_sum, head_sum = 0, 0.0, 0.0
        trace_parts = []
        draws = _DrawBuf()
    noises, exchange = pt_noises(generators)
    n_acc = torch.tensor(acc_sum, dtype=torch.float32, device=n.device)

    while it < cfg.total_sweeps:
        check_preempted()
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        out = run_pt_segment(n, cfg, states, accums, rung, it, seg, noises,
                             exchange, max_temp, ks, store=cfg.store_samples)
        states, accums, rung, trace, seg_acc, seg_heads = out[:6]
        if cfg.store_samples:
            draws.append(*(_numpy(d) for d in out[6]))
        it += seg
        n_acc = n_acc + seg_acc
        head_sum += seg_heads
        trace_parts.append(_numpy(trace))
        save_pt(checkpoint_path, states, accums, rung, it,
                np.concatenate(trace_parts), float(n_acc), head_sum, generators,
                extras=draws.extras())

    trace = torch.as_tensor(np.concatenate(trace_parts), device=n.device)
    return _result_from_accum(pt_merge_accums(accums), cfg, trace,
                              pt_swap_accept=pt_swap_rate(n_acc, head_sum),
                              **draws.result_fields(n.device))
