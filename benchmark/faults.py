"""Faults planted in the program, to see ``correct`` come out false: a
sweep whose updates return the state they were given; the tau sweep and
the swap reading the counts of half the positions; an answer altered where
it is produced (a chain's star haplotypes and a bin's filter error matrix;
a bin's selected positions, its chosen G, its gene calls).

``test_bench_faults.py`` plants each in a small run on the CPU;
``control.py --fault NAME`` plants it in a run at the cell's own size on
the card. Each takes a ``pytest.MonkeyPatch``-like object (``setattr``),
which undoes it. ``ENTRIES`` names the entries a fault can reach (all where
it is not named). No cell spans chips, so none can drop an exchange.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def unchanged(mp) -> None:
    """Every sweep's updates return the state they were given."""
    from desman_tpu_torch import resident, sampler

    def front(cfg, ks, n, state, it, noise, temp, *rest):
        zero = torch.zeros(state.loglik.shape, device=state.loglik.device)
        return (state.tau, state.mix, state.gamma, state.eta, state.loglik, zero, zero)

    mp.setattr(sampler, "_staged_front", front)
    mp.setattr(resident, "front", front)


def half(mp) -> None:
    """The tau sweep and the swap (the fused sweep) read the counts of the
    first half of the positions only: the second half's count as zero."""
    from desman_tpu_torch import model_selection, ops, sampler

    def keep_half(fn):
        def wrapped(n, *args, **kw):
            n = n.clone()
            n[..., n.shape[-3] // 2:, :, :] = 0
            return fn(n, *args, **kw)
        return wrapped

    def resolve(kernel, n=None):
        ks = ops.resolve(kernel, n)
        return ks._replace(tau_sweep=keep_half(ks.tau_sweep), swap=keep_half(ks.swap),
                           fused_sweep=keep_half(ks.fused_sweep))

    mp.setattr(sampler, "resolve", resolve)
    mp.setattr(model_selection, "resolve", resolve)


def altered(mp) -> None:
    """A chain's star haplotypes change strain 0's base at every 20th
    position as the chain returns them; the filter's error matrix moves
    1e-4 of row A's mass from A to C as the filter returns it."""
    from desman_tpu_torch import pipeline, sampler

    run_chain = sampler.run_chain

    def chain(*args, **kw):
        res = run_chain(*args, **kw)
        tau = res.tau_star.clone()
        tau[::20, 0] = (tau[::20, 0] + 1) % 4
        return res._replace(tau_star=tau)

    filter_variants = pipeline.filter_variants

    def filtered(*args, **kw):
        res = filter_variants(*args, **kw)
        res.eta = res.eta.copy()
        res.eta[0, 0] -= 1e-4
        res.eta[0, 1] += 1e-4
        return res

    mp.setattr(sampler, "run_chain", chain)
    mp.setattr(pipeline, "filter_variants", filtered)


def altered_selection(mp) -> None:
    """The filter drops every 100th position it selects, as it returns its
    selection."""
    from desman_tpu_torch import pipeline

    filter_variants = pipeline.filter_variants

    def filtered(*args, **kw):
        res = filter_variants(*args, **kw)
        res.selected = res.selected.copy()
        res.selected[np.flatnonzero(res.selected)[::100]] = False
        return res

    mp.setattr(pipeline, "filter_variants", filtered)


def altered_g(mp) -> None:
    """``resolve_nhap`` returns a G one above the one it picked (its run
    kept)."""
    from desman_tpu_torch import pipeline

    resolve_nhap = pipeline.resolve_nhap

    def resolve(*args, **kw):
        res = resolve_nhap(*args, **kw)
        return dataclasses.replace(res, G=res.G + 1)

    mp.setattr(pipeline, "resolve_nhap", resolve)


def altered_genes(mp) -> None:
    """GeneAssign's presence probability of strain 1 in every 50th gene
    turns to its complement, as ``assign_genes`` returns it."""
    from desman_tpu_torch import pipeline

    assign_genes = pipeline.assign_genes

    def assign(*args, **kw):
        res = assign_genes(*args, **kw)
        p = res.presence_prob.clone()
        p[::50, 0] = 1.0 - p[::50, 0]
        return res._replace(presence_prob=p)

    mp.setattr(pipeline, "assign_genes", assign)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "altered_selection": altered_selection, "altered_g": altered_g,
          "altered_genes": altered_genes}
# the entries a fault can reach, where not all
ENTRIES = {"altered_selection": ("run_pipeline",), "altered_g": ("run_pipeline",),
           "altered_genes": ("run_pipeline",)}


def reaches(fault: str, entry: str) -> bool:
    return entry in ENTRIES.get(fault, (entry,))
