"""Sampler state and results as numpy arrays, both ways.

The "weights" of this system are the sampler's state. These functions move
it between the port's tensors and plain numpy arrays keyed by the field
names the JAX package's ``SamplerState`` / ``SamplerAccum`` /
``SamplerResult`` / ``GeneAssignResult`` use, so one state can start both
packages and one result can be read by either. The JAX state's PRNG
``key`` has no counterpart: the generators differ. A result field that is
None (no stored draws) stays None both ways. ``snapshot_from_jax_npz``
and ``pt_snapshot_from_jax_npz`` read the JAX package's checkpoint files
the same way.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .geneassign import GeneAssignResult
from .sampler import SamplerAccum, SamplerResult, SamplerState
from .utils import NBASES

_INT_FIELDS = ("tau", "star_tau", "tau_star")
_INT8_FIELDS = ("tau_samples",)


def _tensor(name: str, x, device) -> torch.Tensor:
    dtype = (torch.int8 if name in _INT8_FIELDS else
             torch.int32 if name in _INT_FIELDS else torch.float32)
    return torch.as_tensor(np.array(x), device=device).to(dtype).contiguous()


def state_from_numpy(d: Mapping, device="cpu", V: Optional[int] = None
                     ) -> SamplerState:
    """Port state from a mapping of SamplerState fields (extra keys such as
    ``key`` are ignored).

    Also takes the JAX package's resident state, whose ``mix`` is the
    base-major [Vp, 4S] mixture (lane a*S + s) and whose ``mix`` and
    ``tau`` carry pad rows past V: give V, and the mixture comes back as
    [V,S,4] and both without the pad rows.
    """
    d = dict(d)
    mix = np.asarray(d["mix"])
    if mix.ndim == 2:
        if V is None:
            raise ValueError("a base-major [Vp, 4S] mixture needs V")
        Vp, lanes = mix.shape
        S = lanes // NBASES
        d["mix"] = mix.reshape(Vp, NBASES, S).transpose(0, 2, 1)[:V]
        d["tau"] = np.asarray(d["tau"])[:V]
    return SamplerState(**{f: _tensor(f, d[f], device)
                           for f in SamplerState._fields})


def topk_layout_from_numpy(n_val, b_idx, device="cpu"):
    """The top-2 kernel's layout (``ops.tau_topk.TopkLayout``: [V,S,2] per
    cell, slots in ascending base order) from the JAX package's slot-major
    ``compress_counts`` arrays (n_val/b_idx [V, 2S], lane = k*S + s, slots
    by descending count)."""
    from .ops.tau_topk import K_SLOTS, TopkLayout

    n_val = np.asarray(n_val, np.float32)
    b_idx = np.asarray(b_idx, np.int32)
    V, lanes = n_val.shape
    S = lanes // K_SLOTS
    vals = n_val.reshape(V, K_SLOTS, S).transpose(0, 2, 1)       # [V,S,2]
    idx = b_idx.reshape(V, K_SLOTS, S).transpose(0, 2, 1)
    order = np.argsort(idx, axis=2, kind="stable")
    vals = np.take_along_axis(vals, order, axis=2)
    idx = np.take_along_axis(idx, order, axis=2)
    return TopkLayout(
        n_val=torch.as_tensor(np.ascontiguousarray(vals), device=device),
        b_idx=torch.as_tensor(np.ascontiguousarray(idx), device=device))


def accum_from_numpy(d: Mapping, device="cpu") -> SamplerAccum:
    return SamplerAccum(**{f: _tensor(f, d[f], device)
                           for f in SamplerAccum._fields})


def snapshot_from_jax_npz(path: str, device="cpu"):
    """(SamplerState, SamplerAccum, it, trace) of a checkpoint the JAX
    package's ``checkpoint.save`` wrote (a single chain's, or chains' with a
    leading axis). Its chain key (``state_key``) has no counterpart and is
    dropped; its noise can be replayed from that key by the caller."""
    with np.load(path) as z:
        state = state_from_numpy(
            {f: z[f"state_{f}"] for f in SamplerState._fields}, device)
        accum = accum_from_numpy(
            {f: z[f"accum_{f}"] for f in SamplerAccum._fields}, device)
        return state, accum, int(z["it"]), np.asarray(z["trace"])


def pt_snapshot_from_jax_npz(path: str, device="cpu"):
    """(states, accums, rung, it, trace, n_acc, n_heads) of a snapshot the
    JAX package's ``checkpoint.save_pt`` wrote: per-replica lists of
    SamplerState / SamplerAccum (its [R] axis unstacked), rung int64 [R].
    The replicas' keys (``state_key``) have no counterpart and are dropped;
    their noise can be replayed from those keys by the caller."""
    with np.load(path) as z:
        R = z["rung"].shape[0]
        states = [state_from_numpy(
            {f: z[f"state_{f}"][r] for f in SamplerState._fields}, device)
            for r in range(R)]
        accums = [accum_from_numpy(
            {f: z[f"accum_{f}"][r] for f in SamplerAccum._fields}, device)
            for r in range(R)]
        rung = torch.as_tensor(z["rung"].astype(np.int64), device=device)
        return (states, accums, rung, int(z["it"]), np.asarray(z["trace"]),
                float(z["n_acc"]), float(z["n_heads"]))


def _to_numpy(t) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def state_to_numpy(state: SamplerState) -> dict:
    return {f: _to_numpy(getattr(state, f)) for f in SamplerState._fields}


def accum_to_numpy(accum: SamplerAccum) -> dict:
    return {f: _to_numpy(getattr(accum, f)) for f in SamplerAccum._fields}


def result_to_numpy(res: SamplerResult) -> dict:
    return {f: _to_numpy(getattr(res, f)) for f in SamplerResult._fields}


def result_from_numpy(d: Mapping, device="cpu") -> SamplerResult:
    """Port result from a mapping of SamplerResult fields (the JAX
    result's ``_asdict()`` as numpy arrays, or ``result_to_numpy``'s).
    Fields the mapping lacks or holds as None come back None (PT's
    ``pt_swap_accept`` included); keys that are no result field are
    ignored."""
    return SamplerResult(**{
        f: None if d.get(f) is None else _tensor(f, d[f], device)
        for f in SamplerResult._fields})


def geneassign_to_numpy(res: GeneAssignResult) -> dict:
    return {f: _to_numpy(getattr(res, f)) for f in GeneAssignResult._fields}


def geneassign_from_numpy(d: Mapping, device="cpu") -> GeneAssignResult:
    """GeneAssign result from numpy arrays (eta_star int32, the rest f32)."""
    return GeneAssignResult(**{
        f: torch.as_tensor(np.array(d[f]), device=device).to(
            torch.int32 if f == "eta_star" else torch.float32).contiguous()
        for f in GeneAssignResult._fields})
