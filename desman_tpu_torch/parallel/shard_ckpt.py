"""Sharded checkpoints: one file a rank for its blocks, and a manifest
(counterpart of ``desman_tpu.parallel.shard_ckpt``).

No rank ever holds the whole [C, V, ...] state: each writes only what it
owns, and a resumed rank reads back only the blocks that overlap its new
place, so a checkpoint written on one (world, mesh) layout resumes on
another.

A checkpoint directory (on a file system every rank shares):

    p{rank}_it{it}.npz   the rank's blocks. Member "{field}@{c},{v}" is a
                         position block (chains from c, rows from v);
                         "{field}@{c}" a chain block of a field every rank
                         of a chain row holds alike (gamma, eta, logliks,
                         kappas, the accumulators' sums and stars, the
                         chains' generator states and loglik traces),
                         written by the row's first rank only
    p{rank}_draws_s{s}.npz  the thinned draws of the segment from sweep s
                         (--store_every), keyed the same way
    manifest.json        the commit record: it, V, the padded V, the chain
                         count, the mesh, each field's global shape and
                         dtype. The coordinator writes it last, by rename,
                         after every rank's file is on disk.

When chain rows replicate one chain (a single chain on an n_chain > 1
mesh), only row 0 writes.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

import numpy as np
import torch

from ..checkpoint import stack, unstack
from ..convert import accum_from_numpy, state_from_numpy
from ..likelihood import mixture
from ..sampler import SamplerAccum, SamplerState
from ..utils import one_hot_tau
from .distributed import is_coordinator, rank

_STATE_FIELDS = SamplerState._fields
_ACCUM_FIELDS = SamplerAccum._fields
# the fields with a position axis (after the chain axis)
ROW_FIELDS = ("state_tau", "state_mix", "accum_sum_tau", "accum_star_tau")
_DRAW_FIELDS = ("tau", "gamma", "eta")


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _writes(shard, replicated: bool):
    """(position blocks, chain blocks): what this rank writes."""
    rows = not replicated or shard.c == 0
    return rows, rows and shard.d == 0


def _atomic_savez(path: str, payload: dict) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The committed sweep index, or None when nothing is committed."""
    mpath = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.isfile(mpath):
        return None
    with open(mpath) as f:
        return int(json.load(f)["it"])


def save_sharded(ckpt_dir: str, shard, chains: range, n_chains: int, states,
                 accums, generators, it: int, trace: np.ndarray,
                 replicated: bool = False) -> None:
    """Write one step: every rank its blocks, then (after a barrier) the
    coordinator's manifest, the commit point; then the coordinator drops
    the files of earlier steps. trace: the rank's chains' [k, it] host
    loglik traces."""
    os.makedirs(ckpt_dir, exist_ok=True)
    write_rows, write_chain = _writes(shard, replicated)
    c0 = chains.start
    st, ac = stack(states), stack(accums)
    leaves = [(f"state_{k}", v) for k, v in zip(_STATE_FIELDS, st)]
    leaves += [(f"accum_{k}", v) for k, v in zip(_ACCUM_FIELDS, ac)]
    leaves.append(("generator_state", torch.stack([g.get_state() for g in generators])))
    leaves.append(("trace", torch.as_tensor(np.asarray(trace, np.float32))))
    fields, payload = {}, {}
    for name, x in leaves:
        x = _numpy(x)
        rows = name in ROW_FIELDS
        shape = [n_chains] + list(x.shape[1:])
        if rows:
            shape[1] = shard.Vp
        fields[name] = {"shape": shape, "dtype": str(x.dtype), "rows": rows}
        if rows and write_rows:
            payload[f"{name}@{c0},{shard.lo}"] = x
        elif not rows and write_chain:
            payload[f"{name}@{c0}"] = x
    spath = os.path.join(ckpt_dir, f"p{rank()}_it{it}.npz")
    if payload:
        _atomic_savez(spath, payload)
    shard.world.barrier()               # every rank's blocks are on disk ...
    if is_coordinator():                # ... before the commit record
        mpath = os.path.join(ckpt_dir, "manifest.json")
        with open(mpath + ".tmp", "w") as f:
            json.dump({"it": int(it), "V": shard.V, "Vp": shard.Vp,
                       "chains": n_chains, "mesh": [shard.mesh.n_chain,
                                                    shard.mesh.n_data],
                       "n_proc": shard.world.size, "fields": fields}, f)
        os.replace(mpath + ".tmp", mpath)
        for old in glob.glob(os.path.join(ckpt_dir, "p*_it*.npz")):
            if not old.endswith(f"_it{it}.npz"):
                os.remove(old)
    shard.world.barrier()


def _offsets(tag: str, ndim: int) -> tuple:
    off = tuple(int(x) for x in tag.split(",")) if tag else ()
    return off + (0,) * (ndim - len(off))


def assemble_blocks(shape, dtype, region, parts) -> np.ndarray:
    """The region (a tuple of slices into an array of ``shape``) from
    blocks given as (offsets, ndarray) pairs that tile the array; each
    block copies its overlap with the region. Raises when the blocks leave
    part of the region uncovered."""
    lo = [s.start or 0 for s in region]
    hi = [shape[d] if s.stop is None else s.stop for d, s in enumerate(region)]
    out = np.empty([h - l for l, h in zip(lo, hi)], dtype)
    covered = np.zeros(out.shape, bool)
    for off, blk in parts:
        src, dst = [], []
        for d in range(len(shape)):
            o_lo, o_hi = max(lo[d], off[d]), min(hi[d], off[d] + blk.shape[d])
            if o_lo >= o_hi:
                break
            src.append(slice(o_lo - off[d], o_hi - off[d]))
            dst.append(slice(o_lo - lo[d], o_hi - lo[d]))
        else:
            out[tuple(dst)] = blk[tuple(src)]
            covered[tuple(dst)] = True
    if not covered.all():
        raise ValueError("checkpoint blocks do not cover the requested region "
                         f"({int(covered.sum())}/{covered.size} elements)")
    return out


def _blocks(paths) -> dict:
    """name -> [(tag, npz, key)] over the given shard files."""
    blocks: dict = {}
    for path in paths:
        z = np.load(path)
        for key in z.files:
            if "@" in key:
                name, tag = key.rsplit("@", 1)
                blocks.setdefault(name, []).append((tag, z, key))
    return blocks


def load_sharded(ckpt_dir: str, shard, chains: range, n_chains: int, device):
    """The committed step rebuilt for this rank's place: (states, accums,
    it, trace [k, it] host, generator states [k, ...] uint8) of its chains
    and its rows. Rows past the writer's padded V (a layout that pads
    further) start as pad rows: base A, the mixture of gamma."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    it = int(manifest["it"])
    if manifest["chains"] != n_chains or manifest["V"] != shard.V:
        raise ValueError(
            f"checkpoint {ckpt_dir} holds {manifest['chains']} chains of V="
            f"{manifest['V']}; this run has {n_chains} of V={shard.V}")
    blocks = _blocks(sorted(glob.glob(os.path.join(ckpt_dir, f"p*_it{it}.npz"))))
    vp_old = int(manifest["Vp"])
    top = min(shard.hi, vp_old)

    def build(name):
        spec = manifest["fields"][name]
        shape, dtype = tuple(spec["shape"]), np.dtype(spec["dtype"])
        region = [slice(chains.start, chains.stop)]
        if spec["rows"]:
            region.append(slice(shard.lo, top))
        region += [slice(0, s) for s in shape[len(region):]]
        parts = [(_offsets(tag, len(shape)), z[key])
                 for tag, z, key in blocks.get(name, [])]
        out = assemble_blocks(shape, dtype, tuple(region), parts)
        if spec["rows"] and top < shard.hi:
            pad = np.zeros((out.shape[0], shard.hi - top) + out.shape[2:], dtype)
            out = np.concatenate([out, pad], axis=1)
        return out

    state = state_from_numpy({k: build(f"state_{k}") for k in _STATE_FIELDS}, device)
    accum = accum_from_numpy({k: build(f"accum_{k}") for k in _ACCUM_FIELDS}, device)
    states, accums = unstack(state), unstack(accum)
    if top < shard.hi:
        start = top - shard.lo
        for i, s in enumerate(states):
            mix = s.mix.clone()
            mix[start:] = mixture(one_hot_tau(s.tau[start:]), s.gamma)
            states[i] = s._replace(mix=mix)
    return states, accums, it, build("trace"), build("generator_state")


def save_draw_shards(ckpt_dir: str, shard, chains: range, start_it: int, sweeps,
                     draws, replicated: bool = False) -> None:
    """One segment's thinned draws, each rank its blocks: draws = (tau
    int8 [k, n, rows, G], gamma [k, n, S, G], eta [k, n, 4, 4]) of its k
    chains and n draws; sweeps: the draws' absolute sweep indices. Files
    are named by segment start, so a rerun of the segment rewrites them."""
    write_rows, write_chain = _writes(shard, replicated)
    c0 = chains.start
    payload = {}
    if write_rows:
        payload[f"tau@{c0},{shard.lo}"] = draws[0]
    if write_chain:
        payload[f"gamma@{c0}"], payload[f"eta@{c0}"] = draws[1], draws[2]
    if payload:
        os.makedirs(ckpt_dir, exist_ok=True)
        payload["sweeps"] = np.asarray(sweeps, np.int64)
        _atomic_savez(os.path.join(ckpt_dir, f"p{rank()}_draws_s{start_it}.npz"),
                      payload)


def clear_draws_from(ckpt_dir: str, it: int) -> None:
    """Drop draw files of segments from sweep `it` on (uncommitted, or of
    an earlier run in the directory). Coordinator only."""
    for path in glob.glob(os.path.join(ckpt_dir, "p*_draws_s*.npz")):
        if int(re.search(r"_draws_s(\d+)\.npz$", path).group(1)) >= it:
            os.remove(path)


def assemble_draws(ckpt_dir: str, n_chains: int, V: int, S: int, G: int):
    """Every stored draw, sweep-ordered, from all ranks' draw files:
    {field: [C, n, ...]} with tau's rows cut to V, or {} without draws."""
    shapes = {"tau": (n_chains, V, G), "gamma": (n_chains, S, G),
              "eta": (n_chains, 4, 4)}
    dtypes = {"tau": np.int8, "gamma": np.float32, "eta": np.float32}
    by_sweep: dict = {}
    for path in sorted(glob.glob(os.path.join(ckpt_dir, "p*_draws_s*.npz"))):
        z = np.load(path)
        sweeps = z["sweeps"]
        for key in z.files:
            if key == "sweeps":
                continue
            name, tag = key.rsplit("@", 1)
            blk = z[key]
            off = _offsets(tag, 3)
            for j, a in enumerate(sweeps):
                by_sweep.setdefault(int(a), {}).setdefault(name, []).append(
                    (off, blk[:, j]))
    if not by_sweep:
        return {}
    order = sorted(by_sweep)
    return {name: np.stack([
        assemble_blocks(shapes[name], dtypes[name],
                        tuple(slice(0, s) for s in shapes[name]), by_sweep[a][name])
        for a in order], axis=1) for name in _DRAW_FIELDS}
