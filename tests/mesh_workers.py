"""Rank functions of the mesh tests (tests/test_torch_mesh*.py and the card
tests in tests/test_torch_cuda.py).

Each runs as every rank of a world that ``desman_tpu_torch.parallel.launch``
starts (gloo on the CPU, one torch thread a rank), and rank 0 saves what the
test reads to an npz. A world may run several jobs in turn, so that one
start of its processes serves them all. Nothing here imports JAX but
``replay``, which rebuilds the JAX package's streams.
"""
import os
import signal

import numpy as np
import torch

from desman_tpu_torch import checkpoint, cli, convert, sampler
from desman_tpu_torch.parallel import distributed, make_mesh, sharded

# a world that outlives this fails its test (launch returns 124)
WORLD_TIMEOUT_S = 120


def _join(device):
    if device == "cpu":
        torch.set_num_threads(1)
    distributed.maybe_initialize(device)


def _arrays(res, prefix=""):
    return {} if res is None else {
        prefix + k: v.cpu().numpy() for k, v in res._asdict().items() if v is not None}


def _save(out, **arrays):
    if distributed.is_coordinator():
        np.savez(out, **arrays)


def chains(out, counts, cfg_kw, seeds, shape, device="cpu", kernel="cuda", runs=1):
    """run_chains_sharded `runs` times; run i's fields as "{i}_{field}"."""
    _join(device)
    cfg = sampler.SamplerConfig(**cfg_kw)
    arrays = {}
    for i in range(runs):
        res = sharded.run_chains_sharded(counts, cfg, seeds, make_mesh(*shape),
                                         kernel=kernel, device=device)
        arrays.update(_arrays(res, f"{i}_"))
    _save(out, backend=str(distributed.backend()), **arrays)
    return 0


def alone(out, counts, cfg_kw, seeds, shape):
    """run_chains_sharded of `seeds` ("all_{field}"), then of each seed
    alone ("{seed}_{field}"), in one world."""
    _join("cpu")
    cfg = sampler.SamplerConfig(**cfg_kw)
    arrays = {}
    for name, run in [("all", seeds)] + [(str(s), [s]) for s in seeds]:
        res = sharded.run_chains_sharded(counts, cfg, run, make_mesh(*shape), device="cpu")
        arrays.update(_arrays(res, f"{name}_"))
    _save(out, **arrays)
    return 0


def run_costs(out, counts, shape, runs):
    """run_chains_sharded of each (name, seeds, cfg keywords) in `runs`;
    saves this rank's "{name}_calls" (``exchange.calls`` over the whole
    run), "{name}_sweeps" and "{name}_collectives" (``SWEEP_STATS``) and
    "{name}_tau"/"{name}_swap", the calls of the tau sweep and swap of its
    kernel choice."""
    from collections import Counter

    _join("cpu")
    calls = Counter()
    bind = sharded.shard_kernels

    def counted(*args):
        ks = bind(*args)

        def wrap(name):
            def fn(*a, **kw):
                calls[name] += 1
                return getattr(ks, name)(*a, **kw)
            return fn
        return ks._replace(tau_sweep=wrap("tau_sweep"), swap=wrap("swap"))

    sharded.shard_kernels = counted
    arrays = {}
    for name, seeds, kw in runs:
        calls.clear()
        before = dict(sharded.SWEEP_STATS)
        distributed.reset_collectives()
        sharded.run_chains_sharded(counts, sampler.SamplerConfig(**kw), seeds,
                                   make_mesh(*shape), device="cpu")
        arrays[f"{name}_calls"] = np.int64(distributed.exchange.calls)
        for k in ("sweeps", "collectives"):
            arrays[f"{name}_{k}"] = np.int64(sharded.SWEEP_STATS[k] - before[k])
        arrays[f"{name}_tau"], arrays[f"{name}_swap"] = (np.int64(calls["tau_sweep"]),
                                                         np.int64(calls["swap"]))
    _save(out, **arrays)
    return 0


def _sigterm_after_first_segment(method="segment"):
    """This rank gets SIGTERM once its first segment (``Shard.<method>``)
    has run."""
    real = getattr(sharded.Shard, method)

    def segment(self, *args, **kw):
        setattr(sharded.Shard, method, real)
        result = real(self, *args, **kw)
        os.kill(os.getpid(), signal.SIGTERM)
        return result

    setattr(sharded.Shard, method, segment)


def checkpointed(out, counts, cfg_kw, jobs, shape, device="cpu", term_rank=None,
                 kernel="cuda"):
    """Checkpointed runs in turn; jobs: (name, seeds, ckpt dir, every,
    stop_after, single) each, saved as "{name}_{field}" ("{name}_stopped"
    for a run that stopped). With term_rank, that rank gets SIGTERM after
    its first segment: every rank must exit 75 at the next segment head."""
    _join(device)
    checkpoint.install_preemption_handler()
    if term_rank is not None and distributed.rank() == term_rank:
        _sigterm_after_first_segment()
    arrays = {}
    for name, seeds, ck, every, stop_after, single in jobs:
        cfg = sampler.SamplerConfig(**cfg_kw)
        kw = dict(checkpoint_every=every, mesh=make_mesh(*shape), device=device,
                  stop_after=stop_after, kernel=kernel)
        try:
            if single:
                res = sharded.run_chain_sharded_checkpointed(counts, cfg, seeds[0], ck, **kw)
            else:
                res = sharded.run_chains_sharded_checkpointed(counts, cfg, seeds, ck, **kw)
        except checkpoint.Preempted:
            _save(out, preempted=np.int64(1))
            return distributed.PREEMPTED_EXIT
        if res is None:
            arrays[f"{name}_stopped"] = np.int64(1)
        arrays.update(_arrays(res, f"{name}_"))
    _save(out, **arrays)
    return 0


def pt(out, counts, cfg_kw, jobs, shape, device="cpu", term_rank=None, kernel="cuda"):
    """PT runs on the mesh in turn; jobs: (name, seed, R, ckpt dir or None,
    every, stop_after) each, saved as "{name}_{field}" ("{name}_stopped"
    for a run that stopped) with "{name}_collectives", this rank's
    collectives an ensemble sweep. With term_rank, that rank gets SIGTERM
    after its first segment: every rank must exit 75."""
    _join(device)
    checkpoint.install_preemption_handler()
    if term_rank is not None and distributed.rank() == term_rank:
        _sigterm_after_first_segment("pt_segment")
    arrays = {}
    for name, seed, R, ck, every, stop_after in jobs:
        cfg = sampler.SamplerConfig(**cfg_kw)
        kw = dict(n_replicas=R, mesh=make_mesh(*shape), kernel=kernel, device=device)
        before = dict(sharded.SWEEP_STATS)
        try:
            if ck is None:
                res = sharded.run_chain_pt_sharded(counts, cfg, seed, **kw)
            else:
                res = sharded.run_chain_pt_sharded_checkpointed(
                    counts, cfg, seed, ck, every, stop_after=stop_after, **kw)
        except checkpoint.Preempted:
            _save(out, preempted=np.int64(1))
            return distributed.PREEMPTED_EXIT
        if res is None:
            arrays[f"{name}_stopped"] = np.int64(1)
        arrays.update(_arrays(res, f"{name}_"))
        sweeps = sharded.SWEEP_STATS["sweeps"] - before["sweeps"]
        arrays[f"{name}_collectives"] = np.float64(
            (sharded.SWEEP_STATS["collectives"] - before["collectives"]) / max(sweeps, 1))
    _save(out, **arrays)
    return 0


def auto(out, counts, cfg_kw, jobs, shape, device="cpu", term_rank=None):
    """converge.run_chains_auto on the mesh in turn; jobs: (name, seeds,
    ckpt dir or None, auto keywords) each, saved as "{name}_{field}" with
    "{name}_burn" and "{name}_samples". With term_rank, that rank gets
    SIGTERM after its first segment: every rank must exit 75."""
    from desman_tpu_torch import converge

    _join(device)
    checkpoint.install_preemption_handler()
    if term_rank is not None and distributed.rank() == term_rank:
        _sigterm_after_first_segment()
    arrays = {}
    for name, seeds, ck, kw in jobs:
        try:
            res, burn, samples = converge.run_chains_auto(
                counts, sampler.SamplerConfig(**cfg_kw), seeds, checkpoint_path=ck,
                mesh=make_mesh(*shape), device=device, **kw)
        except checkpoint.Preempted:
            _save(out, preempted=np.int64(1))
            return distributed.PREEMPTED_EXIT
        arrays.update(_arrays(res, f"{name}_"))
        arrays[f"{name}_burn"], arrays[f"{name}_samples"] = np.int64(burn), np.int64(samples)
    _save(out, **arrays)
    return 0


class TraceFeed:
    """A stand-in for the sharded chains' ``run_segment`` that hands back a
    JAX run's loglik trace (and its stored gamma draws) for the sweeps
    asked: a rank of chain row c holds chains c k .. c k + k - 1 (k = C /
    n_chain) on one chain axis, and gets their [k, sweeps] trace and [k,
    slots, ...] draws in one call. The chain state does not move."""

    def __init__(self, trace, burn_used, gamma, first, k):
        self.trace, self.burn_used, self.gamma = trace, burn_used, gamma
        self.rows = slice(first, first + k)

    def __call__(self, n, cfg, state, accum, start_it, n_sweeps, noise, kernel="cuda",
                 burn=None, store=False, psum=None, agree=None):
        k = state.loglik.shape[0]
        assert k == self.rows.stop - self.rows.start, "a rank's chains on one axis"
        trace = torch.tensor(self.trace[self.rows, start_it:start_it + n_sweeps])
        assert trace.shape[1] == n_sweeps, "the port ran past JAX's run"
        if not store:
            return state, accum, trace
        assert burn == self.burn_used
        slots = checkpoint.stored_slots(start_it, n_sweeps, burn, cfg.store_thin)
        gamma = torch.tensor(self.gamma[self.rows][:, [start_it + j - burn for j in slots]])
        return state, accum, trace, (
            torch.zeros((k, len(slots), n.shape[0], cfg.G), dtype=torch.int8), gamma,
            torch.zeros((k, len(slots), 4, 4)))


def auto_feed(out, counts, cfg_kw, seeds, shape, trace, burn, gamma, ck, kw):
    """converge.run_chains_auto on the mesh fed a JAX run's traces
    (``TraceFeed``); saves the burn and sampling length chosen and the
    result's trace and gamma draws."""
    from desman_tpu_torch import converge

    _join("cpu")
    m = make_mesh(*shape)
    k = len(seeds) // m.n_chain
    sharded.run_segment = TraceFeed(trace, burn, gamma, distributed.rank() // m.n_data * k, k)
    res, b, s = converge.run_chains_auto(counts, sampler.SamplerConfig(**cfg_kw), seeds,
                                         checkpoint_path=ck, mesh=m, device="cpu", **kw)
    _save(out, burn=np.int64(b), samples=np.int64(s), **_arrays(res))
    return 0


def replicated(out, counts, cfg_kw, shape, sweeps):
    """A chain's sweeps one by one; after each, whether gamma, eta, the
    loglik, the kappas and the star loglik are bitwise equal on every rank
    of the chain row."""
    _join("cpu")
    cfg = sampler.SamplerConfig(**cfg_kw)
    sh = sharded.Shard(counts, make_mesh(*shape), "cpu")
    gen = sampler.chain_generator(0, sh.device)
    state, accum, noise = sh.init(cfg, [gen]), sh.accum(cfg, 1), sh.noise([gen])
    sweep = sh.sweep_fn(cfg)
    same = []
    for it in range(sweeps):
        state, accum, ll = sweep(sh.n, state, accum, it, noise)
        for x in (state.gamma, state.eta, state.loglik, state.kappa_gamma,
                  state.kappa_eta, ll, accum.star_loglik, accum.sum_gamma):
            parts = sh.data.gather(x)
            same.append(all(torch.equal(parts[0], p) for p in parts[1:]))
    _save(out, same=np.array(same))
    return 0


def collectives(out, counts, shape):
    """The collectives of one sweep: eta joint, eta rows, and with gamma
    and eta fixed (one likelihood pass)."""
    _join("cpu")
    found = {}
    for name, kw in (("joint", {}), ("rows", {"eta_update": "rows"}),
                     ("fixed", {"fix_gamma": True, "fix_eta": True})):
        cfg = sampler.SamplerConfig(G=3, burn=4, samples=4, nmf_iters=10, **kw)
        sh = sharded.Shard(counts, make_mesh(*shape), "cpu")
        gen = sampler.chain_generator(0, sh.device)
        state = sh.init(cfg, [gen])
        sweep = sh.sweep_fn(cfg)
        distributed.reset_collectives()
        sweep(sh.n, state, sh.accum(cfg, 1), 0, sh.noise([gen]))
        found[name] = np.int64(distributed.exchange.calls)
    _save(out, **found)
    return 0


def grid(out, counts, data, stub, g_values, seeds, shape, extra=None):
    """fit_grid on the mesh twice (extra: more fit_grid keywords): the
    second call must find every run on disk and sweep nothing."""
    from desman_tpu_torch.model_selection import fit_grid

    _join("cpu")
    kw = dict(iterations=20, out_stub=stub, data=data, mesh=make_mesh(*shape), device="cpu",
              **(extra or {}))
    first = fit_grid(counts, g_values, seeds, **kw)
    swept = sharded.SWEEP_STATS["sweeps"]
    again = fit_grid(counts, g_values, seeds, **kw)
    rows = torch.tensor([(r.G, r.seed, r.mean_deviance, r.uncertainty) for r in first],
                        dtype=torch.float64)
    by_rank = distributed.mesh_axes(kw["mesh"], torch.device("cpu")).world.gather(rows)
    _save(out, records=rows.numpy(), by_rank=by_rank.numpy(),
          again=np.array([(r.G, r.seed, r.mean_deviance, r.uncertainty) for r in again]),
          swept_again=np.int64(sharded.SWEEP_STATS["sweeps"] - swept),
          swept=np.int64(swept))
    return 0


def peak_memory(out, data, rc_kw, shape=None):
    """run_multi of one chain (or, with pt_replicas, of one PT run) on the
    card, on the mesh (shape: run_pt_sharded for PT) or on one device
    (None); every rank's peak allocated device bytes over the run, from a
    fresh process: cuBLAS's workspace included ("peaks", by rank)."""
    from desman_tpu_torch import run

    _join("cuda")
    dev = distributed.rank_device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = None if shape is None else make_mesh(*shape)
    rc = run.RunConfig(**rc_kw)
    if mesh is not None and rc.pt_replicas >= 2:
        run.run_pt_sharded(data, rc, mesh, device=dev, kernel="cuda")
    else:
        run.run_multi(data, rc, 1, device=dev, kernel="cuda", mesh=mesh)
    torch.cuda.synchronize(dev)
    peak = torch.tensor(torch.cuda.max_memory_allocated(dev), device=dev)
    peaks = distributed.mesh_axes(mesh or make_mesh(1, 1), dev).world.gather(peak)
    _save(out, peaks=peaks.cpu().numpy())
    return 0


def placement(out, counts, cfg_kw, seeds, shape):
    """run_chains_sharded with stored draws; which result fields each rank
    holds ("held", [rank, field]: 1 where not None), and rank 0's fields."""
    _join("cpu")
    mesh = make_mesh(*shape)
    res = sharded.run_chains_sharded(counts, sampler.SamplerConfig(**cfg_kw), seeds, mesh,
                                     device="cpu")
    held = torch.tensor([x is not None for x in res], dtype=torch.int64)
    held = distributed.mesh_axes(mesh, torch.device("cpu")).world.gather(held)
    _save(out, held=held.numpy(), **_arrays(res, "0_"))
    return 0


def desman(argv):
    """The desman CLI on every rank of a world (the torchrun path)."""
    return cli.main(["desman", *argv])


def replay(out, counts, cfg_kw, shape, keys, jstates, jaccums):
    """The sharded chains of the chain keys `keys` fed the JAX package's
    streams: a ``ReplayNoise`` of each key on one chain axis (``ChainNoise``'s
    per-source path), cut to each rank's block. Their own run from JAX's
    start (jstates[0]), and one sweep from each of JAX's states (jstates,
    jaccums: each sweep's trees with a leading chain axis). Saves the whole
    tau, mix and the replicated fields of both, chain axis first."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from torch_helpers import ReplayNoise

    _join("cpu")
    cfg = sampler.SamplerConfig(**cfg_kw)
    sh = sharded.Shard(counts, make_mesh(*shape), "cpu")
    noise = sh.noise([ReplayNoise(jnp.asarray(k)) for k in keys])
    rows = ("tau", "mix", "sum_tau", "star_tau")

    def block(tree):
        return {k: (v[:, sh.lo:sh.hi] if k in rows else v) for k, v in tree.items()}

    def whole(x):
        return torch.cat(list(sh.data.gather(x)), dim=1).numpy()

    start = convert.state_from_numpy(block(jstates[0]))
    _, accum, trace = sh.segment(cfg, start, sh.accum(cfg, len(keys)), 0,
                                 len(jstates) - 1, noise)
    res = sampler._result_from_accum(accum, cfg, trace)
    arrays = {"own_tau_star": whole(res.tau_star), "own_trace": trace.numpy()}
    sweep = sh.sweep_fn(cfg)
    steps = []
    for it in range(len(jstates) - 1):
        new, acc_new, ll = sweep(sh.n, convert.state_from_numpy(block(jstates[it])),
                                 convert.accum_from_numpy(block(jaccums[it])), it, noise)
        steps.append({"tau": whole(new.tau), "mix": whole(new.mix),
                      "gamma": new.gamma.numpy(), "eta": new.eta.numpy(),
                      "loglik": new.loglik.numpy(), "kappa_gamma": new.kappa_gamma.numpy(),
                      "kappa_eta": new.kappa_eta.numpy(), "ll": ll.numpy(),
                      "star_loglik": acc_new.star_loglik.numpy()})
    for k in steps[0]:
        arrays[f"step_{k}"] = np.stack([s[k] for s in steps])
    _save(out, **arrays)
    return 0


def pt_replay(out, counts, cfg_kw, shape, R, key, jstates, jaccums, jrungs):
    """The sharded PT step fed the JAX package's streams (each replica's
    ``ReplayNoise`` of its state key, cut to each rank's block, and
    ``ReplayExchange`` of the run key): the port's own run of the sweeps
    from JAX's start (jstates[0]), and one step from each of JAX's
    ensembles (jstates[it], jaccums[it], jrungs[it]). Saves the own run's
    tau_star and cold trace, and each step's rung, n_acc, cold loglik and
    every replica's whole tau, mix and replicated fields."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from torch_helpers import ReplayExchange, ReplayNoise

    _join("cpu")
    cfg = sampler.SamplerConfig(**cfg_kw)
    sh = sharded.Shard(counts, make_mesh(*shape), "cpu")
    part = sh.replica_shard(R)
    rows = ("tau", "mix", "sum_tau", "star_tau")
    mine = slice(part.replicas.start, part.replicas.stop)

    def block(tree):
        return {k: (v[mine, sh.lo:sh.hi] if k in rows else v[mine]) for k, v in tree.items()}

    def whole(x):
        return torch.cat(list(sh.data.gather(x)), dim=0).numpy()

    noise = sh.noise([ReplayNoise(jnp.asarray(jstates[0]["key"][i])) for i in part.replicas])
    exchange = [ReplayExchange(jnp.asarray(key))]
    state = convert.state_from_numpy(block(jstates[0]))
    accum = sh.accum(cfg, len(part.replicas))
    sweeps = len(jstates) - 1
    rung = torch.as_tensor(np.asarray(jrungs[0]), dtype=torch.int64)
    own = sh.pt_segment(cfg, state, accum, rung, 0, sweeps, noise, exchange, 8.0, part)
    merged = sharded._pt_merge(sh, own[1], part.replicas, R)
    arrays = {"own_tau_star": whole(merged.star_tau), "own_trace": own[3].numpy()}
    step = sampler.make_pt_step(sh.n, cfg, R, 8.0, sh.ks, shard=part)
    steps = []
    for it in range(sweeps):
        new, acc_new, rung, cold, n_acc, heads = step(
            convert.state_from_numpy(block(jstates[it])),
            convert.accum_from_numpy(block(jaccums[it])),
            torch.as_tensor(np.asarray(jrungs[it]), dtype=torch.int64), it, noise, exchange)
        rec = {"rung": rung.numpy(), "cold": cold.numpy(), "n_acc": n_acc.numpy(),
               "heads": np.int64(heads)}
        for j, i in enumerate(part.replicas):
            rec.update({f"{i}_tau": whole(new.tau[j]), f"{i}_mix": whole(new.mix[j]),
                        f"{i}_gamma": new.gamma[j].numpy(), f"{i}_eta": new.eta[j].numpy(),
                        f"{i}_loglik": new.loglik[j].numpy(),
                        f"{i}_kappa_gamma": new.kappa_gamma[j].numpy(),
                        f"{i}_kappa_eta": new.kappa_eta[j].numpy(),
                        f"{i}_star_loglik": acc_new.star_loglik[j].numpy()})
        steps.append(rec)
    for k in steps[0]:
        arrays[f"step_{k}"] = np.stack([s[k] for s in steps])
    _save(out, **arrays)
    return 0
