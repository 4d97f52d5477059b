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


def _sigterm_after_first_segment():
    """This rank gets SIGTERM once its first segment has run."""
    real = sharded.Shard.segment

    def segment(self, *args, **kw):
        sharded.Shard.segment = real
        result = real(self, *args, **kw)
        os.kill(os.getpid(), signal.SIGTERM)
        return result

    sharded.Shard.segment = segment


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


def replicated(out, counts, cfg_kw, shape, sweeps):
    """A chain's sweeps one by one; after each, whether gamma, eta, the
    loglik, the kappas and the star loglik are bitwise equal on every rank
    of the chain row."""
    _join("cpu")
    cfg = sampler.SamplerConfig(**cfg_kw)
    sh = sharded.Shard(counts, make_mesh(*shape), "cpu")
    gen = sampler.chain_generator(0, sh.device)
    state, accum, noise = sh.init(cfg, [gen])[0], sh.accum(cfg), sh.noise(gen)
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
        state = sh.init(cfg, [gen])[0]
        sweep = sh.sweep_fn(cfg)
        distributed.reset_collectives()
        sweep(sh.n, state, sh.accum(cfg), 0, sh.noise(gen))
        found[name] = np.int64(distributed.exchange.calls)
    _save(out, **found)
    return 0


def grid(out, counts, data, stub, g_values, seeds, shape):
    """fit_grid on the mesh twice: the second call must find every run on
    disk and sweep nothing."""
    from desman_tpu_torch.model_selection import fit_grid

    _join("cpu")
    kw = dict(iterations=20, out_stub=stub, data=data, mesh=make_mesh(*shape), device="cpu")
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
    """run_multi of one chain on the card, on the mesh (shape) or on one
    device (None); every rank's peak allocated device bytes over the run,
    from a fresh process: cuBLAS's workspace included ("peaks", by rank)."""
    from desman_tpu_torch import run

    _join("cuda")
    dev = distributed.rank_device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = None if shape is None else make_mesh(*shape)
    run.run_multi(data, run.RunConfig(**rc_kw), 1, device=dev, kernel="cuda", mesh=mesh)
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


def replay(out, counts, cfg_kw, shape, key, jstates, jaccums):
    """The sharded chain fed the JAX package's streams (``ReplayNoise`` of
    the chain key `key`, cut to each rank's block): its own chain from
    JAX's start (jstates[0]), and one sweep from each of JAX's states.
    Saves the whole tau, mix and the replicated fields of both."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from torch_helpers import ReplayNoise

    _join("cpu")
    cfg = sampler.SamplerConfig(**cfg_kw)
    sh = sharded.Shard(counts, make_mesh(*shape), "cpu")
    noise = sh.noise(ReplayNoise(jnp.asarray(key)))

    def block(state):
        return state._replace(tau=state.tau[sh.lo:sh.hi].contiguous(),
                              mix=state.mix[sh.lo:sh.hi].contiguous())

    def whole(x):
        return torch.cat(list(sh.data.gather(x)), dim=0).numpy()

    start = block(convert.state_from_numpy(jstates[0]))
    _, accum, trace = sh.segment(cfg, start, sh.accum(cfg), 0, len(jstates) - 1, noise)
    res = sampler._result_from_accum(accum, cfg, trace)
    arrays = {"own_tau_star": whole(res.tau_star), "own_trace": trace.numpy()}
    sweep = sh.sweep_fn(cfg)
    steps = []
    for it in range(len(jstates) - 1):
        acc = convert.accum_from_numpy(jaccums[it])
        acc = acc._replace(sum_tau=acc.sum_tau[sh.lo:sh.hi], star_tau=acc.star_tau[sh.lo:sh.hi])
        new, acc_new, ll = sweep(sh.n, block(convert.state_from_numpy(jstates[it])),
                                 acc, it, noise)
        steps.append({"tau": whole(new.tau), "mix": whole(new.mix),
                      "gamma": new.gamma.numpy(), "eta": new.eta.numpy(),
                      "loglik": new.loglik.numpy(), "kappa_gamma": new.kappa_gamma.numpy(),
                      "kappa_eta": new.kappa_eta.numpy(), "ll": ll.numpy(),
                      "star_loglik": acc_new.star_loglik.numpy()})
    for k in steps[0]:
        arrays[f"step_{k}"] = np.stack([s[k] for s in steps])
    _save(out, **arrays)
    return 0
