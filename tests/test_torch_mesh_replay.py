"""The port's sharded chains (``desman_tpu_torch.parallel``) replayed on the
JAX package's streams against ``desman_tpu.parallel.run_chains_sharded``:
one chain, and a row of two on one chain axis.

JAX's side runs on a 1x2 mesh of the conftest's 8 virtual CPU devices; the
port's in a world of two spawned processes over gloo, each rank drawing
``ReplayNoise`` for all positions and keeping its block
(tests/mesh_workers.py's ``replay``). The bar is the replayed-sweep gates of
the single-device replays (``torch_helpers.check_replayed_sweep``).
"""
import jax
import jax.numpy as jnp
import numpy as np

from desman_tpu import sampler as js
from desman_tpu.parallel import make_mesh as jax_make_mesh
from desman_tpu.parallel import run_chains_sharded as jax_run_chains_sharded
from desman_tpu_torch import synth
from desman_tpu_torch.parallel import launch

import mesh_workers
from torch_helpers import check_replayed_sweep, jax_state_numpy


SWEEPS = 10


def _replayed(tmp_path, seeds):
    """JAX's run_chains_sharded of `seeds` on its 1x2 mesh and each chain's
    sweeps one by one from its start, and the port's 1x2 world replaying
    them (mesh_workers.replay, the chains on one axis). Returns (JAX's
    result, each chain's states, accumulators and sweep logliks, the
    port's arrays)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    counts = synth.generate(V=120, S=12, G=3, coverage=60.0, seed=1).data.counts
    cfg_kw = dict(G=3, burn=SWEEPS // 2, samples=SWEEPS // 2, nmf_iters=40)
    jcfg = js.SamplerConfig(**cfg_kw)
    jm = jax_make_mesh(n_chain=1, n_data=2, devices=jax.devices()[:2])
    jres = jax_run_chains_sharded(counts, jcfg, seeds, mesh=jm)
    n_j = jax.device_put(jnp.asarray(counts, jnp.float32),
                         NamedSharding(jm, P("data", None, None)))
    jsweep = jax.jit(js.make_sweep_fn(jcfg))
    chains = []
    for seed in seeds:
        jstate = js.init_state(n_j, jcfg, jax.random.PRNGKey(seed))
        jaccum = js.init_accum(*counts.shape[:2], 3)
        states, accums, lls = [jstate], [jaccum], []
        for it in range(SWEEPS):
            jstate, jaccum, jll = jsweep(n_j, jstate, jaccum, jnp.int32(it))
            states.append(jstate)
            accums.append(jaccum)
            lls.append(jll)
        chains.append((states, accums, lls))

    def stacked(trees):   # one sweep's trees of the chains, chain axis first
        return {k: np.stack([t[k] for t in trees]) for k in trees[0]}

    out = str(tmp_path / "replay.npz")
    assert launch(mesh_workers.replay, 2, (
        out, counts, cfg_kw, (1, 2), [np.asarray(c[0][0].key) for c in chains],
        [stacked([jax_state_numpy(c[0][it]) for c in chains]) for it in range(SWEEPS + 1)],
        [stacked([jax_state_numpy(c[1][it]) for c in chains]) for it in range(SWEEPS + 1)]),
        timeout_s=mesh_workers.WORLD_TIMEOUT_S) == 0
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    return jres, chains, got


def _check_chain(jres, chain, got, c):
    """Chain c of the port's replay against JAX's: the own run's tau_star
    on >= 99% of positions and its trace to rtol 1e-5; from JAX's state at
    each sweep the port's sweep lands where JAX's does
    (check_replayed_sweep: the MH decisions on >= 9 of 10 sweeps)."""
    states, accums, lls = chain
    agree = (got["own_tau_star"][c] == np.asarray(jres.tau_star[c])).all(1).mean()
    assert agree >= 0.99, (c, agree)
    np.testing.assert_allclose(got["own_trace"][c], np.asarray(jres.loglik_trace[c]),
                               rtol=1e-5)
    same = 0
    for it in range(SWEEPS):
        step = {k[len("step_"):]: v[it][c] for k, v in got.items() if k.startswith("step_")}

        class PortAccum:
            star_loglik = step["star_loglik"]

        same += check_replayed_sweep(it, jax_state_numpy(states[it]),
                                     jax_state_numpy(states[it + 1]), step, lls[it],
                                     step["ll"], accums[it + 1], PortAccum)
    assert same >= SWEEPS - 1, (c, same)


def test_replay_takes_the_decisions_of_jax_run_chains_sharded(tmp_path):
    """From JAX's start on its 1x2 mesh, the port's sharded chain fed JAX's
    streams ends with JAX run_chains_sharded's tau_star on >= 99% of
    positions and its trace to rtol 1e-5; from JAX's state at each sweep
    the port's sharded sweep lands where JAX's does (check_replayed_sweep:
    the MH decisions on >= 9 of 10 sweeps)."""
    jres, chains, got = _replayed(tmp_path, [7])
    _check_chain(jres, chains[0], got, 0)


def test_a_row_of_two_chains_replays_jax_run_chains_sharded(tmp_path):
    """Two chains a rank on one chain axis, each fed its own JAX key's
    streams through ChainNoise's per-source path (cut to the block): each
    chain holds the one-chain test's bar against its row of JAX
    run_chains_sharded's vmapped chains."""
    jres, chains, got = _replayed(tmp_path, [7, 8])
    assert got["own_trace"].shape == (2, SWEEPS)
    for c, chain in enumerate(chains):
        _check_chain(jres, chain, got, c)
