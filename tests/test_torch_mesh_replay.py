"""The port's sharded chain (``desman_tpu_torch.parallel``) replayed on the
JAX package's streams against ``desman_tpu.parallel.run_chains_sharded``.

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


def test_replay_takes_the_decisions_of_jax_run_chains_sharded(tmp_path):
    """From JAX's start on its 1x2 mesh, the port's sharded chain fed JAX's
    streams ends with JAX run_chains_sharded's tau_star on >= 99% of
    positions and its trace to rtol 1e-5; from JAX's state at each sweep
    the port's sharded sweep lands where JAX's does (check_replayed_sweep:
    the MH decisions on >= 9 of 10 sweeps)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sweeps = 10
    counts = synth.generate(V=120, S=12, G=3, coverage=60.0, seed=1).data.counts
    cfg_kw = dict(G=3, burn=sweeps // 2, samples=sweeps // 2, nmf_iters=40)
    jcfg = js.SamplerConfig(**cfg_kw)
    jm = jax_make_mesh(n_chain=1, n_data=2, devices=jax.devices()[:2])
    jres = jax_run_chains_sharded(counts, jcfg, [7], mesh=jm)
    n_j = jax.device_put(jnp.asarray(counts, jnp.float32),
                         NamedSharding(jm, P("data", None, None)))
    jstate = js.init_state(n_j, jcfg, jax.random.PRNGKey(7))
    jaccum = js.init_accum(*counts.shape[:2], 3)
    jsweep = jax.jit(js.make_sweep_fn(jcfg))
    states, accums, lls = [jstate], [jaccum], []
    for it in range(sweeps):
        jstate, jaccum, jll = jsweep(n_j, jstate, jaccum, jnp.int32(it))
        states.append(jstate)
        accums.append(jaccum)
        lls.append(jll)
    out = str(tmp_path / "replay.npz")
    assert launch(mesh_workers.replay, 2, (out, counts, cfg_kw, (1, 2),
                                           np.asarray(states[0].key),
                                           [jax_state_numpy(s) for s in states],
                                           [jax_state_numpy(a) for a in accums]),
                  timeout_s=mesh_workers.WORLD_TIMEOUT_S) == 0
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    agree = (got["own_tau_star"] == np.asarray(jres.tau_star[0])).all(1).mean()
    assert agree >= 0.99, agree
    np.testing.assert_allclose(got["own_trace"], np.asarray(jres.loglik_trace[0]), rtol=1e-5)
    same = 0
    for it in range(sweeps):
        step = {k[len("step_"):]: v[it] for k, v in got.items() if k.startswith("step_")}

        class PortAccum:
            star_loglik = step["star_loglik"]

        same += check_replayed_sweep(it, jax_state_numpy(states[it]),
                                     jax_state_numpy(states[it + 1]), step, lls[it],
                                     step["ll"], accums[it + 1], PortAccum)
    assert same >= sweeps - 1, same
