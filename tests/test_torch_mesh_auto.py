"""Auto-length runs on a mesh of ranks (``converge.run_chains_auto(mesh=...)``,
``fit_grid(mesh=..., ess_target=...)`` and ``desman --mesh --auto_*``) on
the CPU over gloo.

The verdicts, fed the traces (and gamma draws) of the JAX package's
``run_chains_auto(mesh=...)`` on a 2x1 mesh of the conftest's virtual
devices, stop where JAX stopped: every rank decides on the whole [C, seg]
trace gathered over the chain axis; with a checkpoint the gamma-ESS gate
is skipped on both sides, without one the chains' gamma draws are gathered
for it. The port's own runs hold tests/test_sharding.py's standards
against ``run_chains_auto`` on the padded counts (tau_star equal, the trace
to rtol 1e-5, gamma_mean to rtol 1e-4 with atol 1e-6; a data axis of one
rank bitwise), and checkpoints resume bitwise on the same mesh and to those
standards on another. The worlds run tests/mesh_workers.py's ``auto``,
``auto_feed`` and ``grid``.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import converge as jconv
from desman_tpu import sampler as js
from desman_tpu.parallel import make_mesh as jax_make_mesh
from desman_tpu_torch import converge, sampler, synth
from desman_tpu_torch.parallel import launch, make_mesh, mesh

import mesh_workers

EASY = dict(V=80, S=10, G=2, coverage=60.0, seed=21)
FEED_CFG = dict(G=2, burn=30, samples=40, nmf_iters=40, store_samples=True)
FEED_KW = dict(check_every=20, max_burn=400, ess_target=10.0, max_samples=300)
# the port's own runs: burn-in checked every 3 sweeps from sweep 6, the
# sampling phase extended towards an ESS target to its cap; at most 24
# sweeps, so that tests/test_sharding.py's standards apply (f32 sums in
# another order drift a chain's trace further the longer it runs)
CFG = dict(G=3, burn=6, samples=6, nmf_iters=30, store_samples=True, store_thin=2)
KW = dict(check_every=3, max_burn=12, ess_target=30.0, max_samples=12)


@pytest.fixture(scope="module")
def counts120():
    return synth.generate(V=120, S=12, G=3, coverage=60.0, seed=1).data.counts


@pytest.fixture(scope="module")
def counts(counts120):
    """V=119: a zero row on a data axis of 2."""
    return counts120[:119]


def run_world(tmp_path, fn, nprocs, *args, name="w", rc=0):
    out = str(tmp_path / f"{name}.npz")
    assert launch(fn, nprocs, (out, *args), timeout_s=mesh_workers.WORLD_TIMEOUT_S) == rc
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def fields(got, prefix):
    return {k[len(prefix) + 1:]: v for k, v in got.items() if k.startswith(prefix + "_")}


@pytest.mark.parametrize("checkpointed", [False, True], ids=["plain", "checkpoint"])
def test_verdicts_on_a_mesh_stop_where_jax_stopped(tmp_path, checkpointed):
    """JAX's run_chains_auto(mesh=2x1) of two chains plateaus before
    max_burn and, without a checkpoint, extends its sampling on the
    gathered gamma draws' ESS; the port's on a 2x1 world, each rank fed
    its chain's JAX trace and draws, stops at the same burn and sampling
    length with JAX's trace (and draws)."""
    t = synth.generate(**EASY)
    keys = jnp.stack([jax.random.PRNGKey(k) for k in range(2)])
    jm = jax_make_mesh(n_chain=2, n_data=1, devices=jax.devices()[:2])
    jck = str(tmp_path / "jax_ck") if checkpointed else None
    res, burn, samples = jconv.run_chains_auto(
        jnp.asarray(t.data.counts, jnp.float32), js.SamplerConfig(**FEED_CFG), keys,
        checkpoint_path=jck, mesh=jm, **FEED_KW)
    assert 30 < burn < 400 and 40 <= samples < 300, (burn, samples)
    trace, gamma = np.asarray(res.loglik_trace), np.asarray(res.gamma_samples)
    ck = str(tmp_path / "ck") if checkpointed else None
    got = run_world(tmp_path, mesh_workers.auto_feed, 2, t.data.counts, FEED_CFG, [0, 1],
                    (2, 1), trace, burn, gamma, ck, FEED_KW)
    assert (int(got["burn"]), int(got["samples"])) == (burn, samples)
    np.testing.assert_array_equal(got["loglik_trace"], trace)
    if not checkpointed:
        np.testing.assert_array_equal(got["gamma_samples"], gamma)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)], ids=str)
def test_auto_on_a_mesh_matches_one_device(tmp_path, counts, shape):
    """Two chains with stored draws and an ESS target, on the mesh (and
    checkpointed in a directory) against run_chains_auto on the padded
    counts: the same burn and sampling length, and the standards of the
    module docstring; a data axis of one rank bitwise, and the
    checkpointed run bitwise the plain one on its mesh."""
    padded, V = mesh.pad_positions(np.asarray(counts, np.float32), shape[1])
    ref, burn, samples = converge.run_chains_auto(
        torch.as_tensor(padded), sampler.SamplerConfig(**CFG), [3, 4], **KW)
    got = run_world(tmp_path, mesh_workers.auto, shape[0] * shape[1], counts, CFG,
                    [("plain", [3, 4], None, KW), ("ck", [3, 4], str(tmp_path / "ck"), KW)],
                    shape)
    plain, ck = fields(got, "plain"), fields(got, "ck")
    assert (int(plain["burn"]), int(plain["samples"])) == (burn, samples)
    want = {k: (v[:, :V] if k in ("tau_mean", "tau_star") else
                v[:, :, :V] if k == "tau_samples" else v).numpy()
            for k, v in ref._asdict().items() if v is not None}
    assert plain.keys() - {"burn", "samples"} == want.keys()
    for k in plain:
        assert np.array_equal(plain[k], ck[k]), k
    if shape[1] == 1:
        for k in want:
            assert np.array_equal(plain[k], want[k]), k
        return
    assert np.array_equal(plain["tau_star"], want["tau_star"])
    np.testing.assert_allclose(plain["loglik_trace"], want["loglik_trace"], rtol=1e-5)
    np.testing.assert_allclose(plain["gamma_mean"], want["gamma_mean"], rtol=1e-4, atol=1e-6)
    assert (plain["tau_samples"] == want["tau_samples"]).all(-1).mean() >= 0.99


def test_checkpointed_auto_resumes_on_the_same_mesh_and_across_shapes(tmp_path, counts120):
    """1x2: rank 1 alone gets SIGTERM after its first segment; every rank
    raises Preempted at the next segment head (the world exits 75) with
    it=3 committed, the plateau state in the extras channel. Resumed on
    1x2: bitwise the uninterrupted run; a copy resumed on 1x1 in this
    process: the same burn and sampling length, tau_star equal, the trace
    to rtol 1e-5 (V=120: no shape pads, as test_torch_mesh_pt.py's
    checkpoints)."""
    counts = counts120
    ck, copy = str(tmp_path / "ck"), str(tmp_path / "copy")
    got = run_world(tmp_path, mesh_workers.auto, 2, counts, CFG, [("run", [3, 4], ck, KW)],
                    (1, 2), "cpu", 1, name="term", rc=75)
    assert got["preempted"] == 1
    with open(os.path.join(ck, "manifest.json")) as f:
        assert json.load(f)["it"] == 3
    extras = np.load(os.path.join(ck, "extras_it3.npz"))
    assert set(extras.files) == {"burn_used", "prev_mean", "done", "hits", "trace"}
    assert int(extras["burn_used"]) == -1 and extras["trace"].shape == (2, 3)
    shutil.copytree(ck, copy)
    got = run_world(tmp_path, mesh_workers.auto, 2, counts, CFG, [
        ("resumed", [3, 4], ck, KW), ("whole", [3, 4], str(tmp_path / "whole"), KW)],
                    (1, 2), name="again")
    whole = fields(got, "whole")
    for k, v in fields(got, "resumed").items():
        assert np.array_equal(v, whole[k]), k
    res, burn, samples = converge.run_chains_auto(
        counts, sampler.SamplerConfig(**CFG), [3, 4], checkpoint_path=copy,
        mesh=make_mesh(1, 1), device="cpu", **KW)
    assert (burn, samples) == (int(whole["burn"]), int(whole["samples"]))
    assert np.array_equal(res.tau_star.numpy(), whole["tau_star"])
    np.testing.assert_allclose(res.loglik_trace.numpy(), whole["loglik_trace"], rtol=1e-5)
    assert res.tau_samples.shape == whole["tau_samples"].shape


def test_fit_grid_on_a_mesh_with_an_ess_target(tmp_path, counts):
    """fit_grid(mesh=2x1, ess_target=...) writes the one-device ESS grid's
    records (a data axis of one: each chain bitwise up to the CPU thread
    count) and the sampling length run; the rerun sweeps nothing."""
    from desman_tpu_torch.io import CountsData
    from desman_tpu_torch.model_selection import fit_grid

    V = counts.shape[0]
    data = CountsData(counts=counts, contigs=np.array(["c"] * V, dtype=object),
                      positions=np.arange(V), samples=[f"s{i}" for i in range(12)])
    ess = dict(ess_target=30.0, max_samples=30)
    got = run_world(tmp_path, mesh_workers.grid, 2, counts, data, str(tmp_path / "g"),
                    [1, 2], [0, 1], (2, 1), ess)
    ref = fit_grid(counts, [1, 2], [0, 1], iterations=20, device="cpu", **ess)
    want = np.array([(r.G, r.seed, r.mean_deviance, r.uncertainty) for r in ref])
    np.testing.assert_allclose(got["records"], want, rtol=1e-5)
    assert (got["by_rank"] == got["records"]).all()
    assert got["swept"] > 2 * 20 and got["swept_again"] == 0
    with open(tmp_path / "g_2_1" / "metrics.json") as f:
        m = json.load(f)
    assert m["sampling_sweeps"] > 10 and m["sweeps"] == 10 + m["sampling_sweeps"]
