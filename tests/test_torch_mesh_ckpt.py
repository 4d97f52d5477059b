"""Sharded checkpoints (``desman_tpu_torch.parallel.shard_ckpt``) against
tests/test_sharding.py's standards: resumed on the same mesh, bitwise the
uninterrupted run; resumed on another mesh shape, tau_star agreement >
0.99 and the trace to rtol 1e-4; a completed run loaded onto a mesh whose
chain rows replicate the chain gives the same tau_star. Also the stored
draws (--store_every) across an interruption, several chains split over
the chain axis, and the SIGTERM consensus: one rank preempted stops every
rank at the same segment head with the checkpoint committed (exit 75).

Worlds of 2 and 4 spawned processes over gloo on the CPU
(tests/mesh_workers.py); a 1x1 mesh runs in this process without one.
"""
import json
import os

import numpy as np
import pytest
import torch

from desman_tpu_torch import sampler, synth
from desman_tpu_torch.parallel import launch, make_mesh, sharded

import mesh_workers

# tests/test_sharding.py's checkpoint configuration
CFG = dict(G=2, burn=6, samples=6, nmf_iters=30)
STORE = dict(CFG, store_samples=True, store_thin=2)


@pytest.fixture(scope="module")
def counts():
    return synth.generate(V=120, S=12, G=3, coverage=60.0, seed=1).data.counts


def world(tmp_path, nprocs, *args, name="w", rc=0):
    out = str(tmp_path / f"{name}.npz")
    assert launch(mesh_workers.checkpointed, nprocs, (out, *args),
                  timeout_s=mesh_workers.WORLD_TIMEOUT_S) == rc
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def fields(got, prefix):
    return {k[len(prefix) + 1:]: v for k, v in got.items() if k.startswith(prefix + "_")}


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("shape,seeds,single", [((1, 2), [13], True),
                                                ((2, 2), [13, 14], False)],
                         ids=["1x2-one-chain", "2x2-two-chains"])
def test_same_mesh_resume_is_bitwise(tmp_path, counts, shape, seeds, single):
    """Uninterrupted; stopped after the first 4-sweep segment; resumed: the
    resumed run's result, stored draws included, is bitwise the
    uninterrupted one's (V=119: the zero row a data axis of 2 pads)."""
    ck = str(tmp_path / "ck")
    got = world(tmp_path, shape[0] * shape[1], counts[:119], STORE, [
        ("whole", seeds, str(tmp_path / "whole"), 4, None, single),
        ("stop", seeds, ck, 4, 4, single),
        ("resumed", seeds, ck, 4, None, single)], shape)
    assert got["stop_stopped"] == 1
    whole, resumed = fields(got, "whole"), fields(got, "resumed")
    assert_same(whole, resumed)
    lead = () if single else (2,)
    assert whole["tau_samples"].shape == lead + (3, 119, 2)
    assert whole["tau_star"].shape == lead + (119, 2)
    with open(os.path.join(ck, "manifest.json")) as f:
        m = json.load(f)
    assert (m["it"], m["V"], m["Vp"], m["mesh"]) == (12, 119, 120, list(shape))


def test_resume_across_mesh_shapes(tmp_path, counts):
    """Stopped on a 1x4 mesh after a segment, resumed on 1x1 (in this
    process): tau_star agreement > 0.99, trace rtol 1e-4 against the
    uninterrupted 1x4 run; the completed directory loaded onto a 2x2 mesh
    (chain rows replicating the chain) gives the same tau_star."""
    ck = str(tmp_path / "ck")
    cfg = sampler.SamplerConfig(**CFG)
    got = world(tmp_path, 4, counts, CFG, [
        ("whole", [13], str(tmp_path / "whole"), 7, None, True),
        ("stop", [13], ck, 7, 7, True)], (1, 4), name="w4")
    assert got["stop_stopped"] == 1
    whole = fields(got, "whole")
    one = sharded.run_chain_sharded_checkpointed(counts, cfg, 13, ck, checkpoint_every=7,
                                                 mesh=make_mesh(1, 1), device="cpu")
    agree = (one.tau_star.numpy() == whole["tau_star"]).all(1).mean()
    assert agree > 0.99, agree
    np.testing.assert_allclose(one.loglik_trace.numpy(), whole["loglik_trace"], rtol=1e-4)
    loaded = fields(world(tmp_path, 4, counts, CFG, [("done", [13], ck, 7, None, True)],
                          (2, 2), name="w22"), "done")
    assert np.array_equal(loaded["tau_star"], one.tau_star.numpy())
    assert np.array_equal(loaded["loglik_trace"], one.loglik_trace.numpy())


def test_store_every_draws_resume_across_layouts(tmp_path, counts):
    """Stored draws written by a 2x2 world for two chains, then resumed on
    one process at 1x1: the draws assembled from both layouts' files are
    the draws of the uninterrupted 2x2 run up to where the layouts part."""
    ck = str(tmp_path / "ck")
    got = world(tmp_path, 4, counts, STORE, [
        ("whole", [3, 4], str(tmp_path / "whole"), 8, None, False),
        ("stop", [3, 4], ck, 8, 8, False)], (2, 2))
    whole = fields(got, "whole")
    res = sharded.run_chains_sharded_checkpointed(
        counts, sampler.SamplerConfig(**STORE), [3, 4], ck, checkpoint_every=8,
        mesh=make_mesh(1, 1), device="cpu")
    assert res.tau_samples.shape == whole["tau_samples"].shape == (2, 3, 120, 2)
    assert res.tau_samples.dtype == torch.int8
    # the draw at sweep 7 was stored by the 2x2 world before the stop
    assert np.array_equal(res.tau_samples[:, 0].numpy(), whole["tau_samples"][:, 0])
    assert np.array_equal(res.gamma_samples[:, 0].numpy(), whole["gamma_samples"][:, 0])
    agree = (res.tau_samples.numpy() == whole["tau_samples"]).all(-1).mean()
    assert agree > 0.99, agree


def test_sigterm_on_one_rank_stops_every_rank_committed(tmp_path, counts):
    """Rank 1 alone gets SIGTERM during the first segment: both ranks raise
    Preempted at the next segment head (the world exits 75), the
    checkpoint committed at it=4; the resumed run matches the
    uninterrupted one bitwise (same mesh)."""
    ck = str(tmp_path / "ck")
    got = world(tmp_path, 2, counts, CFG, [("run", [5], ck, 4, None, True)], (1, 2),
                "cpu", 1, name="term", rc=75)
    assert got["preempted"] == 1
    with open(os.path.join(ck, "manifest.json")) as f:
        assert json.load(f)["it"] == 4
    got = world(tmp_path, 2, counts, CFG, [
        ("resumed", [5], ck, 4, None, True),
        ("whole", [5], str(tmp_path / "whole"), 4, None, True)], (1, 2), name="again")
    assert_same(fields(got, "resumed"), fields(got, "whole"))


def test_checkpoint_refuses_another_run(tmp_path, counts):
    """A directory holding another run (chain count, V) is refused."""
    ck = str(tmp_path / "ck")
    cfg = sampler.SamplerConfig(**CFG)
    kw = dict(checkpoint_every=4, mesh=make_mesh(1, 1), device="cpu")
    assert sharded.run_chains_sharded_checkpointed(counts, cfg, [1, 2], ck, stop_after=4,
                                                   **kw) is None
    with pytest.raises(ValueError, match="holds 2 chains of V=120"):
        sharded.run_chains_sharded_checkpointed(counts, cfg, [1], ck, **kw)
    with pytest.raises(ValueError, match="holds 2 chains of V=120"):
        sharded.run_chains_sharded_checkpointed(counts[:100], cfg, [1, 2], ck, **kw)
