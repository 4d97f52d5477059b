"""The port's mesh (``desman_tpu_torch.parallel``) against the JAX package's
(``desman_tpu.parallel``) and against its own single-device chains.

The sharded runs execute in worlds of 2 and 4 spawned processes over gloo
on the CPU (``parallel.launch``; the rank functions are in
tests/mesh_workers.py). The standards are tests/test_sharding.py's: against
``run_chains`` on the same padded counts and seeds tau_star equal, the
loglik trace to rtol 1e-5 and gamma_mean to rtol 1e-4 (the position shards'
sums add in another order); across mesh shapes tau_star equal and the
trace to rtol 1e-5; one layout run twice bitwise; gamma, eta and the
loglik bitwise equal on every rank of a chain row after every sweep; at
most 3 collectives a joint-eta sweep and 5 a per-row one. The replay
against JAX's sharded run is in tests/test_torch_mesh_replay.py.
"""
import jax
import numpy as np
import pytest
import torch

from desman_tpu.parallel import make_mesh as jax_make_mesh
from desman_tpu.parallel import mesh as jmesh
from desman_tpu_torch import sampler, synth
from desman_tpu_torch.parallel import distributed, launch, make_mesh, mesh

import mesh_workers

# tests/test_sharding.py's configuration, on its small_synth counts
CFG = dict(G=2, burn=4, samples=4, nmf_iters=30)


@pytest.fixture(scope="module")
def counts():
    return synth.generate(V=120, S=12, G=3, coverage=60.0, seed=1).data.counts


def world(tmp_path, fn, nprocs, *args):
    """Run fn as every rank of a world of nprocs; rank 0's npz."""
    out = str(tmp_path / f"{fn.__name__}_{nprocs}.npz")
    assert launch(fn, nprocs, (out, *args), timeout_s=mesh_workers.WORLD_TIMEOUT_S) == 0
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def single_device(counts, seeds, n_data, cfg=CFG):
    padded, V = mesh.pad_positions(np.asarray(counts, np.float32), n_data)
    res = sampler.run_chains(torch.as_tensor(padded), sampler.SamplerConfig(**cfg), seeds)
    return res._replace(tau_mean=res.tau_mean[:, :V], tau_star=res.tau_star[:, :V])


@pytest.mark.parametrize("args", [(None, None, 8), (2, None, 8), (None, 4, 8),
                                  (2, 4, 8), (1, 1, 1), (3, 3, 8), (None, 3, 8)],
                         ids=str)
def test_make_mesh_matches_jax(args):
    c, d, n = args
    devices = jax.devices()[:n]
    try:
        theirs = dict(jax_make_mesh(n_chain=c, n_data=d, devices=devices).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            make_mesh(c, d, world_size=n)
        assert str(ours.value) == str(e)
        return
    ours = make_mesh(c, d, world_size=n)
    assert ours.shape == theirs and ours.size == n
    assert [ours.coords(r) for r in range(n)] == [divmod(r, ours.n_data) for r in range(n)]


@pytest.mark.parametrize("multiple", [1, 2, 4, 8])
def test_pad_positions_and_tau_match_jax(counts, multiple):
    c = np.asarray(counts[:117], np.float32)
    ours, V = mesh.pad_positions(c, multiple)
    theirs, jV = jmesh.pad_positions(c, multiple)
    assert V == jV == 117 and ours.dtype == theirs.dtype
    assert np.array_equal(ours, theirs) and (ours[117:] == 0).all()
    tau = np.random.default_rng(0).integers(0, 4, size=(117, 3))
    assert np.array_equal(mesh.pad_tau(tau, multiple), jmesh.pad_tau(tau, multiple))
    assert mesh.pad_tau(None, multiple) is None
    m = make_mesh(1, multiple, world_size=multiple)
    blocks = [m.block(ours.shape[0], d) for d in range(multiple)]
    assert blocks[0][0] == 0 and blocks[-1][1] == ours.shape[0]
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


def test_device_and_backend_rules(monkeypatch):
    """gloo on the CPU; NCCL when every local rank has a card, gloo when
    they share one; rank r on cuda:{LOCAL_RANK % cards}; no CUDA: raise."""
    assert distributed.backend_for(torch.device("cpu")) == "gloo"
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert distributed.backend_for(torch.device("cuda", 1)) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed.backend_for(torch.device("cuda", 1)) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.rank_device("cuda") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.rank_device("cuda")


def test_a_mesh_of_several_ranks_needs_a_world(counts):
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        distributed.mesh_axes(make_mesh(1, 2, world_size=2), torch.device("cpu"))


@pytest.mark.parametrize("shape,V", [((1, 2), 119), ((2, 2), 119), ((1, 4), 120),
                                     ((2, 1), 120)], ids=str)
def test_sharded_matches_the_single_device_chain(tmp_path, counts, shape, V):
    """tests/test_sharding.py's standard against run_chains on the counts
    padded as the mesh pads them (V=119: one zero row on a data axis of
    2); a data axis of 1 is bitwise."""
    got = world(tmp_path, mesh_workers.chains, shape[0] * shape[1], counts[:V], CFG,
                [0, 1], shape)
    ref = single_device(counts[:V], [0, 1], shape[1])
    assert str(got["backend"]) == "gloo"
    assert got["0_tau_star"].shape == (2, V, 2)
    assert np.array_equal(got["0_tau_star"], ref.tau_star.numpy())
    np.testing.assert_allclose(got["0_loglik_trace"], ref.loglik_trace.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["0_gamma_mean"], ref.gamma_mean.numpy(),
                               rtol=1e-4, atol=1e-6)
    if shape[1] == 1:
        for k, v in ref._asdict().items():
            if v is not None:
                assert np.array_equal(got[f"0_{k}"], v.numpy()), k


def test_mesh_shapes_agree_and_a_layout_repeats_bitwise(tmp_path, counts):
    """Seeds 3 and 4 on 1x2 (twice in one world), 1x4 and 2x2: tau_star
    equal and the trace to rtol 1e-5 across the shapes; the 1x2 layout's
    two runs bitwise."""
    seeds = [3, 4]
    a = world(tmp_path, mesh_workers.chains, 2, counts, CFG, seeds, (1, 2), "cpu", "cuda", 2)
    for k in a:
        if k.startswith("0_"):
            assert np.array_equal(a[k], a["1" + k[1:]]), k
    for shape in ((1, 4), (2, 2)):
        b = world(tmp_path, mesh_workers.chains, 4, counts, CFG, seeds, shape)
        assert np.array_equal(b["0_tau_star"], a["0_tau_star"]), shape
        np.testing.assert_allclose(b["0_loglik_trace"], a["0_loglik_trace"], rtol=1e-5)


def test_position_fields_reach_the_coordinator_alone(tmp_path, counts):
    """At 2x2 with stored draws: rank 0 holds every field, tau_samples
    int8 at the true V; the other ranks hold None for tau_mean, tau_star
    and the draws, and the per-chain fields as rank 0 does."""
    from desman_tpu_torch.sampler import SamplerResult

    cfg = dict(CFG, store_samples=True, store_thin=2)
    got = world(tmp_path, mesh_workers.placement, 4, counts[:119], cfg, [0, 1], (2, 2))
    host = {"tau_mean", "tau_star", "tau_samples", "gamma_samples", "eta_samples"}
    fields = SamplerResult._fields
    want_rank0 = [f != "pt_swap_accept" for f in fields]
    assert got["held"][0].tolist() == want_rank0
    for r in (1, 2, 3):
        assert got["held"][r].tolist() == [w and f not in host
                                           for f, w in zip(fields, want_rank0)], r
    assert got["0_tau_samples"].dtype == np.int8
    assert got["0_tau_samples"].shape == (2, 2, 119, 2)
    ref = single_device(counts[:119], [0, 1], 2, cfg)
    assert np.array_equal(got["0_tau_star"], ref.tau_star.numpy())


def test_replicated_state_is_bitwise_equal_on_every_rank(tmp_path, counts):
    got = world(tmp_path, mesh_workers.replicated, 4, counts[:118],
                dict(G=3, burn=4, samples=4, nmf_iters=20, eta_update="rows"), (1, 4), 8)
    assert got["same"].size == 8 * 8 and got["same"].all()


@pytest.mark.parametrize("shape,want", [((1, 2), (2, 5, 1)), ((2, 1), (0, 0, 0))],
                         ids=["1x2", "2x1"])
def test_collectives_a_sweep_within_the_budget(tmp_path, counts, shape, want):
    """tests/test_sharding.py's budget: joint eta <= 3, rows <= 5, joint <=
    rows; with gamma and eta fixed, the one likelihood pass. A data axis of
    one rank exchanges nothing."""
    got = world(tmp_path, mesh_workers.collectives, 2, counts, shape)
    assert got["joint"] <= 3 and got["rows"] <= 5 and got["joint"] <= got["rows"]
    assert (int(got["joint"]), int(got["rows"]), int(got["fixed"])) == want


def test_fit_grid_on_a_mesh(tmp_path, counts):
    """fit_grid(mesh=...) with the seeds over a chain axis of 2 (a data
    axis of 1: each chain is run_chains' bitwise up to the CPU thread
    count) against fit_grid on one device; the rerun finds every run on
    disk and sweeps nothing."""
    from desman_tpu_torch.io import CountsData
    from desman_tpu_torch.model_selection import fit_grid

    data = CountsData(counts=counts, contigs=np.array(["c"] * 120, dtype=object),
                      positions=np.arange(120), samples=[f"s{i}" for i in range(12)])
    got = world(tmp_path, mesh_workers.grid, 2, counts, data, str(tmp_path / "g"),
                [1, 2], [0, 1], (2, 1))
    ref = fit_grid(counts, [1, 2], [0, 1], iterations=20, device="cpu")
    want = np.array([(r.G, r.seed, r.mean_deviance, r.uncertainty) for r in ref])
    np.testing.assert_allclose(got["records"], want, rtol=1e-5)
    np.testing.assert_allclose(got["again"], got["records"], rtol=1e-6)
    assert (got["by_rank"] == got["records"]).all()   # every rank's records
    assert got["swept"] == 2 * 20 and got["swept_again"] == 0
    assert (tmp_path / "g_2_1" / "fit.txt").exists()
