"""Parallel tempering on a mesh of ranks (``desman_tpu_torch.parallel``'s
``run_chain_pt_sharded`` and ``run_chain_pt_sharded_checkpointed``,
``run.run_pt_sharded`` and ``desman --mesh CxD --pt R``) on the CPU over
gloo, against the port's ``run_chain_pt`` and the JAX package's
``run_chain_pt_sharded``.

The standards are tests/test_sharding.py's: against ``run_chain_pt`` on the
counts padded as the mesh pads them, tau_star equal, the cold loglik trace
to rtol 1e-5 and gamma_mean to rtol 1e-4 (atol 1e-6): the position shards'
sums add in another order; pt_swap_accept equal (the exchange decisions
are the same). A data axis of one rank moves values and adds none, so a
1x1 or Cx1 mesh is ``run_chain_pt`` bit for bit. Checkpoints resume bitwise
on the same mesh, and across shapes to the standards above. The worlds
run tests/mesh_workers.py's ``pt`` and ``pt_replay``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import sampler as js
from desman_tpu.parallel import make_mesh as jax_make_mesh
from desman_tpu.parallel import run_chain_pt_sharded as jax_run_chain_pt_sharded
from desman_tpu_torch import cli, io, sampler, synth
from desman_tpu_torch.parallel import launch, make_mesh, mesh, sharded

import mesh_workers
from torch_helpers import REPO, check_replayed_sweep, jax_state_numpy

R = 4
SEED = 5
# stored draws every other sampling sweep: the cold rung's draws cross rows
CFG = dict(G=3, burn=6, samples=6, nmf_iters=30, store_samples=True, store_thin=2)
# collectives an ensemble sweep: a row's replicas sweep as one chain axis,
# so two row sums an ensemble sweep on a data axis of 2 (the gamma pair and
# the eta loglik of all the row's replicas at once), one chain-axis
# exchange on a chain axis of 2
COLLECTIVES = {(1, 2): 2.0, (2, 1): 1.0, (2, 2): 3.0}


@pytest.fixture(scope="module")
def counts120():
    return synth.generate(V=120, S=12, G=3, coverage=60.0, seed=1).data.counts


@pytest.fixture(scope="module")
def counts(counts120):
    """V=119: a zero row on a data axis of 2."""
    return counts120[:119]


def world(tmp_path, shape, counts, jobs, name, cfg=CFG, rc=0, term_rank=None):
    out = str(tmp_path / f"{name}.npz")
    assert launch(mesh_workers.pt, shape[0] * shape[1],
                  (out, counts, cfg, jobs, shape, "cpu", term_rank),
                  timeout_s=mesh_workers.WORLD_TIMEOUT_S) == rc
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def fields(got, prefix):
    return {k[len(prefix) + 1:]: v for k, v in got.items() if k.startswith(prefix + "_")}


def one_device(counts, n_data, cfg=CFG, seed=SEED):
    """run_chain_pt on the counts padded to a multiple of n_data, the
    padding stripped."""
    padded, V = mesh.pad_positions(np.asarray(counts, np.float32), n_data)
    res = sampler.run_chain_pt(torch.as_tensor(padded), sampler.SamplerConfig(**cfg), seed,
                               R, 8.0)
    return {k: (v[:V] if k in ("tau_mean", "tau_star") else
                v[:, :V] if k == "tau_samples" else v).numpy()
            for k, v in res._asdict().items() if v is not None}


def assert_matches(got, want, bitwise=False):
    """The standards of the module docstring (every field equal when
    bitwise)."""
    run_record = {"collectives", "stopped"}
    assert got.keys() - run_record == want.keys() - run_record
    if bitwise:
        for k in want.keys() - run_record:
            assert np.array_equal(got[k], want[k]), k
        return
    assert np.array_equal(got["tau_star"], want["tau_star"])
    assert got["pt_swap_accept"] == want["pt_swap_accept"]
    np.testing.assert_allclose(got["loglik_trace"], want["loglik_trace"], rtol=1e-5)
    np.testing.assert_allclose(got["gamma_mean"], want["gamma_mean"], rtol=1e-4, atol=1e-6)
    assert got["tau_samples"].dtype == np.int8
    assert (got["tau_samples"] == want["tau_samples"]).all(-1).mean() >= 0.99


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)], ids=str)
def test_pt_on_a_mesh_matches_run_chain_pt(tmp_path, counts, shape):
    """R=4 replicas with stored cold draws: 1x2 (the four replicas on every
    rank, positions split), 2x1 (two replicas a row, all positions:
    bitwise) and 2x2. Each rank makes COLLECTIVES[shape] collectives an
    ensemble sweep."""
    got = fields(world(tmp_path, shape, counts, [("run", SEED, R, None, 0, None)], "w"),
                 "run")
    assert got["tau_star"].shape == (119, 3) and got["tau_samples"].shape == (3, 119, 3)
    assert_matches(got, one_device(counts, shape[1]), bitwise=shape[1] == 1)
    assert got["collectives"] == COLLECTIVES[shape]


def test_pt_on_a_1x1_mesh_is_run_chain_pt_bit_for_bit(tmp_path, counts):
    """In this process (a 1x1 mesh needs no group): run_chain_pt_sharded
    and run_chain_pt_sharded_checkpointed, stopped after a segment and
    resumed, give run_chain_pt's every field bit for bit; R=1 is one chain
    of run_chains_sharded, as run_chain_pt's R < 2 is run_chain."""
    cfg = sampler.SamplerConfig(**CFG)
    want = one_device(counts, 1)
    kw = dict(n_replicas=R, mesh=make_mesh(1, 1), device="cpu")
    got = sharded.run_chain_pt_sharded(counts, cfg, SEED, **kw)
    assert_matches({k: v.numpy() for k, v in got._asdict().items() if v is not None}, want,
                   bitwise=True)
    ck = str(tmp_path / "ck")
    assert sharded.run_chain_pt_sharded_checkpointed(counts, cfg, SEED, ck, 4, stop_after=4,
                                                     **kw) is None
    got = sharded.run_chain_pt_sharded_checkpointed(counts, cfg, SEED, ck, 4, **kw)
    assert_matches({k: v.numpy() for k, v in got._asdict().items() if v is not None}, want,
                   bitwise=True)
    one = sharded.run_chain_pt_sharded(counts, cfg, SEED, 1, mesh=make_mesh(1, 1),
                                       device="cpu")
    chain = sampler.run_chain(torch.as_tensor(counts, dtype=torch.float32), cfg,
                              sampler.chain_generator(SEED, "cpu"))
    for a, b in zip(one, chain):
        assert (a is None and b is None) or torch.equal(a, b)


def test_pt_checkpoints_resume_on_the_same_mesh_and_across_shapes(tmp_path, counts120):
    """1x2: uninterrupted; stopped after the first 4-sweep segment and
    resumed: bitwise, stored draws included. Another directory stopped on
    1x2 after 4 sweeps, continued on 2x1 (the replicas move rows) to 8,
    finished on 1x1 in this process: tau_star equal to the uninterrupted
    1x2 run's and the trace to rtol 1e-5. The extras channel holds the
    rung vector, the counters, the exchange generator and the trace. V=120
    pads on none of the shapes: a replica's generator draws the noise of
    every padded position, so layouts that pad differently part their
    streams (tests/test_torch_mesh_ckpt.py resumes across shapes alike)."""
    counts = counts120
    ck, cross = str(tmp_path / "ck"), str(tmp_path / "cross")
    got = world(tmp_path, (1, 2), counts, [
        ("whole", SEED, R, str(tmp_path / "whole"), 4, None),
        ("stop", SEED, R, ck, 4, 4), ("resumed", SEED, R, ck, 4, None),
        ("cross", SEED, R, cross, 4, 4)], "w12")
    assert got["stop_stopped"] == 1 and got["cross_stopped"] == 1
    whole = fields(got, "whole")
    assert_matches(fields(got, "resumed"), whole, bitwise=True)
    extras = np.load(os.path.join(ck, "extras_it12.npz"))
    assert set(extras.files) == {"rung", "n_acc", "n_heads", "trace", "exchange_generator"}
    assert extras["trace"].shape == (12,) and sorted(extras["rung"]) == [0, 1, 2, 3]
    mid = world(tmp_path, (2, 1), counts, [("mid", SEED, R, cross, 4, 8)], "w21")
    assert mid["mid_stopped"] == 1
    with open(os.path.join(cross, "manifest.json")) as f:
        m = json.load(f)
    assert (m["it"], m["mesh"], m["chains"]) == (8, [2, 1], R)
    done = sharded.run_chain_pt_sharded_checkpointed(
        counts, sampler.SamplerConfig(**CFG), SEED, cross, 4, n_replicas=R,
        mesh=make_mesh(1, 1), device="cpu")
    assert np.array_equal(done.tau_star.numpy(), whole["tau_star"])
    np.testing.assert_allclose(done.loglik_trace.numpy(), whole["loglik_trace"], rtol=1e-5)
    assert done.tau_samples.shape == (3, 120, 3)


def test_sigterm_on_one_rank_preempts_every_rank_committed(tmp_path, counts):
    """2x1: rank 1 alone gets SIGTERM after its first segment; both ranks
    raise Preempted at the next segment head (the world exits 75) with
    it=4 committed; the rerun completes bitwise the uninterrupted run."""
    ck = str(tmp_path / "ck")
    got = world(tmp_path, (2, 1), counts, [("run", SEED, R, ck, 4, None)], "term",
                rc=75, term_rank=1)
    assert got["preempted"] == 1
    with open(os.path.join(ck, "manifest.json")) as f:
        assert json.load(f)["it"] == 4
    got = world(tmp_path, (2, 1), counts, [
        ("resumed", SEED, R, ck, 4, None), ("whole", SEED, R, None, 0, None)], "again")
    assert_matches(fields(got, "resumed"), fields(got, "whole"), bitwise=True)


def test_replay_takes_the_decisions_of_jax_run_chain_pt_sharded(tmp_path):
    """JAX's PT ensemble on a 1x2 mesh of the conftest's virtual devices
    (V=200 S=8 G=3 R=4, burn 5) before each of 10 sweeps; the port's
    sharded step on two ranks fed each replica's JAX stream cut to its
    block and JAX's exchange uniforms takes JAX's exchange decisions on
    every sweep (rung, n_acc, n_heads equal; the cold loglik to rtol 1e-5)
    and every replica's MH decisions on at least 9 of the 10 sweeps
    (check_replayed_sweep). The one sweep that may differ is sweep 4: its
    T=8 replica's eta step takes lgamma of about 5.6e5, whose f32 ulp
    XLA's and torch's lgamma round apart (tests/test_torch_pt.py). The
    port's own run from JAX's start ends with JAX run_chain_pt_sharded's
    tau_star on >= 99% of positions."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sweeps = 10
    t = synth.generate(V=200, S=8, G=3, coverage=40.0, seed=11)
    cfg_kw = dict(G=3, burn=5, samples=5, nmf_iters=30)
    jcfg = js.SamplerConfig(**cfg_kw)
    key = jax.random.PRNGKey(SEED)
    jm = jax_make_mesh(n_chain=1, n_data=2, devices=jax.devices()[:2])
    jres = jax_run_chain_pt_sharded(t.data.counts, jcfg, key, n_replicas=R, mesh=jm)
    n_j = jax.device_put(jnp.asarray(t.data.counts, jnp.float32),
                         NamedSharding(jm, P("data", None, None)))
    carry = jax.jit(js.pt_init, static_argnums=(1, 3))(n_j, jcfg, key, R)
    jstep = jax.jit(js.make_pt_step(n_j, jcfg, key, R, 8.0))
    states, accums, rungs, want = [], [], [], []
    for it in range(sweeps + 1):
        states.append(jax_state_numpy(carry[0]))
        accums.append(jax_state_numpy(carry[1]))
        rungs.append(np.asarray(carry[2]))
        if it < sweeps:
            carry, step = jstep(carry, jnp.int32(it))
            want.append([np.asarray(x) for x in step])
    out = str(tmp_path / "replay.npz")
    assert launch(mesh_workers.pt_replay, 2, (out, t.data.counts, cfg_kw, (1, 2), R,
                                              np.asarray(key), states, accums, rungs),
                  timeout_s=mesh_workers.WORLD_TIMEOUT_S) == 0
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    agree = (got["own_tau_star"] == np.asarray(jres.tau_star)).all(1).mean()
    assert agree >= 0.99, agree
    agreed = []
    for it in range(sweeps):
        cold, n_acc, heads = want[it]
        assert np.array_equal(got["step_rung"][it], rungs[it + 1])
        assert float(got["step_n_acc"][it]) == float(n_acc)
        assert int(got["step_heads"][it]) == int(heads)
        np.testing.assert_allclose(got["step_cold"][it], cold, rtol=1e-5)
        ok = True
        for i in range(R):
            step = {k.split("_", 2)[2]: v[it] for k, v in got.items()
                    if k.startswith(f"step_{i}_")}

            class PortAccum:
                star_loglik = step["star_loglik"]

            old = {k: v[i] for k, v in states[it].items()}
            new = {k: v[i] for k, v in states[it + 1].items()}
            jaccum = jax.tree_util.tree_map(lambda x: x[i], accums[it + 1])

            class JaxAccum:
                star_loglik = jaccum["star_loglik"]

            ok &= check_replayed_sweep(it, old, new, step, new["loglik"], step["loglik"],
                                       JaxAccum, PortAccum)
        if ok:
            agreed.append(it)
    assert len(agreed) >= sweeps - 1, agreed
    assert set(range(sweeps)) - set(agreed) <= {4}, agreed


# ---- the CLI and run.run_pt_sharded ----


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """Counts CSVs: V=150 S=10 G=3 (a zero row on a data axis of 4), and
    biallelic counts for cuda_topk."""
    tmp = tmp_path_factory.mktemp("mesh_pt")
    paths = {}
    for name, kw in (("synth", {}), ("bi", dict(error_rate=0.0, max_alleles=2))):
        t = synth.generate(V=150, S=10, G=3, coverage=50.0, seed=4, **kw)
        paths[name] = str(tmp / f"{name}.csv")
        io.write_counts_csv(paths[name], t.data)
    return paths


def _argv(csv, out, *extra):
    return ["desman", csv, "-g", "3", "-i", "40", "-s", "0", "-o", out, "--device", "cpu",
            "--pt", "4", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


def _tau(out):
    return io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))[0]


@pytest.mark.parametrize("mesh_shape,counts_name,extra", [
    ("1x2", "synth", ["--store_every", "4"]),
    ("2x1", "synth", ["--checkpoint", "CK", "--checkpoint_every", "10"]),
    ("1x2", "bi", ["--kernel", "cuda_topk"]),
], ids=["1x2-store", "2x1-checkpoint", "1x2-topk"])
def test_cli_pt_on_a_mesh(csvs, tmp_path, mesh_shape, counts_name, extra):
    """`desman --mesh CxD --pt 4` (the CLI starts the ranks) against `desman
    --pt 4` on one device: tau_star agreement >= 0.99 (2x1: the same files
    but metrics.json), pt_swap_accept in (0, 1] and equal, the run record's
    mesh and its launches: the replicas' tau (or top-2) and swap kernels 4
    x 40 sweeps x the data ranks (counted where a kernel launches: on a
    card, tests/test_torch_cuda.py); with --store_every the cold draws."""
    extra = [str(tmp_path / "ck") if x == "CK" else x for x in extra]
    one, out = str(tmp_path / "one"), str(tmp_path / "mesh")
    plain = [x for x in extra if x not in ("--checkpoint", "--checkpoint_every", "10")
             and not x.startswith(str(tmp_path))]
    assert cli.main(_argv(csvs[counts_name], one, *plain)) == 0
    done = subprocess.run([sys.executable, "-m", "desman_tpu_torch",
                           *_argv(csvs[counts_name], out, "--mesh", mesh_shape, *extra)],
                          env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                          capture_output=True, text=True,
                          timeout=mesh_workers.WORLD_TIMEOUT_S)
    assert done.returncode == 0, done.stderr
    m, m1 = _metrics(out), _metrics(one)
    c, d = (int(x) for x in mesh_shape.split("x"))
    assert (m["mesh"], m["ranks"], m["backend"]) == (mesh_shape, c * d, "gloo")
    assert 0.0 < m["pt_swap_accept"] <= 1.0 and m["pt_swap_accept"] == m1["pt_swap_accept"]
    assert m["kernel"] == ("cuda_topk" if "cuda_topk" in extra else "cuda")
    assert (np.asarray(_tau(out)) == np.asarray(_tau(one))).all(1).mean() >= 0.99
    if d == 1:
        for f in ("fit.txt", "Filtered_Tau_star.csv", "Gamma_mean.csv", "Tau_mean.csv",
                  "loglik_trace.csv"):
            with open(os.path.join(out, f), "rb") as a, open(os.path.join(one, f), "rb") as b:
                assert a.read() == b.read(), f
    if "--store_every" in extra:
        draws = np.load(os.path.join(out, "draws.npz"))
        assert draws["tau"].shape == (5, 150, 3) and draws["tau"].dtype == np.int8
        ref = np.load(os.path.join(one, "draws.npz"))
        assert (draws["tau"] == ref["tau"]).all(-1).mean() >= 0.99


def test_cli_pt_mesh_checkpoint_resumes_on_another_shape(csvs, tmp_path):
    """In this process: `--mesh 1x1 --pt 4 --checkpoint DIR` resumes a
    directory a 2x1 world (torchrun's path: ``launch`` of the CLI on every
    rank) stopped in, and writes the files of the uninterrupted 2x1 run
    (a data axis of one rank: bitwise)."""
    ck, whole, out = (str(tmp_path / k) for k in ("ck", "whole", "out"))
    cfg = sampler.SamplerConfig(G=3, burn=20, samples=20)
    data = io.read_counts_csv(csvs["synth"])
    assert launch(mesh_workers.pt, 2, (str(tmp_path / "stop.npz"), data.counts,
                                       dict(G=3, burn=20, samples=20),
                                       [("stop", 0, R, ck, 10, 10)], (2, 1)),
                  timeout_s=mesh_workers.WORLD_TIMEOUT_S) == 0
    assert cli.main(_argv(csvs["synth"], out, "--mesh", "1x1", "--checkpoint", ck,
                          "--checkpoint_every", "10")) == 0
    assert launch(mesh_workers.desman, 2, (_argv(csvs["synth"], whole, "--mesh", "2x1")[1:],),
                  timeout_s=mesh_workers.WORLD_TIMEOUT_S) == 0
    assert cfg.total_sweeps == _metrics(out)["sweeps"] == 40
    for f in ("fit.txt", "Filtered_Tau_star.csv", "Gamma_mean.csv", "loglik_trace.csv"):
        with open(os.path.join(out, f), "rb") as a, open(os.path.join(whole, f), "rb") as b:
            assert a.read() == b.read(), f
