"""Checkpoint/resume of the port (desman_tpu_torch.checkpoint) on the CPU:
against the JAX package (the stored-draw grid, a JAX snapshot replayed one
sweep with each burn override) and against the port's own uninterrupted
chains, bit for bit: segmented, interrupted and resumed chains, the
snapshot round trip with the generator state, and the `desman` CLI killed
(SIGKILL) or preempted (SIGTERM -> exit 75) mid-run and rerun."""
import dataclasses
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import checkpoint as jck
from desman_tpu import sampler as js
from desman_tpu_torch import checkpoint, cli, convert, converge, io, sampler, synth

from torch_helpers import REPO, ReplayNoise, check_replayed_sweep, jax_state_numpy

CFG = sampler.SamplerConfig(G=2, burn=10, samples=10, nmf_iters=20)
STORED = dataclasses.replace(CFG, store_samples=True, store_thin=2)


@pytest.fixture(scope="module")
def counts():
    t = synth.generate(V=60, S=6, G=2, coverage=40.0, seed=1)
    return torch.as_tensor(t.data.counts)


def _assert_same(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None and y is None) or torch.equal(x, y), name


@pytest.mark.parametrize("start,n_sweeps,burn,thin", [
    (0, 20, 10, 1), (0, 20, 10, 3), (7, 7, 10, 2), (14, 6, 10, 4), (3, 50, 0, 5),
    (100, 40, 100, 1)])
def test_stored_slots_match_jax(start, n_sweeps, burn, thin):
    assert checkpoint.stored_slots(start, n_sweeps, burn, thin) == \
        jck.stored_slots(start, n_sweeps, burn, thin)


@pytest.mark.parametrize("cfg", [CFG, STORED], ids=["plain", "store"])
def test_checkpointed_chain_is_run_chain(counts, cfg, tmp_path):
    ref = sampler.run_chain(counts, cfg, sampler.chain_generator(4, "cpu"))
    got = checkpoint.run_chain_checkpointed(
        counts, cfg, sampler.chain_generator(4, "cpu"), str(tmp_path / "c.npz"),
        checkpoint_every=7)
    _assert_same(ref, got)
    assert (got.tau_samples is None) == (not cfg.store_samples)


@pytest.mark.parametrize("cfg", [CFG, STORED], ids=["plain", "store"])
def test_checkpointed_chains_are_run_chains(counts, cfg, tmp_path):
    ref = sampler.run_chains(counts, cfg, [3, 7, 0])
    got = checkpoint.run_chains_checkpointed(counts, cfg, [3, 7, 0],
                                             str(tmp_path / "c.npz"),
                                             checkpoint_every=7)
    _assert_same(ref, got)
    if cfg.store_samples:
        assert got.tau_samples.shape == (3, 5, 60, 2)


class Interrupt(Exception):
    pass


def _interrupt_after(monkeypatch, segments):
    """Make checkpoint's run_segment raise once `segments` calls are done."""
    real = checkpoint.run_segment
    calls = []

    def segment(*args, **kw):
        if len(calls) == segments:
            raise Interrupt
        calls.append(args[4])
        return real(*args, **kw)

    monkeypatch.setattr(checkpoint, "run_segment", segment)
    return calls


@pytest.mark.parametrize("chains", [False, True], ids=["chain", "chains"])
@pytest.mark.parametrize("cfg", [CFG, STORED], ids=["plain", "store"])
def test_resume_after_interrupt(counts, cfg, chains, tmp_path, monkeypatch):
    """A run stopped by an exception after k segments resumes from its
    snapshot (it = 7k) to the uninterrupted chain's result."""
    ck = str(tmp_path / "c.npz")
    seeds = [5, 6]
    if chains:
        def go():
            return checkpoint.run_chains_checkpointed(counts, cfg, seeds, ck,
                                                      checkpoint_every=7)
        ref = sampler.run_chains(counts, cfg, seeds)
    else:
        def go():
            return checkpoint.run_chain_checkpointed(
                counts, cfg, sampler.chain_generator(5, "cpu"), ck, checkpoint_every=7)
        ref = sampler.run_chain(counts, cfg, sampler.chain_generator(5, "cpu"))
    # one run_segment a segment, for every chain at once: two segments done
    calls = _interrupt_after(monkeypatch, 2)
    with pytest.raises(Interrupt):
        go()
    assert calls == [0, 7]
    assert checkpoint.load(ck)[2] == 14
    monkeypatch.undo()
    _assert_same(ref, go())


def test_save_load_round_trips_the_generator(counts, tmp_path):
    gen = sampler.chain_generator(9, "cpu")
    state = sampler.init_state(counts, CFG, gen)
    accum = sampler.init_accum(60, 6, 2, "cpu")
    torch.rand(5, generator=gen)
    path = str(tmp_path / "s.npz")
    checkpoint.save(path, state, accum, 3, np.arange(3, dtype=np.float32), [gen],
                    extras={"x": np.ones(2)})
    want = torch.rand(100, generator=gen)
    s2, a2, it, trace, gen_state = checkpoint.load(path)
    assert it == 3 and gen_state.dtype == np.uint8 and gen_state.shape[0] == 1
    np.testing.assert_array_equal(trace, np.arange(3))
    _assert_same(state, s2)
    _assert_same(accum, a2)
    fresh = sampler.chain_generator(0, "cpu")
    checkpoint.restore_generators([fresh], gen_state)
    assert torch.equal(torch.rand(100, generator=fresh), want)
    np.testing.assert_array_equal(checkpoint.load_extras(path)["x"], np.ones(2))
    with np.load(path) as z:   # the JAX package's field names, and ours
        assert {"state_mix", "accum_sum_tau", "it", "trace", "generator_state",
                "extra_x"} <= set(z.files)
    assert not os.path.exists(path + ".tmp.npz")


# ---- a JAX snapshot replayed in the port ----

NEVER = int(np.iinfo(np.int32).max)


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """A JAX chain of 6 sweeps (burn 4: two accumulated), saved by JAX's
    checkpoint.save."""
    t = synth.generate(V=96, S=12, G=3, coverage=40.0, seed=3)
    kw = dict(G=3, burn=4, samples=10, nmf_iters=50)
    jcfg = js.SamplerConfig(**kw)
    n = jnp.asarray(t.data.counts, jnp.float32)
    state = js.init_state(n, jcfg, jax.random.PRNGKey(4))
    accum = js.init_accum(96, 12, 3)
    trace = []
    for it in range(6):
        state, accum, tr = jck.run_segment(n, jcfg, state, accum, it, 1,
                                           burn=jnp.int32(jcfg.burn))
        trace.append(np.asarray(tr))
    path = str(tmp_path_factory.mktemp("jax") / "snap.npz")
    jck.save(path, state, accum, 6, np.concatenate(trace))
    return t, jcfg, sampler.SamplerConfig(**kw), path


@pytest.mark.parametrize("mode", ["none", "never", "it"])
def test_jax_snapshot_replays_one_sweep(jax_snapshot, mode):
    """From a JAX snapshot read by snapshot_from_jax_npz, the port's
    run_segment fed JAX's streams lands where JAX's run_segment lands, with
    burn=None, burn=int32 max (kappa adapts, nothing accumulates) and
    burn=it (kappa frozen, the sweep accumulates)."""
    t, jcfg, pcfg, path = jax_snapshot
    jstate, jaccum, it, jtrace = jck.load(path)
    pstate, paccum, pit, ptrace = convert.snapshot_from_jax_npz(path)
    assert pit == it == 6
    np.testing.assert_array_equal(ptrace, np.asarray(jtrace))
    old = jax_state_numpy(jstate)
    for k, v in convert.state_to_numpy(pstate).items():
        np.testing.assert_array_equal(v, old[k])
    jburn, pburn = {"none": (None, None), "never": (jnp.int32(NEVER), converge._NEVER),
                    "it": (jnp.int32(it), it)}[mode]
    jnew, jacc, jll = jck.run_segment(jnp.asarray(t.data.counts, jnp.float32), jcfg,
                                      jstate, jaccum, it, 1, burn=jburn)
    pnew, pacc, pll = sampler.run_segment(
        torch.as_tensor(t.data.counts, dtype=torch.float32), pcfg, pstate, paccum,
        it, 1, ReplayNoise(jstate.key), "cuda", burn=pburn)
    assert check_replayed_sweep(it, old, jax_state_numpy(jnew),
                                convert.state_to_numpy(pnew), jll[0], pll[0], jacc,
                                pacc)
    want = jax_state_numpy(jacc)
    for k, v in convert.accum_to_numpy(pacc).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)
    sums = ("sum_tau", "sum_gamma", "sum_eta", "sum_loglik", "n_samples")
    kappas = ("kappa_gamma", "kappa_eta")
    if mode == "never":
        assert all(torch.equal(getattr(pacc, k), getattr(paccum, k)) for k in sums)
        assert all(not torch.equal(getattr(pnew, k), getattr(pstate, k)) for k in kappas)
    else:   # it = 6 >= burn: kappa frozen, the sweep is a sample
        assert all(torch.equal(getattr(pnew, k), getattr(pstate, k)) for k in kappas)
        assert float(pacc.n_samples) == float(paccum.n_samples) + 1 == 3


# ---- the desman CLI killed or preempted mid-run ----

SWEEPS = 400
COMPARED = ("fit.txt", "Filtered_Tau_star.csv", "Gamma_star.csv", "Gamma_mean.csv",
            "Eta_star.csv", "Eta_mean.csv", "Tau_mean.csv", "loglik_trace.csv")


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A counts CSV and the uninterrupted run's output dir (in-process, at
    the subprocesses' thread count)."""
    tmp = tmp_path_factory.mktemp("cli")
    t = synth.generate(V=200, S=8, G=3, coverage=40.0, seed=2)
    csv = str(tmp / "counts.csv")
    io.write_counts_csv(csv, t.data)
    ref = str(tmp / "ref")
    assert cli.main(_argv(csv, ref)) == 0
    return csv, ref


def _argv(csv, out, *extra):
    return ["desman", csv, "-g", "3", "-i", str(SWEEPS), "-s", "1", "-o", out,
            "--device", "cpu", *extra]


def _env():
    return dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()),
                PYTHONPATH=REPO)


def _command(csv, out, ck):
    return [sys.executable, "-m", "desman_tpu_torch",
            *_argv(csv, out, "--checkpoint", ck, "--checkpoint_every", "20")]


def _snapshot_it(ck):
    if not os.path.exists(ck):
        return None
    with np.load(ck) as z:
        return int(z["it"])


def _signal_mid_run(csv, out, ck, sig):
    """Start the checkpointed run in a subprocess, send `sig` once its
    snapshot shows 0 < it < SWEEPS; returns (rc, it at the signal, stderr)."""
    proc = subprocess.Popen(_command(csv, out, ck), env=_env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    seen = None
    try:
        deadline = time.time() + 60
        while proc.poll() is None and time.time() < deadline:
            it = _snapshot_it(ck)
            if it is not None and 0 < it < SWEEPS:
                proc.send_signal(sig)
                seen = it
                break
            time.sleep(0.002)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    return proc.returncode, seen, err


def _rerun_matches(csv, out, ck, ref):
    done = subprocess.run(_command(csv, out, ck), env=_env(), cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert done.returncode == 0, done.stderr
    assert _snapshot_it(ck) == SWEEPS
    for f in COMPARED:
        with open(os.path.join(out, f), "rb") as a, open(os.path.join(ref, f), "rb") as b:
            assert a.read() == b.read(), f


def test_sigkilled_run_resumes_byte_identical(cli_case, tmp_path):
    csv, ref = cli_case
    out, ck = str(tmp_path / "out"), str(tmp_path / "ck.npz")
    rc, seen, err = _signal_mid_run(csv, out, ck, signal.SIGKILL)
    assert rc == -signal.SIGKILL and seen is not None, (rc, err)
    assert 0 < _snapshot_it(ck) < SWEEPS
    assert not os.path.exists(os.path.join(out, "fit.txt"))
    _rerun_matches(csv, out, ck, ref)


def test_sigterm_exits_75_and_the_rerun_completes(cli_case, tmp_path):
    csv, ref = cli_case
    out, ck = str(tmp_path / "out"), str(tmp_path / "ck.npz")
    rc, seen, err = _signal_mid_run(csv, out, ck, signal.SIGTERM)
    assert rc == 75 and seen is not None, (rc, err)
    assert "desman: preempted" in err and "SIGTERM" in err
    assert seen <= _snapshot_it(ck) < SWEEPS
    _rerun_matches(csv, out, ck, ref)


@pytest.mark.parametrize("extra", [["--chains", "2"], ["--store_every", "4"]],
                         ids=["chains", "store"])
def test_cli_checkpoint_writes_the_plain_runs_files(cli_case, tmp_path, extra):
    """--checkpoint with --chains (run_chains_checkpointed) and with
    --store_every writes the files of the same command without it."""
    csv, _ = cli_case
    plain, ck_out = str(tmp_path / "plain"), str(tmp_path / "ck")
    argv = ["desman", csv, "-g", "2", "-i", "40", "-s", "3", "--device", "cpu", *extra]
    assert cli.main([*argv, "-o", plain]) == 0
    assert cli.main([*argv, "-o", ck_out, "--checkpoint", str(tmp_path / "c.npz"),
                     "--checkpoint_every", "15"]) == 0
    names = COMPARED + (("chains.json",) if "--chains" in extra else ())
    for f in names:
        with open(os.path.join(plain, f), "rb") as a, open(os.path.join(ck_out, f), "rb") as b:
            assert a.read() == b.read(), f
    if "--store_every" in extra:
        want, got = (io.read_draws(os.path.join(d, "draws.npz")) for d in (plain, ck_out))
        assert set(want) == set(got) and want["tau"].shape == (5, 200, 2)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
