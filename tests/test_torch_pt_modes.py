"""The port's parallel-tempering run modes on the CPU: checkpointed PT runs
(interrupted, preempted and resumed: bit for bit the plain run, stored cold
draws included), a JAX ``save_pt`` snapshot replayed one sweep in the port,
the auto-length PT run's verdicts fed a JAX run's cold trace (it must stop
where JAX stopped) and the port's own auto PT runs, and `desman --pt`
through run_multi, --checkpoint and the JAX CLI's refusals."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import checkpoint as jck
from desman_tpu import cli as jcli
from desman_tpu import converge as jconv
from desman_tpu import sampler as js
from desman_tpu_torch import checkpoint, cli, convert, converge, io, run, sampler, synth

from torch_helpers import ReplayExchange, ReplayNoise, check_replayed_sweep

CFG = sampler.SamplerConfig(G=2, burn=10, samples=10, nmf_iters=20)
STORED = dataclasses.replace(CFG, store_samples=True, store_thin=2)


@pytest.fixture(scope="module")
def counts():
    t = synth.generate(V=60, S=6, G=2, coverage=40.0, seed=1)
    return torch.as_tensor(t.data.counts)


def _same(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None and y is None) or torch.equal(x, y), name


# ---- checkpoints ----


class Interrupt(Exception):
    pass


def _stop_after(monkeypatch, segments, action):
    """Make checkpoint's run_pt_segment call `action` once `segments`
    segments are done; returns the start sweeps of the segments run."""
    real = checkpoint.run_pt_segment
    calls = []

    def segment(*args, **kw):
        if len(calls) == segments:
            action()
        calls.append(args[5])
        return real(*args, **kw)

    monkeypatch.setattr(checkpoint, "run_pt_segment", segment)
    return calls


def _interrupt():
    raise Interrupt


@pytest.mark.parametrize("cfg", [CFG, STORED], ids=["plain", "store"])
def test_interrupted_pt_run_resumes_bitwise(counts, cfg, tmp_path, monkeypatch):
    """Stopped by an exception after two segments, the checkpointed PT run
    resumes from its snapshot (it = 14, every generator restored) to the
    uninterrupted run_chain_pt's result, stored cold draws included."""
    ref = sampler.run_chain_pt(counts, cfg, 5, n_replicas=3, max_temp=4.0)
    ck = str(tmp_path / "pt.npz")
    calls = _stop_after(monkeypatch, 2, _interrupt)
    with pytest.raises(Interrupt):
        checkpoint.run_chain_pt_checkpointed(counts, cfg, 5, ck, checkpoint_every=7,
                                             n_replicas=3, max_temp=4.0)
    assert calls == [0, 7]
    states, accums, rung, it, trace, n_acc, n_heads, gen = checkpoint.load_pt(ck)
    assert (it, len(states), trace.shape, gen.shape[0]) == (14, 3, (14,), 4)
    assert rung.dtype == torch.int64 and sorted(rung.tolist()) == [0, 1, 2]
    assert n_heads == 14.0 and 0 <= n_acc <= n_heads
    monkeypatch.undo()
    got = checkpoint.run_chain_pt_checkpointed(counts, cfg, 5, ck, checkpoint_every=7,
                                               n_replicas=3, max_temp=4.0)
    _same(ref, got)
    assert (got.tau_samples is None) == (not cfg.store_samples)
    if cfg.store_samples:
        assert got.tau_samples.shape == (5, 60, 2)
        with np.load(ck) as z:   # the draws ride the snapshot: no second file
            assert z["extra_draw_tau"].shape == (5, 60, 2)
        assert not os.path.exists(ck + ".draws.npz")


def test_sigterm_preempts_at_the_next_segment_head(counts, tmp_path, monkeypatch):
    ck = str(tmp_path / "pt.npz")

    def term():
        checkpoint._on_sigterm(15, None)

    _stop_after(monkeypatch, 1, term)
    with pytest.raises(checkpoint.Preempted):
        checkpoint.run_chain_pt_checkpointed(counts, CFG, 2, ck, checkpoint_every=7,
                                             n_replicas=3)
    assert checkpoint.load_pt(ck)[3] == 14   # the in-flight segment committed
    monkeypatch.undo()
    _same(sampler.run_chain_pt(counts, CFG, 2, n_replicas=3),
          checkpoint.run_chain_pt_checkpointed(counts, CFG, 2, ck, checkpoint_every=7,
                                               n_replicas=3))


def test_one_replica_checkpoints_as_run_chain(counts, tmp_path):
    """(f) for the checkpointed and the auto PT runs."""
    want = sampler.run_chain(counts, CFG, sampler.chain_generator(6, "cpu"))
    _same(want, checkpoint.run_chain_pt_checkpointed(
        counts, CFG, 6, str(tmp_path / "c.npz"), checkpoint_every=7, n_replicas=1))
    auto = dict(check_every=10, max_burn=40, ess_target=0.0)
    a = converge.run_chain_pt_auto(counts, CFG, 6, n_replicas=1, **auto)
    b = converge.run_chain_auto(counts, CFG, sampler.chain_generator(6, "cpu"), **auto)
    assert a[1:] == b[1:]
    _same(a[0], b[0])


# ---- a JAX PT snapshot replayed in the port ----



def test_jax_pt_snapshot_replays_one_segment(tmp_path):
    """A JAX ensemble (the port's starts, JAX keys) advanced 3 sweeps by
    JAX's run_pt_segment and saved by JAX's save_pt, read by
    pt_snapshot_from_jax_npz: a one-sweep port segment fed JAX's streams
    lands where JAX's run_pt_segment lands (rung, exchanges, cold trace;
    each replica through check_replayed_sweep)."""
    t = synth.generate(V=96, S=8, G=3, coverage=40.0, seed=3)
    kw = dict(G=3, burn=2, samples=6, nmf_iters=30)
    jcfg, pcfg = js.SamplerConfig(**kw), sampler.SamplerConfig(**kw)
    n = jnp.asarray(t.data.counts, jnp.float32)
    key = jax.random.PRNGKey(8)
    pst0, pac0, _ = sampler.pt_init(torch.as_tensor(t.data.counts, dtype=torch.float32),
                                    pcfg, sampler.pt_generators(8, 3, "cpu")[:3])
    states = js.SamplerState(key=jax.random.split(key, 3), **{
        k: jnp.stack([jnp.asarray(convert.state_to_numpy(st)[k]) for st in pst0])
        for k in sampler.SamplerState._fields})
    accums = js.SamplerAccum(**{
        k: jnp.stack([jnp.asarray(convert.accum_to_numpy(ac)[k]) for ac in pac0])
        for k in sampler.SamplerAccum._fields})
    rung = jnp.arange(3)
    acc = heads = 0.0
    for it in range(3):
        states, accums, rung, tr, a, h = jck.run_pt_segment(
            n, jcfg, key, states, accums, rung, it, 1, 4.0)
        acc, heads = acc + float(a), heads + float(h)
    path = str(tmp_path / "snap.npz")
    jck.save_pt(path, states, accums, rung, 3, np.zeros(3, np.float32), acc, heads)

    pst, pac, prung, it, trace, n_acc, n_heads = convert.pt_snapshot_from_jax_npz(path)
    assert (it, n_acc, n_heads) == (3, acc, heads) and trace.shape == (3,)
    np.testing.assert_array_equal(prung.numpy(), np.asarray(rung))
    jnew = jck.run_pt_segment(n, jcfg, key, states, accums, rung, 3, 1, 4.0)
    with np.load(path) as z:
        noises = [ReplayNoise(k) for k in z["state_key"]]
    out = sampler.run_pt_segment(torch.as_tensor(t.data.counts, dtype=torch.float32),
                                 pcfg, pst, pac, prung, 3, 1, noises,
                                 ReplayExchange(key), 4.0, "cuda")
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jnew[2]))
    assert (float(out[4]), out[5]) == (float(jnew[4]), float(jnew[5]))
    np.testing.assert_allclose(out[3].numpy(), np.asarray(jnew[3]), rtol=1e-5)
    for i in range(3):
        def rep(tree):
            return {k: np.asarray(v)[i] for k, v in tree._asdict().items()}
        want = rep(jnew[0])
        assert check_replayed_sweep(3, rep(states), want, convert.state_to_numpy(out[0][i]),
                                    want["loglik"], out[0][i].loglik,
                                    jax.tree_util.tree_map(lambda x: x[i], jnew[1]),
                                    out[1][i])


# ---- auto-length PT ----

EASY = dict(V=80, S=10, G=2, coverage=60.0, seed=21)
AUTO_KW = dict(check_every=20, max_burn=400, ess_target=10.0, max_samples=300)


class ColdTraceFeed:
    """A stand-in for ``sampler.run_pt_segment`` that hands back a JAX PT
    run's cold trace (and its stored cold gamma draws) for the sweeps asked;
    the ensemble does not move."""

    def __init__(self, trace, burn_used, gamma):
        self.trace, self.burn_used, self.gamma = trace, burn_used, gamma

    def __call__(self, n, cfg, states, accums, rung, start, n_sweeps, noises,
                 exchange, max_temp, kernel="cuda", burn=None, store=False):
        trace = torch.tensor(self.trace[start:start + n_sweeps])
        assert trace.shape[0] == n_sweeps, "the port ran past JAX's run"
        out = (states, accums, rung, trace, torch.zeros(()), 0)
        if not store:
            return out
        assert burn == self.burn_used
        slots = checkpoint.stored_slots(start, n_sweeps, burn, cfg.store_thin)
        gamma = torch.tensor(self.gamma[[start + j - burn for j in slots]])
        return out + ((torch.zeros((len(slots), n.shape[0], cfg.G), dtype=torch.int8),
                       gamma, torch.zeros((len(slots), 4, 4))),)


def test_auto_verdicts_stop_where_jax_stopped(monkeypatch):
    """JAX's run_chain_pt_auto plateaus before max_burn and extends its
    sampling past cfg.samples short of the cap on the cold gamma-ESS gate;
    the port's, fed JAX's cold trace and draws, stops at the same burn and
    sampling length."""
    t = synth.generate(**EASY)
    kw = dict(G=2, burn=30, samples=40, nmf_iters=40, store_samples=True)
    res, burn, samples = jconv.run_chain_pt_auto(
        jnp.asarray(t.data.counts, jnp.float32), js.SamplerConfig(**kw),
        jax.random.PRNGKey(1), n_replicas=3, max_temp=4.0, **AUTO_KW)
    assert 30 < burn < 400 and 40 < samples < 300, (burn, samples)
    trace = np.asarray(res.loglik_trace)
    monkeypatch.setattr(converge, "run_pt_segment", ColdTraceFeed(
        trace, burn, np.asarray(res.gamma_samples)))
    got, b, s = converge.run_chain_pt_auto(
        torch.as_tensor(t.data.counts), sampler.SamplerConfig(**kw), 1,
        n_replicas=3, max_temp=4.0, **AUTO_KW)
    assert (b, s) == (burn, samples)
    np.testing.assert_array_equal(got.loglik_trace.numpy(), trace)
    np.testing.assert_array_equal(got.gamma_samples.numpy(), np.asarray(res.gamma_samples))


def test_auto_pt_runs():
    """The port's own auto PT runs: a plateaued burn within its bounds and
    the truth recovered; with auto_burn=False exactly cfg.burn; sampling
    extended to an ESS target; the result's rates over sampling sweeps."""
    t = synth.generate(**EASY)
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=2, burn=30, samples=40, nmf_iters=40)
    res, burn, samples = converge.run_chain_pt_auto(n, cfg, 0, n_replicas=3,
                                                    check_every=20, max_burn=300)
    assert 30 <= burn <= 300 and samples == 40
    assert res.loglik_trace.shape == (burn + 40,)
    assert 0.0 < float(res.pt_swap_accept) <= 1.0 and 0.0 < float(res.accept_gamma) <= 1.0
    # phase 2's fresh accumulators: every rate is over the sampling sweeps
    assert torch.allclose(res.accept_gamma, res.accept_gamma_post, rtol=1e-6)
    from desman_tpu_torch.utils import snp_distance_perm

    assert snp_distance_perm(t.tau_idx, res.tau_star.numpy()) == 0
    pinned, b2, s2 = converge.run_chain_pt_auto(n, cfg, 0, n_replicas=3, check_every=20,
                                                max_burn=300, auto_burn=False,
                                                ess_target=1e9, max_samples=80)
    assert (b2, s2) == (30, 80) and pinned.loglik_trace.shape == (110,)


# ---- the CLI and run() ----


@pytest.fixture(scope="module")
def truth(tmp_path_factory):
    t = synth.generate(V=120, S=6, G=2, coverage=40.0, seed=5)
    tmp = tmp_path_factory.mktemp("pt")
    io.write_counts_csv(str(tmp / "counts.csv"), t.data)
    io.write_tau_star_csv(str(tmp / "tau.csv"), t.tau_idx, t.data.contigs,
                          t.data.positions)
    return t, str(tmp / "counts.csv"), str(tmp / "tau.csv")


@pytest.fixture(scope="module")
def csv(truth):
    return truth[1]


def _desman(csv, out, *extra):
    return cli.main(["desman", csv, "-g", "2", "-i", "30", "-s", "2", "-o", out,
                     "--device", "cpu", "--pt", "2", *extra])


def _metrics(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


FILES = ("fit.txt", "Filtered_Tau_star.csv", "Gamma_mean.csv", "Tau_mean.csv",
         "loglik_trace.csv")


def test_cli_pt_checkpoint_and_chains(csv, tmp_path):
    """--pt with --checkpoint writes the plain PT run's files and keeps its
    snapshot at the last sweep; --chains 2 --pt runs run_chains_pt (the
    best chain's files are its seed's single PT run's), and with
    --checkpoint too it runs without checkpoints, as the JAX package's
    run_multi does."""
    outs = {k: str(tmp_path / k) for k in ("pt", "ck", "chains", "one", "chains_ck")}
    ck = str(tmp_path / "pt.npz")
    assert _desman(csv, outs["pt"]) == 0
    assert _desman(csv, outs["ck"], "--checkpoint", ck, "--checkpoint_every", "8") == 0
    m = _metrics(outs["pt"])
    assert 0.0 <= m["pt_swap_accept"] <= 1.0 and m["sweeps"] == 30
    assert _metrics(outs["ck"])["pt_swap_accept"] == m["pt_swap_accept"]
    for f in FILES:
        with open(os.path.join(outs["pt"], f), "rb") as a, \
                open(os.path.join(outs["ck"], f), "rb") as b:
            assert a.read() == b.read(), f
    assert checkpoint.load_pt(ck)[3] == 30
    assert _desman(csv, outs["chains"], "--chains", "2") == 0
    with open(os.path.join(outs["chains"], "chains.json")) as f:
        best = json.load(f)["best_seed"]
    assert best in (2, 3)
    assert cli.main(["desman", csv, "-g", "2", "-i", "30", "-s", str(best), "-o",
                     outs["one"], "--device", "cpu", "--pt", "2"]) == 0
    for f in FILES:
        with open(os.path.join(outs["chains"], f), "rb") as a, \
                open(os.path.join(outs["one"], f), "rb") as b:
            assert a.read() == b.read(), f
    nock = str(tmp_path / "never.npz")
    assert _desman(csv, outs["chains_ck"], "--chains", "2", "--checkpoint", nock) == 0
    assert not os.path.exists(nock)
    with open(os.path.join(outs["chains_ck"], "chains.json")) as f:
        assert json.load(f)["best_seed"] == best


def test_cli_pt_with_fixed_haplotypes_and_stored_draws(truth, tmp_path):
    """--pt with -f holds tau to the file on every replica; with
    --store_every the cold rung's draws land in draws.npz."""
    t, csv, tau = truth
    out = str(tmp_path / "o")
    assert _desman(csv, out, "-f", tau, "--store_every", "5") == 0
    got = io.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))[0]
    np.testing.assert_array_equal(got, t.tau_idx)
    draws = io.read_draws(os.path.join(out, "draws.npz"))
    assert draws["tau"].shape == (3, 120, 2) and (draws["burn"], draws["thin"]) == (15, 5)
    assert (draws["tau"] == t.tau_idx[None]).all()
    assert 0.0 <= _metrics(out)["pt_swap_accept"] <= 1.0


@pytest.mark.parametrize("extra,said", [
    (["--auto_burn", "--checkpoint", "ck.npz"], "composes only single-chain"),
    (["--auto_samples", "50", "--chains", "2"], "composes only single-chain"),
    (["--kernel", "cuda_resident"], "--kernel cuda for --pt"),
], ids=["auto_checkpoint", "auto_chains", "resident"])
def test_cli_refusals_exit_2(csv, extra, said, tmp_path, capsys):
    """The JAX CLI's capability checks, with its message (the resident
    one names the port's kernel); nothing is written."""
    out = str(tmp_path / "o")
    assert _desman(csv, out, *extra) == 2
    ours = capsys.readouterr().err
    assert said in ours and not os.path.exists(out)
    if "--kernel" not in extra:
        assert jcli.main(["desman", csv, "-g", "2", "-o", out, "--pt", "2",
                          *extra]) == 2
        assert capsys.readouterr().err == ours


def test_run_refuses_what_the_cli_refuses(csv, tmp_path):
    data = io.read_counts_csv(csv)
    rc = run.RunConfig(G=2, iterations=20, out_dir=str(tmp_path / "o"), pt_replicas=2,
                       auto_burn=True, checkpoint_path=str(tmp_path / "c.npz"))
    with pytest.raises(ValueError, match="composes only single-chain"):
        run.run(data, rc, device="cpu")
    with pytest.raises(ValueError, match="composes only single-chain"):
        run.run_multi(data, dataclasses.replace(rc, checkpoint_path=None), 2,
                      device="cpu")
    with pytest.raises(ValueError, match="pt/checkpoint need the composable"):
        run.run(data, dataclasses.replace(rc, auto_burn=False, checkpoint_path=None),
                device="cpu", kernel="cuda_resident")
    assert not os.path.exists(tmp_path / "o")
