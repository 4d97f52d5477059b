"""Auto-length runs of the port (desman_tpu_torch.converge) on the CPU:
the MC-error and ESS helpers value for value against the JAX package's; the
plateau and extension verdicts, fed the traces (and gamma draws) of JAX
runs, stop where JAX stopped; the port's own auto runs as
tests/test_converge.py holds JAX's; and fit_grid's ESS target."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import converge as jconv
from desman_tpu import sampler as js
from desman_tpu_torch import (
    checkpoint, cli, converge, io, model_selection, run, sampler, synth,
)
from desman_tpu_torch.utils import match_gamma_perm, snp_distance_perm

import torch_helpers  # noqa: F401 (caps torch's CPU threads)

EASY = dict(V=80, S=10, G=2, coverage=60.0, seed=21)
SLOW = dict(V=100, S=8, G=3, coverage=4.0, gamma_alpha=50.0, seed=3)


def _ar_traces(seed, C, n, phi):
    rng = np.random.default_rng(seed)
    x = np.zeros((C, n))
    for i in range(1, n):
        x[:, i] = phi * x[:, i - 1] + rng.normal(size=C)
    return (x - 5000.0).astype(np.float32)


@pytest.mark.parametrize("seed,phi", [(0, 0.0), (1, 0.6), (2, 0.95), (3, 0.99)])
def test_ess_helpers_match_jax(seed, phi):
    seg = _ar_traces(seed, 3, 50, phi)
    assert np.array_equal(converge._plateau_stderr(seg), jconv._plateau_stderr(seg))
    post = _ar_traces(seed + 10, 2, 120, phi)
    gamma = np.random.default_rng(seed).dirichlet(np.ones(3), size=(2, 120, 4))
    gamma[:, :, 0] = gamma[:, :, 0] * 0.1 + _ar_traces(seed, 2, 120, phi)[:, :, None] * 1e-4
    for gd in (None, gamma):
        for target in (None, 5.0, 50.0, 500.0):
            assert np.array_equal(converge._post_ess(post, gd, target),
                                  jconv._post_ess(post, gd, target))
            if target is not None:
                assert converge._need_extension(post, gd, target) == \
                    jconv._need_extension(post, gd, target)


class TraceFeed:
    """A stand-in for ``sampler.run_segment`` that hands back a JAX run's
    loglik trace [C, sweeps] (and its stored gamma draws) for the sweeps
    asked, chain by chain in turn; the chain state does not move."""

    def __init__(self, trace, burn_used, gamma=None):
        self.trace, self.burn_used, self.gamma = trace, burn_used, gamma
        self.calls = 0

    def __call__(self, n, cfg, state, accum, start_it, n_sweeps, noise,
                 kernel="cuda", burn=None, store=False):
        c = self.calls % self.trace.shape[0]
        self.calls += 1
        trace = torch.tensor(self.trace[c, start_it:start_it + n_sweeps])
        assert trace.shape[0] == n_sweeps, "the port ran past JAX's run"
        if not store:
            return state, accum, trace
        assert burn == self.burn_used
        slots = checkpoint.stored_slots(start_it, n_sweeps, burn, cfg.store_thin)
        gamma = torch.tensor(self.gamma[c][[start_it + j - burn for j in slots]])
        V = n.shape[0]
        return state, accum, trace, (torch.zeros((len(slots), V, cfg.G), dtype=torch.int8),
                                     gamma, torch.zeros((len(slots), 4, 4)))


AUTO_KW = dict(check_every=20, max_burn=400, ess_target=10.0, max_samples=300)


@pytest.fixture(scope="module")
def jax_one_chain():
    """A JAX run_chain_auto that plateaus before max_burn and extends its
    sampling past cfg.samples, short of the cap, on the gamma-ESS gate."""
    t = synth.generate(**EASY)
    kw = dict(G=2, burn=30, samples=40, nmf_iters=40, store_samples=True)
    res, burn, samples = jconv.run_chain_auto(
        jnp.asarray(t.data.counts, jnp.float32), js.SamplerConfig(**kw),
        jax.random.PRNGKey(1), **AUTO_KW)
    assert 30 < burn < 400 and 40 < samples < 300, (burn, samples)
    return (t, sampler.SamplerConfig(**kw), np.asarray(res.loglik_trace)[None],
            np.asarray(res.gamma_samples)[None], burn, samples)


@pytest.fixture(scope="module")
def jax_chains():
    """A JAX run_chains_auto of 3 chains that plateaus before max_burn and
    extends sampling short of the cap."""
    t = synth.generate(**EASY)
    kw = dict(G=2, burn=30, samples=40, nmf_iters=40)
    keys = jnp.stack([jax.random.PRNGKey(k) for k in range(3)])
    res, burn, samples = jconv.run_chains_auto(
        jnp.asarray(t.data.counts, jnp.float32), js.SamplerConfig(**kw), keys,
        **AUTO_KW)
    assert 30 < burn < 400 and 40 < samples < 300, (burn, samples)
    return t, sampler.SamplerConfig(**kw), np.asarray(res.loglik_trace), burn, samples


def test_verdicts_stop_where_jax_stopped_one_chain(jax_one_chain, monkeypatch):
    t, cfg, trace, gamma, burn, samples = jax_one_chain
    monkeypatch.setattr(checkpoint, "run_segment", TraceFeed(trace, burn, gamma))
    res, b, s = converge.run_chain_auto(torch.as_tensor(t.data.counts), cfg,
                                        sampler.chain_generator(0, "cpu"), **AUTO_KW)
    assert (b, s) == (burn, samples)
    np.testing.assert_array_equal(res.loglik_trace.numpy(), trace[0])
    np.testing.assert_array_equal(res.gamma_samples.numpy(), gamma[0])


@pytest.mark.parametrize("checkpointed", [False, True], ids=["plain", "checkpoint"])
def test_verdicts_stop_where_jax_stopped_chains(jax_chains, checkpointed, tmp_path,
                                                monkeypatch):
    t, cfg, trace, burn, samples = jax_chains
    monkeypatch.setattr(checkpoint, "run_segment", TraceFeed(trace, burn))
    ck = str(tmp_path / "c.npz") if checkpointed else None
    res, b, s = converge.run_chains_auto(torch.as_tensor(t.data.counts), cfg,
                                         [0, 1, 2], checkpoint_path=ck, **AUTO_KW)
    assert (b, s) == (burn, samples)
    np.testing.assert_array_equal(res.loglik_trace.numpy(), trace)
    if checkpointed:
        ex = checkpoint.load_extras(ck)
        assert int(ex["burn_used"]) == burn and ex["done"].shape == (3,)


# ---- the port's own auto runs (tests/test_converge.py's cases) ----


def test_auto_burn_stops_early_on_easy_data():
    t = synth.generate(**EASY)
    cfg = sampler.SamplerConfig(G=2, burn=30, samples=40, nmf_iters=40)
    res, burn, samples = converge.run_chain_auto(
        torch.as_tensor(t.data.counts), cfg, sampler.chain_generator(0, "cpu"),
        check_every=20, max_burn=1000)
    assert 30 <= burn <= 200 and samples == 40, burn
    assert snp_distance_perm(t.tau_idx, res.tau_star.numpy()) == 0
    assert match_gamma_perm(t.gamma, res.gamma_mean.numpy())[0] < 0.03
    assert res.loglik_trace.shape == (burn + 40,)


def test_auto_burn_respects_max_burn():
    t = synth.generate(V=40, S=6, G=3, coverage=10.0, seed=22)
    cfg = sampler.SamplerConfig(G=3, burn=10, samples=10, nmf_iters=20)
    res, burn, _ = converge.run_chain_auto(
        torch.as_tensor(t.data.counts), cfg, sampler.chain_generator(1, "cpu"),
        check_every=40, rel_tol=0.0, max_burn=40)
    assert burn == 40 and torch.isfinite(res.star_loglik)


def test_auto_samples_extends_until_the_ess_target():
    t = synth.generate(**SLOW)
    cfg = sampler.SamplerConfig(G=3, burn=30, samples=40, nmf_iters=30)
    res, burn, samples = converge.run_chain_auto(
        torch.as_tensor(t.data.counts), cfg, sampler.chain_generator(0, "cpu"),
        check_every=20, max_burn=30, ess_target=60.0, max_samples=400)
    assert samples > 40 and res.loglik_trace.shape == (burn + samples,)
    post = res.loglik_trace.numpy()[None, burn:]
    assert samples == 400 or converge._post_ess(post)[0] >= 60.0
    # easy posterior, trivial target: no extension
    t2 = synth.generate(**EASY)
    cfg2 = sampler.SamplerConfig(G=2, burn=30, samples=40, nmf_iters=40)
    _, _, s2 = converge.run_chain_auto(
        torch.as_tensor(t2.data.counts), cfg2, sampler.chain_generator(0, "cpu"),
        check_every=20, max_burn=30, ess_target=2.0, max_samples=400)
    assert s2 == 40


def test_auto_samples_gamma_ess_gate():
    """With draws stored the extension also gates on the min gamma ESS:
    the run samples further than on the loglik alone."""
    t = synth.generate(V=80, S=6, G=2, coverage=8.0, gamma_alpha=50.0, seed=5)
    n = torch.as_tensor(t.data.counts)
    kw = dict(G=2, burn=20, samples=20, nmf_iters=20)
    run = dict(check_every=20, max_burn=20, ess_target=30.0, max_samples=200)
    res, burn, samples = converge.run_chain_auto(
        n, sampler.SamplerConfig(**kw, store_samples=True),
        sampler.chain_generator(1, "cpu"), **run)
    assert res.gamma_samples.shape == (samples, 6, 2)
    assert res.loglik_trace.shape == (burn + samples,)
    _, _, loglik_only = converge.run_chain_auto(
        n, sampler.SamplerConfig(**kw), sampler.chain_generator(1, "cpu"), **run)
    assert samples >= loglik_only


def test_checkpointed_auto_samples_resumed_mid_extension_keeps_extending(tmp_path):
    t = synth.generate(V=80, S=6, G=2, coverage=6.0, gamma_alpha=50.0, seed=7)
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=2, burn=20, samples=20, nmf_iters=20)
    kw = dict(check_every=10, max_burn=20, ess_target=80.0)
    ref, _, s_ref = converge.run_chains_auto(n, cfg, [0], max_samples=120, **kw)
    assert s_ref > 20
    ck = str(tmp_path / "as.npz")
    # the first life stops mid-extension at a lower cap, its snapshot there
    _, _, s1 = converge.run_chains_auto(n, cfg, [0], max_samples=40,
                                        checkpoint_path=ck, **kw)
    assert 20 < s1 < s_ref
    got, _, s2 = converge.run_chains_auto(n, cfg, [0], max_samples=120,
                                          checkpoint_path=ck, **kw)
    assert s2 == s_ref
    for name in ("loglik_trace", "tau_star", "gamma_mean", "star_loglik"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_chains_auto_is_each_chains_auto_and_the_plain_chain():
    """Given the same stopping points (one burn segment to max_burn = cfg.burn,
    no ESS target), each of run_chains_auto's chains is run_chain_auto of its
    seed, and its trace is the plain chain's."""
    t = synth.generate(V=60, S=6, G=2, coverage=40.0, seed=4)
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=2, burn=20, samples=15, nmf_iters=20)
    kw = dict(check_every=20, rel_tol=0.0, max_burn=20)
    res, burn, samples = converge.run_chains_auto(n, cfg, [0, 1, 2], **kw)
    assert (burn, samples) == (20, 15)
    plain = sampler.run_chains(n, cfg, [0, 1, 2])
    assert torch.equal(res.loglik_trace, plain.loglik_trace)
    for i in range(3):
        one, b, s = converge.run_chain_auto(n, cfg, sampler.chain_generator(i, "cpu"), **kw)
        assert (b, s) == (burn, samples)
        for name, a, x in zip(one._fields, sampler.chain_result(res, i), one):
            assert (a is None and x is None) or torch.equal(a, x), (i, name)


# ---- fit_grid's ESS target ----


@pytest.fixture(scope="module")
def grid_counts():
    return synth.generate(V=150, S=10, G=2, coverage=60.0, seed=21)


def test_fit_grid_with_a_reached_target_is_the_fixed_grid(grid_counts):
    kw = dict(g_values=[1, 2], seeds=[0, 1], iterations=60, device="cpu")
    fixed = model_selection.fit_grid(grid_counts.data.counts, **kw)
    ess = model_selection.fit_grid(grid_counts.data.counts, ess_target=1.0, **kw)
    assert [(r.G, r.seed, r.mean_deviance, r.uncertainty) for r in ess] == \
        [(r.G, r.seed, r.mean_deviance, r.uncertainty) for r in fixed]


def test_fit_grid_ess_target_lengthens_sampling_and_is_not_resumed_from_a_fixed_grid(
        grid_counts, tmp_path, monkeypatch):
    stub = str(tmp_path / "run")
    kw = dict(g_values=[1, 2], seeds=[0], iterations=20, out_stub=stub,
              data=grid_counts.data, device="cpu")
    model_selection.fit_grid(grid_counts.data.counts, **kw)
    calls = []
    real = model_selection.run_chains_auto

    def counted(n, cfg, seeds, **k):
        calls.append(cfg.G)
        return real(n, cfg, seeds, **k)

    monkeypatch.setattr(model_selection, "run_chains_auto", counted)
    for _ in range(2):   # the second time resumes the ESS grid's own dirs
        model_selection.fit_grid(grid_counts.data.counts, ess_target=1e6,
                                 max_samples=30, **kw)
    assert calls == [1, 2]
    for G in (1, 2):
        with open(os.path.join(f"{stub}_{G}_0", "metrics.json")) as f:
            m = json.load(f)
        assert (m["sampling_sweeps"], m["sweeps"]) == (30, 40)


def test_fit_grid_ess_target_refuses_the_resident_kernel(grid_counts):
    with pytest.raises(ValueError, match="ess_target"):
        model_selection.fit_grid(grid_counts.data.counts, [1], [0], iterations=20,
                                 kernel="cuda_resident", ess_target=10.0, device="cpu")


# ---- run / run_multi through the CLI ----


@pytest.mark.parametrize("extra", [[], ["--chains", "2"]], ids=["chain", "chains"])
def test_cli_auto_run_with_a_checkpoint_writes_the_same_files(tmp_path, extra):
    """--auto_burn --auto_samples with --checkpoint (a one-chain
    run_chains_auto, or the chains') writes the files of the run without
    it; metrics.json reports the sweeps run."""
    t = synth.generate(**EASY)
    csv = str(tmp_path / "c.csv")
    io.write_counts_csv(csv, t.data)
    argv = ["desman", csv, "-g", "2", "-i", "60", "-s", "2", "--auto_burn",
            "--auto_samples", "20", "--device", "cpu", *extra]
    outs = [str(tmp_path / "plain"), str(tmp_path / "ck")]
    assert cli.main([*argv, "-o", outs[0]]) == 0
    assert cli.main([*argv, "-o", outs[1], "--checkpoint", str(tmp_path / "c.npz")]) == 0
    files = ["fit.txt", "Gamma_mean.csv", "Tau_mean.csv", "Filtered_Tau_star.csv",
             "loglik_trace.csv"] + (["chains.json"] if extra else [])
    for f in files:
        with open(os.path.join(outs[0], f), "rb") as a, open(os.path.join(outs[1], f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(outs[1], "metrics.json")) as f:
        m = json.load(f)
    trace = np.loadtxt(os.path.join(outs[1], "loglik_trace.csv"))
    assert m["sweeps"] == len(trace) and m["sweeps"] - m["sampling_sweeps"] >= 30
    assert m["sampling_sweeps"] >= 30


@pytest.mark.parametrize("field", [dict(checkpoint_path="c.npz"), dict(auto_burn=True),
                                   dict(auto_samples=10.0)],
                         ids=["checkpoint", "auto_burn", "auto_samples"])
def test_run_refuses_the_resident_kernel_with_auto_or_checkpoint(field, tmp_path):
    data = synth.generate(V=30, S=4, G=2, coverage=30.0, seed=0).data
    rc = run.RunConfig(G=2, iterations=10, out_dir=str(tmp_path / "o"), **field)
    for go in (run.run, lambda d, r, **k: run.run_multi(d, r, 2, **k)):
        with pytest.raises(ValueError, match="resident kernel"):
            go(data, rc, device="cpu", kernel="cuda_resident")
    assert not (tmp_path / "o").exists()


def test_checkpointed_auto_run_is_preempted_at_a_segment_head(tmp_path, monkeypatch):
    """A preemption notice during a segment of a checkpointed auto run lets
    the segment finish and commit, raises Preempted at the next segment
    head, and the rerun ends where an uninterrupted run ends."""
    t = synth.generate(**EASY)
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=2, burn=20, samples=20, nmf_iters=20)
    kw = dict(check_every=10, max_burn=60, ess_target=20.0, max_samples=80)
    ref, b_ref, s_ref = converge.run_chains_auto(n, cfg, [0, 1], **kw)
    ck = str(tmp_path / "auto.npz")
    real = checkpoint.run_segment
    calls = []

    def segment(*args, **k):
        calls.append(args[4])
        if len(calls) == 3:   # during the second segment's first chain
            checkpoint._on_sigterm(None, None)
        return real(*args, **k)

    monkeypatch.setattr(checkpoint, "run_segment", segment)
    with pytest.raises(checkpoint.Preempted):
        converge.run_chains_auto(n, cfg, [0, 1], checkpoint_path=ck, **kw)
    assert calls == [0, 0, 10, 10] and checkpoint.load(ck)[2] == 20
    monkeypatch.undo()
    got, b, s = converge.run_chains_auto(n, cfg, [0, 1], checkpoint_path=ck, **kw)
    assert (b, s) == (b_ref, s_ref)
    for name in ("loglik_trace", "tau_star", "gamma_mean", "star_loglik"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
