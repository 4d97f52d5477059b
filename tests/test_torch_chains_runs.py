"""The chain axis under the port's run modes, each against the loop it
replaced (every chain one segment in turn on its own state, each seed a
``run_chain``): checkpointed chains (with a resume across the two),
auto-length chains, ``fit_grid`` and ``run_multi`` (``desman --chains``).
The traces, verdicts, stored draws and results are the same bit for bit,
the snapshots hold the same arrays, and the grid's run directories are the
same bytes. A checkpoint file itself is a zip whose entries carry the time
they were written, so the snapshots are compared array by array.
"""
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from desman_tpu_torch import (
    checkpoint, converge, io, model_selection, ops, run, sampler, synth,
)

from torch_helpers import stack, unstack

SEEDS = [3, 7, 0]


def _loop_advance(n, cfg, state, accum, noise, it, n_sweeps, kernel, burn=None,
                  store=False):
    """The loop checkpoint.advance_chains was: every chain one segment in
    turn on its own state, from its own source."""
    states, accums = unstack(state), unstack(accum)
    traces, draws = [], []
    for c, source in enumerate(noise.sources):
        out = sampler.run_segment(n, cfg, states[c], accums[c], it, n_sweeps, source,
                                  kernel, burn=burn, store=store)
        states[c], accums[c] = out[:2]
        traces.append(out[2])
        if store:
            draws.append(out[3])
    stacked = (tuple(checkpoint._numpy(torch.stack(d)) for d in zip(*draws))
               if store else None)
    return (stack(states), stack(accums),
            checkpoint._numpy(torch.stack(traces)), stacked)


def _loop_run_chains(n, cfg, seeds, eta_init=None, kernel="cuda", tau_init=None):
    """The loop sampler.run_chains was: each seed's run_chain, stacked."""
    results = [sampler.run_chain(n, cfg, sampler.chain_generator(s, n.device),
                                 eta_init=eta_init, tau_init=tau_init, kernel=kernel)
               for s in seeds]
    return sampler.SamplerResult(*(None if f[0] is None else torch.stack(f)
                                   for f in zip(*results)))


def _loop(monkeypatch):
    """Every chain set of one device (``checkpoint._Chains``: the
    checkpointed and the auto runs) advances through the loop."""
    monkeypatch.setattr(checkpoint, "advance_chains", _loop_advance)


def _same_results(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        assert x is None or torch.equal(x, y), name


def _same_snapshots(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k


@pytest.fixture(scope="module")
def counts():
    return torch.as_tensor(synth.generate(V=60, S=6, G=2, coverage=40.0, seed=3)
                           .data.counts)


CFG = sampler.SamplerConfig(G=2, burn=10, samples=10, nmf_iters=20)
STORED = sampler.SamplerConfig(G=2, burn=10, samples=10, nmf_iters=20,
                               store_samples=True, store_thin=2)


@pytest.mark.parametrize("cfg", [CFG, STORED], ids=["plain", "store"])
def test_checkpointed_chains_are_the_loop(counts, cfg, tmp_path, monkeypatch):
    """run_chains_checkpointed advances every chain in one run_segment a
    segment; its result and each snapshot are the loop's."""
    segments = []
    real = checkpoint.run_segment

    def counted(*args, **kw):
        segments.append(args[2].tau.shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(checkpoint, "run_segment", counted)
    got = checkpoint.run_chains_checkpointed(counts, cfg, SEEDS, str(tmp_path / "b.npz"),
                                             checkpoint_every=7)
    assert segments == [3, 3, 3]   # 20 sweeps in segments of 7: every chain at once
    _loop(monkeypatch)
    want = checkpoint.run_chains_checkpointed(counts, cfg, SEEDS, str(tmp_path / "l.npz"),
                                              checkpoint_every=7)
    _same_results(got, want)
    _same_snapshots(tmp_path / "b.npz", tmp_path / "l.npz")


class Interrupt(Exception):
    pass


@pytest.mark.parametrize("first", ["loop", "batched"])
def test_a_snapshot_resumes_across_the_loop_and_the_chain_axis(counts, first, tmp_path,
                                                               monkeypatch):
    """A run interrupted after two segments by one implementation resumes
    under the other to run_chains' result: the snapshot is the same."""
    ck = str(tmp_path / "c.npz")
    real = checkpoint.advance_chains if first == "batched" else _loop_advance
    calls = []

    def interrupted(*args, **kw):
        if len(calls) == 2:
            raise Interrupt
        calls.append(args[5])
        return real(*args, **kw)

    monkeypatch.setattr(checkpoint, "advance_chains", interrupted)
    with pytest.raises(Interrupt):
        checkpoint.run_chains_checkpointed(counts, STORED, SEEDS, ck, checkpoint_every=7)
    assert calls == [0, 7] and checkpoint.load(ck)[2] == 14
    monkeypatch.undo()
    if first == "batched":
        _loop(monkeypatch)
    got = checkpoint.run_chains_checkpointed(counts, STORED, SEEDS, ck, checkpoint_every=7)
    _same_results(got, sampler.run_chains(counts, STORED, SEEDS))


AUTO = dict(check_every=10, max_burn=200, ess_target=15.0, max_samples=120)


@pytest.mark.parametrize("checkpointed", [False, True], ids=["plain", "checkpoint"])
def test_auto_chains_are_the_loop(checkpointed, tmp_path, monkeypatch):
    """run_chains_auto on the chain axis takes the loop's verdicts on the
    same traces: the same burn, sampling length, result, stored draws and
    snapshot."""
    t = synth.generate(V=50, S=5, G=2, coverage=40.0, seed=4)
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=2, burn=20, samples=30, nmf_iters=20,
                                store_samples=True)

    def go(name):
        ck = str(tmp_path / f"{name}.npz") if checkpointed else None
        return converge.run_chains_auto(n, cfg, [0, 1], checkpoint_path=ck, **AUTO)

    got = go("batched")
    _loop(monkeypatch)
    want = go("loop")
    assert got[1:] == want[1:] and got[1] >= cfg.burn
    _same_results(got[0], want[0])
    assert got[0].gamma_samples.shape[:2] == (2, got[2])
    if checkpointed:
        _same_snapshots(tmp_path / "batched.npz", tmp_path / "loop.npz")


@pytest.fixture(scope="module")
def grid_data():
    return synth.generate(V=80, S=8, G=2, coverage=50.0, seed=21)


@pytest.mark.parametrize("ess", [0.0, 20.0], ids=["fixed", "ess_target"])
def test_fit_grid_runs_each_G_on_the_chain_axis(grid_data, ess, tmp_path, monkeypatch):
    """fit_grid makes one batched run a G (run_chains, or with an ESS target
    run_chains_auto, each sweep advancing every seed's chain), and its run
    directories are byte for byte those of the loop of run_chain per seed."""
    calls, segments = Counter(), []
    real_chains, real_segment = model_selection.run_chains, sampler.run_segment

    def chains(n, cfg, seeds, **kw):
        calls[cfg.G] += 1
        return real_chains(n, cfg, seeds, **kw)

    def segment(n, cfg, state, *args, **kw):
        segments.append(state.tau.shape[0])
        return real_segment(n, cfg, state, *args, **kw)

    monkeypatch.setattr(model_selection, "run_chains", chains)
    monkeypatch.setattr(sampler, "run_segment", segment)
    monkeypatch.setattr(checkpoint, "run_segment", segment)
    kw = dict(g_values=[1, 2, 3], seeds=[0, 1], iterations=30, eta_init=grid_data.eta,
              fix_eta=True, data=grid_data.data, device="cpu", ess_target=ess,
              max_samples=40)
    got = model_selection.fit_grid(grid_data.data.counts,
                                   out_stub=str(tmp_path / "b" / "run"), **kw)
    if ess:
        assert not calls and segments and set(segments) == {2}
    else:
        assert calls == {1: 1, 2: 1, 3: 1} and segments == [2, 2, 2]
    monkeypatch.undo()
    monkeypatch.setattr(model_selection, "run_chains", _loop_run_chains)
    _loop(monkeypatch)
    want = model_selection.fit_grid(grid_data.data.counts,
                                    out_stub=str(tmp_path / "l" / "run"), **kw)
    assert [(r.G, r.seed, r.mean_deviance, r.uncertainty) for r in got] == \
        [(r.G, r.seed, r.mean_deviance, r.uncertainty) for r in want]
    for r in got:
        name = os.path.basename(r.run_dir)
        files = sorted(os.listdir(r.run_dir))
        assert files == sorted(os.listdir(tmp_path / "l" / name))
        for f in files:
            with open(os.path.join(r.run_dir, f), "rb") as a, \
                    open(tmp_path / "l" / name / f, "rb") as b:
                assert a.read() == b.read(), (name, f)


@pytest.mark.parametrize("kernel", ["cuda", "cuda_topk", "torch"])
def test_desman_chains_is_the_loop(kernel, tmp_path, monkeypatch):
    """run_multi (``desman --chains 3``) on the chain axis writes the loop's
    files: the same best chain's outputs and chains.json, metrics.json but
    for its wall-clock fields."""
    t = synth.generate(V=60, S=6, G=2, coverage=40.0, seed=7, error_rate=0.0,
                       max_alleles=2)
    csv = str(tmp_path / "counts.csv")
    io.write_counts_csv(csv, t.data)
    data = io.read_counts_csv(csv)

    def go(name):
        rc = run.RunConfig(G=2, iterations=30, seed=2, out_dir=str(tmp_path / name))
        run.run_multi(data, rc, 3, device="cpu", kernel=kernel, nmf_iters=20)
        return tmp_path / name

    got = go("batched")
    monkeypatch.setattr(run, "run_chains", _loop_run_chains)
    want = go("loop")
    files = sorted(os.listdir(got))
    assert files == sorted(os.listdir(want)) and "chains.json" in files
    for f in files:
        a, b = (open(d / f).read() for d in (got, want))
        if f == "metrics.json":
            a, b = json.loads(a), json.loads(b)
            for m in (a, b):
                for k in ("elapsed_s", "sweeps_per_s"):
                    m.pop(k)
        assert a == b, f


def test_advance_chains_is_one_segment_of_every_chain(counts):
    """checkpoint.advance_chains: (state, accum, host trace [C, n], host
    draws [C, k, ...]) of one run_segment of the stacked chains."""
    gens = [sampler.chain_generator(s, "cpu") for s in SEEDS]
    n = counts.to(torch.float32)
    state, accum = checkpoint.init_chains(n, STORED, gens)
    out = checkpoint.advance_chains(n, STORED, state, accum, checkpoint.chain_noise(gens),
                                    8, 6, ops.resolve("cuda"), store=True)
    assert out[0].tau.shape == (3, 60, 2) and out[1].n_samples.shape == (3,)
    assert out[2].shape == (3, 6) and isinstance(out[2], np.ndarray)
    assert [d.shape[:2] for d in out[3]] == [(3, 2)] * 3   # sweeps 11 and 13 of 8-13
