"""The port's resident sweep (``--kernel cuda_resident``) against the JAX
package's (``desman_tpu.resident``): one sweep at a time fed JAX's exact
random streams (replay), whole chains from one seed against the port's
``cuda`` chain, the refusals, the CLI and the quickstart gates.

Replay is exact only where JAX pads no rows (V a multiple of 8 and at most
one tile): V=96, S=12 here.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desman_tpu import sampler as js
from desman_tpu.ops.tau_pallas import from_bmajor, to_bmajor
from desman_tpu.resident import make_resident_sweep, run_chain_resident
from desman_tpu_torch import cli, convert, io, ops, resident, sampler, synth
from desman_tpu_torch.utils import snp_distance_perm

from torch_helpers import (
    TESTDATA, TRUE_ETA, ReplayNoise, check_quickstart_gates,
    check_replayed_sweep, jax_state_numpy,
)

V, S = 96, 12


@pytest.mark.parametrize("G,fix_eta,sweeps", [
    (3, False, 10), (3, True, 10), (1, False, 5),
], ids=["joint_eta", "fix_eta", "one_strain"])
def test_resident_sweep_replays_the_jax_resident_sweep(G, fix_eta, sweeps):
    """From JAX's resident state at each sweep, the port's resident sweep
    fed JAX's streams lands where JAX's lands. G=1 takes the tau kernel and
    gamma_ll (no swap to fuse)."""
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=21)
    cfg_kw = dict(G=G, fix_eta=fix_eta, nmf_iters=100)
    jcfg, pcfg = js.SamplerConfig(**cfg_kw), sampler.SamplerConfig(**cfg_kw)
    n_j = jnp.asarray(t.data.counts, jnp.float32)
    n_p = torch.as_tensor(t.data.counts, dtype=torch.float32)
    eta0 = jnp.asarray(t.eta, jnp.float32) if fix_eta else None
    jstate = js.init_state(n_j, jcfg, jax.random.PRNGKey(4), eta_init=eta0)
    jstate = jstate._replace(mix=to_bmajor(jstate.mix))
    jaccum = js.init_accum(V, S, G)
    jsweep = jax.jit(make_resident_sweep(jcfg, to_bmajor(n_j), V, True))
    psweep = sampler.make_sweep_fn(pcfg, kernel="cuda_resident")

    same_decisions = 0
    for it in range(sweeps):
        jnew, jacc_new, jll = jsweep(jstate, jaccum, jnp.int32(it))
        pstate = convert.state_from_numpy(jax_state_numpy(jstate), V=V)
        paccum = convert.accum_from_numpy(jax_state_numpy(jaccum))
        pnew, pacc_new, pll = psweep(n_p, pstate, paccum, it,
                                     ReplayNoise(jstate.key))
        want = convert.state_to_numpy(
            convert.state_from_numpy(jax_state_numpy(jnew), V=V))
        same_decisions += check_replayed_sweep(
            it, convert.state_to_numpy(pstate), want,
            convert.state_to_numpy(pnew), jll, pll, jacc_new, pacc_new)
        jstate, jaccum = jnew, jacc_new
    assert same_decisions >= sweeps - 1, same_decisions


@pytest.fixture(scope="module")
def chains():
    """synth V=101 (ragged: no warp-sized multiple) S=10 G=3, one seed,
    through both kernel choices."""
    t = synth.generate(V=101, S=10, G=3, coverage=50.0, seed=5)
    n = torch.as_tensor(t.data.counts)
    cfg = sampler.SamplerConfig(G=3, burn=30, samples=30, nmf_iters=60)
    return t, {k: sampler.run_chain(n, cfg, torch.Generator().manual_seed(0),
                                    kernel=k)
               for k in ("cuda", "cuda_resident")}


def test_resident_chain_recovers_truth(chains):
    t, res = chains
    got = res["cuda_resident"]
    assert snp_distance_perm(t.tau_idx, got.tau_star.numpy()) == 0
    assert got.loglik_trace.shape == (60,)
    assert torch.isfinite(got.loglik_trace).all()


def test_resident_chain_matches_the_staged_chain(chains):
    """Same seed, same draws in the same order: the two chains differ only
    at float near-ties, none on this data."""
    _, res = chains
    ref, got = res["cuda"], res["cuda_resident"]
    assert (ref.tau_star == got.tau_star).float().mean().item() >= 0.999
    np.testing.assert_allclose(got.loglik_trace.numpy(),
                               ref.loglik_trace.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.gamma_mean.numpy(), ref.gamma_mean.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("change", [
    dict(fix_tau=True), dict(fix_gamma=True), dict(store_samples=True),
    dict(eta_update="rows"),
], ids=["fix_tau", "fix_gamma", "store_samples", "rows"])
def test_resident_refuses_what_the_jax_resident_path_refuses(change):
    cfg = sampler.SamplerConfig(G=2, burn=2, samples=2, nmf_iters=5, **change)
    with pytest.raises(ValueError, match="resident"):
        resident.check_supported(cfg)
    with pytest.raises(ValueError, match="resident"):
        sampler.run_chain(torch.ones(10, 3, 4), cfg, torch.Generator(),
                          kernel="cuda_resident")


@pytest.mark.parametrize("kernel", ["cuda", "cuda_resident"])
def test_fixed_eta_runs_with_rows(kernel):
    """The JAX sweeps, staged and resident, run eta_update='rows' when eta
    is fixed (the eta update never runs), and so does the port."""
    cfg = sampler.SamplerConfig(G=2, burn=2, samples=2, nmf_iters=5,
                                fix_eta=True, eta_update="rows")
    resident.check_supported(cfg)
    t = synth.generate(V=16, S=4, G=2, seed=0)
    res = sampler.run_chain(torch.as_tensor(t.data.counts), cfg,
                            torch.Generator().manual_seed(0),
                            eta_init=torch.as_tensor(t.eta), kernel=kernel)
    np.testing.assert_allclose(res.eta_star.numpy(), t.eta, atol=1e-6)


def test_resident_state_converts_from_jax_with_pad_rows():
    """JAX's resident runner pads V=101 to 104 rows in base-major layout;
    convert strips the pad rows and gives back the [V,S,4] mixture."""
    t = synth.generate(V=101, S=10, G=3, coverage=30.0, seed=2)
    n = jnp.asarray(t.data.counts, jnp.float32)
    cfg = js.SamplerConfig(G=3, nmf_iters=20)
    state = js.init_state(n, cfg, jax.random.PRNGKey(0))
    pad = 3
    mix_bm = jnp.concatenate([to_bmajor(state.mix),
                              jnp.ones((pad, 4 * 10), jnp.float32)])
    tau = jnp.pad(state.tau, ((0, pad), (0, 0)))
    d = jax_state_numpy(state._replace(mix=mix_bm, tau=tau))
    got = convert.state_to_numpy(convert.state_from_numpy(d, V=101))
    np.testing.assert_array_equal(got["mix"], np.asarray(state.mix))
    np.testing.assert_array_equal(
        got["mix"], np.asarray(from_bmajor(mix_bm, 10))[:101])
    np.testing.assert_array_equal(got["tau"], np.asarray(state.tau))
    with pytest.raises(ValueError, match="needs V"):
        convert.state_from_numpy(d)


def test_resident_cli_writes_every_output(tmp_path):
    t = synth.generate(V=60, S=6, G=2, coverage=50.0, seed=3)
    csv = str(tmp_path / "c.csv")
    io.write_counts_csv(csv, t.data)
    out = str(tmp_path / "out")
    ops.reset_launches()
    rc = cli.main(["desman", csv, "-g", "2", "-o", out, "-i", "20",
                   "--kernel", "cuda_resident", "--device", "cpu"])
    assert rc == 0
    for f in ("fit.txt", "Gamma_mean.csv", "Gamma_star.csv", "Eta_mean.csv",
              "Eta_star.csv", "Filtered_Tau_star.csv", "Tau_mean.csv",
              "metrics.json", "loglik_trace.csv"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f)["kernel"] == "cuda_resident"
    # CPU tensors take the plain versions: nothing was launched
    assert ops.fused_sweep.launches == ops.gamma_apply_eta.launches == 0


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x4"], ["--pt", "2"], ["--auto_burn"], ["--checkpoint", "c.npz"],
    ["--store_every", "5"], ["-f", "tau.csv"], ["--eta_update", "rows"],
])
def test_resident_cli_refuses_what_the_jax_cli_refuses(argv, tmp_path, capsys):
    """The flags the JAX CLI refuses with --kernel pallas_resident exit 2:
    --store_every, -f and --eta_update rows with the JAX CLI's message
    (use --kernel cuda), the flags not ported yet with their not-ported
    message."""
    rc = cli.main(["desman", "x.csv", "-g", "2", "-o", str(tmp_path / "o"),
                   "--device", "cpu", "--kernel", "cuda_resident", *argv])
    assert rc == 2
    err = capsys.readouterr().err
    if argv[0] in ("--store_every", "-f", "--eta_update"):
        assert "single-device speed mode" in err and "--kernel cuda" in err
    else:
        assert "not ported" in err
    assert not (tmp_path / "o").exists()


def test_resident_cli_meets_the_quickstart_gates(tmp_path):
    data = io.read_counts_csv(os.path.join(TESTDATA, "variant_counts.csv"))
    data = data.select(np.flatnonzero(data.positions < 1000))
    csv = str(tmp_path / "variants.csv")
    io.write_counts_csv(csv, data)
    out = str(tmp_path / "out")
    rc = cli.main(["desman", csv, "-g", "5", "-e", TRUE_ETA, "-o", out, "-i", "150",
                   "-s", "0", "--device", "cpu", "--kernel", "cuda_resident"])
    assert rc == 0
    check_quickstart_gates(out)


def test_jax_resident_chain_agrees_with_the_port():
    """Native mode (each package's own generator): the two resident chains
    land on the same posterior."""
    t = synth.generate(V=80, S=8, G=2, coverage=50.0, seed=7)
    cfg_kw = dict(G=2, burn=15, samples=15, nmf_iters=30)
    jres = run_chain_resident(jnp.asarray(t.data.counts, jnp.float32),
                              js.SamplerConfig(**cfg_kw), jax.random.PRNGKey(0),
                              interpret=True)
    pres = sampler.run_chain(torch.as_tensor(t.data.counts),
                             sampler.SamplerConfig(**cfg_kw),
                             torch.Generator().manual_seed(0),
                             kernel="cuda_resident")
    assert snp_distance_perm(t.tau_idx, np.asarray(jres.tau_star)) == 0
    assert snp_distance_perm(t.tau_idx, pres.tau_star.numpy()) == 0
