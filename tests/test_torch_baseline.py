"""The port's copy of the benchmark baseline (``desman_tpu_torch.baseline_numpy``)
against the JAX package's ``desman_tpu.baseline_numpy``: the same sweeps
from the same ``np.random.default_rng`` draws, value for value, and a module
that imports neither jax nor the JAX package."""
import subprocess
import sys

import numpy as np
import pytest

from desman_tpu import baseline_numpy as jbase
from desman_tpu_torch import baseline_numpy, synth

from torch_helpers import REPO


@pytest.mark.parametrize("G,seed", [(1, 0), (3, 1), (5, 2)])
def test_a_sweep_equals_the_jax_packages(G, seed):
    """From one state and one generator seed each: tau, gamma, eta and the
    loglik equal (the same numpy ops in the same order)."""
    n = synth.generate(V=80, S=6, G=max(G, 2), coverage=30.0, seed=seed).data.counts
    rng = np.random.default_rng(seed)
    tau = rng.integers(0, 4, size=(80, G))
    gamma = rng.dirichlet(np.ones(G), size=6)
    eta = np.full((4, 4), 0.01 / 3) + np.eye(4) * (0.99 - 0.01 / 3)
    ours = baseline_numpy.sweep(n, tau.copy(), gamma.copy(), eta.copy(),
                                np.random.default_rng(seed + 10))
    theirs = jbase.sweep(n, tau.copy(), gamma.copy(), eta.copy(),
                         np.random.default_rng(seed + 10))
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)
    ours = baseline_numpy.run(n.astype(np.float64), G, 3, seed=seed)
    theirs = jbase.run(n.astype(np.float64), G, 3, seed=seed)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_the_module_imports_no_jax():
    code = ("import sys\nimport desman_tpu_torch.baseline_numpy\n"
            "bad = [m for m in ('jax', 'desman_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
