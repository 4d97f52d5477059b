"""Shared pieces of the PyTorch port's tests (tests/test_torch_*.py).

- Caps torch's CPU threads: the suite runs in several worker processes at
  once, and each would otherwise take every core.
- ``ReplayNoise``: a noise source for the port's sweep that rebuilds the
  JAX package's exact random streams from a chain key, with the key layout
  of ``desman_tpu.sampler.make_sweep_fn``, so one sweep of each package can
  be compared draw for draw; ``GeneTauReplay`` does the same for
  ``assign_gene_tau``'s annealed sweeps.
- ``check_replayed_sweep``: the gates one replayed sweep is held to;
  ``check_quickstart_gates``: tests/test_quickstart.py's accuracy gates on
  an output directory from TestData's true-variant half.
- Small helpers that move data between the two packages as numpy arrays.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from desman_tpu import io as jio
from desman_tpu.ops.swap_pallas import draw_swap_proposal
from desman_tpu_torch.utils import match_gamma_perm
from desman_tpu_torch.validation import compare_tau

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "TestData")
TRUE_ETA = os.path.join(TESTDATA, "true_eta.csv")


def to_torch(x, dtype=None):
    """A JAX or numpy array as a CPU tensor (dtype kept unless given)."""
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def to_jax(t):
    return jnp.asarray(t.detach().cpu().numpy())


def jax_state_numpy(state) -> dict:
    """A JAX SamplerState/SamplerAccum as a dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in state._asdict().items()}


class ReplayNoise:
    """The JAX sweep's streams for chain key `key`.

    make_sweep_fn folds the sweep index into the chain key and splits it
    into (k_tau, k_gamma, k_eta): Gumbel noise per strain from
    fold_in(k_tau, g), the swap proposal from fold_in(k_tau, 12345), the
    gamma and eta proposals from split(k_gamma) / split(k_eta) into
    (k_prop, k_u). The Dirichlet alphas come from the port, as tensors.
    """

    def __init__(self, key):
        self.key = key

    def _keys(self, it):
        return jax.random.split(jax.random.fold_in(self.key, it), 3)

    def gumbel(self, it, V, G):
        k_tau = self._keys(it)[0]
        gz = [np.asarray(jax.random.gumbel(jax.random.fold_in(k_tau, g), (V, 4)))
              for g in range(G)]
        return torch.as_tensor(np.stack(gz, axis=1))

    def swap(self, it, V, G):
        k_tau = self._keys(it)[0]
        g, h, logu = draw_swap_proposal(jax.random.fold_in(k_tau, 12345), V, G)
        return (torch.tensor(int(g), dtype=torch.int32),
                torch.tensor(int(h), dtype=torch.int32), to_torch(logu))

    def _prop(self, k, alpha):
        k_prop, _ = jax.random.split(k)
        return to_torch(jax.random.gamma(k_prop, to_jax(alpha)))

    def _u(self, k, shape):
        _, k_u = jax.random.split(k)
        return to_torch(jax.random.uniform(k_u, shape))

    def gamma_prop(self, it, alpha):
        return self._prop(self._keys(it)[1], alpha)

    def gamma_u(self, it, S):
        return self._u(self._keys(it)[1], (S,))

    def eta_prop(self, it, alpha):
        return self._prop(self._keys(it)[2], alpha)

    def eta_u(self, it):
        return self._u(self._keys(it)[2], ())

    # eta_update="rows": row a's proposal and uniform from fold_in(k_eta, a)
    def eta_row_prop(self, it, a, alpha):
        return self._prop(jax.random.fold_in(self._keys(it)[2], a), alpha)

    def eta_row_u(self, it, a):
        return self._u(jax.random.fold_in(self._keys(it)[2], a), ())


class GeneTauReplay:
    """The Gumbel streams of the JAX package's ``assign_gene_tau`` Gibbs
    path: sweep it, strain g draws from fold_in(fold_in(PRNGKey(seed), it),
    g), unscaled (the port multiplies by the temperature)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def gumbel(self, it, V, G):
        k = jax.random.fold_in(self.key, it)
        gz = [np.asarray(jax.random.gumbel(jax.random.fold_in(k, g), (V, 4)))
              for g in range(G)]
        return torch.as_tensor(np.stack(gz, axis=1))


def check_replayed_sweep(it, old, want, got, jll, pll, jaccum, paccum) -> bool:
    """Hold one port sweep against the JAX sweep from the same state `old`.

    want/got: the new states as numpy dicts ([V,S,4] mixtures); jll/pll
    and jaccum/paccum: each sweep's loglik and new accumulators. Tau must
    agree on >= 99% of positions (float near-ties). Returns whether the
    gamma and eta MH decisions agree; where they do, gamma, eta, kappa and
    loglik must match to rtol 1e-5 and the mixture to rtol 1e-4.
    """
    same = (got["tau"] == want["tau"]).all(axis=1)
    assert same.mean() >= 0.99, f"sweep {it}: tau agreement {same.mean()}"
    dec_j = ((want["gamma"] != old["gamma"]).any(1),
             (want["eta"] != old["eta"]).any())
    dec_p = ((got["gamma"] != old["gamma"]).any(1),
             (got["eta"] != old["eta"]).any())
    if not all(np.array_equal(a, b) for a, b in zip(dec_j, dec_p)):
        return False
    for k in ("gamma", "eta", "loglik", "kappa_gamma", "kappa_eta"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   err_msg=f"sweep {it}: {k}")
    np.testing.assert_allclose(got["mix"][same], want["mix"][same],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(pll), float(jll), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(paccum.star_loglik),
                               np.asarray(jaccum.star_loglik), rtol=1e-5)
    return True


def check_quickstart_gates(out):
    """SNP error rate < 0.02 and gamma MAE < 0.02 against TestData's truth."""
    pred, pc, pp = jio.read_tau_star_csv(os.path.join(out, "Filtered_Tau_star.csv"))
    true, tc, tp = jio.read_tau_star_csv(os.path.join(TESTDATA, "true_tau.csv"))
    rep = compare_tau(pred, true, pred_keys=list(zip(map(str, pc), map(int, pp))),
                      true_keys=list(zip(map(str, tc), map(int, tp))))
    gmae, _ = match_gamma_perm(
        jio.read_gamma_csv(os.path.join(TESTDATA, "true_gamma.csv")),
        jio.read_gamma_csv(os.path.join(out, "Gamma_mean.csv")))
    assert rep.error_rate < 0.02, f"SNP error rate {rep.error_rate}"
    assert gmae < 0.02, f"gamma MAE {gmae}"
