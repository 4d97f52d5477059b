"""NMF initialization for the Gibbs sampler (counterpart of ``desman_tpu.nmf``).

Factorize the base-frequency matrix F[(v,a), s] ~= W H at rank G with
KL-divergence multiplicative updates, then discretize W into an initial tau
and normalize H into an initial gamma. Unfolding the (v,b) modes of the
[V,S,4] mixture this way is the structured rank-G tensor factorization the
model needs (see the JAX module's docstring).
"""
from __future__ import annotations

from typing import Optional

import torch

from .utils import NBASES, normalize_rows

_EPS = 1e-9


def _kl_updates(F: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                iters: int):
    """Multiplicative KL-NMF updates: F ~= W @ H, all entries >= 0."""
    for _ in range(iters):
        WH = torch.clamp_min(W @ H, _EPS)
        # H update: H <- H * (W^T (F/WH)) / (W^T 1)
        H = H * (W.T @ (F / WH)) / torch.clamp_min(W.sum(dim=0)[:, None], _EPS)
        WH = torch.clamp_min(W @ H, _EPS)
        # W update: W <- W * ((F/WH) H^T) / (1 H^T)
        W = W * ((F / WH) @ H.T) / torch.clamp_min(H.sum(dim=1)[None, :], _EPS)
    return W, H


def nmf_init(
    counts: torch.Tensor, G: int, generator: torch.Generator,
    iters: int = 300, W0: Optional[torch.Tensor] = None,
    H0: Optional[torch.Tensor] = None,
):
    """Initial (tau_idx [V,G] int32, gamma [S,G]) from rank-G NMF.

    counts: [V,S,4] float. W and H start uniform in [0.1, 1) from
    `generator` unless W0 [V*4, G] / H0 [G, S] are given (tests inject the
    JAX package's start to compare the updates).
    """
    V, S, _ = counts.shape
    dev = counts.device
    cov = torch.clamp_min(counts.sum(dim=2, keepdim=True), 1.0)
    freq = counts / cov                                  # [V,S,4]
    F = freq.permute(0, 2, 1).reshape(V * NBASES, S)

    if W0 is None:
        W0 = 0.1 + 0.9 * torch.rand((V * NBASES, G), generator=generator,
                                    device=dev)
    if H0 is None:
        H0 = 0.1 + 0.9 * torch.rand((G, S), generator=generator, device=dev)
    W, H = _kl_updates(F, W0.to(dev, torch.float32), H0.to(dev, torch.float32),
                       iters)

    tau_probs = normalize_rows(W.reshape(V, NBASES, G).permute(0, 2, 1))  # [V,G,4]
    tau_idx = torch.argmax(tau_probs, dim=-1).to(torch.int32)
    gamma = normalize_rows(H.T.contiguous())                               # [S,G]
    return tau_idx, gamma
