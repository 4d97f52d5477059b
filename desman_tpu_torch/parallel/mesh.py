"""The (chain, data) mesh over a world of ranks (counterpart of
``desman_tpu.parallel.mesh``).

Two axes, as in the JAX package:

- ``chain``: independent chains (seeds), split into contiguous groups, one
  group a row of the mesh. No communication.
- ``data``: variant positions, padded to a multiple of the axis and cut
  into one contiguous block a rank. The tau sweep and the swap move are
  position-local given (gamma, eta); the likelihood sums of the gamma and
  eta MH steps add the blocks' partial sums over the row
  (``distributed.Axis.sum``).

Rank r sits at chain row ``r // n_data`` and data column ``r % n_data``;
one process a rank, one device a rank (``distributed.rank_device``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

CHAIN_AXIS = "chain"
DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A (chain, data) grid of ranks."""

    n_chain: int
    n_data: int

    @property
    def shape(self) -> dict:
        return {CHAIN_AXIS: self.n_chain, DATA_AXIS: self.n_data}

    @property
    def size(self) -> int:
        return self.n_chain * self.n_data

    def coords(self, rank: int) -> Tuple[int, int]:
        """(chain row, data column) of a rank."""
        return rank // self.n_data, rank % self.n_data

    def row(self, c: int) -> list:
        """The ranks of chain row c, in data order."""
        return list(range(c * self.n_data, (c + 1) * self.n_data))

    def block(self, Vp: int, d: int) -> Tuple[int, int]:
        """[lo, hi) of data column d's positions, of Vp (a multiple of
        n_data)."""
        b = Vp // self.n_data
        return d * b, (d + 1) * b

    def __str__(self) -> str:
        return f"{self.n_chain}x{self.n_data}"


def make_mesh(n_chain: Optional[int] = None, n_data: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """A (chain, data) mesh over the world's ranks.

    Default split: every rank on the data (position) axis; pass n_chain > 1
    to give ranks to chains. Raises ValueError when the shape does not
    cover the world exactly (the JAX package's message, ranks for
    devices).
    """
    if world_size is None:
        from .distributed import world_ranks

        world_size = world_ranks()
    n = int(world_size)
    if n_chain is None and n_data is None:
        n_chain, n_data = 1, n
    elif n_chain is None:
        n_chain = n // n_data
    elif n_data is None:
        n_data = n // n_chain
    if n_chain < 1 or n_data < 1 or n_chain * n_data != n:
        raise ValueError(f"mesh {n_chain}x{n_data} != {n} devices")
    return Mesh(int(n_chain), int(n_data))


def parse_mesh(text: str) -> Tuple[int, int]:
    """'CxD' -> (C, D), as the JAX CLI reads --mesh."""
    c, d = (int(x) for x in text.lower().split("x"))
    return c, d


def pad_positions(counts: np.ndarray, multiple: int):
    """Pad V up to a multiple of the data axis with zero-coverage rows.

    Zero-coverage rows add exactly 0 to every likelihood term (n log p with
    n = 0), so padding is inference-neutral. Returns (padded, original V).
    """
    V = counts.shape[0]
    Vp = ((V + multiple - 1) // multiple) * multiple
    if Vp == V:
        return counts, V
    pad = np.zeros((Vp - V,) + counts.shape[1:], counts.dtype)
    return np.concatenate([counts, pad], axis=0), V


def pad_tau(tau, multiple: int):
    """Pad a [V,G] tau (known haplotypes) as ``pad_positions`` pads the
    counts: the pad rows have no coverage, so their base (A) is inert."""
    if tau is None:
        return None
    padded, _ = pad_positions(np.asarray(tau), multiple)
    return padded
