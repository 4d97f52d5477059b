"""The tau Gibbs sweep: CUDA kernel wrapper, its plain PyTorch version, and
the sweep's Gumbel noise.

``tau_sweep`` runs ``csrc/tau_kernel.cu`` on CUDA tensors and the plain
version ``tau_sweep_reference`` on CPU tensors; on any other device it
raises. The plain version is the ``--kernel torch`` sweep and the oracle the
kernel is held against. Both take the categorical noise pre-drawn
(``draw_gumbel``, multiplied by the temperature by the caller), so the same
noise gives the same draws up to float near-ties. Both take a leading chain
axis: C chains in one launch (the JAX package's vmap over chains), chain c
bitwise its own sweep.

``tile_plan`` is the shared-memory plan of the row-resident tau, fused and
top-2 kernels (``csrc/tile.cuh``): whether a block stages its 8-position
tile of rows, the bytes that takes, and where the fused kernel's reduction
slots live; ``resident_grid`` the persistent grid that walks the tiles.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from ..utils import NBASES, one_hot_tau, safe_log
from ._build import (
    SMEM_LIMIT, TILE, chains_of, check, load_library, per_chain, require, require_counts,
    slots_in_device_memory, stream_of,
)

# the C entry point that reports each row-resident kernel's resources
_INFO = {"tau_sweep": "desman_tau_sweep_info", "fused_sweep": "desman_fused_sweep_info",
         "tau_sweep_topk": "desman_tau_sweep_topk_info"}


class TilePlan(NamedTuple):
    """buffers: 1 where a block stages its tile's rows in shared memory, 0
    where they stay in device memory. smem_bytes: the block's dynamic
    shared memory. device_slots: 1 where the block's [2,8,S] reduction slots
    are past the shared memory a block may use (S > 3632) and live in a
    device-memory scratch, else 0."""

    buffers: int
    smem_bytes: int
    device_slots: int = 0


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


@lru_cache(maxsize=None)
def tile_plan(S: int, G: int, fused: bool = False, topk: bool = False) -> TilePlan:
    """The tile plan of the tau kernel, the fused front-half kernel
    (fused=True) or the top-2 kernel (topk=True) at S samples and G
    strains: tile.cuh's TileLayout.

    A block holds 16 bytes of mbarrier, in the top-2 kernel eta's four
    columns ([4] float4), gamma as [G][S] f32 (rounded up to 16 bytes), the
    tile's new tau rows [8,G] i32 and, in the fused kernel, its [2,8,S] f32
    reduction slots, and one buffer of the tile's n and mix rows ([8,S]
    float4 each; the top-2 kernel's n_val and b_idx rows take n's 16 bytes
    a cell), gz rows ([8,G] float4) and tau rows ([8,G] i32), where that
    fits in SMEM_LIMIT; else nothing is staged but eta's columns and the
    fused kernel's slots, and past S = 3632 those slots are in device
    memory too. A second buffer, the next tile's copy in flight, was slower
    for the tau and fused kernels on an H100 at S=64 and S=96 (PERF.md).
    """
    head = 64 if topk else 0
    slots = 2 * TILE * 4 * S if fused else 0
    need = (16 + head + _round16(4 * S * G) + TILE * 4 * G + slots
            + 2 * TILE * 16 * S + TILE * 16 * G + TILE * 4 * G)
    if need <= SMEM_LIMIT:
        return TilePlan(1, need)
    if fused and slots_in_device_memory(S):
        return TilePlan(0, head, 1)
    return TilePlan(0, head + slots)


def plan(kernel: str, S: int, G: int) -> TilePlan:
    """The plan of row-resident kernel `kernel` at (S, G)."""
    if kernel not in _INFO:
        raise ValueError(f"no tile plan for kernel {kernel!r}")
    return tile_plan(S, G, kernel == "fused_sweep", kernel == "tau_sweep_topk")


@lru_cache(maxsize=None)
def _info(kernel: str, S: int, G: int, device: int) -> tuple:
    p = plan(kernel, S, G)
    lib = load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        check(lib, getattr(lib, _INFO[kernel])(p.buffers, p.smem_bytes, out),
              f"{kernel} info")
    return p, tuple(out)


def kernel_info(kernel: str, S: int, G: int) -> dict:
    """The tile plan of a row-resident kernel (tau_sweep, fused_sweep,
    tau_sweep_topk) at (S, G) with its registers, local (spill) bytes,
    resident blocks a SM and the SMs of the current CUDA device, from
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor.
    The first call for a device opts the kernel in to its shared memory
    there; the answer is kept, so a launch asks the runtime nothing."""
    p, (registers, local_bytes, per_sm, sms) = _info(
        kernel, S, G, torch.cuda.current_device())
    return dict(registers=registers, local_bytes=local_bytes, blocks_per_sm=per_sm,
                sms=sms, **p._asdict())


def resident_grid(kernel: str, V: int, S: int, G: int, device: int,
                  max_blocks: int = 0, chains: int = 1) -> tuple[TilePlan, int]:
    """(tile plan, grid) of a launch of a row-resident kernel on CUDA device
    `device`: the blocks the card holds at once (SMs x resident blocks a SM
    for this shared memory), split evenly over `chains` chains (at least one
    block a chain; the launch's grid rows are the chains), no more than a
    chain's tiles and, when max_blocks > 0, no more than max_blocks."""
    p, (_, _, per_sm, sms) = _info(kernel, S, G, device)
    grid = min(max(sms * max(per_sm, 1) // chains, 1), (V + TILE - 1) // TILE)
    return p, min(grid, max_blocks) if max_blocks > 0 else grid


def _check(n, tau, mix, gamma, eta, gz):
    """(V, S, G, C, the counts' chain stride): C None for one chain."""
    dev = n.device
    C = chains_of(tau)
    lead = () if C is None else (C,)
    V, S, stride = require_counts("n", n, torch.float32, NBASES, C, dev)
    require("tau", tau, torch.int32, (*lead, V, -1), dev)
    G = tau.shape[-1]
    require("mix", mix, torch.float32, (*lead, V, S, NBASES), dev)
    require("gamma", gamma, torch.float32, (*lead, S, G), dev)
    require("eta", eta, torch.float32, (*lead, NBASES, NBASES), dev)
    require("gz", gz, torch.float32, (*lead, V, G, NBASES), dev)
    return V, S, G, C, stride


def launch(lib, n, tau, mix, gamma, eta, gz, tau_out, mix_out, max_blocks=0):
    """Launch the tau kernel on checked CUDA tensors (one chain, or a
    leading chain axis) into preallocated outputs; max_blocks > 0 caps the
    persistent grid's blocks a chain (the result does not depend on it).
    Raises on a launch error."""
    chains = chains_of(tau) or 1
    V, G = tau.shape[-2:]
    S = mix.shape[-2]
    stride = V * S if n.dim() == 4 else 0
    plan, grid = resident_grid("tau_sweep", V, S, G, n.device.index, max_blocks, chains)
    with torch.cuda.device(n.device):
        err = lib.desman_tau_sweep(
            n.data_ptr(), tau.data_ptr(), mix.data_ptr(), gamma.data_ptr(),
            eta.data_ptr(), gz.data_ptr(), tau_out.data_ptr(),
            mix_out.data_ptr(), V, S, G, plan.buffers, plan.smem_bytes, grid,
            chains, stride, stream_of(n))
    check(lib, err, "tau_sweep")


def tau_sweep(n, tau, mix, gamma, eta, gz):
    """One full Gibbs sweep over strains: (tau [V,G] i32, mix [V,S,4]).

    n, mix: [V,S,4] f32; tau: [V,G] int32; gamma: [S,G]; eta: [4,4];
    gz: [V,G,4] Gumbel noise already multiplied by the temperature. All
    contiguous, on one device. Inputs are not modified.

    Chains: tau [C,V,G], mix [C,V,S,4], gamma [C,S,G], eta [C,4,4] and gz
    [C,V,G,4] sweep C chains in one launch, on counts n shared by the chains
    ([V,S,4]) or their own ([C,V,S,4]); chain c's outputs are bitwise the
    sweep of chain c alone. ``launches`` counts the launches and
    ``chain_launches`` the chains they swept.
    """
    V, S, G, C, _ = _check(n, tau, mix, gamma, eta, gz)
    if n.device.type == "cpu":
        return tau_sweep_reference(n, tau, mix, gamma, eta, gz)
    if n.device.type != "cuda":
        raise ValueError(f"tau_sweep: no kernel for device {n.device}")
    tau_out = torch.empty_like(tau)
    mix_out = torch.empty_like(mix)
    launch(load_library(), n, tau, mix, gamma, eta, gz, tau_out, mix_out)
    tau_sweep.launches += 1
    tau_sweep.chain_launches += C or 1
    return tau_out, mix_out


tau_sweep.launches = 0
tau_sweep.chain_launches = 0


def tau_sweep_reference(n, tau, mix, gamma, eta, gz):
    """Plain PyTorch tau sweep (the JAX package's ``tau_sweep_xla`` with
    the noise pre-drawn): for each strain g in order, remove it from the
    mixture, score the 4 candidate bases, draw by Gumbel-argmax (first
    maximum wins) and put the new base back. Over a chain axis, each chain
    in turn."""
    if tau.dim() == 3:
        return per_chain(tau_sweep_reference, (n,), tau, mix, gamma, eta, gz)
    G = tau.shape[1]
    tau = tau.clone()
    for g in range(G):
        gam = gamma[:, g]                                          # [S]
        rest = mix - gam[None, :, None] * one_hot_tau(tau[:, g])[:, None, :]
        q = torch.einsum("vsa,ab->vsb", rest, eta)                 # [V,S,4]
        # cand[v,c] = sum_{s,b} n[v,s,b] * log(q[v,s,b] + gamma[s,g] eta[c,b])
        terms = safe_log(q[:, :, None, :]
                         + gam[None, :, None, None] * eta[None, None, :, :])
        cand = torch.einsum("vsb,vscb->vc", n, terms)              # [V,4]
        new = torch.argmax(cand + gz[:, g, :], dim=1)
        mix = rest + gam[None, :, None] * one_hot_tau(new)[:, None, :]
        tau[:, g] = new.to(torch.int32)
    return tau, mix


def draw_gumbel(generator: torch.Generator, V: int, G: int) -> torch.Tensor:
    """Standard Gumbel noise [V,G,4] on the generator's device."""
    return gumbel_of(torch.rand((V, G, NBASES), generator=generator,
                                device=generator.device))


def gumbel_of(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms u, elementwise (any shape)."""
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
