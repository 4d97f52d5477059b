"""Many genome bins in one run (counterpart of ``desman_tpu.multibin``).

A metagenome yields tens of bins that share one sample set. Each bin's
variant positions are padded with zero rows to a common V (a zero row is
likelihood-neutral: n=0 kills every log term and the multinomial
coefficient) and one chain runs per bin. The JAX package vmaps the chain
over bins; here the bins are the chain axis (``sampler.run_chains`` on the
[B, V_max, S, 4] padded counts, each bin's chain on its own counts through
the kernels' counts stride), one sweep of every bin at a time, and each
bin's results are cut back to its own V.

A run is the ``multibin`` span (bins, rows: the bins' own positions,
padded_rows: B x V_max), with ``multibin.read_counts`` (``run_bins_files``)
and ``multibin.pad`` (the padded counts assembled on the device) inside it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import io
from .ops import resolve
from .profiling import span
from .sampler import SamplerConfig, SamplerResult, run_chains, spawn_seeds


def _bin_shape(counts_list: Sequence[np.ndarray]):
    """(S, V_max) of bins that share a sample axis; ValueError otherwise."""
    if not counts_list:
        raise ValueError("no bins")
    S = counts_list[0].shape[1]
    for c in counts_list:
        if c.ndim != 3 or c.shape[1] != S or c.shape[2] != 4:
            raise ValueError(
                "all bins must be [V, S, 4] with a shared sample axis; got "
                f"{[tuple(x.shape) for x in counts_list]}")
    return S, max(c.shape[0] for c in counts_list)


def pad_bins(counts_list: Sequence[np.ndarray]) -> np.ndarray:
    """Stack [V_b, S, 4] tensors into [B, V_max, S, 4] with zero padding."""
    S, v_max = _bin_shape(counts_list)
    out = np.zeros((len(counts_list), v_max, S, 4), np.float32)
    for b, c in enumerate(counts_list):
        out[b, : c.shape[0]] = c
    return out


def run_bins(
    counts_list: Sequence[np.ndarray],
    cfg: SamplerConfig,
    seed: int = 0,
    eta_init: Optional[np.ndarray] = None,
    kernel: str = "cuda",
    device="cuda",
) -> List[SamplerResult]:
    """One chain per bin on its padded counts; returns per-bin results,
    their tensors on `device`, with tau_mean and tau_star cut back to the
    bin's V.

    The bins are padded to V_max into one [B, V_max, S, 4] tensor on the
    device (``pad_bins``' rows; device memory holds every bin's counts and
    state at once, as the JAX package's vmap does) and advance as one
    chain axis, one sweep of all of them at a time (``run_chains`` on the
    bins' own counts). Bin b runs on its own generator, seeded with child b
    of ``spawn_seeds(seed, B)`` (PT's convention), so its result is bitwise
    ``run_chain`` of ``pad_bins(counts_list)[b]`` with that generator. The
    kernel choice ("cuda", "cuda_resident" or "torch") is resolved once for
    all bins; "cuda_topk" binds to one counts tensor, so it raises
    ValueError.
    """
    with span("multibin", **_sizes(counts_list)):
        return _run_bins(counts_list, cfg, seed, eta_init, kernel, device)


def _sizes(counts_list: Sequence[np.ndarray]) -> dict:
    """The ``multibin`` span's attributes: the bins, their own rows and the
    rows the padded bins sweep."""
    _, v_max = _bin_shape(counts_list)
    return {"bins": len(counts_list), "rows": sum(c.shape[0] for c in counts_list),
            "padded_rows": len(counts_list) * v_max}


def _run_bins(counts_list, cfg, seed, eta_init, kernel, device) -> List[SamplerResult]:
    resolve(kernel)   # an unknown choice or cuda_topk raises before the bins reach the device
    S, v_max = _bin_shape(counts_list)
    device = torch.device(device)
    eta = (None if eta_init is None else
           torch.as_tensor(eta_init, dtype=torch.float32, device=device))
    with span("multibin.pad"):
        n = torch.zeros((len(counts_list), v_max, S, 4), dtype=torch.float32,
                        device=device)
        for b, counts in enumerate(counts_list):
            n[b, :counts.shape[0]] = torch.as_tensor(counts, dtype=torch.float32,
                                                     device=device)
    res = run_chains(n, cfg, spawn_seeds(seed, len(counts_list)), eta_init=eta,
                     kernel=kernel)
    del n
    return [SamplerResult(*(None if x is None else x[b] for x in res))._replace(
        tau_mean=res.tau_mean[b, :c.shape[0]], tau_star=res.tau_star[b, :c.shape[0]])
        for b, c in enumerate(counts_list)]


def run_bins_files(
    counts_files: Sequence[str],
    cfg: SamplerConfig,
    out_dirs: Sequence[str],
    seed: int = 0,
    eta_init: Optional[np.ndarray] = None,
    kernel: str = "cuda",
    device="cuda",
) -> List[SamplerResult]:
    """Read the bins' counts CSVs, run them, and write one DESMAN-format
    output directory per bin from its own (unpadded) data."""
    from .run import _device_name, write_outputs

    if len(set(out_dirs)) != len(out_dirs):
        raise ValueError(f"duplicate output dirs: {sorted(out_dirs)}")
    with span("multibin") as run_span:
        with span("multibin.read_counts", bins=len(counts_files)):
            datas = [io.read_counts_csv(f) for f in counts_files]
            samples0 = datas[0].samples
            for f, d in zip(counts_files, datas):
                if d.samples != samples0:
                    raise ValueError(
                        f"{f}: sample columns differ from {counts_files[0]} — "
                        "multi-bin batching requires a shared sample set")
        counts_list = [d.counts for d in datas]
        run_span.attrs.update(_sizes(counts_list))
        results = _run_bins(counts_list, cfg, seed, eta_init, kernel, device)
        metrics = {"device": _device_name(torch.device(device)), "kernel": kernel}
        for d, r, out_dir in zip(datas, results, out_dirs):
            write_outputs(out_dir, d, r, cfg, extra_metrics=metrics)
    return results
