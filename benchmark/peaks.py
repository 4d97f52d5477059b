"""The card's peaks and the least time a Gibbs sweep's work needs on it.

Frozen from the port's ``kernel_bench`` (``LOG_RATE``, ``MEM_RATE``,
``kernel_work``) so that a change to the program cannot move the
yardstick. The rates are the published ones of an H100 SXM: 132 SMs, 16
MUFU results a clock an SM at the 1.98 GHz boost clock, 3.35 TB/s of HBM3.

A sweep's work is that of the resident path's two kernels, the fused front
half (tau update, swap, the gamma proposal's likelihoods) and the
apply/eta pass: the least any kernel choice of the port needs. Bytes count
each input read once and each output written once (f32 and i32: 4 bytes).
Logs count only the cells' observed bases (n > 0): a term n log p with
n = 0 needs no log, so a kernel that skips them cannot read above its
bound.
"""
from __future__ import annotations

LOG_RATE = 132 * 16 * 1.98e9     # logs a second
MEM_RATE = 3.35e12               # bytes a second

# logs a cell's observed base costs: fused, per strain the 4 candidate
# bases (4 G), plus the gamma proposal's old and new likelihoods and the
# swap's (3); apply/eta, one (the new eta's likelihood)
FUSED_LOGS_PER_G, FUSED_LOGS_FIXED, APPLY_LOGS = 4, 3, 1


def sweep_bytes(V: int, S: int, G: int) -> int:
    """Bytes of one sweep of the fused and apply/eta kernels (kernel_work's
    ``fused_sweep`` plus ``gamma_apply_eta``, one chain)."""
    cells = V * S
    row = 16 * cells
    tau, gz, gam = 4 * V * G, 16 * V * G, 4 * S * G
    fused = row + 2 * row + 2 * tau + gz + 2 * gam + 64 + 4 * V + 8 * S
    apply = row + 2 * row + tau + gam + S + 64 + 4 * S
    return fused + apply


def sweep_logs(observed: int, G: int) -> int:
    """Logs of one sweep over `observed` (position, sample, base) counts > 0."""
    return (FUSED_LOGS_PER_G * G + FUSED_LOGS_FIXED + APPLY_LOGS) * observed


def sweep_least_s(V: int, S: int, G: int, observed: int) -> float:
    """The least seconds a sweep could take: the larger of its logs over the
    SFU rate and its bytes over the memory rate."""
    return max(sweep_logs(observed, G) / LOG_RATE, sweep_bytes(V, S, G) / MEM_RATE)
