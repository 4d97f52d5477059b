"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``), one nvcc
process per source, all started together, and the objects are linked into
one shared library with a plain C interface, named by a hash of the sources
and flags: ``build/desman_tpu_torch/libdesman_kernels.<hash>.so`` at the
repository root. The build happens at first use, writes to a temporary name
and renames it into place, so concurrent processes never load a
half-written library. A missing nvcc or a failed compile raises with the
compiler's output.
Beside the build: the checks every wrapper makes before it hands pointers
to the library (with the chain axis every wrapper takes),
the error check after each launch, and the scratch of the kernels' ``[S]``
reductions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "desman_tpu_torch"
# No --use_fast_math: it flushes subnormals to zero and makes log_check.cu's
# reference logf the approximate __logf, and the kernels' logs (warp.cuh's
# log_normal) must keep the IEEE logf's bits, or tau stops matching the plain
# version beyond float near-ties.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
SMEM_LIMIT = 232448    # dynamic shared memory one block may use on Hopper (227 KB)
TILE = 8               # positions a tile (and a block's warps)
SLOT_ROWS = 2          # rows of a block's reduction slots (csrc/warp.cuh)

_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own search: CUDA_HOME / CUDA_PATH, then the default install
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if CUDA_HOME and os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(put nvcc on PATH or set CUDA_HOME)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdesman_kernels.{h.hexdigest()[:16]}.so"


def _start(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc: subprocess.Popen, cmd) -> None:
    """Wait for one nvcc process; raise with its output if it failed."""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{stdout}{stderr}")


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources, objs)]
        procs = []
        try:
            procs = [_start(cmd) for cmd in cmds]
            for proc, cmd in zip(procs, cmds):
                _wait(proc, cmd)
        finally:  # a failed compile leaves no nvcc running
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _wait(_start(link), link)
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call, with its C signatures set."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.desman_tau_sweep.argtypes = [ptr] * 8 + [i32] * 7 + [i64, ptr]
        lib.desman_tau_sweep.restype = i32
        lib.desman_tau_sweep_info.argtypes = [i32, i32, ptr]
        lib.desman_tau_sweep_info.restype = i32
        lib.desman_tau_sweep_topk.argtypes = [ptr] * 9 + [i32] * 7 + [i64, ptr]
        lib.desman_tau_sweep_topk.restype = i32
        lib.desman_swap.argtypes = [ptr] * 13 + [i32] * 4 + [i64, ptr]
        lib.desman_swap.restype = i32
        lib.desman_gamma_ll.argtypes = [ptr] * 8 + [i32] * 5 + [i64, ptr]
        lib.desman_gamma_ll.restype = i32
        lib.desman_gamma_apply_eta.argtypes = [ptr] * 10 + [i32] * 5 + [i64, ptr]
        lib.desman_gamma_apply_eta.restype = i32
        lib.desman_fused_sweep.argtypes = [ptr] * 15 + [i32] * 7 + [i64, ptr]
        lib.desman_fused_sweep.restype = i32
        for info in ("tau_sweep_topk", "fused_sweep"):
            fn = getattr(lib, f"desman_{info}_info")
            fn.argtypes = [i32, i32, ptr]
            fn.restype = i32
        lib.desman_log_mismatches.argtypes = [ctypes.c_uint, ctypes.c_uint, ptr, ptr]
        lib.desman_log_mismatches.restype = i32
        lib.desman_partial_rows.argtypes = [i32]
        lib.desman_partial_rows.restype = i32
        lib.desman_error_string.argtypes = [i32]
        lib.desman_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.desman_error_string(err).decode()})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def partial_scratch(lib: ctypes.CDLL, V: int, rows: int, S: int,
                    device, chains: int = 1) -> torch.Tensor:
    """Scratch for the per-block partial rows of an [rows, S] output of
    each of `chains` chains, [blocks, chains * rows, S] (warp.cuh's
    deterministic reduction: chain c's columns of every block's row)."""
    return torch.empty((max(lib.desman_partial_rows(V), 1), chains * rows, S),
                       dtype=torch.float32, device=device)


def slots_in_device_memory(S: int) -> bool:
    """Whether a block's [2,8,S] f32 reduction slots are past the shared
    memory a block may use (S > 3632), and so live in device memory."""
    return SLOT_ROWS * TILE * 4 * S > SMEM_LIMIT


def slot_scratch(blocks: int, S: int, device):
    """None where a block's reduction slots fit in shared memory; past
    that, the device-memory scratch of `blocks` blocks' slots, [blocks, 2,
    8, S] f32 (csrc/warp.cuh)."""
    if not slots_in_device_memory(S):
        return None
    return torch.empty((blocks, SLOT_ROWS, TILE, S), dtype=torch.float32,
                       device=device)


def chains_of(tau: torch.Tensor):
    """The chains C of a chain-axis call (tau [C,V,G]), None for one chain
    (tau [V,G])."""
    return tau.shape[0] if tau.dim() == 3 else None


def require_counts(name: str, n, dtype, last: int, chains, device) -> tuple:
    """Check the counts of a call: [V,S,last], shared by the chains, or with
    a chain axis [C,V,S,last]. Returns (V, S, the kernel's chain stride in
    cells: 0 where shared)."""
    if chains is not None and isinstance(n, torch.Tensor) and n.dim() == 4:
        require(name, n, dtype, (chains, -1, -1, last), device)
        return n.shape[1], n.shape[2], n.shape[1] * n.shape[2]
    require(name, n, dtype, (-1, -1, last), device)
    return n.shape[0], n.shape[1], 0


def per_chain(fn, counts: tuple, *xs) -> tuple:
    """A plain version over a chain axis: fn of each chain's counts (the
    shared ones, or chain c's of [C,...] counts) and slices x[c], each
    output stacked on a leading [C] axis. Chain c is fn's call on chain c
    alone, bit for bit."""
    outs = [fn(*(k if k.dim() == 3 else k[c] for k in counts), *(x[c] for x in xs))
            for c in range(xs[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def ptr(t):
    """A tensor's data pointer for a C entry point, None for None."""
    return None if t is None else t.data_ptr()


def require(name: str, t, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype, shape and device.

    A -1 in `shape` matches any size."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want not in (-1, got) for want, got in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned for the kernel")
