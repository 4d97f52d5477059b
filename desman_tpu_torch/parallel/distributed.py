"""Process groups, the rank's device, and the collective layer of a sharded
run (counterpart of ``desman_tpu.parallel.distributed``).

One process a rank, one device a rank. A world is joined from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) by ``maybe_initialize``, the one entry
point that creates a group; ``launch`` starts a world on this host (the
``desman --mesh`` CLI without torchrun) by setting those variables for
each rank.

The device rule: rank r runs on ``cuda:{LOCAL_RANK % device_count}``; with
no card ``rank_device("cuda")`` raises, as every entry point of the port
does, and ``device="cpu"`` runs the rank on the CPU.

The backend rule, decided once and never retried:

- gloo on the CPU;
- NCCL when every local rank has a card of its own
  (``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``);
- gloo when ranks share a card (NCCL refuses two ranks on one device);
  gloo moves CUDA tensors through the host.

The run record (metrics.json's ``backend``) reports the choice.

**The collective layer.** Every cross-rank reduction of a sharded run
goes through ``exchange``: one ``all_reduce(SUM)``, counted in
``exchange.calls``; an axis of one rank (a 1x1 mesh, or the chain rows of
a Cx1 one) makes none. ``Axis.gather`` is an exact all-gather built on it:
each rank writes its part into its own slot of a zeroed ``[size, ...]``
buffer, and the sum fills in the other slots (x + 0 is exact), whatever
the backend and its ring order. ``Axis.sum`` then adds the slots in index
order, so every rank of a chain row holds bitwise the same gamma, eta and
loglik: an MH decision that differed between ranks would split the chain
without a word. ``all_reduce`` is one of the two collectives gloo takes
on CUDA tensors; nothing else crosses ranks on the device.

A run's result reaches the coordinator alone through ``Axis.collect``:
each rank's part moves to the host and is gathered to rank 0 over gloo
(the world's own group when it is gloo, else a gloo group beside NCCL's),
so no card holds more than its own part of the per-position fields.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import signal
import socket
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

# a collective that waits this long for a rank fails the run instead of
# hanging it
TIMEOUT_S = 600
# the exit code of a run that committed its checkpoint after SIGTERM
PREEMPTED_EXIT = 75


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_ranks() -> int:
    """The joined group's size, else torchrun's WORLD_SIZE, else 1."""
    if initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def rank() -> int:
    return dist.get_rank() if initialized() else int(os.environ.get("RANK", 0))


def is_coordinator() -> bool:
    """True on the rank that writes the outputs (rank 0)."""
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK % device_count}`` for
    "cuda" (raises without CUDA), the CPU for "cpu"; an indexed device is
    taken as given."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"a rank runs on 'cuda' or 'cpu', not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    if dev.index is not None:
        return dev
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """gloo on the CPU; NCCL when each local rank has a card of its own;
    gloo when ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                      os.environ.get("WORLD_SIZE", 1)))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def backend() -> Optional[str]:
    """The joined group's backend (None without one)."""
    return dist.get_backend() if initialized() else None


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_S)


def maybe_initialize(device="cuda") -> bool:
    """Join the world torchrun's environment describes. A no-op when a
    group is joined already (returns True) or no such environment is set
    (returns False)."""
    if initialized():
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT")):
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://",
                            timeout=_timeout())
    return True


def exchange(buf: torch.Tensor, axis: "Axis") -> torch.Tensor:
    """The layer's one collective: all_reduce(SUM) of buf over the axis's
    ranks, in place. Counts its calls in ``exchange.calls``."""
    exchange.calls += 1
    if axis.group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
    return buf


exchange.calls = 0


def reset_collectives() -> None:
    exchange.calls = 0


class Axis:
    """The ranks one reduction runs over (a chain row's data ranks, or the
    whole world) and this rank's slot among them."""

    def __init__(self, group, size: int, index: int, device: torch.device,
                 host=None):
        self.group, self.size, self.index, self.device = group, size, index, device
        self.host = host   # a gloo group over the same ranks (the world's)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x stacked on a new leading axis, exactly. An axis of
        one rank exchanges nothing: x is the whole."""
        if self.size == 1:
            return x.unsqueeze(0)
        buf = torch.zeros((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        buf[self.index] = x
        return exchange(buf, self)

    def collect(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Every rank's x, moved to the host, stacked on a new leading axis
        on the axis's rank 0 alone (None on the others): a gather over the
        host group. Its dtype is kept."""
        x = x.detach().cpu().contiguous()
        if self.size == 1:
            return x.unsqueeze(0)
        parts = [torch.empty_like(x) for _ in range(self.size)] if self.index == 0 else None
        dist.gather(x, parts, dst=dist.get_global_rank(self.host, 0), group=self.host)
        return None if parts is None else torch.stack(parts)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x added in index order: bitwise the same on every
        rank, and x itself on an axis of one rank."""
        parts = self.gather(x)
        out = parts[0]
        for i in range(1, self.size):
            out = out + parts[i]
        return out

    def any(self, flag: bool) -> bool:
        """Whether any rank's flag is set (every rank gets the answer)."""
        one = torch.tensor(int(bool(flag)), dtype=torch.int32, device=self.device)
        return bool(self.sum(one).item())

    def barrier(self) -> None:
        self.any(False)


class MeshAxes:
    """This rank's place on a mesh: its chain row c and data column d, the
    row's data axis and the world axis."""

    def __init__(self, mesh, c: int, d: int, data: Axis, world: Axis):
        self.mesh, self.c, self.d, self.data, self.world = mesh, c, d, data, world


_AXES: dict = {}


def mesh_axes(mesh, device: torch.device) -> MeshAxes:
    """The rank's MeshAxes; the row groups (and, beside NCCL, the world's
    gloo group for ``Axis.collect``) are made once a mesh (every rank
    makes every group, in the same order)."""
    if not initialized():
        if mesh.size != 1:
            raise RuntimeError(
                f"a {mesh} mesh needs a process group of {mesh.size} ranks: run "
                "under torchrun, or through `desman --mesh`, which starts them")
        return MeshAxes(mesh, 0, 0, Axis(None, 1, 0, device),
                        Axis(None, 1, 0, device))
    world, r = dist.get_world_size(), dist.get_rank()
    if mesh.size != world:
        raise ValueError(f"mesh {mesh.n_chain}x{mesh.n_data} != {world} devices")
    key = (mesh.n_chain, mesh.n_data, str(device))
    if key not in _AXES:
        rows = [dist.new_group(mesh.row(c)) for c in range(mesh.n_chain)]
        host = (dist.group.WORLD if dist.get_backend() == "gloo"
                else dist.new_group(backend="gloo"))
        c, d = mesh.coords(r)
        _AXES[key] = MeshAxes(mesh, c, d, Axis(rows[c], mesh.n_data, d, device),
                              Axis(dist.group.WORLD, world, r, device, host))
    return _AXES[key]


def leave() -> None:
    """Leave the joined group (and forget its axes)."""
    _AXES.clear()
    if initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# starting a world on this host
# --------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(env: dict, fn, args) -> None:
    os.environ.update(env)
    try:
        rc = fn(*args)
    finally:
        leave()
    sys.exit(int(rc or 0))


def combined_exit(codes, first_failure=None) -> int:
    """One exit code for a world: 0 when every rank exits 0; 75 when the
    ranks stopped at a committed checkpoint after SIGTERM; otherwise the
    code of the rank that failed first (the first failing rank's when not
    known; a signal's as 128 + its number)."""
    bad = [c for c in codes if c not in (0, PREEMPTED_EXIT)]
    if bad:
        c = bad[0] if first_failure is None else first_failure
        return 128 - c if c is not None and c < 0 else (c or 1)
    return PREEMPTED_EXIT if PREEMPTED_EXIT in codes else 0


# the exit code of a world that outlived launch's timeout (as timeout(1))
TIMED_OUT_EXIT = 124
# how often launch looks at its ranks
POLL_S = 0.05


def launch(fn, nprocs: int, args=(), timeout_s: Optional[float] = None) -> int:
    """Run ``fn(*args)`` as every rank of a world of `nprocs` processes on
    this host (the spawn context, a free port on 127.0.0.1, torchrun's
    environment variables); each rank exits with fn's return value.

    The caller's SIGTERM is forwarded to every rank. When a rank fails
    (any exit but 0 and 75), the others are killed: a rank left alone
    would wait in a collective. Returns ``combined_exit`` of the ranks, or
    124 with every rank killed once timeout_s has passed.
    """
    ctx = multiprocessing.get_context("spawn")
    base = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "WORLD_SIZE": str(nprocs), "LOCAL_WORLD_SIZE": str(nprocs)}
    procs = [ctx.Process(target=_rank_main, args=(
        dict(base, RANK=str(r), LOCAL_RANK=str(r)), fn, args)) for r in range(nprocs)]
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    try:
        previous = signal.signal(signal.SIGTERM, forward)
    except ValueError:   # not the main thread: nothing to forward
        previous = None
    first = None
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while first is None and any(p.is_alive() for p in procs):
            first = next((p.exitcode for p in procs
                          if p.exitcode not in (None, 0, PREEMPTED_EXIT)), None)
            if deadline is not None and time.monotonic() > deadline:
                first = TIMED_OUT_EXIT
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    if first == TIMED_OUT_EXIT:
        return TIMED_OUT_EXIT
    return combined_exit([p.exitcode for p in procs], first)
