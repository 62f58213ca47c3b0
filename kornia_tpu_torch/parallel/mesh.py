"""Mesh construction and the collectives of the distributed layer (port
of kornia_tpu/parallel/mesh.py, over ``torch.distributed``).

The reference has one controller: a ``jax.sharding.Mesh`` of devices and
``shard_map`` programs whose leading axis holds every shard. PyTorch runs
one process per rank instead. A :class:`Mesh` here is a 1-D group of
ranks with the axis "obs": rank ``i`` works on ``devices[i]``.
Observations (and the points they reference) are sharded; poses and the
reduced camera system are replicated (6P ≲ a few thousand).

Every collective of the layer goes through a method of :class:`Mesh`,
which counts it (``mesh.counts``: collectives, and the bytes this rank
handed to them). A 1-rank mesh made without a process group runs its
collectives as the identity.

Importing this module starts no process group:
:func:`initialize_distributed` does. :func:`spawn` runs a function on
several ranks of one host (CPU ranks, or ranks that share a card).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from kornia_tpu_torch import resolve_device

OBS_AXIS = "obs"


def _group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A 1-D mesh of ranks: rank ``i`` of the default process group works
    on ``devices[i]`` (a numpy object array, so ``devices.size`` is the
    rank count, as on the reference's mesh). ``rank``, ``size`` and
    ``device`` are this process's; ``counts`` counts its collectives."""

    def __init__(self, devices: Sequence, axis_names=(OBS_AXIS,)):
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.size = int(self.devices.size)
        if _group_active():
            if dist.get_world_size() != self.size:
                raise ValueError(
                    f"a mesh of {self.size} devices in a process group of "
                    f"{dist.get_world_size()} ranks")
            self.rank = dist.get_rank()
        elif self.size == 1:
            self.rank = 0
        else:
            raise RuntimeError(
                f"a mesh of {self.size} ranks needs torch.distributed: call "
                "initialize_distributed first")
        self.device = resolve_device(self.devices[self.rank])
        self.counts = {"collectives": 0, "bytes": 0}

    def __repr__(self):
        return (f"Mesh(rank {self.rank} of {self.size}, {self.device}, "
                f"axis {self.axis_names[0]!r})")

    # ------------------------------------------------------ collectives
    def _count(self, t: torch.Tensor) -> bool:
        """Count one collective of ``t``'s bytes; False when there is no
        process group (a 1-rank mesh), so the caller skips the call."""
        if not _group_active():
            return False
        self.counts["collectives"] += 1
        self.counts["bytes"] += t.numel() * t.element_size()
        return True

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self._count(t):
            dist.all_reduce(t)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(…) on every rank → (size, …), rank order."""
        if not self._count(t):
            return t[None]
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        # the list form: every backend takes it (gloo refuses the flat
        # output tensor's (size, …) shape)
        dist.all_gather(list(out.unbind(0)), t.contiguous())
        return out

    def all_to_all(self, send: torch.Tensor, send_rows: List[int],
                   recv_rows: List[int]) -> torch.Tensor:
        """Rows of ``send`` (…, C) in rank blocks: ``send_rows[t]`` rows
        to rank ``t``; returns the ``recv_rows[s]`` rows from each rank
        ``s``, stacked in rank order."""
        send = send.contiguous()
        out = torch.empty((sum(recv_rows),) + tuple(send.shape[1:]),
                          dtype=send.dtype, device=send.device)
        if self._count(send):
            dist.all_to_all_single(out, send, recv_rows, send_rows)
        else:
            out.copy_(send)
        return out

    def broadcast_object(self, obj=None, src: int = 0):
        """``obj`` of rank ``src`` on every rank (pickled; only this
        program's ranks write what is unpickled)."""
        if not _group_active():
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        self.counts["collectives"] += 1
        return box[0]


def make_mesh(devices: Optional[Sequence] = None,
              axis: str = OBS_AXIS) -> Mesh:
    """1-D mesh over the ranks of the default process group, rank ``i``
    on ``devices[i]``. Default: rank ``i`` on ``cuda:(i % n_cards)`` (the
    card; a mesh on the CPU is asked for with ``["cpu"] * size``). Without
    a process group the mesh has one rank."""
    if devices is None:
        size = dist.get_world_size() if _group_active() else 1
        n = max(torch.cuda.device_count(), 1)
        devices = [f"cuda:{i % n}" for i in range(size)]
    return Mesh(devices, (axis,))


def replicated(mesh: Mesh):
    """The placement of a replicated array: DTensor's ``Replicate()``."""
    from torch.distributed.tensor import Replicate

    return Replicate()


def sharded_leading(mesh: Mesh, axis: str = OBS_AXIS):
    """The placement of an array sharded on its leading axis: DTensor's
    ``Shard(0)``."""
    from torch.distributed.tensor import Shard

    return Shard(0)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Start the default process group: ``nccl`` when each rank owns a
    card (``num_processes`` ≤ the cards this host has), ``gloo``
    otherwise (CPU ranks, or several ranks sharing one card).
    ``coordinator_address`` is ``host:port`` (TCP) or any
    ``init_method`` URL (``file://…``); without it the ``env://``
    variables are read. Idempotent: a no-op when a group exists (e.g.
    started by a launcher). Multi-host NCCL jobs start the group
    themselves with ``torch.distributed.init_process_group``."""
    _start_group(coordinator_address, num_processes, process_id)


def _start_group(coordinator_address, num_processes, process_id,
                 devices=None) -> None:
    """:func:`initialize_distributed`; ranks whose ``devices`` are all
    CPU devices talk over gloo, whatever cards the host has."""
    if _group_active():
        return
    n = 1 if num_processes is None else int(num_processes)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    cpu = devices is not None and all(
        torch.device(d).type == "cpu" for d in devices)
    backend = "nccl" if 0 < n <= cards and not cpu else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(int(process_id or 0) % cards)
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else n,
        rank=-1 if process_id is None else int(process_id))


def global_mesh(axis: str = OBS_AXIS) -> Mesh:
    """1-D mesh over every process (call after
    :func:`initialize_distributed` on every host), rank order."""
    return make_mesh(None, axis)


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a leading-axis-sharded global batch this process owns."""
    n_proc = dist.get_world_size() if _group_active() else 1
    rank = dist.get_rank() if _group_active() else 0
    per = global_batch // n_proc
    return slice(rank * per, (rank + 1) * per)


def _spawned_rank(rank, n_ranks, tmp, devices, results):
    try:
        with open(os.path.join(tmp, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        _start_group(f"file://{os.path.join(tmp, 'rendezvous')}",
                     n_ranks, rank, devices)
        try:
            out = fn(make_mesh(devices), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def _failures(results, rank, trace, pending: int,
              grace: float = 5.0) -> str:
    """The failed rank's traceback and those of the ``pending`` other
    ranks that report within ``grace`` seconds after it (a rank's failure
    breaks the others' collectives, and the first report is not always
    the cause's)."""
    msgs = [f"rank {rank} failed:\n{trace}"]
    deadline = time.monotonic() + grace
    for _ in range(pending):
        try:
            r, ok, value = results.get(
                timeout=max(deadline - time.monotonic(), 0.0))
        except queue.Empty:
            break
        if not ok:
            msgs.append(f"rank {r} failed:\n{value}")
    return "\n".join(msgs)


def spawn(fn: Callable, n_ranks: int, *args, devices=None,
          timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` processes of this host
    (start method ``spawn``; ``fn`` and ``args`` are pickled to a file the
    ranks read once started, ``fn`` by import path, so that large inputs
    do not hold each start until its rank has imported its modules), each
    rank in a process group over a rendezvous file
    (:func:`initialize_distributed`: gloo unless each rank owns a card)
    and a mesh on ``devices`` (:func:`make_mesh`). Returns every rank's
    return value, rank order. A rank that raises makes it raise with that
    rank's traceback; ranks not done within ``timeout`` seconds make it
    raise TimeoutError. Either way every rank is stopped first."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="kornia_ranks_")
    procs = [ctx.Process(target=_spawned_rank, daemon=True, args=(
        r, n_ranks, tmp, devices, results)) for r in range(n_ranks)]
    try:
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < n_ranks:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank that died without a report (killed, or a
                    # fatal error below Python)
                    raise RuntimeError(_failures(
                        results, dead[0], "exited with code "
                        f"{procs[dead[0]].exitcode} without a report",
                        n_ranks - len(out) - 1)) from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n_ranks)) - set(out))} "
                        f"not done within {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(_failures(results, rank, value,
                                             n_ranks - len(out) - 1))
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(n_ranks)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)
