"""The agent axis: pedestrian slots split over shards (port of
parallel/mesh.py).

The JAX package writes every sharded function from one device's view under
``shard_map``, with ``jax.lax.all_gather`` / ``jax.lax.ppermute`` over a
named mesh axis.  The port writes them from one shard's view against
:class:`AgentAxis`, which has the shard's ``index``, the axis ``size`` and
the two collectives, with JAX's semantics:

* ``all_gather(t)``: every shard's ``t`` concatenated along dim 0 in shard
  order (``jax.lax.all_gather(..., tiled=True)``);
* ``ppermute(t, perm)``: ``perm`` lists ``(source, destination)`` pairs;
  each shard returns what its source sent, and zeros when no pair names it
  as a destination (``jax.lax.ppermute``).

Two implementations:

* :class:`LocalMesh` -- D shards in one process on one device, each run in
  its own Python thread (:meth:`LocalMesh.run`).  A collective puts the
  shard's tensor in a slot and passes a ``threading.Barrier``; every thread
  issues onto the stream that was current when ``run`` was called, so the
  host's order through the barrier orders the work on the card.  This is
  how one card runs the sharded path over D virtual shards (the JAX
  package's 8-device virtual CPU mesh).  A collective's result may be the
  sending shard's own tensor: treat it as read-only.
* :class:`ProcessGroupAxis` -- one shard per process, over
  ``torch.distributed`` (gloo on the CPU; the same calls run under NCCL
  across cards).

Only the agent axis exists yet: ``make_mesh`` refuses batch shards
(ensembles over a 2-D mesh, ROADMAP item 19b); a batch of crowds runs on
one device (``parallel/sweeps.py``).
"""
from __future__ import annotations

import threading
from typing import Callable, Protocol, Sequence

import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device

AGENT_AXIS = "agents"
BATCH_AXIS = "batch"

#: seconds a shard waits at a collective before the run is given up
BARRIER_TIMEOUT_S = 600.0


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


class AgentAxis(Protocol):
    """One shard's view of the agent axis."""

    index: int
    size: int

    def all_gather(self, t: torch.Tensor) -> torch.Tensor: ...

    def ppermute(self, t: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor: ...


def _source(perm, index: int):
    """The source that ``perm`` names for destination ``index``, or None."""
    srcs = [s for s, d in perm if d == index]
    if len(srcs) > 1:
        raise ValueError(f"ppermute: destination {index} has sources {srcs}")
    return srcs[0] if srcs else None


class LocalShard:
    """Shard ``index`` of a :class:`LocalMesh` (an :class:`AgentAxis`)."""

    def __init__(self, mesh: "LocalMesh", index: int):
        self.mesh = mesh
        self.index = index
        self.size = mesh.size

    def _exchange(self, value):
        """Every shard's ``value``, in shard order (a list this shard must
        not modify)."""
        m = self.mesh
        m._slots[self.index] = value
        m._wait()
        out = list(m._slots)
        m._wait()  # nobody writes a slot again before everyone has read
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._exchange(t), dim=0)

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        vals = self._exchange(t)
        src = _source(perm, self.index)
        return torch.zeros_like(t) if src is None else vals[src]

    def host_collective(self, fn: Callable[[list], list], value):
        """Every shard hands in ``value``; shard 0 runs ``fn`` on the list
        of them (shard order) and each shard gets its element of the list
        ``fn`` returns.  One launch for all shards (the ring kernel)."""
        vals = self._exchange(value)
        m = self.mesh
        if self.index == 0:
            try:
                m._result = fn(vals)
            except BaseException:
                m._result = None
                m._barrier.abort()
                raise
        m._wait()
        out = m._result[self.index]
        m._wait()
        return out


class LocalMesh:
    """``n_shards`` shards of the agent axis in one process, on ``device``.

    :meth:`run` calls ``fn(shard, *args)`` for every shard, each in its own
    thread, and returns the results in shard order.  A shard that raises
    aborts the barrier: the other shards fail at their next collective
    instead of waiting, and ``run`` raises the first error."""

    def __init__(self, n_shards: int, device: torch.device | str =
                 DEFAULT_DEVICE, timeout: float = BARRIER_TIMEOUT_S):
        if n_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{n_shards}")
        self.size = int(n_shards)
        self.device = resolve_device(device)
        self.timeout = timeout
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots: list = [None] * self.size
        self._result = None

    def shard(self, index: int) -> LocalShard:
        return LocalShard(self, index)

    def _wait(self) -> None:
        self._barrier.wait()

    def run(self, fn: Callable, *per_shard_args) -> list:
        """``[fn(shard(d), *(a[d] for a in per_shard_args)) for d]``, the
        shards in parallel threads on the calling thread's stream."""
        for a in per_shard_args:
            if len(a) != self.size:
                raise ValueError(f"run: {len(a)} arguments for "
                                 f"{self.size} shards")
        self._barrier = threading.Barrier(self.size, timeout=self.timeout)
        self._slots = [None] * self.size
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(d):
            try:
                if stream is None:
                    results[d] = fn(self.shard(d),
                                    *(a[d] for a in per_shard_args))
                else:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(stream):
                        results[d] = fn(self.shard(d),
                                        *(a[d] for a in per_shard_args))
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors[d] = exc
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(d,),
                                    name=f"agent-shard-{d}")
                   for d in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            # the first error that is not a shard giving up at the barrier
            # because another one failed
            real = [e for e in failed
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or failed)[0]
        return results


class ProcessGroupAxis:
    """This process's shard of the agent axis over ``torch.distributed``
    (``group``: a process group, default the world).  ``all_gather`` goes
    through ``dist.all_gather``, ``ppermute`` through
    ``dist.batch_isend_irecv``; bool tensors travel as uint8."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def _global(self, rank: int) -> int:
        if self.group is None:
            return rank
        return self._dist.get_global_rank(self.group, rank)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        wire = wire.contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        self._dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts, dim=0)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        dist = self._dist
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        wire = wire.contiguous()
        dsts = [d for s, d in perm if s == self.index]
        src = _source(perm, self.index)
        out = torch.zeros_like(wire)
        ops = []
        for d in dsts:
            if d == self.index:
                out = wire.clone()
            else:
                ops.append(dist.P2POp(dist.isend, wire, self._global(d),
                                      self.group))
        if src is not None and src != self.index:
            ops.append(dist.P2POp(dist.irecv, out, self._global(src),
                                  self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def host_collective(self, fn: Callable[[list], list], value):
        """A one-launch collective over every shard's ``value`` (see
        :meth:`LocalShard.host_collective`): only a group of one process
        can run it, since its launch would need every shard's memory."""
        if self.size == 1:
            return fn([value])[0]
        raise NotImplementedError(
            "the in-kernel ring across processes needs peer pointers "
            "between cards, which the port does not have yet (ROADMAP "
            "Queue 1 item 23)")


def make_mesh(n_agent_shards: int, n_batch_shards: int = 1,
              device: torch.device | str = DEFAULT_DEVICE) -> LocalMesh:
    """A :class:`LocalMesh` of ``n_agent_shards`` virtual shards on
    ``device``.  Batch shards (ensembles over a 2-D mesh) are not ported
    yet: one device runs a whole batch (``parallel/sweeps.py``)."""
    if n_batch_shards != 1:
        raise NotImplementedError(
            "batch shards (ensembles over a 2-D mesh) are not ported yet "
            "(ROADMAP item 19b)")
    return LocalMesh(n_agent_shards, device)
