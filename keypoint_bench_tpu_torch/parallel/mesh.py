"""Ranks, groups and the few collectives of the parallel layer
(counterpart of keypoint_bench_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ('data', 'model') mesh and runs
shard_map over it. Here every rank is a process (under `torchrun`, after
`init_distributed`) or a thread of one process (`thread_ranks`: the tests,
and several ranks sharing one card) and holds a `Mesh`: its place on the
two axes, its device and one process group per axis. Rank r sits at data
index r // n_model and model index r % n_model, the JAX layout
(`np.array(devices).reshape(n_data, n_model)`).

The collectives are the ones the JAX code uses: `psum` (`all_reduce`),
`ppermute` (the pipeline's one-way hop between the two ranks of a
`make_stage_mesh` 'stage' axis, and `ring_shift`, the ring of the
sequence-sharded VO and of ring attention) and the host gather of
data-sharded outputs (`all_gather`), plus `broadcast_json` for
what rank 0 alone reads (the resume journal). Each is a method call on a
group object (`allreduce`, `allgather`, `broadcast`, `send` / `recv`), so
the same code serves the groups of `dist.new_group` and the thread ranks'
gloo groups.

Gloo takes CUDA tensors in allreduce, allgather and broadcast; its send and
recv read host memory, so on a gloo group a CUDA tensor's ring hop goes
through a host copy. `Mesh.staged` names each op that was staged so. NCCL
takes CUDA tensors everywhere, and refuses two ranks on one card, so ranks
that share a card run over gloo.

Without a process group, `Mesh.single(device)` is one rank whose
collectives are the identity: what JAX's one-device mesh does.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field, replace
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist

from keypoint_bench_tpu_torch.device import resolve_device

# gloo's send / recv read and write host memory: on a gloo group their
# CUDA tensors go through host copies (allreduce, allgather and broadcast
# take CUDA tensors as they are)
GLOO_HOST_OPS = frozenset({"send", "recv"})


@dataclass(eq=False)
class Mesh:
    """One rank's view of the n_data x n_model grid.

    `groups` maps "world", "data" and "model" to this rank's group on that
    axis, or None where the axis holds this rank alone. `new_group(ranks)`
    is called by every rank with the same global ranks and returns the new
    group to its members (None to the others). With `timing`, every
    collective waits for the device first and `stats` sums its calls and
    host seconds by op (the collectives' share of a step)."""
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    backend: str = "none"
    groups: dict = field(default_factory=dict)
    new_group: Callable | None = None
    timing: bool = False
    stats: dict = field(default_factory=dict)
    staged: set = field(default_factory=set)

    @classmethod
    def single(cls, device="cuda") -> "Mesh":
        """One rank on `device`: every collective is the identity."""
        return cls(1, 1, 0, resolve_device(device))

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def subset(self, n_data: int) -> "Mesh | None":
        """The mesh over data ranks 0..n_data-1 (a 'data'-only mesh):
        every rank calls it; the ranks outside get None. JAX's mesh over
        `jax.devices()[:n_data]`."""
        if self.n_model != 1 or not 1 <= n_data <= self.n_data:
            raise ValueError(f"subset({n_data}) of a {self.n_data} x "
                             f"{self.n_model} mesh")
        if n_data == self.n_data:
            return self
        group = None
        if n_data > 1:
            group = self.new_group(list(range(n_data)))
        if self.rank >= n_data:
            return None
        return Mesh(n_data, 1, self.rank, self.device, self.backend,
                    {"world": group, "data": group, "model": None},
                    self.new_group, self.timing, self.stats, self.staged)

    # -- collectives -------------------------------------------------------

    def _wait(self, op: str, works, t0: float):
        for w in works:
            w.wait()
        if self.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            calls, sec = self.stats.get(op, (0, 0.0))
            self.stats[op] = (calls + 1, sec + time.perf_counter() - t0)

    def _start(self) -> float:
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def all_reduce(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum of t over the axis (jax.lax.psum), in place; returns t."""
        g = self.groups.get(axis)
        if g is None:
            return t
        t0 = self._start()
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._wait("allreduce", [g.allreduce([t], opts)], t0)
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "data") -> list:
        """Every rank's t on the axis, in rank order (equal shapes)."""
        g = self.groups.get(axis)
        if g is None:
            return [t]
        t = t.contiguous()
        t0 = self._start()
        outs = [torch.empty_like(t) for _ in range(g.size())]
        self._wait("allgather", [g.allgather([outs], [t])], t0)
        return outs

    def ring_shift(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The previous rank's t on the axis (rank 0 gets the last rank's):
        jax.lax.ppermute with the ring [(i, i + 1 mod n)]. One rank gets
        its own t."""
        g = self.groups.get(axis)
        if g is None or g.size() == 1:
            return t
        n = g.size()
        return self.ppermute(t, [(i, (i + 1) % n) for i in range(n)], axis,
                             "ring_shift")

    def ppermute(self, t: torch.Tensor, perm, axis: str = "data",
                 op: str = "ppermute") -> torch.Tensor:
        """jax.lax.ppermute on the axis: for each (src, dst) of `perm`
        (axis ranks), rank dst gets rank src's t; a rank that no pair
        sends to gets zeros shaped like its own t, which is also the shape
        it receives. With the pipeline's [(0, 1)] stage 1 gets stage 0's
        activations and stage 0 zeros. On a gloo group a CUDA t goes
        through a host copy (`staged`); the seconds count under `op`."""
        g = self.groups.get(axis)
        if g is None:
            raise ValueError(f"ppermute on axis {axis!r}, which holds this "
                             f"rank alone")
        r = g.rank()
        dst = [d for s, d in perm if s == r]
        src = [s for s, d in perm if d == r]
        buf = t.contiguous()
        host = self.backend == "gloo" and buf.is_cuda
        if host:
            self.staged.update(GLOO_HOST_OPS)
            buf = buf.cpu()
        out = torch.zeros_like(buf)
        t0 = self._start()
        works = [g.send([buf], d, 0) for d in dst]
        works += [g.recv([out], s, 0) for s in src]
        self._wait(op, works, t0)
        return out.to(t.device) if host else out

    def broadcast_json(self, obj, src: int = 0, axis: str = "world"):
        """`obj` (anything json can write) of rank `src` on every rank of
        the axis."""
        g = self.groups.get(axis)
        if g is None:
            return obj
        on = self.device if self.backend == "nccl" else torch.device("cpu")
        data = json.dumps(obj).encode() if g.rank() == src else b""
        n = torch.tensor([len(data)], dtype=torch.int64, device=on)
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        t0 = self._start()
        self._wait("broadcast", [g.broadcast([n], opts)], t0)
        buf = torch.zeros(int(n), dtype=torch.uint8, device=on)
        if g.rank() == src:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        t0 = self._start()
        self._wait("broadcast", [g.broadcast([buf], opts)], t0)
        return json.loads(bytes(buf.cpu().tolist()).decode())


def make_stage_mesh(mesh: Mesh) -> "Mesh | None":
    """Two pipeline stages, a 'stage' axis over data ranks 0 and 1 of a
    'data'-only mesh (JAX's make_stage_mesh over the first two devices).
    Every rank calls it; the ranks outside get None. The stage mesh
    shares the mesh's timing, stats and staged ops."""
    if mesh.n_data < 2:
        raise ValueError("pipeline parallelism needs >= 2 ranks")
    sub = mesh.subset(2)
    if sub is None:
        return None
    return replace(
        sub, groups={**sub.groups, "stage": sub.groups["data"]})


def collective_seconds(mesh: Mesh) -> float:
    """Host seconds the mesh's timed collectives took, summed over ops."""
    return sum(sec for _, sec in mesh.stats.values())


# -- process ranks (torchrun) -------------------------------------------------


def init_distributed(device: str | torch.device = "cuda"):
    """Join the process group that `torchrun` describes in the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK,
    LOCAL_WORLD_SIZE); JAX's `jax.distributed.initialize`. NCCL on CUDA,
    gloo on the CPU and where more local ranks than cards share one.
    Returns this rank's device; a process outside torchrun (no
    WORLD_SIZE) joins nothing and gets `device` as it is."""
    if "WORLD_SIZE" not in os.environ:
        return resolve_device(device)
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
        if local_world <= n_cards:
            backend = "nccl"
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, **kw)
    return dev


def world_mesh(device: str | torch.device, n_model: int = 1) -> Mesh:
    """This process's Mesh over the initialized process group
    (`init_distributed`), or `Mesh.single` without one. Every rank calls
    it: each axis group comes from `dist.new_group`, which all ranks enter
    in the same order."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh.single(dev)
    n, rank = dist.get_world_size(), dist.get_rank()
    if n % n_model:
        raise ValueError(f"n_model {n_model} does not divide world {n}")
    n_data = n // n_model
    backend = dist.get_backend()

    def new_group(ranks):
        g = dist.new_group(ranks)
        return g if rank in ranks else None

    world = dist.group.WORLD    # kept at one rank: its collectives run
    if n_model == 1:            # the data axis is the world
        return Mesh(n, 1, rank, dev, backend,
                    {"world": world, "data": world, "model": None},
                    new_group)
    groups = {"world": world}
    for axis, members in (
            ("data", [[d * n_model + m for d in range(n_data)]
                      for m in range(n_model)]),
            ("model", [[d * n_model + m for m in range(n_model)]
                       for d in range(n_data)])):
        for ranks in members:
            g = new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                groups[axis] = g
    return Mesh(n_data, n_model, rank, dev, backend, groups, new_group)


# -- thread ranks (tests; ranks sharing one card) ---------------------------


def _thread_mesh(store, rank: int, n_data: int, n_model: int = 1,
                device: str | torch.device = "cuda",
                timeout: float = 300.0) -> Mesh:
    """Rank `rank`'s Mesh over gloo groups that rendezvous in `store`
    (a dist.HashStore the ranks share). Each rank builds its own groups:
    the constructor waits until every member of a group has built it."""
    dev = resolve_device(device)
    td = timedelta(seconds=timeout)
    n = n_data * n_model

    def group(name, ranks):
        if rank not in ranks or len(ranks) == 1:
            return None
        return dist.ProcessGroupGloo(dist.PrefixStore(name, store),
                                     ranks.index(rank), len(ranks), td)

    d, m = rank // n_model, rank % n_model
    groups = {"world": group("world", list(range(n))),
              "data": group(f"data{m}", [i * n_model + m
                                         for i in range(n_data)]),
              "model": group(f"model{d}", [d * n_model + j
                                           for j in range(n_model)])}
    made = [0]

    def new_group(ranks):
        made[0] += 1   # every rank counts the same calls: one prefix a call
        return group(f"sub{made[0]}", list(ranks))

    return Mesh(n_data, n_model, rank, dev, "gloo", groups, new_group)


def thread_ranks(fn, n_data: int, n_model: int = 1,
                 device: str | torch.device = "cuda",
                 timeout: float = 300.0) -> list:
    """fn(mesh) on n_data x n_model ranks, each a thread of this process
    over gloo groups on one HashStore, every rank on `device` (the card
    unless the caller asks for the CPU); returns the ranks' results in rank
    order and raises the first rank's exception. A rank that waits longer
    than `timeout` seconds in a collective raises."""
    device = resolve_device(device)
    store = dist.HashStore()
    n = n_data * n_model
    results, errors = [None] * n, [None] * n

    def run(r):
        try:
            results[r] = fn(_thread_mesh(store, r, n_data, n_model, device,
                                        timeout))
        except Exception as e:    # re-raised in the caller's thread
            errors[r] = e

    threads = [threading.Thread(target=run, args=(r,), daemon=True,
                                name=f"rank{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 60.0)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"thread ranks still running after {timeout} s")
    for e in errors:
        if e is not None:
            raise e
    return results
