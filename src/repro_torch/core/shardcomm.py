"""Ranks of a ``torch.distributed`` process group as the port's device mesh.

``repro`` shards over a mesh of local devices from one process
(``jax.make_mesh`` + ``shard_map``, with ``jax.lax.all_to_all``,
``all_gather`` and ``psum`` inside the jitted program). PyTorch's idiom is
one process per rank: every rank runs the same host loop on its own slice
(SPMD) and the ranks meet in collectives. ``ShardGroup`` is the small
interface the sharded engines use:

  * ``all_to_all(x)``: ``x`` is ``[world, ...]``, row d goes to rank d;
    the result's row s is what rank s sent here (source-major receipt);
  * ``all_gather(x, tiled)``: every rank's ``x``, stacked ``[world,
    ...]``, or joined on dim 0 when ``tiled``;
  * ``any(flag)``: True on every rank when the flag is set on any rank
    (an int32 sum, the only reduction: a float sum of partial sums would
    not be bit-safe);
  * ``barrier()``.

Backends: NCCL where each rank has a GPU of its own, gloo on the CPU, and
gloo for several ranks that share one GPU (NCCL refuses two ranks on one
device). Gloo has no collective for CUDA tensors here, so a gloo group on
a CUDA device stages each collective through host tensors: a transport
only, the arithmetic stays on the card. Every collective counts one in
``ShardGroup.calls``.

``one_rank_group`` initializes a one-rank default group from a
``torch.distributed.HashStore`` (no TCP, no network); ``current_group``
is the group an entry point runs over: the one it is given, else the
initialized default group, else a one-rank group. ``spawn`` starts
``world`` ranks on this host (``torch.multiprocessing.spawn``, a
``FileStore`` in a temporary directory), runs ``fn(group, *args)`` on
each and returns rank 0's result; a rank's exception reaches the caller.
Its gloo ranks talk over the loopback interface (``GLOO_SOCKET_IFNAME``
defaults to ``lo`` there), so that no rank resolves the host's name.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from .types import resolve_device

_TIMEOUT = datetime.timedelta(seconds=600)


def _device(device) -> torch.device:
    """``device`` with its index (the current CUDA device's where none is
    given): NCCL and ``torch.cuda.set_device`` need one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _gather_fn():
    """``all_gather_single`` where the installed torch has it (newer
    releases deprecate ``all_gather_into_tensor`` for it), else
    ``all_gather_into_tensor``; the same call either way."""
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


class ShardGroup:
    """``rank`` of ``world`` ranks of the process group ``pg`` (None: the
    default group), running on ``device``."""

    def __init__(self, rank: int, world: int, device, pg=None,
                 backend: Optional[str] = None):
        self.rank, self.world = int(rank), int(world)
        self.device = _device(device)
        self.pg = pg
        self.backend = backend or dist.get_backend(pg)
        self.stage = (self.backend == "gloo"
                      and self.device.type == "cuda")
        self.calls = 0
        self._gather = _gather_fn()

    def __repr__(self):
        return (f"ShardGroup(rank={self.rank}, world={self.world}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")

    def _io(self, x: torch.Tensor):
        """(the tensor the collective reads, the device the result goes
        back to): host copies on a staged group; bool as uint8 (NCCL has
        no bool)."""
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return (x.cpu() if self.stage else x), x.device

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if int(x.shape[0]) != self.world:
            raise ValueError(f"all_to_all takes [world={self.world}, ...], "
                             f"got {tuple(x.shape)}")
        dtype = x.dtype
        src, dev = self._io(x)
        out = torch.empty_like(src)
        self.calls += 1
        dist.all_to_all_single(out, src, group=self.pg)
        return out.to(dev).to(dtype)

    def all_gather(self, x: torch.Tensor, tiled: bool = False,
                   async_op: bool = False):
        """Every rank's ``x`` as [world, ...] rows (``tiled``: the rows
        concatenated along dim 0). With ``async_op`` the gather is only
        issued, and the call returns a function that waits for it and
        gives the result."""
        dtype = x.dtype
        src, dev = self._io(x)
        out = src.new_empty((self.world * int(src.numel()),))
        self.calls += 1
        work = self._gather(out, src.reshape(-1), group=self.pg,
                            async_op=async_op)

        def wait() -> torch.Tensor:
            if work is not None:
                work.wait()
            rows = out.to(dev).to(dtype).reshape((self.world,)
                                                 + tuple(x.shape))
            if tiled:
                rows = rows.reshape((self.world * int(x.shape[0]),)
                                    + tuple(x.shape[1:]))
            return rows
        return wait if async_op else wait()

    def any(self, flag) -> bool:
        """The psum-agreed flag, read on the host (one read)."""
        t = torch.as_tensor(flag, device=self.device).to(torch.int32)
        t = t.reshape(1).cpu() if self.stage else t.reshape(1).clone()
        self.calls += 1
        dist.all_reduce(t, group=self.pg)
        return bool(int(t.item()) > 0)

    def barrier(self) -> None:
        self.calls += 1
        if self.backend == "nccl":
            dist.barrier(group=self.pg, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=self.pg)


def _backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def default_group(device) -> ShardGroup:
    """The initialized default group as a ``ShardGroup`` on ``device``."""
    return ShardGroup(dist.get_rank(), dist.get_world_size(), device)


def one_rank_group(device) -> ShardGroup:
    """A one-rank group on ``device`` (NCCL for a CUDA device, gloo for the
    CPU): the default group, initialized here from a ``HashStore`` when no
    group is (the default group otherwise)."""
    if not dist.is_initialized():
        dev = _device(device)
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group(_backend_for(dev), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=_TIMEOUT, **kw)
    return default_group(device)


def current_group(device, group: Optional[ShardGroup] = None) -> ShardGroup:
    """``group``, else the initialized default group, else a one-rank
    group."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return default_group(device)
    return one_rank_group(device)


def world_size(group: Optional[ShardGroup] = None) -> int:
    """Ranks of ``group``, else of the initialized default group, else 1
    (no group is created)."""
    if group is not None:
        return group.world
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank_main(rank, world, backend, device, store_path, result_path, fn,
               args):
    """One spawned rank: join the group, run ``fn``, rank 0 saves the
    result."""
    dev = _device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    if backend == "gloo":
        # ranks of one host: the loopback interface, no host-name lookup
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=_TIMEOUT)
    try:
        out = fn(ShardGroup(rank, world, dev), *args)
        if rank == 0:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), backend: Optional[str] = None,
          device="cuda"):
    """Run ``fn(group, *args)`` on ``world`` ranks spawned on this host (all
    on ``device``, the card unless the CPU is asked for; the backend
    defaults to gloo on the CPU and NCCL on CUDA) and return rank 0's
    result. ``fn`` must be importable by name (a module-level function);
    the ranks start from a fresh interpreter and import only what
    ``fn``'s module imports."""
    device = resolve_device(device)
    backend = backend or _backend_for(device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_shard_") as tmp:
        store_path = os.path.join(tmp, "store")
        result_path = os.path.join(tmp, "result.pt")
        torch.multiprocessing.spawn(
            _rank_main, args=(world, backend, str(device), store_path,
                              result_path, fn, tuple(args)),
            nprocs=world, join=True)
        return torch.load(result_path, weights_only=False)
