"""Multi-process runs over ``torch.distributed``: one mesh across processes.

Counterpart of ``akka_game_of_life_tpu/parallel/distributed.py``, under its
names.  One process per card (or per host) joins a process group at a
coordinator's TCP address; the mesh's slots are then the devices of every
process, rank-major (rank 0's slots first, as ``jax.devices()`` orders a
pod), and each process holds and steps only its own slots' tiles.  A board
on such a mesh is a list with one entry per slot, ``None`` where another
process owns the slot.

Usage (one process per card or host, the same program on every one):

    from akka_game_of_life_tpu_torch.parallel import distributed
    distributed.initialize("host0:8476", num_processes=2, process_id=rank)
    mesh = make_grid_mesh(devices=["cuda:0"])    # spans every process
    tiles = distributed.make_global_array(board, mesh)
    out = sharded_sweep_step_fn(mesh, "conway", steps_per_call=60)(tiles)
    full = distributed.fetch(out, mesh)           # every rank, whole board

The arguments of :func:`initialize` fall back to ``GOL_COORDINATOR`` /
``GOL_NUM_PROCESSES`` / ``GOL_PROCESS_ID``, then to torchrun's
``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.

**Transport.**  Tiles on the CPU always travel over gloo.  CUDA tiles go
over NCCL when no two ranks share a card; NCCL refuses two ranks on one card
("Duplicate GPU detected"), so where ranks share a card their strips are
staged through pinned host buffers and sent over gloo ("staged").  The
ranks decide at :func:`initialize` from the facts they exchange (host name
and the UUID of every card each rank drives); there is no knob.  Staging is
only the transport: the tiles are stepped on their cards.  Every collective
carries the group's finite timeout, so a dead peer fails the run.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# A collective that waits longer than this raises (a dead or diverged peer).
TIMEOUT_S = 300.0

_log = logging.getLogger(__name__)


class _Runtime(NamedTuple):
    rank: int
    world: int
    transport: str  # "gloo" | "staged" | "nccl"


_runtime: Optional[_Runtime] = None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def _card_ids(local_device_ids: Optional[Sequence[int]]) -> List[int]:
    """The CUDA ordinals this process drives (default: every visible card;
    none without CUDA)."""
    if not torch.cuda.is_available():
        if local_device_ids:
            raise RuntimeError(
                f"local_device_ids={list(local_device_ids)} names cards, but "
                f"CUDA is not available"
            )
        return []
    if local_device_ids is None:
        return list(range(torch.cuda.device_count()))
    return [int(i) for i in local_device_ids]


def choose_transport(facts: Sequence[dict]) -> str:
    """``gloo`` when no rank drives a card, ``nccl`` when every rank drives
    cards and no card is driven by two ranks, else ``staged``."""
    cards = [(f["host"], u) for f in facts for u in f["cards"]]
    if not cards:
        return "gloo"
    if all(f["cards"] for f in facts) and len(set(cards)) == len(cards):
        return "nccl"
    return "staged"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Join the process group, idempotently.

    Returns True if this call did the set-up, False if the group was
    already up (safe to call from every entry point).  ``local_device_ids``
    are the CUDA ordinals this process drives (default: every visible
    card; ``[]`` for a CPU run); their UUIDs choose the transport."""
    global _runtime
    import torch.distributed as dist

    if _runtime is not None:
        return False
    coordinator_address = coordinator_address or os.environ.get("GOL_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("GOL_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("GOL_PROCESS_ID")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    missing = [
        name for name, value in (
            ("coordinator_address", coordinator_address),
            ("num_processes", num_processes),
            ("process_id", process_id),
        ) if value is None
    ]
    if missing:
        raise ValueError(
            f"distributed run needs {missing}: pass them (CLI: --coordinator "
            f"HOST:PORT --num-processes N --process-id R) or set "
            f"GOL_COORDINATOR / GOL_NUM_PROCESSES / GOL_PROCESS_ID"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id={process_id} out of range for num_processes={num_processes}"
        )
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"coordinator_address={coordinator_address!r} must be HOST:PORT"
        )
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(
        host, int(port), num_processes, is_master=process_id == 0,
        timeout=timeout,
    )
    ids = _card_ids(local_device_ids)
    cards = [str(torch.cuda.get_device_properties(i).uuid) for i in ids]
    store.set(
        f"gol/facts/{process_id}",
        json.dumps({"host": socket.gethostname(), "cards": cards}),
    )
    transport = choose_transport([
        json.loads(store.get(f"gol/facts/{r}").decode()) for r in range(num_processes)
    ])
    if transport == "nccl":
        torch.cuda.set_device(ids[0])
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if transport == "nccl" else "gloo",
        store=store,
        rank=process_id,
        world_size=num_processes,
        timeout=timeout,
    )
    _runtime = _Runtime(process_id, num_processes, transport)
    _log.info(
        "distributed: rank %d of %d via %s, transport %s",
        process_id, num_processes, coordinator_address, transport,
    )
    return True


def shutdown() -> None:
    global _runtime
    if _runtime is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        _runtime = None


def is_initialized() -> bool:
    return _runtime is not None


def process_info() -> Tuple[int, int]:
    """(rank, process count): (0, 1) when not distributed."""
    return (0, 1) if _runtime is None else (_runtime.rank, _runtime.world)


def transport() -> Optional[str]:
    """How tiles travel between processes (``gloo``, ``staged`` or
    ``nccl``); None when not distributed."""
    return None if _runtime is None else _runtime.transport


def describe() -> str:
    """One line for the run's log: rank, process count and transport."""
    if _runtime is None:
        return "single process"
    return (
        f"rank {_runtime.rank} of {_runtime.world} processes, "
        f"transport {_runtime.transport}"
    )


def all_gather_object(obj: Any) -> List[Any]:
    """``obj`` of every rank, in rank order (``[obj]`` when not
    distributed); a collective every rank must post."""
    if _runtime is None or _runtime.world == 1:
        return [obj]
    import torch.distributed as dist

    out: List[Any] = [None] * _runtime.world
    dist.all_gather_object(out, obj)
    return out


def barrier(tag: str = "gol") -> None:
    """Every rank waits here for every other (checkpoint durability,
    orderly shutdown).  ``tag`` names the point in errors."""
    if _runtime is None or _runtime.world == 1:
        return
    import torch.distributed as dist

    try:
        # A one-element all-reduce on the CPU backend: a barrier under the
        # group's timeout on gloo and on cpu:gloo,cuda:nccl alike.
        dist.all_reduce(torch.zeros(1))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed: {e}") from e


def make_global_array(board, mesh) -> List[Optional[torch.Tensor]]:
    """This process's tiles of a host board that every rank passes whole
    (deterministic start boards and shared checkpoints make that free):
    one entry per mesh slot, ``None`` where another rank owns the slot.  On
    a single-process mesh this is ``shard_board``."""
    from akka_game_of_life_tpu_torch.parallel.mesh import shard_board

    return shard_board(board, mesh)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def fetch(tiles, mesh, dst: Optional[int] = None) -> Optional[np.ndarray]:
    """The whole board on the host: on every rank (all-gather), or on rank
    ``dst`` only (the others return None).  int32 words come back as uint32
    words of the same bits.  Tiles travel through host memory over the
    group's CPU backend, one broadcast (or send) per slot, whatever the
    transport of the halo strips."""
    from akka_game_of_life_tpu_torch.parallel.mesh import assemble

    if len(tiles) != mesh.size:
        raise ValueError(f"{len(tiles)} tiles for a mesh of {mesh.size} slots")
    rank, world = process_info()
    if world == 1 or all(t is not None for t in tiles):
        return assemble([_host(t) for t in tiles], mesh)
    import torch.distributed as dist

    local = next(t for t in tiles if t is not None)
    host: List[Optional[torch.Tensor]] = []
    for i, t in enumerate(tiles):
        owner = mesh.owner(i)
        if dst is None:
            buf = _host(t) if owner == rank else torch.empty(
                local.shape, dtype=local.dtype
            )
            dist.broadcast(buf, src=owner)
            host.append(buf)
        elif owner == rank:
            buf = _host(t)
            if owner != dst:
                dist.send(buf, dst=dst)
            host.append(buf)
        elif rank == dst:
            buf = torch.empty(local.shape, dtype=local.dtype)
            dist.recv(buf, src=owner)
            host.append(buf)
        else:
            host.append(None)
    if dst is not None and rank != dst:
        return None
    return assemble(host, mesh)


# -- halo strips between processes -----------------------------------------


def _staged(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and _runtime.transport != "nccl"


def _send_buffer(part: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a (possibly strided) strip, in pinned host
    memory when it is staged: the copy from the card completes before the
    send is posted."""
    if _staged(part):
        buf = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
        buf.copy_(part)
        return buf
    return part.contiguous()


def _recv_buffer(like: torch.Tensor) -> torch.Tensor:
    if _staged(like):
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def exchange(sends, recvs) -> List[torch.Tensor]:
    """One batch of point-to-point strips: ``sends`` are (peer rank, tag,
    strip) and ``recvs`` (peer rank, tag, like) with ``like`` a tensor of
    the incoming strip's shape, dtype and device.  All are posted in one
    ``batch_isend_irecv``, in the order given (both ends list a pair's
    strips in the same order, so NCCL, which ignores tags, matches them
    too), and waited for.  Returns the received strips on ``like``'s
    device, in ``recvs`` order."""
    import torch.distributed as dist

    ops = []
    bufs = []
    for peer, tag, like in recvs:
        buf = _recv_buffer(like)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
    keep = []
    for peer, tag, part in sends:
        buf = _send_buffer(part)
        keep.append(buf)
        ops.append(dist.P2POp(dist.isend, buf, peer, tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [
        buf.to(like.device) if buf.device != like.device else buf
        for buf, (_, _, like) in zip(bufs, recvs)
    ]
