"""The async per-shard checkpoint store (``checkpoint_format = "orbax"``).

Counterpart of ``akka_game_of_life_tpu/runtime/orbax_store.py``, with its
API and contract, on ``torch.distributed.checkpoint`` (DCP) where the JAX
package uses Orbax:

- :meth:`OrbaxCheckpointStore.save` dispatches an async save and returns:
  DCP stages the tensors to host memory before it returns, so the board
  may step on at once, and writes them on a thread of its own.  Each rank
  of a multi-process run writes only its own tiles, keyed by mesh slot
  (``tile_<r>_<c>``), with no gather; the mesh shape, board shape and
  layout go into the step's ``meta.json``.  The timed span is the
  dispatch, as in the JAX store.
- :meth:`load` restores to host numpy whatever the topology: the keys'
  shapes come from the step's metadata, not from the loader's mesh, so a
  two-rank (2, 2) save loads in one process with no mesh and the reverse.
  Binary ``packed32`` words and Generations planes round-trip.
- Finalisation is atomic: a step is written under ``<epoch>.dcp-tmp`` and
  renamed to ``<epoch>`` by rank 0 once every rank's shards and DCP's
  metadata are on disk, and every rank then meets at a barrier in
  :meth:`wait`.  A directory without ``meta.json`` is not an epoch.  The
  newest ``keep`` epochs are kept.

A step directory holds ``state/`` (DCP's ``.metadata`` and ``*.distcp``
shards) and ``meta.json`` (``"format": "torch-dcp"``).  The ``state`` name
is one of the markers by which the JAX package's ``make_store`` recognises
an orbax directory, so it refuses to start an npz store on one of these as
it refuses any foreign format.  The port cannot read Orbax and the JAX
package cannot read DCP: these directories resume only in the package that
wrote them (``runtime/checkpoint.py`` refuses a JAX orbax directory by
name).

Without a process group (a single-process run) DCP's async save runs as a
single-process save on its own thread (``no_dist``); with one, the saves
and the finalising barrier use a gloo group of their own, created on every
rank with the store, so the save thread's collectives never interleave with
the run's halo exchanges and observations on the default group.
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import shutil
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from akka_game_of_life_tpu_torch.runtime.checkpoint import Checkpoint, _StoreMetrics

# A single-process store saves and loads with no_dist on purpose.
warnings.filterwarnings(
    "ignore", message="torch.distributed is disabled, unavailable or uninitialized"
)

FORMAT = "torch-dcp"
META = "meta.json"
STATE = "state"
TMP_SUFFIX = ".dcp-tmp"
_STEP_RE = re.compile(r"^(\d+)$")
_TMP_RE = re.compile(r"^(\d+)" + re.escape(TMP_SUFFIX) + "$")


def is_step_dir(p: Path) -> bool:
    """A finalised step of this store: ``<epoch>/meta.json`` naming the
    format."""
    if not (p.is_dir() and _STEP_RE.match(p.name) and (p / META).is_file()):
        return False
    try:
        return json.loads((p / META).read_text()).get("format") == FORMAT
    except (OSError, ValueError):
        return False


def is_tmp_dir(p: Path) -> bool:
    return p.is_dir() and _TMP_RE.match(p.name) is not None


def _key(r: int, c: int) -> str:
    return f"tile_{r}_{c}"


class OrbaxCheckpointStore:
    """Epoch-stamped async per-shard checkpoints on DCP.

    API-compatible with :class:`~.checkpoint.CheckpointStore`; ``save``
    also takes a sharded board (one tile per mesh slot, ``None`` where
    another rank owns the slot) with its ``mesh``."""

    def __init__(
        self, directory: str, keep: int = 3, registry=None, tracer=None
    ) -> None:
        # DCP's first import takes about a second: here, not in the first
        # save's timed dispatch.
        import torch.distributed.checkpoint  # noqa: F401

        from akka_game_of_life_tpu_torch.parallel import distributed

        self.metrics = _StoreMetrics(registry, tracer=tracer)
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.rank, self.world = distributed.process_info()
        self._group = None
        if self.world > 1:
            import torch.distributed as dist

            # Every rank builds the store at the same point of the run.
            self._group = dist.new_group(backend="gloo")
        self._finisher = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dcp-finish"
        )
        self._pending: Optional[concurrent.futures.Future] = None

    # -- saves ---------------------------------------------------------------

    def save(
        self, epoch: int, board, rule: str, meta: Optional[dict] = None, *, mesh=None
    ) -> Path:
        """Dispatch an async save of ``board`` at ``epoch`` and return its
        step directory.  ``board`` is a host array or a tensor (the whole
        board), or, with ``mesh``, one tile per slot (this rank's; ``None``
        elsewhere).  ``meta["layout"] == "packed32"`` marks uint32 words
        (binary) or (m, H, W/32) planes; otherwise the board is dense
        uint8.  The previous save is made durable first, so at most one is
        in flight."""
        import torch
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint import FileSystemWriter

        self.wait()
        epoch = int(epoch)
        meta = dict(meta or {})
        if mesh is None:
            tiles, shape, owned = [board], (1, 1), [0]
        else:
            tiles, shape = list(board), mesh.shape
            owned = [i for i, t in enumerate(tiles) if t is not None]
        cols = shape[1]
        state: Dict[str, torch.Tensor] = {}
        for i in owned:
            t = tiles[i]
            if not isinstance(t, torch.Tensor):
                arr = np.ascontiguousarray(t)
                if arr.dtype == np.uint32:
                    arr = arr.view(np.int32)
                t = torch.from_numpy(arr)
            state[_key(*divmod(i, cols))] = t.detach()
        # The cell board's (H, W), from a tile and the mesh.
        tile = state[next(iter(state))].shape
        lanes = 32 if meta.get("layout") == "packed32" else 1
        cells = [tile[-2] * shape[0], tile[-1] * shape[1] * lanes]
        doc = {
            "format": FORMAT, "rule": rule, "mesh": list(shape), "shape": cells,
            **meta,
        }
        tmp = self.dir / f"{epoch}{TMP_SUFFIX}"
        if self.rank == 0:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
        if self._group is not None:
            from akka_game_of_life_tpu_torch.parallel import distributed

            distributed.barrier(f"dcp-mkdir-{epoch}")
        with self.metrics.timed_save():
            future = dcp.async_save(
                state,
                storage_writer=FileSystemWriter(str(tmp / STATE)),
                process_group=self._group,
                no_dist=self._group is None,
            )
        self._pending = self._finisher.submit(self._finish, future, epoch, tmp, doc)
        return self.dir / str(epoch)

    def _finish(self, future, epoch: int, tmp: Path, doc: dict) -> None:
        """On the finishing thread: once this rank's shards (and, on rank
        0, DCP's metadata) are written, rank 0 seals the step and trims the
        store."""
        future.result()
        if self.rank != 0:
            return
        (tmp / META).write_text(json.dumps(doc))
        final = self.dir / str(epoch)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self) -> None:
        steps = self._steps()
        for e in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / str(e), ignore_errors=True)
        newest = steps[-1] if steps else None
        for p in self.dir.iterdir():
            m = _TMP_RE.match(p.name)
            if m and newest is not None and int(m.group(1)) < newest:
                shutil.rmtree(p, ignore_errors=True)

    def wait(self) -> None:
        """Block until the pending save is durable on every rank; raises
        its error here."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        pending.result()
        if self._group is not None:
            from akka_game_of_life_tpu_torch.parallel import distributed

            # No rank reads the store before rank 0 has sealed the step.
            distributed.barrier("dcp-sealed")

    # -- reads ---------------------------------------------------------------

    def _steps(self):
        return sorted(
            int(p.name) for p in self.dir.iterdir() if is_step_dir(p)
        )

    def latest_epoch(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def epochs(self):
        """Every durable epoch, sorted."""
        self.wait()
        return self._steps()

    def step_meta(self, epoch: int) -> dict:
        return json.loads((self.dir / str(int(epoch)) / META).read_text())

    def load(
        self, epoch: Optional[int] = None, *, keep_packed: bool = False
    ) -> Checkpoint:
        with self.metrics.timed_restore():
            return self._load(epoch, keep_packed=keep_packed)

    def _load(self, epoch: Optional[int], *, keep_packed: bool) -> Checkpoint:
        import torch
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint import FileSystemReader

        steps = self.epochs()
        if epoch is None:
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            epoch = steps[-1]
        elif int(epoch) not in steps:
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} in {self.dir}")
        epoch = int(epoch)
        meta = self.step_meta(epoch)
        reader = FileSystemReader(str(self.dir / str(epoch) / STATE))
        saved = reader.read_metadata().state_dict_metadata
        rows, cols = meta.pop("mesh")
        meta.pop("shape", None)
        state = {}
        for r in range(rows):
            for c in range(cols):
                md = saved[_key(r, c)]
                state[_key(r, c)] = torch.empty(tuple(md.size), dtype=md.properties.dtype)
        # Every process reads every shard: no process group is needed.
        dcp.load(state, storage_reader=reader, no_dist=True)
        bands = [
            torch.cat([state[_key(r, c)] for c in range(cols)], dim=-1)
            for r in range(rows)
        ]
        raw = torch.cat(bands, dim=-2).contiguous().numpy()
        meta.pop("format", None)
        rule = meta.pop("rule")
        if meta.get("layout") == "packed32":
            words = raw.view(np.uint32) if raw.dtype == np.int32 else raw.astype(np.uint32)
            if keep_packed:
                return Checkpoint(
                    epoch=epoch, board=None, rule=rule, meta=meta, packed32=words
                )
            if words.ndim == 3:
                from akka_game_of_life_tpu_torch.ops.bitpack_gen import unpack_gen_np

                board = unpack_gen_np(words)
            else:
                from akka_game_of_life_tpu_torch.ops.bitpack import unpack_np

                board = unpack_np(words)
            return Checkpoint(epoch=epoch, board=board, rule=rule, meta=meta)
        return Checkpoint(
            epoch=epoch, board=raw.astype(np.uint8, copy=False), rule=rule, meta=meta
        )

    def step_bytes(self, epoch: int) -> int:
        d = self.dir / str(int(epoch))
        return sum(p.stat().st_size for p in d.rglob("*") if p.is_file())

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._finisher.shutdown(wait=True)

