"""Durable checkpoint/resume: a directory of epoch-stamped npz files.

Counterpart of the npz ``CheckpointStore`` of
``akka_game_of_life_tpu/runtime/checkpoint.py``, byte-compatible with it: the
same file names (``ckpt_<epoch:012d>.npz``), keys (``epoch``, ``shape``,
``packed``, ``board``, ``meta``) and layouts (1 = np.packbits of a binary
board, 0 = dense uint8, 2 = (H, W/32) uint32 LSB-first words, 3 = (m, H,
W/32) Generations/WireWorld bit planes), so each package resumes the other's
checkpoints.  The cluster frontend streams per-tile epochs instead:
``ckpt_<epoch:012d>.d/tile_<r>_<c>.npz`` wire payloads plus a
``COMPLETE.json`` marker that makes the epoch durable, the same layout as the
JAX package's, so a cluster checkpoint directory written by either package
resumes in the other's frontend.  Writes are atomic (tmp + fsync + rename);
the newest ``keep`` epochs are kept.

``make_store(dir, "orbax")`` gives the async per-shard store of
``runtime/orbax_store.py`` (on ``torch.distributed.checkpoint``; the JAX
package's is on Orbax).  The two formats are per package: a directory
written by the JAX package's orbax store is refused by name, and a
directory of either format refuses a store of the other, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")
_TILE_DIR_RE = re.compile(r"^ckpt_(\d+)\.d$")
_COMPLETE = "COMPLETE.json"


# The markers of a step directory of the JAX package's orbax store (its
# ``_existing_format``), and of an async save it left unfinished.
_JAX_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "state", "meta")
_JAX_ORBAX_TMP = ".orbax-checkpoint-tmp"
JAX_ORBAX = "jax-orbax"


def _existing_format(directory: str) -> Optional[str]:
    """Which store already owns ``directory``: ``npz``, ``orbax`` (this
    package's DCP store, finalised or mid-save), ``jax-orbax`` (the JAX
    package's orbax store) or None."""
    from akka_game_of_life_tpu_torch.runtime import orbax_store

    d = Path(directory)
    if not d.is_dir():
        return None
    for p in d.iterdir():
        if _CKPT_RE.match(p.name) or (p.is_dir() and _TILE_DIR_RE.match(p.name)):
            return "npz"
        if orbax_store.is_step_dir(p) or orbax_store.is_tmp_dir(p):
            return "orbax"
        if p.is_dir() and _JAX_ORBAX_TMP in p.name:
            return JAX_ORBAX
        # A numeric directory alone is not enough (an unrelated output dir
        # may hold some): it must carry the orbax markers.
        if p.is_dir() and p.name.isdigit() and any(
            (p / marker).exists() for marker in _JAX_ORBAX_MARKERS
        ):
            return JAX_ORBAX
    return None


def make_store(
    directory: str, fmt: str = "npz", keep: int = 3, registry=None, tracer=None
):
    """Checkpoint store factory: ``npz`` (host, packed, one writer) or
    ``orbax`` (async, per shard, on DCP).

    Refuses a directory already holding the other format's checkpoints, as
    the JAX package does, and one written by the JAX package's orbax store,
    which only that package reads."""
    if fmt not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint format {fmt!r}; use npz or orbax")
    existing = _existing_format(directory)
    if existing == JAX_ORBAX:
        raise ValueError(
            f"checkpoint dir {directory} was written by the JAX package's "
            f"orbax store; resume it there"
        )
    if existing is not None and existing != fmt:
        raise ValueError(
            f"checkpoint dir {directory} already holds {existing}-format "
            f"checkpoints; refusing to start a {fmt}-format store there"
        )
    if fmt == "npz":
        return CheckpointStore(directory, keep=keep, registry=registry, tracer=tracer)
    from akka_game_of_life_tpu_torch.runtime.orbax_store import OrbaxCheckpointStore

    return OrbaxCheckpointStore(directory, keep=keep, registry=registry, tracer=tracer)


class _StoreMetrics:
    """Save/restore counters, latency histograms and spans (the JAX
    package's instruments, by name)."""

    def __init__(self, registry=None, tracer=None) -> None:
        if registry is None:
            from akka_game_of_life_tpu_torch.obs import get_registry

            registry = get_registry()
        self.tracer = tracer
        self.saves = registry.counter("gol_checkpoint_saves_total")
        self.restores = registry.counter("gol_checkpoint_restores_total")
        seconds = registry.histogram("gol_checkpoint_seconds", labelnames=("op",))
        self.save_seconds = seconds.labels(op="save")
        self.restore_seconds = seconds.labels(op="restore")

    @contextlib.contextmanager
    def _timed(self, name: str, seconds, counter):
        if self.tracer is None:
            from akka_game_of_life_tpu_torch.obs.tracing import get_tracer

            self.tracer = get_tracer()
        with self.tracer.span(name):
            t0 = time.perf_counter()
            yield
            seconds.observe(time.perf_counter() - t0)
            counter.inc()

    def timed_save(self):
        return self._timed("checkpoint.save", self.save_seconds, self.saves)

    def timed_restore(self):
        return self._timed(
            "checkpoint.restore", self.restore_seconds, self.restores
        )


@dataclasses.dataclass
class Checkpoint:
    epoch: int
    board: Optional[np.ndarray]  # None only when loaded with keep_packed=True
    rule: str
    meta: dict
    # (H, W/32) uint32 words, or (m, H, W/32) planes, of a packed checkpoint
    # loaded with keep_packed.
    packed32: Optional[np.ndarray] = None


class CheckpointStore:
    """A directory of epoch-stamped checkpoints with atomic writes."""

    def __init__(
        self, directory: str, keep: int = 3, registry=None, tracer=None
    ) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.metrics = _StoreMetrics(registry, tracer)

    @staticmethod
    def _atomic_write(directory: Path, target: Path, write, mode: str = "wb") -> None:
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, mode) as f:
                write(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, target)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _write_epoch(self, epoch: int, payload: dict) -> Path:
        target = self.dir / f"ckpt_{epoch:012d}.npz"
        with self.metrics.timed_save():
            self._atomic_write(
                self.dir, target, lambda f: np.savez_compressed(f, **payload)
            )
        self._gc()
        return target

    @staticmethod
    def _meta_blob(rule: str, meta: Optional[dict]) -> np.ndarray:
        return np.frombuffer(
            json.dumps({"rule": rule, **(meta or {})}).encode(), dtype=np.uint8
        )

    def save(
        self, epoch: int, board: np.ndarray, rule: str, meta: Optional[dict] = None
    ) -> Path:
        """Save a dense uint8 board (np.packbits-packed when binary)."""
        board = np.asarray(board, dtype=np.uint8)
        binary = bool((board <= 1).all())
        return self._write_epoch(
            epoch,
            {
                "epoch": np.int64(epoch),
                "shape": np.asarray(board.shape, dtype=np.int64),
                "packed": np.uint8(1 if binary else 0),
                "board": np.packbits(board) if binary else board,
                "meta": self._meta_blob(rule, meta),
            },
        )

    def save_packed32(
        self,
        epoch: int,
        words: np.ndarray,
        shape: Tuple[int, int],
        rule: str,
        meta: Optional[dict] = None,
    ) -> Path:
        """Save a packed board as it left the device, never unpacked:
        (H, W/32) uint32 LSB-first words of a binary rule (layout 2,
        0.25 B/cell) or (m, H, W/32) bit planes of a Generations/WireWorld
        rule (layout 3, LSB plane first, m derived from the rule)."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        h, w = shape
        if words.ndim == 2:
            expect, fmt = (h, w // 32), 2
        else:
            from akka_game_of_life_tpu_torch.ops.bitpack_gen import n_planes
            from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

            expect, fmt = (n_planes(resolve_rule(rule).states), h, w // 32), 3
        if words.shape != expect:
            raise ValueError(f"packed words {words.shape} != {expect}")
        return self._write_epoch(
            epoch,
            {
                "epoch": np.int64(epoch),
                "shape": np.asarray(shape, dtype=np.int64),
                "packed": np.uint8(fmt),
                "board": words,
                "meta": self._meta_blob(rule, meta),
            },
        )

    # -- per-tile streaming saves (the cluster frontend's) -------------------

    def _tile_dir(self, epoch: int) -> Path:
        return self.dir / f"ckpt_{epoch:012d}.d"

    def _tile_path(self, epoch: int, tile) -> Path:
        return self._tile_dir(epoch) / f"tile_{int(tile[0])}_{int(tile[1])}.npz"

    def save_tile(self, epoch: int, tile, arr) -> Path:
        """Stream one tile of ``epoch`` to disk atomically: ``arr`` is a
        uint8 tile or its wire payload (``wire.pack_tile``), stored as is.
        The epoch becomes durable only at :meth:`finalize_epoch`."""
        from akka_game_of_life_tpu_torch.runtime.wire import pack_tile

        d = self._tile_dir(epoch)
        d.mkdir(parents=True, exist_ok=True)
        payload = arr if isinstance(arr, dict) else pack_tile(
            np.asarray(arr, dtype=np.uint8)
        )
        target = self._tile_path(epoch, tile)
        self._atomic_write(
            d,
            target,
            lambda f: np.savez_compressed(
                f,
                enc=np.frombuffer(payload["enc"].encode(), dtype=np.uint8),
                shape=np.asarray(payload["shape"], dtype=np.int64),
                data=payload["data"],
            ),
        )
        return target

    def finalize_epoch(
        self, epoch: int, rule: str, grid, board_shape, meta: Optional[dict] = None
    ) -> None:
        """Mark a per-tile epoch durable once every tile has been saved."""
        doc = json.dumps(
            {
                "epoch": epoch,
                "rule": rule,
                "grid": list(grid),
                "shape": list(board_shape),
                **(meta or {}),
            }
        )
        d = self._tile_dir(epoch)
        with self.metrics.timed_save():
            self._atomic_write(d, d / _COMPLETE, lambda f: f.write(doc), mode="w")
        self._gc()

    def tile_meta(self, epoch: int) -> dict:
        return json.loads((self._tile_dir(epoch) / _COMPLETE).read_text())

    def load_tile_payload(self, epoch: int, tile) -> dict:
        """The tile's wire payload exactly as stored."""
        with np.load(self._tile_path(epoch, tile)) as z:
            return {
                "enc": bytes(z["enc"].tobytes()).decode(),
                "shape": [int(v) for v in z["shape"]],
                "data": z["data"].copy(),
            }

    def load_tile(self, epoch: int, tile) -> np.ndarray:
        from akka_game_of_life_tpu_torch.runtime.wire import unpack_tile

        return unpack_tile(self.load_tile_payload(epoch, tile))

    def tile_digest(self, epoch: int) -> int:
        """A per-tile epoch's merged 64-bit digest, one tile in memory at a
        time; a tile whose shape disagrees with the layout raises."""
        from akka_game_of_life_tpu_torch.ops import digest as odigest

        meta = self.tile_meta(epoch)
        rows, cols = meta["grid"]
        h, w = (int(v) for v in meta["shape"])
        th, tw = h // rows, w // cols

        def tile_lanes(i: int, j: int) -> np.ndarray:
            tile = self.load_tile(epoch, (i, j))
            if tile.shape != (th, tw):
                raise ValueError(
                    f"tile ({i}, {j}) of epoch {epoch} has shape "
                    f"{tile.shape}, layout expects {(th, tw)}"
                )
            return odigest.digest_dense_np(tile, (i * th, j * tw), w)

        return odigest.value(
            odigest.merge_lanes(
                tile_lanes(i, j) for i in range(rows) for j in range(cols)
            )
        )

    def _epochs(self):
        """(epoch, path) of every durable checkpoint: full-board files and
        COMPLETE-marked tile directories."""
        out = []
        for p in self.dir.iterdir():
            m = _CKPT_RE.match(p.name)
            if m:
                out.append((int(m.group(1)), p))
                continue
            m = _TILE_DIR_RE.match(p.name)
            if m and p.is_dir() and (p / _COMPLETE).exists():
                out.append((int(m.group(1)), p))
        return sorted(out)

    def _gc(self) -> None:
        epochs = self._epochs()
        for _, p in epochs[: max(0, len(epochs) - self.keep)]:
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)
        # Unfinalized tile directories older than the newest durable epoch
        # are failed partial saves.
        if epochs:
            newest = epochs[-1][0]
            for p in self.dir.iterdir():
                m = _TILE_DIR_RE.match(p.name)
                if (
                    m
                    and p.is_dir()
                    and not (p / _COMPLETE).exists()
                    and int(m.group(1)) < newest
                ):
                    shutil.rmtree(p, ignore_errors=True)

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1][0] if epochs else None

    def load(
        self, epoch: Optional[int] = None, *, keep_packed: bool = False
    ) -> Checkpoint:
        """Load the newest (or the given) epoch.  With ``keep_packed=True`` a
        packed checkpoint (layout 2 or 3) comes back as words or planes
        (``board=None``); a per-tile epoch is stitched into a dense board."""
        with self.metrics.timed_restore():
            return self._load(epoch, keep_packed=keep_packed)

    def _load(self, epoch: Optional[int], *, keep_packed: bool) -> Checkpoint:
        epochs = self._epochs()
        if not epochs:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        if epoch is None:
            epoch, path = epochs[-1]
        else:
            matches = [p for e, p in epochs if e == epoch]
            if not matches:
                raise FileNotFoundError(
                    f"no checkpoint for epoch {epoch} in {self.dir}"
                )
            path = matches[0]
        if path.is_dir():
            meta = self.tile_meta(epoch)
            rows, cols = meta.pop("grid")
            shape = tuple(int(v) for v in meta.pop("shape"))
            meta.pop("epoch", None)
            th, tw = shape[0] // rows, shape[1] // cols
            board = np.empty(shape, dtype=np.uint8)
            for i in range(rows):
                for j in range(cols):
                    board[i * th : (i + 1) * th, j * tw : (j + 1) * tw] = (
                        self.load_tile(epoch, (i, j))
                    )
            rule = meta.pop("rule")
            return Checkpoint(epoch=int(epoch), board=board, rule=rule, meta=meta)
        with np.load(path) as z:
            shape = tuple(int(v) for v in z["shape"])
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            fmt = int(z["packed"])
            rule = meta.pop("rule")
            if fmt in (2, 3):
                words = z["board"].copy()
                if keep_packed:
                    return Checkpoint(
                        epoch=int(epoch), board=None, rule=rule, meta=meta,
                        packed32=words,
                    )
                from akka_game_of_life_tpu_torch.ops.bitpack import unpack_np
                from akka_game_of_life_tpu_torch.ops.bitpack_gen import unpack_gen_np

                unpack = unpack_np if fmt == 2 else unpack_gen_np
                board = unpack(words).reshape(shape)
            elif fmt == 1:
                n = int(np.prod(shape))
                board = np.unpackbits(z["board"], count=n).reshape(shape)
            elif fmt == 0:
                board = z["board"].reshape(shape)
            else:
                raise ValueError(f"unknown checkpoint layout {fmt}")
        return Checkpoint(
            epoch=int(epoch), board=board.astype(np.uint8), rule=rule, meta=meta
        )

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for (the orbax store's
        API)."""

    def close(self) -> None:
        """Saves are synchronous; nothing is held open."""


_LAYOUTS = {0: "dense-uint8", 1: "packbits", 2: "packed32", 3: "gen-planes"}


def describe_store(directory: str, validate: bool = False):
    """Inspect a checkpoint directory without a Simulation (the
    ``checkpoints`` subcommand).

    Yields one dict per durable epoch — epoch, store, layout, rule, shape,
    bytes on disk (tile epochs add grid and tile counts), and the recorded
    digest.  With ``validate=True`` each epoch is also loaded in full and
    ``ok``/``error`` reported; a recorded digest is re-derived from the
    payload on disk (``digest_ok``).  The JAX package's lines, for an npz
    directory either package wrote and for this package's orbax-format
    store (``layout`` "device-native", as the JAX package names its own);
    a directory of the JAX package's orbax store yields nothing.
    """
    from akka_game_of_life_tpu_torch.ops import digest as odigest

    fmt = _existing_format(directory)
    if fmt == "orbax":
        yield from _describe_orbax(directory, validate)
        return
    if fmt != "npz":
        return
    store = CheckpointStore(directory)
    for epoch, path in store._epochs():
        info = {"epoch": epoch, "store": "npz"}
        try:
            if path.is_dir():
                meta = store.tile_meta(epoch)
                tiles = sorted(path.glob("tile_*.npz"))
                info.update(
                    layout="tiles",
                    rule=meta.get("rule"),
                    shape=meta.get("shape"),
                    grid=meta.get("grid"),
                    tiles=len(tiles),
                    bytes=sum(t.stat().st_size for t in tiles),
                )
            else:
                with np.load(path) as z:
                    meta = json.loads(bytes(z["meta"].tobytes()).decode())
                    code = int(z["packed"])
                    info.update(
                        layout=_LAYOUTS.get(code, f"format-{code}"),
                        rule=meta.get("rule"),
                        shape=[int(v) for v in z["shape"]],
                        bytes=path.stat().st_size,
                    )
            if meta.get("digest"):
                info["digest"] = meta["digest"]
        except Exception as e:  # noqa: BLE001 — unreadable metadata is a finding
            info.update(error=f"{type(e).__name__}: {e}")
            if validate:
                info["ok"] = False
            yield info
            continue
        if validate:
            try:
                recorded = info.get("digest")
                computed = None
                if path.is_dir():
                    # Tile by tile, with each tile's global origin: the
                    # board is never assembled.
                    computed = odigest.format_digest(store.tile_digest(epoch))
                    info["ok"] = True
                else:
                    ck = store.load(epoch, keep_packed=True)
                    if ck.packed32 is not None:
                        shape = info.get("shape")
                        h, words = ck.packed32.shape[-2], ck.packed32.shape[-1]
                        info["ok"] = shape is None or list(shape) == [h, words * 32]
                    else:
                        info["ok"] = ck.board is not None and list(
                            ck.board.shape
                        ) == list(info.get("shape") or ck.board.shape)
                    if recorded is not None and info["ok"]:
                        if ck.packed32 is not None:
                            w = int(info["shape"][1])
                            lanes = (
                                odigest.digest_packed_np(ck.packed32, w)
                                if ck.packed32.ndim == 2
                                else odigest.digest_planes_np(ck.packed32, w)
                            )
                        else:
                            lanes = odigest.digest_dense_np(ck.board)
                        computed = odigest.format_digest(odigest.value(lanes))
                if recorded is not None and computed is not None:
                    info["digest_ok"] = computed == recorded
                    if not info["digest_ok"]:
                        info["ok"] = False
                        info["error"] = (
                            f"digest mismatch: stored {recorded}, "
                            f"computed {computed}"
                        )
            except Exception as e:  # noqa: BLE001 — reported per epoch
                info.update(ok=False, error=f"{type(e).__name__}: {e}")
        yield info


def _describe_orbax(directory: str, validate: bool):
    """describe_store's lines for this package's orbax-format store: epoch,
    store, layout, rule, shape and bytes from each step's metadata, without
    a restore; under ``validate`` each step is restored in full and its
    recorded digest re-derived."""
    from akka_game_of_life_tpu_torch.ops import digest as odigest
    from akka_game_of_life_tpu_torch.runtime.orbax_store import OrbaxCheckpointStore

    store = OrbaxCheckpointStore(directory)
    try:
        for epoch in store.epochs():
            info = {"epoch": epoch, "store": "orbax", "layout": "device-native"}
            try:
                meta = store.step_meta(epoch)
                info.update(
                    rule=meta.get("rule"),
                    shape=meta["shape"],
                    bytes=store.step_bytes(epoch),
                )
                if meta.get("digest"):
                    info["digest"] = meta["digest"]
            except Exception as e:  # noqa: BLE001 — unreadable metadata is a finding
                info.update(error=f"{type(e).__name__}: {e}")
                if validate:
                    info["ok"] = False
                yield info
                continue
            if validate:
                try:
                    ck = store.load(epoch)
                    info["ok"] = list(ck.board.shape) == info["shape"]
                    recorded = info.get("digest")
                    if recorded is not None and info["ok"]:
                        computed = odigest.format_digest(
                            odigest.value(odigest.digest_dense_np(ck.board))
                        )
                        info["digest_ok"] = computed == recorded
                        if not info["digest_ok"]:
                            info["ok"] = False
                            info["error"] = (
                                f"digest mismatch: stored {recorded}, "
                                f"computed {computed}"
                            )
                except Exception as e:  # noqa: BLE001 — reported per epoch
                    info.update(ok=False, error=f"{type(e).__name__}: {e}")
            yield info
    finally:
        store.close()
