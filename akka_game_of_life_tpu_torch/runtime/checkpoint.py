"""Durable checkpoint/resume: a directory of epoch-stamped npz files.

Counterpart of the npz ``CheckpointStore`` of
``akka_game_of_life_tpu/runtime/checkpoint.py``, byte-compatible with it: the
same file names (``ckpt_<epoch:012d>.npz``), keys (``epoch``, ``shape``,
``packed``, ``board``, ``meta``) and layouts (1 = np.packbits of a binary
board, 0 = dense uint8, 2 = (H, W/32) uint32 LSB-first words, 3 = (m, H,
W/32) Generations/WireWorld bit planes), so each package resumes the other's
checkpoints.  Writes are atomic (tmp + fsync + rename);
the newest ``keep`` epochs are kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


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

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _write_epoch(self, epoch: int, payload: dict) -> Path:
        target = self.dir / f"ckpt_{epoch:012d}.npz"
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, target)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
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

    def _epochs(self):
        out = []
        for p in self.dir.iterdir():
            m = _CKPT_RE.match(p.name)
            if m:
                out.append((int(m.group(1)), p))
        return sorted(out)

    def _gc(self) -> None:
        epochs = self._epochs()
        for _, p in epochs[: max(0, len(epochs) - self.keep)]:
            p.unlink(missing_ok=True)

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1][0] if epochs else None

    def load(
        self, epoch: Optional[int] = None, *, keep_packed: bool = False
    ) -> Checkpoint:
        """Load the newest (or the given) epoch.  With ``keep_packed=True`` a
        packed checkpoint (layout 2 or 3) comes back as words or planes
        (``board=None``)."""
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
