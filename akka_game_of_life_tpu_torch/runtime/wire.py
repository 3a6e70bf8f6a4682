"""Wire format for the control plane: binary-framed JSON + raw array blobs.

The reference rides Akka remoting's Netty TCP transport with Java
serialization (``application.conf:11-17``; SURVEY.md §2 "Distributed
communication backend").  This channel keeps the control metadata as JSON
(boringly debuggable) but ships numpy arrays as *raw bytes* beside it —
no base64 (+33% size), no JSON string escaping, no text scanning on the hot
path, which matters once tiles at 65536²-class sizes ride the wire
(boundary rings, packed checkpoint tiles, sampled frames).

Frame layout (little-endian):

    u8   magic 0x47 ('G')
    u32  json section length
    u16  blob count
    u64  × blob-count blob lengths
    ...  json bytes, then each blob's bytes in order

Arrays appear in the JSON as ``{"__blob__": i, "dtype": "|u1", "shape":
[...]}`` placeholders; dtypes are preserved (uint8 boards, uint32 packed
words, int64 counters) instead of being forced to uint8.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, List, Optional

import numpy as np

MAX_FRAME = 256 * 1024 * 1024
_MAGIC = 0x47
_HDR = struct.Struct("<BIH")
_BLOB_LEN = struct.Struct("<Q")


def _encode(obj: Any, blobs: List[bytes]) -> Any:
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        blobs.append(arr.tobytes())
        return {
            "__blob__": len(blobs) - 1,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
        }
    if isinstance(obj, dict):
        return {k: _encode(v, blobs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v, blobs) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _decode(obj: Any, blobs: List[bytes]) -> Any:
    if isinstance(obj, dict):
        if "__blob__" in obj:
            raw = blobs[obj["__blob__"]]
            return (
                np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))
                .reshape(obj["shape"])
                .copy()
            )
        return {k: _decode(v, blobs) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, blobs) for v in obj]
    return obj


class Channel:
    """A framed, thread-compatible message channel over a socket.

    ``send`` may be called from multiple threads (a lock serializes frames);
    ``recv`` is meant for a single reader thread.  ``recv`` returns None on
    EOF — connection loss is a first-class event for the membership layer
    (the DeathWatch analog), not an exception.
    """

    def __init__(
        self, sock: socket.socket, send_deadline_s: float = 0.0
    ) -> None:
        import threading

        self.sock = sock
        try:
            # Every frame is one sendall of a complete message; Nagle can
            # only add latency here, never save bytes.  Decisive on the
            # serve op plane, whose request/response frames are small and
            # ping-pongy — without this, Nagle × delayed-ACK stalls every
            # round trip by tens of ms once traffic fans across workers.
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except (OSError, ValueError):
            pass  # non-TCP test doubles (socketpairs) don't support it
        self._rfile = sock.makefile("rb")
        self._wlock = threading.Lock()
        # Optional send deadline (seconds; 0 = block forever): a send into a
        # wedged peer's full socket buffer raises an OSError (every existing
        # handler treats that as a dead channel) after roughly this long
        # instead of blocking the sending thread — heartbeats, ring
        # publishes — forever.  Implemented with SO_SNDTIMEO, which bounds
        # ONLY send-side blocking — settimeout() would race with a reader
        # thread blocked in recv on the same (bidirectional) socket.  A
        # timed-out send may have written a PARTIAL frame, so the channel
        # must not be reused after one: callers' OSError paths already
        # drop/close it.
        self.send_deadline_s = 0.0
        if send_deadline_s:
            self.set_send_deadline(send_deadline_s)

    def set_send_deadline(self, seconds: float) -> None:
        """Install/replace the per-send deadline (0 disables).  A method —
        not a bare attribute write — so chaos wrappers can delegate it to
        the real channel."""
        tv = struct.pack("ll", int(seconds), int((seconds % 1.0) * 1e6))
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
        except (OSError, ValueError):  # platform without timeval sockopts
            return
        self.send_deadline_s = seconds

    def send(self, msg: Dict[str, Any]) -> None:
        blobs: List[bytes] = []
        payload = json.dumps(_encode(msg, blobs)).encode()
        total = len(payload) + sum(len(b) for b in blobs)
        if total > MAX_FRAME:
            raise ValueError(f"frame of {total} bytes exceeds MAX_FRAME {MAX_FRAME}")
        parts = [_HDR.pack(_MAGIC, len(payload), len(blobs))]
        parts.extend(_BLOB_LEN.pack(len(b)) for b in blobs)
        parts.append(payload)
        parts.extend(blobs)
        data = b"".join(parts)
        with self._wlock:
            self.sock.sendall(data)

    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = self._rfile.read(n)
        if buf is None or len(buf) < n:
            return None  # EOF (clean at frame start, or truncated mid-frame)
        return buf

    def recv(self) -> Optional[Dict[str, Any]]:
        hdr = self._read_exact(_HDR.size)
        if hdr is None:
            return None
        magic, json_len, nblobs = _HDR.unpack(hdr)
        if magic != _MAGIC:
            raise ValueError(f"bad frame magic {magic:#x}")
        lens_raw = self._read_exact(_BLOB_LEN.size * nblobs)
        if lens_raw is None:
            return None
        blob_lens = [
            _BLOB_LEN.unpack_from(lens_raw, i * _BLOB_LEN.size)[0]
            for i in range(nblobs)
        ]
        if json_len + sum(blob_lens) > MAX_FRAME:
            raise ValueError("incoming frame exceeds MAX_FRAME")
        payload = self._read_exact(json_len)
        if payload is None:
            return None
        blobs: List[bytes] = []
        for ln in blob_lens:
            b = self._read_exact(ln)
            if b is None:
                return None
            blobs.append(b)
        try:
            return _decode(json.loads(payload), blobs)
        except (KeyError, IndexError, TypeError) as e:
            # A structurally bad payload (blob reference out of range, wrong
            # nesting) is a malformed FRAME, same class as a bad magic:
            # surface it as the ValueError the serve loops already handle.
            raise ValueError(
                f"malformed frame payload: {type(e).__name__}: {e}"
            ) from e

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def dial(
    host: str,
    port: int,
    *,
    timeout_s: float = 5.0,
    send_deadline_s: float = 0.0,
) -> Channel:
    """Connect to a peer listener and wrap the socket as a Channel.  The
    timeout bounds only the CONNECT (a dead seed address must not wedge a
    gossip tick); the established channel reverts to blocking reads, with
    the usual optional send deadline.  Raises OSError on failure — every
    caller treats an undialable peer as simply not-yet-alive."""
    sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.settimeout(None)
    return Channel(sock, send_deadline_s=send_deadline_s)


# -- trace-context envelope helpers -------------------------------------------
#
# Span context rides INSIDE the message JSON under obs.tracing.TRACE_KEY
# (an underscored key no protocol payload uses), so propagation needs no
# frame-format change and decoders that predate tracing simply ignore it.


def attach_trace(msg: Dict[str, Any], span) -> Dict[str, Any]:
    """Embed ``span``'s propagation context into a message envelope (no-op
    when ``span`` is None).  Mutates and returns ``msg`` — callers attach
    just before ``Channel.send``."""
    from akka_game_of_life_tpu_torch.obs.tracing import TRACE_KEY

    if span is not None:
        msg[TRACE_KEY] = span.ctx if hasattr(span, "ctx") else dict(span)
    return msg


def extract_trace(msg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The sender's span context from a received envelope, or None.  The
    returned dict is what ``Tracer.span(parent=...)`` accepts."""
    from akka_game_of_life_tpu_torch.obs.tracing import TRACE_KEY

    ctx = msg.get(TRACE_KEY)
    return ctx if isinstance(ctx, dict) else None


# -- tile payload helpers -----------------------------------------------------


# -- boundary-ring payload codec ----------------------------------------------
#
# The peer data plane's wire unit (PEER_RING / PEER_RING_BATCH).  A Ring has
# 8 components (top/bottom/left/right + 4 corners); shipping them as 8 raw
# uint8 blobs costs 8 blob-length headers and 8 JSON placeholders per ring.
# Here the whole ring concatenates into ONE blob, and binary-rule rings
# additionally bit-pack 32 cells per uint32 word (the ops/bitpack layout:
# LSB-first within the word) — ~8x fewer payload bytes on the wire.  The
# entry self-describes via "enc", so the receiver decodes without knowing
# the sender's pack setting; an unknown "enc" raises ValueError, which every
# peer serve loop treats as a dead channel (mixed-version peers fail loud,
# never silently mis-decode).

# Fixed component order of the concatenated ring blob.
_RING_PARTS = ("top", "bottom", "left", "right", "nw", "ne", "sw", "se")


def _ring_shapes(h: int, w: int, k: int) -> List[tuple]:
    """Component shapes of a width-k ring of an (h, w) tile, in
    ``_RING_PARTS`` order."""
    return [(k, w), (k, w), (h, k), (h, k), (k, k), (k, k), (k, k), (k, k)]


def encode_ring(ring, pack: bool) -> Dict[str, Any]:
    """A :class:`runtime.tiles.Ring` → one wire entry.

    ``pack=True`` (binary rules only — cells must be 0/1) packs the
    concatenated components 32 cells per uint32 word; ``pack=False`` ships
    the concatenation as raw uint8 (any state alphabet).  Either way the
    ring is ONE blob + a 4-int header instead of 8 blobs."""
    k = ring.width
    h = ring.left.shape[0]
    w = ring.top.shape[1]
    parts = [ring.top, ring.bottom, ring.left, ring.right] + [
        ring.corners[c] for c in ("nw", "ne", "sw", "se")
    ]
    flat = np.concatenate(
        [np.ascontiguousarray(p, dtype=np.uint8).ravel() for p in parts]
    )
    if pack:
        bits = np.packbits(flat, bitorder="little")
        pad = (-bits.size) % 4
        if pad:
            bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
        return {"enc": "bits1", "h": h, "w": w, "k": k, "data": bits.view(np.uint32)}
    return {"enc": "raw", "h": h, "w": w, "k": k, "data": flat}


def decode_ring(entry: Dict[str, Any]):
    """Inverse of :func:`encode_ring`; bit-exact round-trip.  Raises
    ``ValueError`` on an unknown encoding or a size mismatch (a
    wrong-version or corrupt peer must fail loud, not yield garbage
    halos)."""
    from akka_game_of_life_tpu_torch.runtime.tiles import Ring

    h, w, k = int(entry["h"]), int(entry["w"]), int(entry["k"])
    shapes = _ring_shapes(h, w, k)
    n = sum(a * b for a, b in shapes)
    enc = entry.get("enc")
    data = entry["data"]
    if enc == "bits1":
        raw = np.asarray(data, dtype=np.uint32)
        if raw.view(np.uint8).size * 8 < n:
            raise ValueError(
                f"packed ring blob holds {raw.view(np.uint8).size * 8} bits, "
                f"needs {n}"
            )
        flat = np.unpackbits(raw.view(np.uint8), count=n, bitorder="little")
    elif enc == "raw":
        flat = np.asarray(data, dtype=np.uint8).ravel()
        if flat.size != n:
            raise ValueError(f"raw ring blob holds {flat.size} cells, needs {n}")
    else:
        raise ValueError(f"unknown ring encoding {enc!r}")
    views = []
    off = 0
    for shape in shapes:
        size = shape[0] * shape[1]
        views.append(flat[off : off + size].reshape(shape).copy())
        off += size
    top, bottom, left, right, nw, ne, sw, se = views
    return Ring(
        top=top, bottom=bottom, left=left, right=right,
        corners={"nw": nw, "ne": ne, "sw": sw, "se": se},
    )


def ring_entry_nbytes(entry: Dict[str, Any]) -> int:
    """Wire payload bytes of one encoded ring entry (the blob only — the
    JSON envelope is the per-frame overhead batching amortizes)."""
    return int(np.asarray(entry["data"]).nbytes)


# Per-entry JSON overhead allowance when splitting batches against
# MAX_FRAME: placeholder + tile/epoch/header ints, generously rounded up.
_ENTRY_JSON_OVERHEAD = 256
# Keep one batch frame well under MAX_FRAME: rings are small, so a quarter
# of the cap leaves room for the envelope while still batching thousands.
RING_BATCH_MAX_BYTES = MAX_FRAME // 4


def split_ring_batches(
    entries: List[Dict[str, Any]], max_bytes: int = RING_BATCH_MAX_BYTES
) -> List[List[Dict[str, Any]]]:
    """Split a list of batch entries (``{"tile", "epoch", "ring"}`` dicts,
    or payload-free ``{"tile", "epoch", "same_as"}`` quiescence markers)
    into sub-lists whose payload bytes each stay under ``max_bytes`` — one
    PEER_RING_BATCH frame per sub-list.  Order is preserved; an oversize
    single entry still gets its own frame (the Channel's MAX_FRAME check is
    the hard backstop).  Empty input → no frames."""
    frames: List[List[Dict[str, Any]]] = []
    cur: List[Dict[str, Any]] = []
    cur_bytes = 0
    for entry in entries:
        nbytes = (
            ring_entry_nbytes(entry["ring"]) if "ring" in entry else 0
        ) + _ENTRY_JSON_OVERHEAD
        if cur and cur_bytes + nbytes > max_bytes:
            frames.append(cur)
            cur, cur_bytes = [], 0
        cur.append(entry)
        cur_bytes += nbytes
    if cur:
        frames.append(cur)
    return frames


def pack_tile(arr: np.ndarray) -> Dict[str, Any]:
    """Encode a tile for bulk shipping: binary boards bit-pack 8 cells/byte
    (the only honest way a 65536²-class tile fits a frame); multi-state
    boards ride raw uint8."""
    arr = np.asarray(arr, dtype=np.uint8)
    if bool((arr <= 1).all()):
        return {
            "enc": "bits",
            "shape": list(arr.shape),
            "data": np.packbits(arr),
        }
    return {"enc": "raw", "shape": list(arr.shape), "data": arr}


def unpack_tile(payload: Dict[str, Any]) -> np.ndarray:
    shape = tuple(int(v) for v in payload["shape"])
    data = payload["data"]
    if payload["enc"] == "bits":
        n = int(np.prod(shape))
        return np.unpackbits(data, count=n).reshape(shape)
    return np.asarray(data, dtype=np.uint8).reshape(shape)
