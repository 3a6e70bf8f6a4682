"""Shared file-IO idiom for observability artifacts.

One implementation of the atomic text dump (tmp + rename, parent dirs
created, tmp unlinked on failure) that the metrics exposition, the Perfetto
trace export, and the flight-recorder dump all use — a scrape or post-
mortem read never sees a torn write, and a durability fix (e.g. adding
fsync) lands in one place.
"""

from __future__ import annotations

import os
import tempfile


def atomic_write_text(path: str, text: str, *, prefix: str = ".tmp_") -> None:
    """Write ``text`` to ``path`` atomically (same-directory tmp + rename),
    creating parent directories.  Raises OSError on failure with the tmp
    file cleaned up."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=prefix)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
