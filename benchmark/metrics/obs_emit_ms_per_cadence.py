"""Milliseconds of one cadence point's host work after the fetch: the
run's own ``obs.emit`` span (``runtime/simulation.py`` ``_obs_emit``: the
joins, the digest's fold, the observer's frame and lines), in which the
card waits for the next call; ``gol_span_seconds{span="obs.emit"}`` sum
over count, in the window."""

SERIES = 'gol_span_seconds{span="obs.emit"}'


def read(r):
    d = r.histogram(SERIES)
    return None if d is None else 1e3 * d["sum"] / d["count"]
