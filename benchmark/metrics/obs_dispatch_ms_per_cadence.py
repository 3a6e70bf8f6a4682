"""Milliseconds of one cadence point's dispatch: the run's own
``obs.dispatch`` span (``runtime/simulation.py`` ``_observe``: the
population, view and probe reads launched, the digest's computation when
on, and their copies to the host started), with the waits for the card's
queue in that: a pageable index upload queued behind the chunk's and the
population's kernels waits for them here, not in ``obs.fetch``;
``gol_span_seconds{span="obs.dispatch"}`` sum over count, in the window."""

SERIES = 'gol_span_seconds{span="obs.dispatch"}'


def read(r):
    d = r.histogram(SERIES)
    return None if d is None else 1e3 * d["sum"] / d["count"]
