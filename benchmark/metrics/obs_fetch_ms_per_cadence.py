"""Milliseconds of one cadence point's fetch: the run's own ``obs.fetch``
span (``runtime/simulation.py`` ``_obs_emit``: the wait for the
observation's copies still in flight once dispatched, and the gather
across ranks), ``gol_span_seconds{span="obs.fetch"}`` sum over count, in
the window.  Where the dispatch's pageable uploads queue behind the
card's work, the wait for the card is in ``obs.dispatch`` and this reads
near zero."""

SERIES = 'gol_span_seconds{span="obs.fetch"}'


def read(r):
    d = r.histogram(SERIES)
    return None if d is None else 1e3 * d["sum"] / d["count"]
