"""Milliseconds of a router tick's own host work around the batched step
(``serve/sessions.py`` ``_run_class_batch``): padding the batch into host
arrays (span ``serve.pad``) and writing the results back (span
``serve.scatter``: slices, popcounts, table writes, completions);
``gol_span_seconds`` of both, summed, over ``gol_serve_tick_seconds``
count, in the window."""

SERIES = ('gol_span_seconds{span="serve.pad"}', 'gol_span_seconds{span="serve.scatter"}')


def read(r):
    ticks = r.histogram("gol_serve_tick_seconds")
    parts = [d for d in map(r.histogram, SERIES) if d is not None]
    if ticks is None or not parts:
        return None
    return 1e3 * sum(d["sum"] for d in parts) / ticks["count"]
