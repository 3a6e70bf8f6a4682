"""Milliseconds a router tick spends calling the batched step
(``serve/sessions.py`` ``_run_class_batch``, span ``serve.dispatch``): the
host's launches, and its waits for room in the card's launch queue once
that is full, so a card-bound step reads here and not in
``serve_fetch_ms_per_tick``; ``gol_span_seconds{span="serve.dispatch"}``
sum over ``gol_serve_tick_seconds`` count, in the window."""

SERIES = 'gol_span_seconds{span="serve.dispatch"}'


def read(r):
    ticks, d = r.histogram("gol_serve_tick_seconds"), r.histogram(SERIES)
    return None if ticks is None or d is None else 1e3 * d["sum"] / ticks["count"]
