"""Milliseconds a router tick waits, after its last launch, for the work
still queued on the card and the batch's boards and digest lanes copied
back (``serve/sessions.py`` ``_run_class_batch``, span ``serve.fetch``);
``gol_span_seconds{span="serve.fetch"}`` sum over
``gol_serve_tick_seconds`` count, in the window."""

SERIES = 'gol_span_seconds{span="serve.fetch"}'


def read(r):
    ticks, d = r.histogram("gol_serve_tick_seconds"), r.histogram(SERIES)
    return None if ticks is None or d is None else 1e3 * d["sum"] / ticks["count"]
