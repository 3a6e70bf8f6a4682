"""Milliseconds of one router tick (``serve/sessions.py`` ticker: pad,
batched calls, scatter): the server's own ``gol_serve_tick_seconds``, sum
over count, in the window."""


def read(r):
    d = r.histogram("gol_serve_tick_seconds")
    return None if d is None else 1e3 * d["sum"] / d["count"]
