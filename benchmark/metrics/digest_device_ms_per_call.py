"""Milliseconds of device time of one board digest (``ops/digest.py``
``digest_packed``): the program ledger's CUDA-event seconds of family
``digest`` over its calls in the window (a start and a stop event at the
call's entry and exit, on its stream)."""


def read(r):
    calls = r.program_delta("digest")
    n = sum(d["calls"] for d in calls.values())
    return 1e3 * sum(d["seconds"] for d in calls.values()) / n if n else None
