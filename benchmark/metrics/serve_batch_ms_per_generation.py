"""Milliseconds of device time of the batched step (``serve/batch.py``
``batch_step_fn``) per generation it ran in the window: the program
ledger's CUDA-event seconds of family ``serve_batch``
(``gol_program_device_seconds_total``) over each call's generations
(the length in the program's key, ``(class, length, device)``)."""

import ast


def read(r):
    calls = r.program_delta("serve_batch")
    generations = sum(d["calls"] * ast.literal_eval(key)[1] for key, d in calls.items())
    seconds = sum(d["seconds"] for d in calls.values())
    return 1e3 * seconds / generations if generations else None
