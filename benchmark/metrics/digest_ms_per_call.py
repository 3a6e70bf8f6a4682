"""Milliseconds of one call of the run's board digest
(``ops/digest.py`` ``digest_packed``), host clock from the call's entry
until its lanes are ready on the device, averaged over the calls in the
window.  The run's own ``gol_digest_seconds`` starts after that call has
returned (it times the fetch and the fold), so the benchmark wraps the
call itself in the traced run."""

import torch


def install(run):
    from akka_game_of_life_tpu_torch.ops import digest

    original = digest.digest_packed

    def ready(lanes):
        if lanes.device.type == "cuda":
            torch.cuda.synchronize(lanes.device)

    digest.digest_packed = run.span("digest_packed", original, ready)

    def undo():
        digest.digest_packed = original

    return undo


def read(r):
    seconds = r.span_seconds("digest_packed")
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
