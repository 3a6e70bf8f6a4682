"""Milliseconds of one cadence point's observation: the run's own
``gol_obs_seconds`` (population, sampled view, probe window, digest when
on; dispatch to the last host read), sum over count, in the window."""


def read(r):
    d = r.histogram("gol_obs_seconds")
    return None if d is None else 1e3 * d["sum"] / d["count"]
