"""Share of the traced slice of the serve process in which nothing ran on
the device, in %: 1 - the union of kernel, copy and set intervals over
the slice's length."""


def read(r):
    return None if r.trace is None else 100.0 * r.trace.idle_share
