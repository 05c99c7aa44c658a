"""Training steps per second: every step of the window over the time to
the synchronize that closes it."""

from benchmark import core


def read(rec: core.Record):
    return core.rate(rec.units, rec.window_s) if rec.units else None
