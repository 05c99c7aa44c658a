"""The card's idle share of the traced window, a profile of the device
alone over steps back to back: 1 − busy / window, percent."""

from benchmark import core


def read(rec: core.Record):
    return None if not rec.trace_window_s else 100.0 * (1.0 - rec.busy_s / rec.trace_window_s)
