"""Set-up: from the process's start to the window's (imports, loading,
warm-up, building kernels where none are built)."""

from benchmark import core


def read(rec: core.Record):
    return rec.setup_s
