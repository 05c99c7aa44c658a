"""ctypes binding of the native COLMAP ``points3D.bin`` reader
(``colmap_loader.cpp``).

``load_points(path)`` returns the same (xyz f64 (N, 3), rgb u8 (N, 3),
err f64 (N,)) tuple as the Python loop in ``scene/colmap.py``, in one pass
over the file. It raises ``ValueError`` when the reader refuses the file
(unreadable, truncated, a count that changed) and ``RuntimeError`` when
the library cannot be built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from gaussianrenderer_tpu_torch import _build

_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "colmap_points_count": (ctypes.c_longlong, [ctypes.c_char_p]),
    "colmap_points_load": (
        ctypes.c_int,
        [ctypes.c_char_p, ctypes.c_longlong, _F64P, _U8P, _F64P],
    ),
}


def library() -> ctypes.CDLL:
    return _build.NATIVE.load("colmap_loader", _SIGNATURES)


def load_points(path):
    lib = library()
    raw = os.fsencode(path)
    n = lib.colmap_points_count(raw)
    if n < 0:
        raise ValueError(f"native points3D reader cannot read {path!r}")
    xyz = np.empty((n, 3), dtype=np.float64)
    rgb = np.empty((n, 3), dtype=np.uint8)
    err = np.empty((n,), dtype=np.float64)
    rc = lib.colmap_points_load(raw, n, xyz, rgb, err)
    if rc != 0:
        raise ValueError(f"native points3D load failed (code {rc}) for {path!r}")
    return xyz, rgb, err
