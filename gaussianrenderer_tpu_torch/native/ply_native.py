"""ctypes binding of the native 3DGS PLY reader (``ply_loader.cpp``).

``load(path, max_sh_degree)`` returns the same tuple as the NumPy reader
in ``scene/io.py``: (positions, sh, opacity, scales, quats), float32, with
the load-time activations applied in C++ (``opacity = 1 / (1 + exp(-raw))``,
``scale = exp(raw)`` in f32, which rounds up to a few ulp apart from
NumPy's). It raises ``ValueError`` when the reader refuses the file (ascii,
a vertex count it cannot read or that changed, a truncated body) or when
``check_header`` finds a file the reader would not read safely, and
``RuntimeError`` when the library cannot be built.
"""

from __future__ import annotations

import ctypes
import os
import re

import numpy as np

from gaussianrenderer_tpu_torch import _build

_F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "ply_num_vertices": (ctypes.c_longlong, [ctypes.c_char_p]),
    "ply_load": (
        ctypes.c_int,
        [ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong] + [_F32P] * 5,
    ),
}

#: Bytes per value of each property type, as ``ply_loader.cpp`` sizes them
#: (any other type is 4).
_TYPE_SIZES = {b"double": 8, b"float64": 8, b"uchar": 1, b"uint8": 1, b"char": 1,
               b"int8": 1, b"short": 2, b"ushort": 2, b"int16": 2, b"uint16": 2}
#: Indexed properties: the prefix and how many slots the reader's buffer has
#: for it (``f_rest_`` indices past the kept ones are skipped by the reader,
#: so only a C ``int`` bounds them).
_INDEXED = ((b"f_dc_", 3), (b"f_rest_", 2 ** 31), (b"scale_", 3), (b"rot_", 4))
_LEADING_INT = re.compile(rb"[+-]?[0-9]+")


def _leading_int(token: bytes) -> int:
    """The integer ``atoi``/``operator>>`` read at the start of ``token``
    (0 where it starts with none)."""
    m = _LEADING_INT.match(token)
    return int(m.group()) if m else 0


def check_header(path) -> None:
    """Raise ``ValueError`` unless ``ply_loader.cpp`` reads ``path`` within
    the buffers ``load`` gives it and fills every one of them.

    The header is scanned as the C++ reader scans it: its index of an
    ``f_dc_``/``f_rest_``/``scale_``/``rot_`` property is the integer at
    the start of the suffix, used as written, so an index out of its
    buffer (``scale_3``, ``rot_-1``) would write outside it. The reader
    also leaves positions, opacity and scales unset where ``x``/``y``/``z``,
    ``opacity`` or a ``scale_*`` is missing, and sets every vertex's
    defaults before it reads the body, so a body shorter than the header
    says is refused here, before any buffer is allocated."""
    try:
        f = open(path, "rb")
    except OSError as e:
        raise ValueError(f"cannot open {path!r}: {e}") from e
    with f:
        if f.readline().rstrip(b"\n").removesuffix(b"\r") != b"ply":
            raise ValueError("not a PLY file")
        num, stride, body = 0, 0, None
        in_vertex = False
        pos, scale, opacity = set(), set(), False
        for raw in iter(f.readline, b""):
            line = raw.rstrip(b"\n").removesuffix(b"\r")
            if line == b"end_header":
                body = f.tell()
                break
            toks = line.split()
            tok = toks[0] if toks else b""
            if tok == b"element":
                in_vertex = toks[1:2] == [b"vertex"]
                if in_vertex:
                    num = _leading_int(toks[2]) if len(toks) > 2 else 0
            elif tok == b"property" and in_vertex:
                kind = toks[1] if len(toks) > 1 else b""
                name = toks[2] if len(toks) > 2 else b""
                stride += _TYPE_SIZES.get(kind, 4)
                if name in (b"x", b"y", b"z"):
                    pos.add(name)
                elif name == b"opacity":
                    opacity = True
                else:
                    for prefix, slots in _INDEXED:
                        if name.startswith(prefix):
                            idx = _leading_int(name[len(prefix):])
                            if not 0 <= idx < slots:
                                raise ValueError(
                                    f"PLY property {name.decode(errors='replace')!r} "
                                    "indexes outside the native reader's buffer")
                            if prefix == b"scale_":
                                scale.add(idx)
                            break
        if body is None:
            raise ValueError("unexpected EOF in PLY header")
        size = os.fstat(f.fileno()).st_size
    if len(pos) < 3 or not opacity or len(scale) < 3:
        raise ValueError("PLY lacks a property the native reader needs "
                         "(x, y, z, opacity or scale_0..2)")
    if num > 0 and body + num * stride > size:
        raise ValueError(f"PLY body truncated: {num} vertices need "
                         f"{num * stride} bytes")


def library() -> ctypes.CDLL:
    return _build.NATIVE.load("ply_loader", _SIGNATURES)


def load(path, max_sh_degree: int = 2):
    lib = library()
    if max_sh_degree < 0:
        raise ValueError(f"max_sh_degree {max_sh_degree} < 0")
    check_header(path)
    raw = os.fsencode(path)
    n = lib.ply_num_vertices(raw)
    if n < 0:
        raise ValueError(f"native PLY reader cannot read {path!r}")
    n_rest = 3 * ((max_sh_degree + 1) ** 2 - 1)
    positions = np.empty((n, 3), dtype=np.float32)
    sh = np.empty((n, 3 + n_rest), dtype=np.float32)
    opacity = np.empty((n,), dtype=np.float32)
    scales = np.empty((n, 3), dtype=np.float32)
    quats = np.empty((n, 4), dtype=np.float32)
    rc = lib.ply_load(raw, max_sh_degree, n, positions, sh, opacity, scales, quats)
    if rc != 0:
        raise ValueError(f"native PLY load failed (code {rc}) for {path!r}")
    return positions, sh, opacity, scales, quats
