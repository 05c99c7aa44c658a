"""The benchmark's own readers of the two scene files it runs.

Both return the trainable (pre-activation) parameters as float32 NumPy
arrays, the 3DGS convention:

    positions (N, 3), sh (N, 3·(d+1)²) with coefficient c of channel ch at
    column 3·c + ch, raw_opacity (N,) logit, raw_scales (N, 3) log,
    quats (N, 4) w, x, y, z (not normalized)

``.ply``: the binary little-endian 3DGS PLY (Kerbl et al. 2023's
``point_cloud.ply``): ``x y z``, ``f_dc_*``, ``f_rest_*``, ``opacity``
(logit), ``scale_*`` (log), ``rot_*``. The repository's files keep
``f_rest_j`` in the interleaved order of the renderer this project
follows (its C++ loader reads ``f_rest_j`` into column ``3 + j``), not
3DGS's channel-major order, and are read as they were written.

``.gsz``: the repository's compact container (magic ``GSZ1``, two u32
lengths, a JSON header, one DEFLATE payload of the header's fields in
order): positions on a per-axis 24-bit grid, SH, opacity and
log-scales on min/max grids, quaternions as the smallest three.

Asked for a higher SH degree than a file holds, both readers give the
bands it lacks as zeros, as 3DGS allocates every band up to degree 3 and
starts the higher ones at zero.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}
_OPACITY_EPS = 1e-6


def read_scene(path: str, sh_degree: int) -> dict:
    """The parameters of ``path`` up to SH degree ``sh_degree``, the bands
    the file does not hold zero."""
    if path.endswith(".gsz"):
        return _read_gsz(path, sh_degree)
    if path.endswith(".ply"):
        return _read_ply(path, sh_degree)
    raise ValueError(f"no reader for {path!r}")


def _read_ply(path: str, sh_degree: int) -> dict:
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt, count, props, in_vertex = None, 0, [], False
        while True:
            line = fh.readline().decode("ascii").strip()
            if line == "end_header":
                break
            words = line.split()
            if not words or words[0] == "comment":
                continue
            if words[0] == "format":
                fmt = words[1]
            elif words[0] == "element":
                in_vertex = words[1] == "vertex"
                if in_vertex:
                    count = int(words[2])
            elif words[0] == "property" and in_vertex:
                props.append((words[2], _PLY_TYPES[words[1]]))
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: format {fmt!r} is not binary_little_endian")
        body = np.fromfile(fh, dtype=np.dtype(props), count=count)
    if body.shape[0] != count:
        raise ValueError(f"{path}: {body.shape[0]} of {count} vertices")

    def cols(names):
        return np.stack([body[n].astype(np.float32) for n in names], axis=1)

    n_rest = 3 * ((sh_degree + 1) ** 2 - 1)
    stored = sum(1 for name, _ in props if name.startswith("f_rest_"))
    sh = np.zeros((count, 3 + n_rest), np.float32)
    sh[:, :3 + min(n_rest, stored)] = cols(
        [f"f_dc_{c}" for c in range(3)] + [f"f_rest_{j}" for j in range(min(n_rest, stored))])
    return {
        "positions": cols(["x", "y", "z"]),
        "sh": sh,
        "raw_opacity": body["opacity"].astype(np.float32),
        "raw_scales": cols(["scale_0", "scale_1", "scale_2"]),
        "quats": cols(["rot_0", "rot_1", "rot_2", "rot_3"]),
    }


def _grid(q: np.ndarray, lo: float, hi: float, bits: int) -> np.ndarray:
    return (q.astype(np.float64) * ((hi - lo) / ((1 << bits) - 1)) + lo).astype(np.float32)


def _read_gsz(path: str, sh_degree: int) -> dict:
    with open(path, "rb") as fh:
        if fh.read(4) != b"GSZ1":
            raise ValueError(f"{path}: not a .gsz file")
        hlen, plen = struct.unpack("<II", fh.read(8))
        meta = json.loads(fh.read(hlen))
        payload = zlib.decompress(fh.read(plen))
    n = meta["n"]
    fields, off = {}, 0
    for f in meta["fields"]:
        arr = np.frombuffer(payload, np.dtype(f["dtype"]), int(np.prod(f["shape"])), off)
        fields[f["name"]] = (arr.reshape(f["shape"]), f)
        off += arr.nbytes

    raw, f = fields["positions24"]
    b = raw.reshape(n, 3, 3).astype(np.uint32)
    q24 = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16)
    positions = np.stack(
        [_grid(q24[:, a], *f["ranges"][a], 24) for a in range(3)], axis=1)

    width = meta["sh_width"]
    keep = 3 * (sh_degree + 1) ** 2
    sh = np.zeros((n, max(width, keep)), np.float32)
    q, f = fields["sh_dc"]
    sh[:, :3] = _grid(q, f["lo"], f["hi"], f["bits"])
    if "sh_rest" in fields:
        q, f = fields["sh_rest"]
        sh[:, 3:width] = _grid(q, f["lo"], f["hi"], f["bits"])

    q, f = fields["opacity"]
    opacity = np.clip(_grid(q, f["lo"], f["hi"], f["bits"]), _OPACITY_EPS, 1 - _OPACITY_EPS)
    q, f = fields["log_scales"]
    log_scales = _grid(q, f["lo"], f["hi"], f["bits"])

    # Smallest three: the dropped (largest, non-negative) component at idx,
    # the other three in order idx+1, idx+2, idx+3 (mod 4) on [−1/√2, 1/√2].
    idx = fields["quat_idx"][0].astype(np.int64)
    comps, f = fields["quat_comps"]
    r = np.float32(1 / np.sqrt(2))
    rest = comps.astype(np.float32) / np.float32((1 << f["bits"]) - 1) * (2 * r) - r
    quats = np.zeros((n, 4), np.float32)
    rows = np.arange(n)
    quats[rows, idx] = np.sqrt(np.maximum(1.0 - (rest * rest).sum(1), 0.0))
    for k in range(3):
        quats[rows, (idx + k + 1) % 4] = rest[:, k]

    return {
        "positions": positions,
        "sh": sh[:, :keep].copy(),
        # The trainable form of a decoded opacity and scale: logit and log.
        "raw_opacity": np.log(opacity / (1 - opacity)).astype(np.float32),
        "raw_scales": log_scales,
        "quats": quats,
    }
