"""Compact quantized scene storage (``.gsz``) and the web-viewer ``.splat``
format (PyTorch port).

Counterpart of ``gaussianrenderer_tpu.scene.compact``. Encoding and
decoding run in NumPy, as in the reference, so a scene saved by either
package gives byte-equal files (same JSON header, field order and zlib
level) and a file loaded by either gives bit-equal arrays; only the final
``GaussianScene`` goes to ``device``.

``.gsz``: positions on a per-axis 24-bit grid over the scene's bounding
box; log-scales, SH and opacity on per-scene min/max grids (16-bit for
``q16``; 8-bit for ``q8``'s scales, higher SH bands and opacity, the DC
band always 16-bit); rotations as smallest-three (drop the largest
component, sign-normalized, 2-bit index); the whole payload DEFLATEd.

``.splat`` (antimatter15's web viewer, 32 bytes a splat): position and
linear scale as f32×3, RGBA u8 (rgb = 0.5 + C0·DC clamped, alpha =
opacity), quaternion u8×4 ((q/‖q‖)·128 + 128, w first). DC only.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene
from gaussianrenderer_tpu_torch.scene.io import _scene_from_numpy
from gaussianrenderer_tpu_torch.scene.io import to_numpy as _np

_MAGIC = b"GSZ1"
_INV_SQRT2 = 0.7071067811865476


def _grid_encode(x: np.ndarray, bits: int) -> Tuple[np.ndarray, float, float]:
    """Quantize to a [lo, hi] uint grid with ``bits`` bits (ties-to-nearest),
    in float64: a 24-bit grid index does not survive the f32 mantissa."""
    x = np.asarray(x, np.float64)
    lo = float(x.min()) if x.size else 0.0
    hi = float(x.max()) if x.size else 1.0
    span = (hi - lo) or 1.0
    steps = (1 << bits) - 1
    q = np.round((x - lo) / span * steps)
    dtype = np.uint8 if bits <= 8 else (np.uint16 if bits <= 16 else np.uint32)
    return q.astype(dtype), lo, hi


def _grid_decode(q: np.ndarray, lo: float, hi: float, bits: int) -> np.ndarray:
    steps = (1 << bits) - 1
    return (q.astype(np.float64) / steps * (hi - lo) + lo).astype(np.float32)


def _pack24(q: np.ndarray) -> np.ndarray:
    """(N, 3) uint32 in [0, 2²⁴) → (N, 9) raw little-endian bytes."""
    b = q.astype("<u4").reshape(-1, 1).view(np.uint8).reshape(-1, 3, 4)
    return b[:, :, :3].reshape(-1, 9)


def _unpack24(raw: np.ndarray, n: int) -> np.ndarray:
    b = np.zeros((n * 3, 4), np.uint8)
    b[:, :3] = raw.reshape(n * 3, 3)
    return b.view("<u4").reshape(n, 3)


def _quat_encode(quats: np.ndarray, bits: int):
    """Smallest-three encoding. Returns (idx u8 (N,), comps uint (N, 3))."""
    q = np.asarray(quats, np.float32)
    norm = np.linalg.norm(q, axis=1, keepdims=True)
    q = q / np.maximum(norm, 1e-12)
    idx = np.argmax(np.abs(q), axis=1)
    # q and −q are the same rotation: make the dropped component ≥ 0.
    sign = np.sign(np.take_along_axis(q, idx[:, None], axis=1))
    sign[sign == 0] = 1.0
    q = q * sign
    rest = np.stack([q[np.arange(len(q)), (idx + k) % 4] for k in (1, 2, 3)], axis=1)
    steps = (1 << bits) - 1
    enc = np.round((rest + _INV_SQRT2) / (2 * _INV_SQRT2) * steps)
    dtype = np.uint8 if bits <= 8 else np.uint16
    return idx.astype(np.uint8), np.clip(enc, 0, steps).astype(dtype)


def _quat_decode(idx: np.ndarray, comps: np.ndarray, bits: int) -> np.ndarray:
    steps = (1 << bits) - 1
    rest = comps.astype(np.float32) / steps * (2 * _INV_SQRT2) - _INV_SQRT2
    n = len(idx)
    big = np.sqrt(np.maximum(1.0 - np.sum(rest * rest, axis=1), 0.0))
    q = np.zeros((n, 4), np.float32)
    rows = np.arange(n)
    q[rows, idx] = big
    for k in (1, 2, 3):
        q[rows, (idx + k) % 4] = rest[:, k - 1]
    return q


def save_compact(scene: GaussianScene, path: str, profile: str = "q16") -> Dict:
    """Write a ``.gsz`` compact scene (``profile`` ``"q16"`` or ``"q8"``).
    Non-finite splats are dropped, so none can poison a shared grid.
    Returns ``{"bytes", "quantized_bytes", "ply_bytes_equiv",
    "ratio_vs_ply", "n"}``."""
    if profile not in ("q16", "q8"):
        raise ValueError(f"unknown profile {profile!r} (q16 or q8)")
    hi_bits = 16
    lo_bits = 16 if profile == "q16" else 8

    pos, sh, opacity, scales, quats = (
        _np(scene.positions), _np(scene.sh), _np(scene.opacity), _np(scene.scales),
        _np(scene.quats))
    tp = None if scene.time_params is None else _np(scene.time_params)
    finite = (
        np.isfinite(pos).all(axis=1)
        & np.isfinite(sh).all(axis=1)
        & np.isfinite(opacity)
        & np.isfinite(scales).all(axis=1)
        & np.isfinite(quats).all(axis=1)
    )
    if tp is not None:
        finite &= np.isfinite(tp).all(axis=1)
    if not finite.all():
        keep = np.flatnonzero(finite)
        pos, sh, opacity, scales, quats = (pos[keep], sh[keep], opacity[keep],
                                           scales[keep], quats[keep])
        tp = None if tp is None else tp[keep]
    n = pos.shape[0]

    blobs = []
    meta = {"profile": profile, "n": n, "fields": []}

    def put(name, arr, **extra):
        raw = np.ascontiguousarray(arr)
        meta["fields"].append(
            dict(name=name, dtype=str(raw.dtype), shape=list(raw.shape), **extra)
        )
        blobs.append(raw.tobytes())

    pq = np.zeros((n, 3), np.uint32)
    ranges = []
    for a in range(3):
        qa, lo, hi = _grid_encode(pos[:, a], 24)
        pq[:, a] = qa
        ranges.append((lo, hi))
    put("positions24", _pack24(pq), ranges=ranges)

    dc, dlo, dhi = _grid_encode(sh[:, :3], hi_bits)
    put("sh_dc", dc, lo=dlo, hi=dhi, bits=hi_bits)
    if sh.shape[1] > 3:
        rest, rlo, rhi = _grid_encode(sh[:, 3:], lo_bits)
        put("sh_rest", rest, lo=rlo, hi=rhi, bits=lo_bits)
    meta["sh_width"] = int(sh.shape[1])

    op_bits = hi_bits if profile == "q16" else 8
    oq, olo, ohi = _grid_encode(np.clip(opacity, 0.0, 1.0), op_bits)
    put("opacity", oq, lo=olo, hi=ohi, bits=op_bits)

    sq, slo, shi = _grid_encode(np.log(np.maximum(scales, 1e-30)), lo_bits)
    put("log_scales", sq, lo=slo, hi=shi, bits=lo_bits)

    qidx, qcomp = _quat_encode(quats, hi_bits)
    put("quat_idx", qidx)
    put("quat_comps", qcomp, bits=hi_bits)

    if tp is not None:
        put("time_params", tp.astype("<f4"))
        meta["time_width"] = int(tp.shape[1])

    payload = zlib.compress(b"".join(blobs), 6)
    header = json.dumps(meta).encode("utf-8")
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(struct.pack("<II", len(header), len(payload)))
        fh.write(header)
        fh.write(payload)

    raw_bytes = sum(len(b) for b in blobs)
    total = 12 + len(header) + len(payload)
    ply_bytes = n * 4 * (6 + sh.shape[1] + 1 + 3 + 4) + 400
    return {
        "bytes": total,
        "quantized_bytes": raw_bytes,
        "ply_bytes_equiv": ply_bytes,
        "ratio_vs_ply": round(ply_bytes / max(total, 1), 2),
        "n": n,
    }


def _load_compact_numpy(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(4)
        if magic != _MAGIC:
            raise ValueError(f"not a .gsz file (magic {magic!r})")
        hlen, plen = struct.unpack("<II", fh.read(8))
        meta = json.loads(fh.read(hlen).decode("utf-8"))
        payload = zlib.decompress(fh.read(plen))

    n = meta["n"]
    fields = {}
    off = 0
    for f in meta["fields"]:
        arr = np.frombuffer(
            payload, dtype=np.dtype(f["dtype"]), offset=off,
            count=int(np.prod(f["shape"])),
        ).reshape(f["shape"])
        off += arr.nbytes
        fields[f["name"]] = (arr, f)

    raw, f = fields["positions24"]
    pq = _unpack24(raw, n)
    pos = np.zeros((n, 3), np.float32)
    for a in range(3):
        lo, hi = f["ranges"][a]
        pos[:, a] = _grid_decode(pq[:, a], lo, hi, 24)

    sh = np.zeros((n, meta["sh_width"]), np.float32)
    arr, f = fields["sh_dc"]
    sh[:, :3] = _grid_decode(arr, f["lo"], f["hi"], f["bits"])
    if "sh_rest" in fields:
        arr, f = fields["sh_rest"]
        sh[:, 3:] = _grid_decode(arr, f["lo"], f["hi"], f["bits"])

    arr, f = fields["opacity"]
    opacity = _grid_decode(arr, f["lo"], f["hi"], f["bits"])

    arr, f = fields["log_scales"]
    scales = np.exp(_grid_decode(arr, f["lo"], f["hi"], f["bits"]))

    qcomp, qmeta = fields["quat_comps"]
    quats = _quat_decode(fields["quat_idx"][0], qcomp, qmeta["bits"])

    time_params = None
    if "time_params" in fields:
        time_params = np.array(fields["time_params"][0], np.float32)  # a writable copy
    return (pos, sh, opacity, scales, quats), time_params


def load_compact(path: str, device="cuda") -> GaussianScene:
    """Read a ``.gsz`` file into a (f32, activated) ``GaussianScene`` on
    ``device``; the decode runs in NumPy on the host."""
    arrays, time_params = _load_compact_numpy(path)
    return _scene_from_numpy(arrays, time_params, device)


_SPLAT_C0 = 0.28209479177387814
_SPLAT_BYTES = 32
_SPLAT_DTYPE = np.dtype([
    ("position", np.float32, 3),
    ("scale", np.float32, 3),
    ("rgba", np.uint8, 4),
    ("rot", np.uint8, 4),
])


def save_splat(scene: GaussianScene, path: str, sort_by_importance: bool = True) -> Dict:
    """Write ``scene`` as a web-viewer ``.splat`` file (lossy: DC colour
    only, u8 colour, opacity and rotation; non-finite splats dropped).
    ``sort_by_importance`` orders splats by descending opacity·volume
    (a stable sort), so progressive loading shows the important ones
    first. Returns ``{"bytes", "num_gaussians"}``."""
    pos, scales, quats, opacity = (_np(scene.positions), _np(scene.scales),
                                   _np(scene.quats), _np(scene.opacity))
    dc = _np(scene.sh[:, :3])
    finite = (
        np.isfinite(pos).all(axis=1)
        & np.isfinite(dc).all(axis=1)
        & np.isfinite(opacity)
        & np.isfinite(scales).all(axis=1)
        & np.isfinite(quats).all(axis=1)
    )
    if not finite.all():
        keep = np.flatnonzero(finite)
        pos, scales, quats = pos[keep], scales[keep], quats[keep]
        opacity, dc = opacity[keep], dc[keep]
    n = pos.shape[0]

    order = np.arange(n)
    if sort_by_importance:
        importance = opacity * scales.prod(axis=1)
        order = np.argsort(-importance, kind="stable")

    rgb = np.clip(0.5 + _SPLAT_C0 * dc[order], 0.0, 1.0)
    rgba = np.empty((n, 4), np.uint8)
    rgba[:, :3] = np.round(rgb * 255.0)
    rgba[:, 3] = np.round(np.clip(opacity[order], 0.0, 1.0) * 255.0)

    q = quats[order]
    norm = np.linalg.norm(q, axis=1, keepdims=True)
    q = q / np.where(norm > 1e-12, norm, 1.0)
    q_u8 = np.clip(np.round(q * 128.0 + 128.0), 0, 255).astype(np.uint8)

    rec = np.empty(n, dtype=_SPLAT_DTYPE)
    rec["position"] = pos[order]
    rec["scale"] = scales[order]
    rec["rgba"] = rgba
    rec["rot"] = q_u8
    buf = rec.tobytes()
    with open(path, "wb") as fh:
        fh.write(buf)
    return {"bytes": len(buf), "num_gaussians": n}


def load_splat(path: str, device="cuda") -> GaussianScene:
    """Load a ``.splat`` file onto ``device``. The format is DC-only; the
    SH array is zero-padded to degree 2, so the scene renders under any
    ``cfg.sh_degree ≤ 2``."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if len(buf) % _SPLAT_BYTES:
        raise ValueError(
            f"{path}: size {len(buf)} is not a multiple of "
            f"{_SPLAT_BYTES} — not a .splat file"
        )
    rec = np.frombuffer(buf, dtype=_SPLAT_DTYPE)
    n = rec.shape[0]
    sh = np.zeros((n, 27), np.float32)
    sh[:, :3] = (rec["rgba"][:, :3].astype(np.float32) / 255.0 - 0.5) / _SPLAT_C0
    quats = (rec["rot"].astype(np.float32) - 128.0) / 128.0
    norm = np.linalg.norm(quats, axis=1, keepdims=True)
    quats = quats / np.where(norm > 1e-12, norm, 1.0)
    opacity = rec["rgba"][:, 3].astype(np.float32) / 255.0
    return _scene_from_numpy(
        (rec["position"], sh, opacity, rec["scale"], quats), None, device)
