"""PLY scene loading and the seeded scene generator (PyTorch port).

Counterpart of ``gaussianrenderer_tpu.scene.io``: the vectorized NumPy
PLY reader (binary little-endian only, activations baked in at load:
``opacity = sigmoid(raw)``, ``scale = exp(raw)``), ``save_ply``, whose
files are byte-equal to the JAX package's for the same scene, and
``make_random_scene``, which draws from the same NumPy generator in the
same order so one seed gives equal arrays in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gaussianrenderer_tpu_torch._device import resolve_device
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene

_PLY_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "short": "<i2",
    "int16": "<i2",
    "ushort": "<u2",
    "uint16": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}


def _scene_from_numpy(arrays, time_params, device) -> GaussianScene:
    dev = resolve_device(device)
    positions, sh, opacity, scales, quats = arrays

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    return GaussianScene(
        positions=t(positions),
        sh=t(sh),
        opacity=t(opacity),
        scales=t(scales),
        quats=t(quats),
        time_params=None if time_params is None else t(time_params),
    )


def _parse_header(f) -> Tuple[str, int, List[Tuple[str, str]], int]:
    """Returns (format, num_vertices, [(type, name)...], header_end_offset)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = ""
    num = -1
    props: List[Tuple[str, str]] = []
    in_vertex_element = False
    while True:
        raw = f.readline()
        if not raw:
            raise ValueError("unexpected EOF in PLY header")
        line = raw.decode("ascii", errors="replace").strip()
        if line == "end_header":
            break
        if line.startswith("comment"):
            continue
        if line.startswith("format "):
            fmt = line[len("format "):]
        elif line.startswith("element "):
            parts = line.split()
            in_vertex_element = parts[1] == "vertex"
            if in_vertex_element:
                num = int(parts[2])
        elif line.startswith("property ") and in_vertex_element:
            parts = line.split()
            if parts[1] == "list":
                raise ValueError("list properties are not supported")
            props.append((parts[1], parts[2]))
    return fmt, num, props, f.tell()


def load_ply(
    path: str,
    max_sh_degree: Optional[int] = 2,
    device="cuda",
) -> GaussianScene:
    """Load a 3DGS PLY into a ``GaussianScene`` on ``device``.

    ``max_sh_degree`` 2 keeps 24 rest coefficients; 3 keeps 45; ``None``
    keeps the file's own stored degree (the highest complete SH band its
    ``f_rest`` properties cover, capped at 3).
    """
    if max_sh_degree is None:
        with open(path, "rb") as f:
            _, _, props, _ = _parse_header(f)
        n_rest = sum(1 for _, n in props if n.startswith("f_rest_"))
        max_sh_degree = next(
            d for d in (3, 2, 1, 0) if 3 * ((d + 1) ** 2 - 1) <= n_rest
        )
    arrays, time_params = _load_ply_numpy(path, max_sh_degree)
    return _scene_from_numpy(arrays, time_params, device)


def _load_ply_numpy(path: str, max_sh_degree: int):
    with open(path, "rb") as f:
        fmt, num, props, _ = _parse_header(f)
        if fmt != "binary_little_endian 1.0":
            raise ValueError(f"unsupported PLY format: {fmt!r}")
        dtype = np.dtype(
            [(f"p{i}", _PLY_DTYPES[t]) for i, (t, _) in enumerate(props)]
        )
        data = np.fromfile(f, dtype=dtype, count=num)
    if data.shape[0] != num:
        raise ValueError(
            f"PLY body truncated: expected {num} vertices, got {data.shape[0]}"
        )

    name_to_col: Dict[str, int] = {name: i for i, (_, name) in enumerate(props)}

    def col(name: str, default: Optional[float] = None) -> np.ndarray:
        if name in name_to_col:
            return np.ascontiguousarray(
                data[f"p{name_to_col[name]}"], dtype=np.float32
            )
        if default is None:
            raise ValueError(f"PLY missing required property {name!r}")
        return np.full(num, default, dtype=np.float32)

    positions = np.stack([col("x"), col("y"), col("z")], axis=1)

    n_rest = 3 * ((max_sh_degree + 1) ** 2 - 1)
    sh = np.zeros((num, 3 + n_rest), dtype=np.float32)
    for c in range(3):
        sh[:, c] = col(f"f_dc_{c}", 0.0)
    for j in range(n_rest):
        sh[:, 3 + j] = col(f"f_rest_{j}", 0.0)

    raw_opacity = col("opacity", 0.0)
    opacity = 1.0 / (1.0 + np.exp(-raw_opacity))
    scales = np.exp(
        np.stack(
            [col("scale_0", 0.0), col("scale_1", 0.0), col("scale_2", 0.0)],
            axis=1,
        )
    )
    quats = np.stack(
        [col(f"rot_{i}", 1.0 if i == 0 else 0.0) for i in range(4)], axis=1
    )

    # Optional spacetime (4D) fields, in either naming: (t_center, t_sigma,
    # vx, vy, vz) or SpacetimeGaussians' (trbf_center, log trbf_scale,
    # motion_0..2).
    time_params = None
    if "t_center" in name_to_col:
        fields = [col("t_center"), col("t_sigma", 0.1)]
        if "vx" in name_to_col:
            fields += [col("vx", 0.0), col("vy", 0.0), col("vz", 0.0)]
        time_params = np.stack(fields, axis=1)
    elif "trbf_center" in name_to_col:
        fields = [
            col("trbf_center"),
            np.exp(col("trbf_scale", np.log(0.1))),
        ]
        if "motion_0" in name_to_col:
            fields += [col(f"motion_{i}", 0.0) for i in range(3)]
        time_params = np.stack(fields, axis=1)

    return (positions, sh, opacity, scales, quats), time_params


def save_ply(scene: GaussianScene, path: str) -> None:
    """Write a scene as a binary little-endian 3DGS PLY.

    Inverts the load-time activations (logit of opacity, log of scale),
    so a round trip keeps the on-disk convention. Spacetime scenes also
    write ``t_center, t_sigma`` (and ``vx, vy, vz`` for (N, 5) motion),
    raw, which :func:`load_ply` reads back."""

    def arr(x):
        return x.detach().cpu().numpy().astype(np.float32, copy=False)

    positions, sh, opacity, scales, quats = (
        arr(scene.positions), arr(scene.sh), arr(scene.opacity), arr(scene.scales),
        arr(scene.quats))
    tp = None if scene.time_params is None else arr(scene.time_params)
    n = positions.shape[0]
    n_rest = sh.shape[1] - 3

    eps = 1e-7
    op = np.clip(opacity, eps, 1.0 - eps)
    raw_opacity = np.log(op / (1.0 - op))
    raw_scales = np.log(np.maximum(scales, 1e-30))

    names = (
        ["x", "y", "z", "nxx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(n_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    if tp is not None:
        names += ["t_center", "t_sigma"] + (["vx", "vy", "vz"] if tp.shape[1] >= 5 else [])
    body = np.zeros((n, len(names)), dtype="<f4")
    body[:, 0:3] = positions
    body[:, 6:9] = sh[:, :3]
    body[:, 9 : 9 + n_rest] = sh[:, 3:]
    body[:, 9 + n_rest] = raw_opacity
    body[:, 10 + n_rest : 13 + n_rest] = raw_scales
    body[:, 13 + n_rest : 17 + n_rest] = quats
    if tp is not None:
        body[:, 17 + n_rest : 17 + n_rest + tp.shape[1]] = tp

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        body.tofile(f)


def make_random_scene(
    num: int,
    seed: int = 0,
    extent: float = 2.0,
    sh_degree: int = 2,
    scale_range: Tuple[float, float] = (0.01, 0.12),
    spacetime: bool = False,
    device="cuda",
) -> GaussianScene:
    """Synthetic scene generator for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    positions = rng.uniform(-extent, extent, size=(num, 3)).astype(np.float32)
    n_coeff = (sh_degree + 1) ** 2
    sh = np.zeros((num, 3 * n_coeff), dtype=np.float32)
    sh[:, :3] = rng.normal(0.0, 1.0, size=(num, 3)).astype(np.float32)
    if n_coeff > 1:
        sh[:, 3:] = rng.normal(
            0.0, 0.15, size=(num, 3 * (n_coeff - 1))
        ).astype(np.float32)
    opacity = rng.uniform(0.05, 0.95, size=num).astype(np.float32)
    scales = rng.uniform(*scale_range, size=(num, 3)).astype(np.float32)
    quats = rng.normal(size=(num, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    time_params = None
    if spacetime:
        centers = rng.uniform(0.0, 1.0, size=num).astype(np.float32)
        sigmas = rng.uniform(0.05, 0.3, size=num).astype(np.float32)
        vel = rng.normal(0.0, 0.08 * extent, size=(num, 3)).astype(np.float32)
        time_params = np.concatenate(
            [np.stack([centers, sigmas], axis=1), vel], axis=1
        )
    return _scene_from_numpy(
        (positions, sh, opacity, scales, quats), time_params, device
    )
