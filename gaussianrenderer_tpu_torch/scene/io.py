"""Scene loading and the seeded scene generators (PyTorch port).

Counterpart of ``gaussianrenderer_tpu.scene.io``: ``load_ply`` through
the C++ reader (``native/ply_native.py``) or the vectorized NumPy reader
(binary little-endian only, activations baked in at load:
``opacity = sigmoid(raw)``, ``scale = exp(raw)``), ``save_ply``, whose
files are byte-equal to the JAX package's for the same scene,
``load_scene`` (PLY, ``.gsz`` or ``.splat`` by extension), and
``make_random_scene``, ``make_surface_scene`` and ``make_clustered_scene``,
which draw from the same NumPy generator in the same order so one seed
gives equal arrays in both packages.
"""

from __future__ import annotations

import math
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


def to_numpy(x, dtype=np.float32) -> np.ndarray:
    """A tensor (on any device) or array as a NumPy array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


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
    use_native: bool = True,
    device="cuda",
) -> GaussianScene:
    """Load a 3DGS PLY into a ``GaussianScene`` on ``device``.

    ``max_sh_degree`` 2 keeps 24 rest coefficients; 3 keeps 45; ``None``
    keeps the file's own stored degree (the highest complete SH band its
    ``f_rest`` properties cover, capped at 3).

    ``use_native`` reads through the C++ reader (``native/ply_native.py``),
    as the JAX package does by default; its f32 ``exp`` rounds opacities
    and scales a few ulp apart from the NumPy reader's. A spacetime (4D)
    file, an unreadable header or a file the C++ reader refuses (ascii, a
    truncated body) takes the NumPy reader, which loads it or raises
    ``ValueError``. So does a header the C++ reader would not read within
    its buffers (an index such as ``scale_3`` or ``rot_-1``) or would leave
    a field of unset (no ``x``/``y``/``z``, ``opacity`` or ``scale_*``):
    ``ply_native.check_header``. A C++ reader that cannot be built raises.
    """
    # The C++ reader does not know the spacetime properties: sniff the
    # header first and send 4D files to the NumPy reader.
    has_time = False
    try:
        with open(path, "rb") as f:
            _, _, props, _ = _parse_header(f)
        pnames = {name for _, name in props}
        has_time = bool(pnames & {"t_center", "trbf_center"})
        if max_sh_degree is None:
            n_rest = sum(1 for n in pnames if n.startswith("f_rest_"))
            max_sh_degree = next(
                d for d in (3, 2, 1, 0) if 3 * ((d + 1) ** 2 - 1) <= n_rest
            )
    except (OSError, ValueError, IndexError):
        if max_sh_degree is None:
            max_sh_degree = 2  # an unreadable header: the NumPy reader reports

    arrays = time_params = None
    if use_native and not has_time:
        from gaussianrenderer_tpu_torch.native import ply_native

        try:
            arrays = ply_native.load(path, max_sh_degree)
        except (ValueError, MemoryError):
            # Refused, unsafe for the C++ reader, or a header count too
            # large to allocate. A failed build raises RuntimeError, which
            # goes on to the caller.
            arrays = None
    if arrays is None:
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
    positions, sh, opacity, scales, quats = (
        to_numpy(scene.positions), to_numpy(scene.sh), to_numpy(scene.opacity),
        to_numpy(scene.scales), to_numpy(scene.quats))
    tp = None if scene.time_params is None else to_numpy(scene.time_params)
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


def load_scene(path: str, device="cuda", **kwargs) -> GaussianScene:
    """Load a scene by extension: ``.gsz`` (the compact quantized
    container) or ``.splat`` (the web-viewer format), both in
    :mod:`gaussianrenderer_tpu_torch.scene.compact`, else PLY
    (:func:`load_ply` with ``kwargs``). For ``.gsz`` and ``.splat`` the
    one option is ``max_sh_degree``, which truncates the SH columns as
    ``load_ply`` does (it never pads)."""
    if not path.endswith((".gsz", ".splat")):
        return load_ply(path, device=device, **kwargs)
    from gaussianrenderer_tpu_torch.scene import compact

    ext = path[path.rindex("."):]
    max_deg = kwargs.pop("max_sh_degree", None)
    if kwargs:
        raise TypeError(f"unsupported {ext} load options: {kwargs}")
    loader = compact.load_splat if ext == ".splat" else compact.load_compact
    scene = loader(path, device=device)
    if max_deg is not None:
        keep = 3 * (max_deg + 1) ** 2
        if keep < scene.sh.shape[1]:
            scene = scene._replace(sh=scene.sh[:, :keep].contiguous())
    return scene


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


def make_surface_scene(
    num: int,
    seed: int = 0,
    sh_degree: int = 1,
    spacetime: bool = False,
    device="cuda",
) -> GaussianScene:
    """Parametric-surface scene: splats on a checkerboard ground plane, a
    hue-shaded sphere, a torus and a box, each flattened along and
    oriented to the local surface normal, so renders show crisp occlusion
    and silhouettes. ``spacetime`` gives each object a rigid velocity and
    a fade window (the ground static and always on)."""
    rng = np.random.default_rng(seed)
    # Budget split: ground 35%, sphere 25%, torus 25%, box 15%.
    n_g = int(num * 0.35)
    n_s = int(num * 0.25)
    n_t = int(num * 0.25)
    n_b = num - n_g - n_s - n_t

    def checker(u, v):
        c = ((np.floor(u * 2) + np.floor(v * 2)) % 2)[:, None]
        return c * np.array([[0.88, 0.86, 0.82]]) + (1 - c) * np.array([[0.22, 0.25, 0.3]])

    # Ground plane y=0, |x|,|z| ≤ 3.2.
    gx = rng.uniform(-3.2, 3.2, n_g)
    gz = rng.uniform(-3.2, 3.2, n_g)
    p_g = np.stack([gx, np.zeros(n_g), gz], 1)
    n_gn = np.tile([0.0, 1.0, 0.0], (n_g, 1))
    c_g = checker(gx, gz)

    # Sphere r=0.85 at (-1.15, 0.85, 0.1), coloured from the normal.
    d = rng.normal(size=(n_s, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p_s = np.array([-1.15, 0.85, 0.1]) + 0.85 * d
    c_s = 0.5 + 0.45 * d
    n_sn = d

    # Torus R=0.72 r=0.28 at (1.25, 0.62, 0.35), axis +y.
    u = rng.uniform(0, 2 * np.pi, n_t)
    v = rng.uniform(0, 2 * np.pi, n_t)
    ring = np.stack([np.cos(u), np.zeros(n_t), np.sin(u)], 1)
    n_tn = (np.cos(v)[:, None] * ring
            + np.sin(v)[:, None] * np.tile([0.0, 1.0, 0.0], (n_t, 1)))
    p_t = np.array([1.25, 0.62, 0.35]) + 0.72 * ring + 0.28 * n_tn
    c_t = np.stack([0.85 + 0.1 * np.cos(u), 0.35 + 0.2 * np.sin(2 * u),
                    0.25 + 0.1 * np.sin(u)], 1)

    # Box 0.9×1.0×0.9 at (0.05, 0.5, -1.45): uniform faces, flat colours.
    face = rng.integers(0, 6, n_b)
    ax, sgn = face // 2, (face % 2) * 2.0 - 1.0
    uv = rng.uniform(-0.5, 0.5, (n_b, 2))
    p_b = np.zeros((n_b, 3))
    n_bn = np.zeros((n_b, 3))
    n_bn[np.arange(n_b), ax] = sgn
    half = np.array([0.45, 0.5, 0.45])
    for a in range(3):
        m = ax == a
        others = [i for i in range(3) if i != a]
        p_b[m, a] = sgn[m] * half[a]
        p_b[m, others[0]] = uv[m, 0] * 2 * half[others[0]]
        p_b[m, others[1]] = uv[m, 1] * 2 * half[others[1]]
    p_b += np.array([0.05, 0.5, -1.45])
    face_colors = np.array(
        [[0.9, 0.55, 0.2], [0.9, 0.55, 0.2], [0.3, 0.7, 0.4],
         [0.25, 0.45, 0.85], [0.35, 0.65, 0.8], [0.35, 0.65, 0.8]]
    )
    c_b = face_colors[face]

    pos = np.concatenate([p_g, p_s, p_t, p_b]).astype(np.float32)
    nrm = np.concatenate([n_gn, n_sn, n_tn, n_bn]).astype(np.float32)
    col = np.concatenate([c_g, c_s, c_t, c_b]).astype(np.float32)

    # Tangent disk size from the surface area per splat (≈ 63 units² in all).
    area = np.array([40.96, 9.08, 7.96, 5.22])
    per = [n_g, n_s, n_t, n_b]
    s_tan = np.concatenate(
        [np.full(k, 1.6 * math.sqrt(a / max(k, 1))) for a, k in zip(area, per)]
    ).astype(np.float32)
    s_tan *= rng.uniform(0.7, 1.4, num).astype(np.float32)
    scales = np.stack([s_tan, s_tan, 0.12 * s_tan], 1)  # flat along the normal

    # Quaternion rotating local +z onto the surface normal: axis = z×n.
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(np.tile(z, (num, 1)), nrm)
    s_ = np.linalg.norm(axis, axis=1)
    w = 1.0 + nrm @ z  # 2·cos²(θ/2)
    quats = np.concatenate([w[:, None], axis], 1)
    flip = s_ < 1e-6  # n ≈ ±z: identity or a 180° tangent flip
    quats[flip] = np.where(nrm[flip, 2:3] > 0, [1.0, 0, 0, 0], [0.0, 1, 0, 0])
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)

    n_coeff = (sh_degree + 1) ** 2
    sh = np.zeros((num, 3 * n_coeff), np.float32)
    sh[:, :3] = (col - 0.5) / 0.28209479177387814

    time_params = None
    if spacetime:
        # Rigid per-object motion: the sphere drifts +x, the torus −x, the
        # box rises; the ground is static and always on.
        obj = np.concatenate([np.full(n_g, 0), np.full(n_s, 1), np.full(n_t, 2),
                              np.full(n_b, 3)])
        vel_table = np.array([[0.0, 0.0, 0.0], [1.1, 0.0, 0.3], [-1.0, 0.0, -0.3],
                              [0.0, 0.9, 0.0]], np.float32)
        tc_table = np.array([0.5, 0.3, 0.5, 0.7], np.float32)
        ts_table = np.array([10.0, 0.22, 0.22, 0.22], np.float32)
        time_params = np.concatenate(
            [tc_table[obj][:, None], ts_table[obj][:, None], vel_table[obj]], axis=1
        ).astype(np.float32)

    return _scene_from_numpy(
        (pos, sh, np.full(num, 0.92, np.float32), scales, quats), time_params, device)


def make_clustered_scene(
    num: int,
    seed: int = 0,
    extent: float = 2.0,
    sh_degree: int = 2,
    spacetime: bool = False,
    device="cuda",
) -> GaussianScene:
    """Synthetic scene with trained-3DGS statistics: splats clustered on
    object blobs and a ground plane with a sparse far background shell,
    log-normal scales with a heavy tail, flattened anisotropy and bimodal
    opacity. ``spacetime`` adds (t_center, t_sigma, vx, vy, vz)."""
    rng = np.random.default_rng(seed)
    n_ground = int(num * 0.35)
    n_shell = int(num * 0.15)
    n_obj = num - n_ground - n_shell

    # Object clusters: anisotropic blobs scattered over the ground patch.
    k = max(4, min(24, num // 2000))
    centers = rng.uniform(-0.7 * extent, 0.7 * extent, size=(k, 3))
    centers[:, 1] = rng.uniform(-0.2 * extent, 0.5 * extent, size=k)
    cluster_id = rng.integers(0, k, size=n_obj)
    cluster_scale = rng.uniform(0.08, 0.3, size=(k, 3)) * extent
    pos_obj = centers[cluster_id] + rng.normal(size=(n_obj, 3)) * cluster_scale[cluster_id]

    # Ground plane patch with small height noise.
    pos_gnd = np.stack(
        [
            rng.uniform(-extent, extent, size=n_ground),
            -0.4 * extent + rng.normal(0.0, 0.01 * extent, size=n_ground),
            rng.uniform(-extent, extent, size=n_ground),
        ],
        axis=1,
    )

    # Sparse far background shell.
    u = rng.normal(size=(n_shell, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
    pos_sh = u * rng.uniform(2.5, 6.0, size=(n_shell, 1)) * extent

    positions = np.concatenate([pos_obj, pos_gnd, pos_sh]).astype(np.float32)

    # Log-normal scales; background splats bigger; surface splats flattened.
    base = np.exp(rng.normal(np.log(0.005 * extent), 0.55, size=(num, 1)))
    base[n_obj + n_ground:] *= 4.0
    np.clip(base, None, 0.12 * extent, out=base)
    aniso = np.exp(rng.normal(0.0, 0.35, size=(num, 3)))
    scales = (base * aniso).astype(np.float32)
    flat_axis = rng.integers(0, 3, size=num)
    flatten = rng.uniform(0.1, 0.35, size=num)
    scales[np.arange(num), flat_axis] *= flatten.astype(np.float32)

    # Bimodal opacity.
    hi = rng.random(num) < 0.55
    logits = np.where(hi, rng.normal(2.0, 1.0, num), rng.normal(-2.5, 1.0, num))
    opacity = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)

    n_coeff = (sh_degree + 1) ** 2
    sh = np.zeros((num, 3 * n_coeff), dtype=np.float32)
    palette = rng.uniform(-1.2, 1.2, size=(k + 2, 3))
    which = np.concatenate([cluster_id, np.full(n_ground, k), np.full(n_shell, k + 1)])
    sh[:, :3] = (palette[which] + rng.normal(0.0, 0.25, size=(num, 3))).astype(np.float32)
    if n_coeff > 1:
        sh[:, 3:] = rng.normal(0.0, 0.12, size=(num, 3 * (n_coeff - 1))).astype(np.float32)

    quats = rng.normal(size=(num, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    time_params = None
    if spacetime:
        t_centers = rng.uniform(0.0, 1.0, size=num).astype(np.float32)
        t_sigmas = rng.uniform(0.05, 0.3, size=num).astype(np.float32)
        vel = rng.normal(0.0, 0.08 * extent, size=(num, 3)).astype(np.float32)
        time_params = np.concatenate([np.stack([t_centers, t_sigmas], axis=1), vel], axis=1)
    return _scene_from_numpy((positions, sh, opacity, scales, quats), time_params, device)
