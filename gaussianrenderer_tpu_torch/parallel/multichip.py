"""Multi-device rendering over ``torch.distributed``: one rank per process
(PyTorch port of ``parallel/multichip.py``).

Every rank holds a contiguous block of the scene's splats
(:func:`shard_scene`) and owns a strip of tile rows, or a rect of tiles,
of the frame:

* **splat-parallel projection**: each rank culls, colors and projects
  its own block, with no communication;
* **record exchange**: only screen-space records travel. ``gather32``
  all-gathers a 22-f32 (88 B) record, the one the differentiable path
  takes (the backward of its all-gather sums each rank's feature
  gradients onto the rank that owns the splats); ``gather_q`` all-gathers
  the quantized 28 B record (``ops.instances.encode_record_rows``);
  ``a2a_q`` ships each record only to the strips its tile rect touches,
  with one uneven all-to-all;
* **strip-parallel compositing**: each rank sorts and composites only
  the instances on its strip, with the single device's kernels (the
  packed compositor ``csrc/tile_render2.cu``; under ``diff`` the
  training compositor ``csrc/tile_train.cu``) on the strip's grid;
* **reassembly**: the strips are all-gathered, so every rank returns the
  whole frame, and the stats flags are MAX-reduced.

The JAX package runs all chips from one controller under ``shard_map``
with static shapes. Here every rank runs this code on its own shard;
shapes follow the data, so the ``a2a_q`` windows carry exact counts
(first a small all-to-all of the counts) and never truncate.

:func:`make_mesh` wraps an initialized process group; :func:`spawn`
starts ranks as processes for tests and smoke runs (``torchrun
--nproc-per-node D`` with ``make_mesh()`` works as well). NCCL needs a
card per rank; ranks that share one card, or run on the CPU, use gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import shutil
import tempfile
import time
import traceback
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gaussianrenderer_tpu_torch._device import resolve_device
from gaussianrenderer_tpu_torch.config import RenderConfig
from gaussianrenderer_tpu_torch.ops.compositing import (
    FEAT_CONIC_A,
    FEAT_CX,
    FEAT_CY,
    FEAT_DIM,
    FEAT_OPACITY,
    FEAT_R,
    FEAT_XMIN,
    FEAT_YMAX,
    FEAT_YMIN,
    build_features,
    composite_tiles_diff,
    composite_tiles_xla,
    gather_sorted_features,
    gather_sorted_features_seg,
)
from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import composite_tiles_packed
from gaussianrenderer_tpu_torch.ops.instances import (
    EXCHANGE_ROWS,
    build_packed_instances,
    decode_record_rows,
    encode_record_rows,
    packed_valid_np,
    u32_to_i32,
)
from gaussianrenderer_tpu_torch.ops.projection import (
    ProjectedGaussians,
    preprocess_gaussians,
    slice_spacetime,
)
from gaussianrenderer_tpu_torch.ops.tile_train import (
    composite_tiles_train,
    train_kernel_compatible,
)
from gaussianrenderer_tpu_torch.ops.tiling import build_sorted_instances
from gaussianrenderer_tpu_torch.render import _finish_fb
from gaussianrenderer_tpu_torch.scene.camera import CameraParams
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene

_U32 = 0xFFFFFFFF


# ------------------------------------------------------------------ the mesh
@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the devices: the process group, its rank and
    size D, the device its tensors live on and the group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def choose_backend(world_size: int, device="cuda") -> str:
    """``nccl`` when every one of ``world_size`` ranks can have a card of
    its own, ``gloo`` when ranks share a card or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def make_mesh(device=None, *, backend: Optional[str] = None) -> Mesh:
    """The mesh of the default process group.

    Without a group yet, one is started from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) with
    ``backend``, or :func:`choose_backend`'s. ``device`` is this rank's
    device; by default an NCCL rank takes ``cuda:LOCAL_RANK`` and a gloo
    rank the card (``"cuda"``, which raises without one). The choice is
    made once and printed by rank 0."""
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        backend = backend or choose_backend(world, device or "cuda")
        dist.init_process_group(backend)
    group_backend = str(dist.get_backend())
    if backend is not None and backend != group_backend:
        raise ValueError(f"make_mesh: the process group runs {group_backend!r}, "
                         f"not {backend!r}")
    rank, size = dist.get_rank(), dist.get_world_size()
    if device is not None:
        dev = resolve_device(device)
    elif group_backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        dev = resolve_device("cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group_backend == "nccl" and dev.type != "cuda":
        raise ValueError("make_mesh: an NCCL group needs a CUDA device per rank")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rank == 0:
        print(f"make_mesh: {size} rank(s) over {group_backend}, rank 0 on {dev}",
              flush=True)
    return Mesh(dist.group.WORLD, rank, size, dev, group_backend)


def _rank_main(fn, args, rank, world, backend, device, store, timeout, queue):
    """One spawned rank: join the group, run ``fn(mesh, *args)``, post
    ``(rank, ok, result or traceback)``."""
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        elif backend == "nccl":
            dev = torch.device("cuda", rank)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(make_mesh(dev, backend=backend), *args)
        queue.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — every failure goes to the parent
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: Optional[str] = None, device="cuda",
          timeout: float = 300.0):
    """Run ``fn(mesh, *args)`` on ``world_size`` new rank processes and
    return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable; return host data, not CUDA tensors.
    The ranks use the ``spawn`` start method, a ``file://`` store in a
    fresh temporary directory (no TCP port), one torch thread each on the
    CPU, and ``init_process_group(timeout=timeout)``. ``backend`` defaults
    to :func:`choose_backend`'s. If a rank raises, every rank is killed
    and the first error is raised here as ``RuntimeError``; if the ranks
    have not all returned ``timeout`` seconds after the start, every rank
    is killed and ``TimeoutError`` is raised."""
    import multiprocessing as mp
    import queue as queue_mod

    backend = backend or choose_backend(world_size, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="gr_spawn_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, world_size, backend, str(device), store,
                               timeout, results))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, res = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: ranks {sorted(set(range(world_size)) - set(out))}"
                                       f" did not finish within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]


# ------------------------------------------------------------- collectives
def _all_gather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Equal-shape all-gather, concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def _all_to_all_rows(mesh: Mesh, x: torch.Tensor, send: Sequence[int],
                     recv: Sequence[int]) -> torch.Tensor:
    """Uneven all-to-all along dim 0: rows ``[Σsend[:c], Σsend[:c+1])`` go to
    rank ``c``; the result holds ``recv[s]`` rows from each rank ``s``,
    source-major."""
    out = x.new_empty((int(sum(recv)),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), [int(v) for v in recv],
                           [int(v) for v in send], group=mesh.group)
    return out


def _all_reduce(mesh: Mesh, x: torch.Tensor, op) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


class _AllGatherRows(torch.autograd.Function):
    """All-gather of equal row blocks whose backward is the reduce-scatter
    sum: block ``c`` of every rank's cotangent goes to rank ``c`` by one
    all-to-all and is summed over the sources in rank order."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(mesh, x, 0)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n = g.shape[0] // mesh.size
        got = _all_to_all_rows(mesh, g, [n] * mesh.size, [n] * mesh.size)
        return got.view(mesh.size, n, *g.shape[1:]).sum(0), None


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's equal row block of ``x``, concatenated in rank order;
    differentiable, with each rank's gradient rows summed onto their
    owner."""
    if x.requires_grad and torch.is_grad_enabled():
        return _AllGatherRows.apply(x, mesh)
    return _all_gather(mesh, x, 0)


def _shard_rows(x: Optional[torch.Tensor], mesh: Mesh) -> Optional[torch.Tensor]:
    if x is None:
        return None
    ns = x.shape[0] // mesh.size
    return x[mesh.rank * ns:(mesh.rank + 1) * ns].to(mesh.device).contiguous()


def shard_scene(scene: GaussianScene, mesh: Mesh) -> GaussianScene:
    """Pad N up to a multiple of the mesh size (:meth:`GaussianScene.pad_to`)
    and return this rank's contiguous block, rows ``[rank·N/D,
    (rank+1)·N/D)``, on the rank's device."""
    d = mesh.size
    padded = scene.pad_to(-(-scene.num_gaussians // d) * d)
    return GaussianScene(*(_shard_rows(x, mesh) for x in padded))


# ------------------------------------------------------------ host geometry
def balance_strip_bounds(row_loads, n_strips: int) -> Tuple[int, ...]:
    """Contiguous tile-row partition minimizing the largest strip load:
    ``n_strips + 1`` cumulative row boundaries for
    :func:`render_frame_multichip`'s ``strip_bounds``. Binary search on
    the bound, then greedy packing; trailing strips may be empty."""
    loads = [max(0, int(v)) for v in np.asarray(row_loads).ravel()]
    if len(loads) == 0 or n_strips < 1:
        raise ValueError("need ≥1 row and ≥1 strip")

    def parts_needed(cap: int) -> int:
        parts, acc = 1, 0
        for v in loads:
            if v > cap:
                return len(loads) + 1
            if acc + v > cap:
                parts += 1
                acc = v
            else:
                acc += v
        return parts

    lo, hi = max(loads), sum(loads)
    while lo < hi:
        mid = (lo + hi) // 2
        if parts_needed(mid) <= n_strips:
            hi = mid
        else:
            lo = mid + 1
    bounds, acc = [0], 0
    for i, v in enumerate(loads):
        if acc + v > lo and len(bounds) < n_strips:
            bounds.append(i)
            acc = v
        else:
            acc += v
    bounds += [len(loads)] * (n_strips + 1 - len(bounds))
    return tuple(bounds)


def row_loads_from_rects(tmin_y, tmax_y, rect_w, valid, tiles_y) -> np.ndarray:
    """Instance lanes per tile row from tile-rect arrays (NumPy): a splat
    adds its rect width to every row its rect covers (a difference array
    and a prefix sum)."""
    use = np.asarray(valid) & (tmax_y >= 0) & (tmin_y < tiles_y)
    lo = np.clip(tmin_y[use], 0, tiles_y - 1)
    hi = np.clip(tmax_y[use], 0, tiles_y - 1)
    w = np.asarray(rect_w)[use].astype(np.int64)
    d = np.zeros(tiles_y + 1, np.int64)
    np.add.at(d, lo, w)
    np.subtract.at(d, hi + 1, w)
    return np.cumsum(d)[:tiles_y]


def _probe(scene: GaussianScene, cam: CameraParams, cfg: RenderConfig):
    """One pose's projection, no gradient: the calibration probes' input."""
    with torch.no_grad():
        return preprocess_gaussians(
            scene, cam, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
            tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            sh_degree=cfg.sh_degree, quantize_centers=cfg.quantize_centers,
            ewa_dilation=cfg.ewa_dilation, ewa_compensate=cfg.ewa_compensate,
        )


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def strip_row_loads(scene: GaussianScene, cam: CameraParams,
                    cfg: RenderConfig) -> np.ndarray:
    """Instance lanes per tile row for one pose, over the packed emitter's
    population: the :func:`balance_strip_bounds` input."""
    proj = _probe(scene, cam, cfg)
    valid = packed_valid_np(_np(proj.valid), _np(proj.opacity))
    tmin, tmax = _np(proj.tile_min), _np(proj.tile_max)
    rect_w = (tmax[:, 0] - tmin[:, 0] + 1).astype(np.int64)
    return row_loads_from_rects(tmin[:, 1], tmax[:, 1], rect_w, valid, cfg.tiles_y)


def strip_geometry(strip_bounds: Tuple[int, ...], num_devices: int,
                   tiles_y: int) -> Tuple[Tuple[int, ...], int]:
    """Validate ``strip_bounds`` and return ``(rows per strip, rows_max)``:
    the one derivation the render, the training loss and the reassembly
    share."""
    if (
        len(strip_bounds) != num_devices + 1
        or strip_bounds[0] != 0
        or strip_bounds[-1] != tiles_y
        or any(strip_bounds[i] > strip_bounds[i + 1] for i in range(num_devices))
    ):
        raise ValueError(
            f"strip_bounds must be {num_devices + 1} non-decreasing row "
            f"boundaries from 0 to tiles_y={tiles_y}, got {strip_bounds}"
        )
    diffs = tuple(strip_bounds[i + 1] - strip_bounds[i] for i in range(num_devices))
    return diffs, max(max(diffs), 1)


def balance_strips_for_scene(scene: GaussianScene, cam: CameraParams,
                             cfg: RenderConfig, n_strips: int) -> Tuple[int, ...]:
    """``strip_bounds`` balanced on one pose's per-row loads."""
    return balance_strip_bounds(strip_row_loads(scene, cam, cfg), n_strips)


def tile_loads_from_rects(tmin, tmax, valid, tiles_x: int, tiles_y: int) -> np.ndarray:
    """Instance lanes per tile from tile-rect arrays (NumPy): a 4-corner
    difference array and a double prefix sum."""
    tmin = np.asarray(tmin)
    tmax = np.asarray(tmax)
    use = (
        np.asarray(valid)
        & (tmax[:, 1] >= 0) & (tmin[:, 1] < tiles_y)
        & (tmax[:, 0] >= 0) & (tmin[:, 0] < tiles_x)
    )
    x0 = np.clip(tmin[use, 0], 0, tiles_x - 1)
    x1 = np.clip(tmax[use, 0], 0, tiles_x - 1)
    y0 = np.clip(tmin[use, 1], 0, tiles_y - 1)
    y1 = np.clip(tmax[use, 1], 0, tiles_y - 1)
    d = np.zeros((tiles_y + 1, tiles_x + 1), np.int64)
    np.add.at(d, (y0, x0), 1)
    np.subtract.at(d, (y0, x1 + 1), 1)
    np.subtract.at(d, (y1 + 1, x0), 1)
    np.add.at(d, (y1 + 1, x1 + 1), 1)
    return np.cumsum(np.cumsum(d, axis=0), axis=1)[:tiles_y, :tiles_x]


def balance_strip_rects(tile_loads, n_strips: int):
    """2-D balanced rects: contiguous row bands, each split into column
    ranges, over every (bands, columns) factorization of ``n_strips``.
    Returns ``((row_bounds, col_bounds_per_band), slack)`` of the best,
    slack being the worst rect's load over the ideal; ranks are ordered
    band-major."""
    loads = np.asarray(tile_loads, np.int64)
    tiles_y, tiles_x = loads.shape
    ideal = max(loads.sum() / max(n_strips, 1), 1.0)
    best = None
    for bands in range(1, n_strips + 1):
        if n_strips % bands:
            continue
        cols = n_strips // bands
        if bands > tiles_y or cols > tiles_x:
            continue
        row_bounds = balance_strip_bounds(loads.sum(axis=1), bands)
        col_bounds = []
        worst = 0
        for b in range(bands):
            y0, y1 = row_bounds[b], row_bounds[b + 1]
            band = loads[y0:y1]
            if band.size == 0:  # an empty band: all columns to its last rect
                cb = tuple([0] * cols + [tiles_x])
            else:
                cb = balance_strip_bounds(band.sum(axis=0), cols)
            col_bounds.append(tuple(cb))
            for j in range(cols):
                worst = max(worst, int(loads[y0:y1, cb[j]:cb[j + 1]].sum()))
        slack = worst / ideal
        if best is None or slack < best[2]:
            best = (tuple(row_bounds), tuple(col_bounds), slack)
    if best is None:
        raise ValueError(
            f"no rect factorization of {n_strips} fits a {tiles_y}x{tiles_x} grid"
        )
    return (best[0], best[1]), best[2]


def rect_geometry(strip_rects, num_devices: int, tiles_y: int, tiles_x: int):
    """Validate a ``(row_bounds, col_bounds_per_band)`` rect spec and return
    ``(rects, rows_max, cols_max)``, ``rects[rank] = (y0, rows, x0,
    cols)`` in band-major order."""
    row_bounds, col_bounds = strip_rects
    bands = len(row_bounds) - 1
    if row_bounds[0] != 0 or row_bounds[-1] != tiles_y or any(
        row_bounds[i] > row_bounds[i + 1] for i in range(bands)
    ):
        raise ValueError(f"bad rect row_bounds {row_bounds}")
    if len(col_bounds) != bands:
        raise ValueError("col_bounds must have one tuple per row band")
    rects = []
    for b in range(bands):
        cb = col_bounds[b]
        if cb[0] != 0 or cb[-1] != tiles_x or any(
            cb[i] > cb[i + 1] for i in range(len(cb) - 1)
        ):
            raise ValueError(f"bad rect col_bounds {cb}")
        for j in range(len(cb) - 1):
            rects.append((row_bounds[b], row_bounds[b + 1] - row_bounds[b], cb[j],
                          cb[j + 1] - cb[j]))
    if len(rects) != num_devices:
        raise ValueError(f"rect spec yields {len(rects)} rects for {num_devices} chips")
    rows_max = max(max(r[1] for r in rects), 1)
    cols_max = max(max(r[3] for r in rects), 1)
    return tuple(rects), rows_max, cols_max


def balance_rects_for_scene(scene: GaussianScene, cam: CameraParams, cfg: RenderConfig,
                            n_strips: int):
    """``(strip_rects, slack)`` balanced on one pose's per-tile loads."""
    proj = _probe(scene, cam, cfg)
    valid = packed_valid_np(_np(proj.valid), _np(proj.opacity))
    loads = tile_loads_from_rects(_np(proj.tile_min), _np(proj.tile_max), valid,
                                  cfg.tiles_x, cfg.tiles_y)
    return balance_strip_rects(loads, n_strips)


def a2a_caps_for_scene(scene: GaussianScene, cams, cfg: RenderConfig, n_strips: int,
                       strip_bounds: Optional[Tuple[int, ...]] = None,
                       margin: float = 1.5) -> Tuple[int, int, int]:
    """The JAX package's calibration of the ``a2a_q`` window capacities
    ``(cap, wide_cap, straddle_cap)`` over one or more poses: per (source
    block, destination strip) the first-destination records, the 2-strip
    straddlers and the wide records, times ``margin``. The port's
    exchange sends exact counts and does not read them."""
    if isinstance(cams, CameraParams) or not isinstance(cams, (list, tuple)):
        cams = [cams]
    d = n_strips
    if strip_bounds is None:
        if cfg.tiles_y % d != 0:
            raise ValueError(f"tiles_y={cfg.tiles_y} not divisible by {d}; pass strip_bounds")
        t_loc = cfg.tiles_y // d
        strip_bounds = tuple(i * t_loc for i in range(d + 1))
    inner = np.asarray(strip_bounds[1:-1])
    n = scene.num_gaussians
    ns = -(-n // d)
    worst_cap, worst_wide, worst_straddle = 0, 0, 0
    for cam in cams:
        proj = _probe(scene, cam, cfg)
        valid = _np(proj.valid)
        tmin_y = _np(proj.tile_min)[:, 1]
        tmax_y = _np(proj.tile_max)[:, 1]
        s0 = np.searchsorted(inner, tmin_y, side="right")
        s1 = np.searchsorted(inner, tmax_y, side="right")
        wide = valid & (s1 - s0 >= 2)
        narrow = valid & ~wide
        for src in range(d):
            lo, hi = src * ns, min((src + 1) * ns, n)
            if lo >= hi:
                continue
            sl = slice(lo, hi)
            cnt = np.bincount(s0[sl][narrow[sl]], minlength=d)
            straddle = narrow[sl] & (s1[sl] > s0[sl])
            scnt = np.bincount(s1[sl][straddle], minlength=d)
            worst_cap = max(worst_cap, int(cnt.max()))
            worst_straddle = max(worst_straddle, int(scnt.max()) if scnt.size else 0)
            worst_wide = max(worst_wide, int(np.sum(wide[sl])))
    cap = max(256, int(math.ceil(worst_cap * margin)))
    wide_cap = max(128, int(math.ceil(worst_wide * margin)))
    straddle_cap = max(64, int(math.ceil(worst_straddle * margin)))
    return cap, wide_cap, straddle_cap


def default_a2a_caps(num_gaussians: int, num_devices: int) -> Tuple[int, int, int]:
    """The JAX package's uncalibrated ``a2a_q`` capacities ``(cap,
    wide_cap, straddle_cap)``; the port's exact-count exchange does not
    read them."""
    ns = -(-num_gaussians // num_devices)
    cap = max(256, -(-3 * ns // num_devices))
    wide_cap = max(128, ns // 64)
    straddle_cap = max(128, ns // max(num_devices * 8, 8))
    return cap, wide_cap, straddle_cap


# --------------------------------------------------------------- the frame
#: This process's last strip (:func:`render_frame_multichip` and the mesh
#: train step): the record exchange's bytes sent and received (the count
#: all-to-all of ``a2a_q`` included), the bytes of strips the reassembly
#: received, and the instances the strip emitted (a 0-d tensor).
last_frame = {"records_sent": 0, "records_received": 0, "strips_received": 0,
              "instances": None}


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """This rank's strip or rect, in tiles, and the computed grid."""

    y0: int
    rows: int
    x0: Optional[int]  # None for row strips
    cols: int
    tiles_y: int  # computed rows (rows_max for balanced strips and rects)
    tiles_x: int


def _geometry(cfg: RenderConfig, d: int, rank: int, strip_bounds, strip_rects) -> _Geometry:
    if strip_rects is not None:
        rects, rows_max, cols_max = rect_geometry(strip_rects, d, cfg.tiles_y, cfg.tiles_x)
        y0, rows, x0, cols = rects[rank]
        return _Geometry(y0, rows, x0, cols, rows_max, cols_max)
    if strip_bounds is None:
        t_loc = cfg.tiles_y // d
        return _Geometry(rank * t_loc, t_loc, None, cfg.tiles_x, t_loc, cfg.tiles_x)
    diffs, rows_max = strip_geometry(strip_bounds, d, cfg.tiles_y)
    return _Geometry(strip_bounds[rank], diffs[rank], None, cfg.tiles_x, rows_max,
                     cfg.tiles_x)


def _global_depth_bits(cfg: RenderConfig) -> int:
    """The whole grid's depth-key width: a strip's smaller grid would
    quantize depth more finely than the single device, and tie groups
    (whose blend order shows) would differ."""
    return min(32 - max(int(cfg.num_tiles).bit_length(), 1), 24)


def _packed_strip_tail(proj_full: ProjectedGaussians, *, cam: CameraParams,
                       cfg: RenderConfig, geo: _Geometry):
    """The single device's packed path on one strip's rebased projection:
    emission, sort and ``csrc/tile_render2.cu``. Returns ``(fb_strip,
    overflow, center_clipped)``."""
    inst = build_packed_instances(
        proj_full, tiles_x=geo.tiles_x, tiles_y=geo.tiles_y, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, near=cam.near, far=cam.far, want_depth=cfg.output_depth,
        depth_bits=_global_depth_bits(cfg),
    )
    fb = composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count, tiles_x=geo.tiles_x,
        tiles_y=geo.tiles_y, tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        width=geo.tiles_x * cfg.tile_w, height=geo.tiles_y * cfg.tile_h,
        chunk=cfg.packed_chunk, out_alpha=cfg.output_alpha or cfg.background is not None,
        depth_row=inst.depth_f32 if cfg.output_depth else None,
    )
    last_frame["instances"] = inst.total_instances
    return _finish_fb(fb, cfg), inst.overflow, inst.center_clipped


def _strip_of(row: torch.Tensor, bounds: Tuple[int, ...]) -> torch.Tensor:
    s = torch.zeros_like(row)
    for b in bounds[1:-1]:
        s = s + (row >= b).to(row.dtype)
    return s


def _destinations(tmin_y, tmax_y, valid, bounds, strip_rects, tmin_x, tmax_x):
    """Per record: first destination, second destination, ``narrow`` (1 or
    2 destinations), ``straddle`` (exactly 2) and ``wide`` (3 or more)."""
    if strip_rects is None:
        s0, s1 = _strip_of(tmin_y, bounds), _strip_of(tmax_y, bounds)
        wide = valid & (s1 - s0 >= 2)
        narrow = valid & ~wide
        return s0, s1, narrow, narrow & (s1 > s0), wide
    row_bounds, col_bounds = strip_rects
    ndest = torch.zeros_like(tmin_y)
    dest0 = torch.zeros_like(tmin_y)
    dest1 = torch.zeros_like(tmin_y)
    found0 = torch.zeros(tmin_y.shape, dtype=torch.bool, device=tmin_y.device)
    found1 = torch.zeros_like(found0)
    base = 0
    for b in range(len(row_bounds) - 1):
        cb = col_bounds[b]
        ov = (tmin_y <= row_bounds[b + 1] - 1) & (tmax_y >= row_bounds[b])
        c0 = _strip_of(tmin_x, cb)
        c1 = _strip_of(tmax_x, cb)
        cnt_b = torch.where(ov, c1 - c0 + 1, 0)
        ndest = ndest + cnt_b
        chip0 = base + c0
        dest0 = torch.where(~found0 & ov, chip0, dest0)
        second_here = ov & ~found0 & (cnt_b >= 2)
        dest1 = torch.where(~found1 & second_here, chip0 + 1, dest1)
        later = ov & found0 & ~found1
        dest1 = torch.where(later, chip0, dest1)
        found1 = found1 | second_here | later
        found0 = found0 | ov
        base += len(cb) - 1
    wide = valid & (ndest >= 3)
    narrow = valid & ~wide
    return dest0, dest1, narrow, narrow & (ndest == 2), wide


def _exchange_a2a(mesh: Mesh, rows_local: torch.Tensor, tmin_y, tmax_y, valid, *,
                  bounds, strip_rects=None, tmin_x=None, tmax_x=None):
    """Strip-ownership exchange with exact counts: each record goes to the
    strips its tile rect touches. A record on 1 or 2 strips goes to its
    first strip and, as a straddler, to its second; a record on 3 or more
    (wide) goes to every rank. A small all-to-all of the per-destination
    counts comes first, then one uneven all-to-all of the records: the 7
    ``u32`` words as int32 and the record's global scene index (32 B).

    Returns ``(rows, index)``: the received (7, M) records in the JAX
    package's order (first-destination records source-major, each
    source's in scene order, then the straddlers source-major, then the
    wide records source-major) and their (M,) global scene indices."""
    d, ns = mesh.size, rows_local.shape[1]
    dev = rows_local.device
    s0, s1, narrow, straddle, wide = _destinations(tmin_y, tmax_y, valid, bounds,
                                                   strip_rects, tmin_x, tmax_x)
    idx = torch.arange(ns, device=dev)
    none = torch.full_like(idx, d + 1)
    # Stable sorts keep scene order inside each destination's group.
    key0 = torch.where(narrow, s0.to(idx.dtype), torch.where(wide, d, none))
    key1 = torch.where(straddle, s1.to(idx.dtype), none)
    order0 = torch.sort(key0, stable=True).indices
    order1 = torch.sort(key1, stable=True).indices
    counts = torch.stack([torch.bincount(key0, minlength=d + 2)[: d + 1],
                          torch.bincount(key1, minlength=d + 2)[: d + 1]])
    main, strad = counts.tolist()  # the exchange's one host wait
    n_wide = main[d]
    m_start = np.concatenate([[0], np.cumsum(main)])
    s_start = np.concatenate([[0], np.cumsum(strad)])
    wide_cols = order0[m_start[d]:m_start[d] + n_wide]
    send_cols = torch.cat([torch.cat([order0[m_start[c]:m_start[c + 1]],
                                      order1[s_start[c]:s_start[c + 1]], wide_cols])
                           for c in range(d)])
    send_counts = [[main[c], strad[c], n_wide] for c in range(d)]
    recv_counts = _all_to_all_rows(
        mesh, torch.tensor(send_counts, dtype=torch.int64, device=dev), [1] * d, [1] * d
    ).tolist()
    send = torch.cat([u32_to_i32(rows_local[:, send_cols]).T,
                      (mesh.rank * ns + send_cols).to(torch.int32)[:, None]], dim=1)
    got = _all_to_all_rows(mesh, send, [sum(c) for c in send_counts],
                           [sum(c) for c in recv_counts])
    last_frame["records_sent"] = send.numel() * 4 + 3 * 8 * d
    last_frame["records_received"] = got.numel() * 4 + 3 * 8 * d
    # Regroup source-major [main, straddle, wide] segments kind-major.
    offs = np.concatenate([[0], np.cumsum([sum(c) for c in recv_counts])])
    parts = [[], [], []]
    for s, (m, st, w) in enumerate(recv_counts):
        o = offs[s]
        parts[0].append(got[o:o + m])
        parts[1].append(got[o + m:o + m + st])
        parts[2].append(got[o + m + st:o + m + st + w])
    got = torch.cat(parts[0] + parts[1] + parts[2])
    return got[:, :EXCHANGE_ROWS].T.to(torch.int64) & _U32, got[:, EXCHANGE_ROWS].to(torch.int64)


def _rebase(proj_g: ProjectedGaussians, cfg: RenderConfig, geo: _Geometry):
    """Strip-local coordinates of globally decoded records: shift center
    and AABB by the strip's origin (exact: integer pixel offsets of
    1/8-px values), clamp the AABB to the owned pixels and the tile rects
    to the owned tiles, and drop records that miss the strip."""
    f32 = torch.float32
    y_off = float(geo.y0 * cfg.tile_h)
    y_hi = float(max(geo.rows * cfg.tile_h - 1, 0))
    center = proj_g.center_px - torch.tensor([0.0, y_off], dtype=f32,
                                             device=proj_g.center_px.device)
    aabb = proj_g.aabb_px
    ay = torch.clamp(aabb[:, [1, 3]] - y_off, 0.0, y_hi)
    tmin_y = torch.clamp_min(proj_g.tile_min[:, 1], geo.y0) - geo.y0
    tmax_y = torch.clamp_max(proj_g.tile_max[:, 1], geo.y0 + geo.rows - 1) - geo.y0
    valid = proj_g.valid & (tmin_y <= tmax_y)
    tmin_x, tmax_x = proj_g.tile_min[:, 0], proj_g.tile_max[:, 0]
    ax = aabb[:, [0, 2]]
    if geo.x0 is not None:
        x_off = float(geo.x0 * cfg.tile_w)
        x_hi = float(max(geo.cols * cfg.tile_w - 1, 0))
        center = center - torch.tensor([x_off, 0.0], dtype=f32, device=center.device)
        ax = torch.clamp(ax - x_off, 0.0, x_hi)
        tmin_x = torch.clamp_min(tmin_x, geo.x0) - geo.x0
        tmax_x = torch.clamp_max(tmax_x, geo.x0 + geo.cols - 1) - geo.x0
        valid = valid & (tmin_x <= tmax_x)
    return ProjectedGaussians(
        valid=valid, depth=proj_g.depth, color=proj_g.color, opacity=proj_g.opacity,
        center_px=center, conic=proj_g.conic,
        aabb_px=torch.stack([ax[:, 0], ay[:, 0], ax[:, 1], ay[:, 1]], dim=-1),
        tile_min=torch.stack([tmin_x, tmin_y], dim=-1),
        tile_max=torch.stack([tmax_x, tmax_y], dim=-1),
    )


def _strip_render(scene_shard: GaussianScene, cam: CameraParams, cfg: RenderConfig,
                  mesh: Mesh, compositor: str, time_value=None, strip_bounds=None,
                  exchange: str = "gather32", strip_rects=None):
    """One rank's strip: returns ``(fb_strip, overflow, center_clipped)``.

    ``compositor`` is ``"packed"`` (the single device's packed path on the
    strip), ``"xla"`` or ``"diff"`` (the f32 tile-sort compositors; under
    ``diff`` the training kernels on 128-pixel-multiple tiles).
    ``exchange`` picks the packed path's records (``gather32``,
    ``gather_q``, ``a2a_q``); xla and diff always take ``gather32``,
    whose f32 features carry gradients."""
    geo = _geometry(cfg, mesh.size, mesh.rank, strip_bounds, strip_rects)
    scene_shard, extra_opacity = slice_spacetime(scene_shard, time_value)
    proj = preprocess_gaussians(
        scene_shard, cam, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        sh_degree=cfg.sh_degree, extra_opacity_scale=extra_opacity,
        quantize_centers=cfg.quantize_centers, ewa_dilation=cfg.ewa_dilation,
        ewa_compensate=cfg.ewa_compensate,
    )
    geom_kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                   tile_h=cfg.tile_h)

    if compositor == "packed" and exchange != "gather32":
        rows_local = encode_record_rows(proj)
        if exchange == "a2a_q":
            bounds = None
            if strip_rects is None:
                bounds = strip_bounds or tuple(
                    i * (cfg.tiles_y // mesh.size) for i in range(mesh.size + 1))
            rows_all, index = _exchange_a2a(
                mesh, rows_local, proj.tile_min[:, 1], proj.tile_max[:, 1], proj.valid,
                bounds=bounds, strip_rects=strip_rects, tmin_x=proj.tile_min[:, 0],
                tmax_x=proj.tile_max[:, 0])
            # Scene order, as on one device: the emission is splat-major
            # and the key sort stable, so a straddler tying a later record
            # in (tile, depth) would otherwise blend after it
            # (tools/torch_multichip_phases.py --phases order).
            rows_all = rows_all[:, torch.sort(index, stable=True).indices]
        else:
            wire = u32_to_i32(rows_local).T
            got = _all_gather(mesh, wire, 0)
            last_frame["records_sent"] = wire.numel() * 4
            last_frame["records_received"] = got.numel() * 4
            rows_all = got.T.to(torch.int64) & _U32
        proj_g, cq_sat = decode_record_rows(rows_all, **geom_kw)
        proj_s = _rebase(proj_g, cfg, geo)
        fb, overflow, clipped = _packed_strip_tail(proj_s, cam=cam, cfg=cfg, geo=geo)
        return fb, overflow, clipped | torch.any(proj_s.valid & cq_sat)

    feats_local = build_features(proj)
    f32 = torch.float32
    record = torch.cat([
        feats_local,
        proj.tile_min.to(f32), proj.tile_max.to(f32),
        proj.depth.detach()[:, None].to(f32), proj.valid.to(f32)[:, None],
    ], dim=-1)  # (N/D, 22)
    record_all = gather_rows(mesh, record)
    last_frame["records_sent"] = record.numel() * 4
    last_frame["records_received"] = record_all.numel() * 4
    # Strip-local feature columns: shift center y and the AABB's y rows
    # (and x for rects), then clamp the AABB to the owned pixels.
    y_off = float(geo.y0 * cfg.tile_h)
    shift = torch.zeros((FEAT_DIM,), dtype=f32, device=record.device)
    shift[[FEAT_CY, FEAT_YMIN, FEAT_YMAX]] = y_off
    lo = torch.full((FEAT_DIM,), -math.inf, dtype=f32, device=record.device)
    hi = torch.full((FEAT_DIM,), math.inf, dtype=f32, device=record.device)
    lo[[FEAT_YMIN, FEAT_YMAX]] = 0.0
    hi[[FEAT_YMIN, FEAT_YMAX]] = float(max(geo.rows * cfg.tile_h - 1, 0))
    if geo.x0 is not None:
        xcols = [FEAT_CX, FEAT_XMIN, FEAT_XMIN + 2]
        shift[xcols] = float(geo.x0 * cfg.tile_w)
        lo[[FEAT_XMIN, FEAT_XMIN + 2]] = 0.0
        hi[[FEAT_XMIN, FEAT_XMIN + 2]] = float(max(geo.cols * cfg.tile_w - 1, 0))
    feats_all = torch.clamp(record_all[:, :FEAT_DIM] - shift, lo, hi)
    rest = record_all[:, FEAT_DIM:].detach()
    tile_min = rest[:, 0:2].to(torch.int32)
    tile_max = rest[:, 2:4].to(torch.int32)
    depth_all = rest[:, 4]
    valid_all = rest[:, 5] > 0.5
    tmin_y = torch.clamp_min(tile_min[:, 1], geo.y0) - geo.y0
    tmax_y = torch.clamp_max(tile_max[:, 1], geo.y0 + geo.rows - 1) - geo.y0
    valid_strip = valid_all & (tmin_y <= tmax_y)
    tmin_x, tmax_x = tile_min[:, 0], tile_max[:, 0]
    if geo.x0 is not None:
        tmin_x = torch.clamp_min(tmin_x, geo.x0) - geo.x0
        tmax_x = torch.clamp_max(tmax_x, geo.x0 + geo.cols - 1) - geo.x0
        valid_strip = valid_strip & (tmin_x <= tmax_x)
    tile_min_s = torch.stack([tmin_x, tmin_y], dim=-1)
    tile_max_s = torch.stack([tmax_x, tmax_y], dim=-1)
    strip_h = geo.tiles_y * cfg.tile_h

    if compositor == "packed":
        fd = feats_all.detach()
        return _packed_strip_tail(ProjectedGaussians(
            valid=valid_strip, depth=depth_all, color=fd[:, FEAT_R:FEAT_R + 3],
            opacity=fd[:, FEAT_OPACITY], center_px=fd[:, FEAT_CX:FEAT_CX + 2],
            conic=fd[:, FEAT_CONIC_A:FEAT_CONIC_A + 3], aabb_px=fd[:, FEAT_XMIN:FEAT_XMIN + 4],
            tile_min=tile_min_s, tile_max=tile_max_s,
        ), cam=cam, cfg=cfg, geo=geo)

    proj_strip = proj._replace(valid=valid_strip, depth=depth_all, tile_min=tile_min_s,
                               tile_max=tile_max_s)
    assignment = build_sorted_instances(
        proj_strip, tiles_x=cfg.tiles_x, num_tiles=cfg.tiles_x * geo.tiles_y,
        near=cam.near, far=cam.far, depth_bits=_global_depth_bits(cfg))
    last_frame["instances"] = assignment.total_instances
    want_alpha = cfg.output_alpha or cfg.background is not None
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=geo.tiles_y, tile_w=cfg.tile_w,
              tile_h=cfg.tile_h, width=cfg.width, height=strip_h,
              chunk_size=cfg.chunk_size, return_alpha=want_alpha)
    ranges = (assignment.tile_start, assignment.tile_count)
    if compositor == "diff":
        sorted_feats = gather_sorted_features_seg(feats_all, assignment, cfg.chunk_size)
        if (cfg.diff_kernel and train_kernel_compatible(cfg.tile_w, cfg.tile_h)
                and not cfg.output_depth):
            fb = composite_tiles_train(sorted_feats, *ranges, **kw)
        else:
            fb = composite_tiles_diff(sorted_feats, *ranges, **kw,
                                      max_chunks=cfg.diff_max_chunks,
                                      return_depth=cfg.output_depth)
        if feats_all.requires_grad:
            # Adds an exact 0 that ties the strip to the gathered records:
            # a rank whose strip holds no instance still joins the
            # all-to-all of the all-gather's backward, as every rank must.
            fb = fb + feats_all[:0].sum()
    else:
        sorted_feats = gather_sorted_features(feats_all, assignment, cfg.chunk_size)
        fb = composite_tiles_xla(sorted_feats, *ranges, **kw, return_depth=cfg.output_depth)
    no = torch.zeros((), dtype=torch.bool, device=fb.device)
    return _finish_fb(fb, cfg), assignment.overflow, no


def _reassemble(strips, cfg: RenderConfig, d: int, strip_bounds, strip_rects):
    """The whole frame from every rank's (C, rows_max·th, cols_max·tw)
    strip, cropped to (C, H, W)."""
    th, tw = cfg.tile_h, cfg.tile_w
    if strip_rects is not None:
        rects, _, _ = rect_geometry(strip_rects, d, cfg.tiles_y, cfg.tiles_x)
        row_bounds, col_bounds = strip_rects
        bands, c = [], 0
        for b in range(len(row_bounds) - 1):
            band_h = (row_bounds[b + 1] - row_bounds[b]) * th
            cols = []
            for j in range(len(col_bounds[b]) - 1):
                w_here = (col_bounds[b][j + 1] - col_bounds[b][j]) * tw
                if band_h > 0 and w_here > 0:
                    cols.append(strips[c][:, :band_h, :w_here])
                c += 1
            if band_h > 0 and cols:
                bands.append(torch.cat(cols, dim=2))
        fb = torch.cat(bands, dim=1)
    elif strip_bounds is not None:
        diffs, _ = strip_geometry(strip_bounds, d, cfg.tiles_y)
        fb = torch.cat([s[:, :diffs[c] * th] for c, s in enumerate(strips) if diffs[c] > 0],
                       dim=1)
    else:
        fb = torch.cat(list(strips), dim=1)
    return fb[:, :cfg.height, :cfg.width]


def render_frame_multichip(
    scene: GaussianScene,
    cam: CameraParams,
    cfg: RenderConfig,
    mesh: Mesh,
    time_value=None,
    strip_bounds: Optional[Tuple[int, ...]] = None,
    exchange: str = "gather_q",
    a2a_caps: Optional[Tuple[int, int, int]] = None,
    strip_rects=None,
):
    """Render one frame across the mesh; every rank calls it with its own
    shard (:func:`shard_scene`) and the same camera.

    Returns ``(fb, stats)`` on every rank: ``fb`` the whole (3[+alpha]
    [+depth], H, W) framebuffer, the strips all-gathered and reassembled,
    and ``stats`` ``{"overflow", "center_clipped"}``, each MAX-reduced over
    the ranks (0-d bool tensors).

    Strips are equal (``cfg.tiles_y`` divisible by D), or
    ``strip_bounds`` (D+1 row boundaries, :func:`balance_strips_for_scene`;
    empty strips allowed), or, on the packed path, 2-D ``strip_rects``
    (:func:`balance_rects_for_scene`), which need no divisible
    ``tiles_y`` (the JAX function asks for one all the same). The compositor follows
    ``cfg.compositor`` as on one device. ``exchange`` picks the packed
    path's records: ``gather_q`` (quantized 28 B all-gather), ``a2a_q``
    (quantized strip-ownership all-to-all with exact counts, so it never
    overflows: ``a2a_caps`` is accepted for the JAX signature and not
    read) or ``gather32`` (the f32 88 B record; xla and diff always take
    it)."""
    if exchange not in ("gather32", "gather_q", "a2a_q"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    del a2a_caps
    if strip_rects is not None:
        if strip_bounds is not None:
            raise ValueError("pass strip_bounds OR strip_rects, not both")
        if not (cfg.compositor == "packed" and cfg.packed_compatible):
            raise ValueError("2-D rect strips require the packed compositor (the "
                             "xla/diff training paths keep row strips)")
    d = mesh.size
    if strip_bounds is not None:
        strip_bounds = tuple(int(b) for b in strip_bounds)
        strip_geometry(strip_bounds, d, cfg.tiles_y)
    elif strip_rects is not None:
        rect_geometry(strip_rects, d, cfg.tiles_y, cfg.tiles_x)
    elif cfg.tiles_y % d != 0:
        raise ValueError(f"tiles_y={cfg.tiles_y} must be divisible by mesh size {d}")
    if cfg.compositor == "packed" and cfg.packed_compatible:
        compositor = "packed"
    elif cfg.compositor == "diff":
        compositor = "diff"
    else:
        compositor = "xla"
    fb_strip, overflow, clipped = _strip_render(
        scene, cam, cfg, mesh, compositor, time_value, strip_bounds=strip_bounds,
        exchange=exchange, strip_rects=strip_rects)
    strips = _all_gather(mesh, fb_strip.detach()[None], 0)
    last_frame["strips_received"] = strips.numel() * 4
    flags = _all_reduce(mesh, torch.stack([overflow, clipped]).to(torch.int32),
                        dist.ReduceOp.MAX) > 0
    fb = _reassemble(strips, cfg, d, strip_bounds, strip_rects)
    return fb, {"overflow": flags[0], "center_clipped": flags[1]}
