"""The training compositor's two kernels: the f32 forward and its
hand-written backward.

Counterpart of the two TPU kernels in
``gaussianrenderer_tpu/ops/pallas/tile_train.py`` (``_fwd_kernel`` and
``_bwd_kernel``). :func:`train_forward` and :func:`train_backward` launch
the hand-written CUDA kernels (``csrc/tile_train.cu``) for tensors on a
CUDA device and run :func:`train_forward_plain` and
:func:`train_backward_plain`, the same functions in plain PyTorch, for
tensors on the CPU. Nothing falls back: a CUDA tensor launches the
kernel or raises.

Forward, per tile: walk the K-aligned chunk windows of the tile's lane
range ``[start, start + count)`` (``aligned = start // K · K``; lanes
outside the range are invalid). Per lane and pixel (global pixel
coordinates), ``md² = clip(A·dx² + B·dx·dy + C·dy², 0, 80)`` and
``alpha = min(op·exp(−½md²), 0.99)``, zeroed outside the AABB, below
1e-3 and outside the range. Within a chunk ``t_before = T_carry ·
∏_{j<i}(1 − alpha_j)`` (ungated) and ``weight = alpha·t_before`` while
``t_before ≥ 1e-3``; across chunks ``T_carry ·= ∏ over gated lanes of
(1 − alpha)``. Before each chunk the walk stops once no pixel of the tile
has ``T ≥ 1e-3``. Outputs: per pixel the stats rows (rgb, T_final,
chunks walked ``i_end``, three zero rows) and per walked chunk its entry
``T_carry`` (the checkpoint the backward recomputes from).

Backward, per tile: walk the chunks in reverse from ``i_end − 1`` with
the cotangent in premultiplied form ``A = ∂L/∂T_carry · T_carry``, seeded
with ``gT · T_final``. Each chunk is recomputed from its checkpoint with
the forward's arithmetic, and per lane::

    ∂alpha_i = g_i·(g·c_i)·t_before_i − (S_i + g_i·A_exit)/(1 − alpha_i)
    S_i      = Σ_{j>i, same chunk} (g·c_j)·w_j,   A_entry = A_exit + Σ_j (g·c_j)·w_j

chained through the 0.99 clamp, the mask and the md² clip to
(cx, cy, A, B, C, op) and to rgb, summed over the tile's pixels. Feature
rows 9–15 get no gradient, and only lanes inside a tile's range are
written.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussianrenderer_tpu_torch import _build
from gaussianrenderer_tpu_torch.ops.compositing import (
    ALPHA_EPS,
    ALPHA_MAX,
    FEAT_B,
    FEAT_CONIC_A,
    FEAT_CONIC_B,
    FEAT_CONIC_C,
    FEAT_CX,
    FEAT_CY,
    FEAT_DIM,
    FEAT_OPACITY,
    FEAT_R,
    FEAT_XMAX,
    FEAT_XMIN,
    FEAT_YMAX,
    FEAT_YMIN,
    MD2_CLIP,
    T_EPS,
)

#: Stats rows per pixel: rgb (3), T_final, i_end (as f32), 3 zero rows.
STATS_ROWS = 8
#: Feature columns that carry a gradient: cx, cy, A, B, C, op, r, g, b.
GRAD_COLS = 9
#: Tiles the plain versions vectorize over at a time.
TILE_BATCH = 16


def chunk_offsets(
    tile_start: torch.Tensor, tile_count: torch.Tensor, chunk: int
) -> Tuple[torch.Tensor, int]:
    """Each tile's first checkpoint row: the exclusive cumsum of its
    chunk count ``cdiv(start + count − aligned, K)``; returns ``((T,)
    int32 offsets, total rows)`` (the total is read back to size the
    buffer)."""
    start = tile_start.to(torch.int64)
    aligned = (start // chunk) * chunk
    n = (start + tile_count.to(torch.int64) - aligned + chunk - 1) // chunk
    incl = torch.cumsum(n, 0)
    total = int(incl[-1]) if n.numel() else 0
    return (incl - n).to(torch.int32), total


def _pixels(tb, tiles_x, tile_w, tile_h):
    """Global (x, y) of a batch of tiles' pixels: (nb, P, 1) each."""
    p = torch.arange(tile_w * tile_h, device=tb.device)
    px = ((tb % tiles_x) * tile_w)[:, None] + (p % tile_w)[None, :]
    py = ((tb // tiles_x) * tile_h)[:, None] + (p // tile_w)[None, :]
    return px.to(torch.float32)[:, :, None], py.to(torch.float32)[:, :, None]


def _chunk_terms(sorted_feats, slot, valid, px, py):
    """The chunk's alpha and what the backward chain reuses; ``slot`` and
    ``valid`` are (nb, K), pixels (nb, P, 1). Fields are (nb, 1, K)."""
    s = torch.clamp(slot, 0, sorted_feats.shape[0] - 1)
    f = sorted_feats[s]  # (nb, K, 16)

    def col(j):
        return f[:, None, :, j]

    dx = px - col(FEAT_CX)
    dy = py - col(FEAT_CY)
    ca, cb, cc = col(FEAT_CONIC_A), col(FEAT_CONIC_B), col(FEAT_CONIC_C)
    md2_raw = ca * dx * dx + cb * dx * dy + cc * dy * dy
    e = torch.exp(-0.5 * torch.clamp(md2_raw, 0.0, MD2_CLIP))
    alpha_raw = col(FEAT_OPACITY) * e
    inside = (
        (px >= col(FEAT_XMIN)) & (px <= col(FEAT_XMAX))
        & (py >= col(FEAT_YMIN)) & (py <= col(FEAT_YMAX))
    )
    alpha_min = torch.clamp_max(alpha_raw, ALPHA_MAX)
    mask = inside & (alpha_min >= ALPHA_EPS) & valid[:, None, :]
    alpha = torch.where(mask, alpha_min, 0.0)
    colors = f[:, :, FEAT_R:FEAT_B + 1]  # (nb, K, 3)
    return alpha, dict(dx=dx, dy=dy, ca=ca, cb=cb, cc=cc, md2_raw=md2_raw, e=e,
                       alpha_raw=alpha_raw, inside=inside, mask=mask, colors=colors)


def _chunk_recompute(alpha, t_carry):
    """u (inclusive ∏(1 − alpha) along lanes), t_before, gate, weights."""
    u = torch.cumprod(1.0 - alpha, dim=2)
    u_excl = torch.cat([torch.ones_like(u[:, :, :1]), u[:, :, :-1]], dim=2)
    t_before = t_carry[:, :, None] * u_excl
    gate = t_before >= T_EPS
    weights = torch.where(gate, alpha * t_before, 0.0)
    return u, t_before, gate, weights


def train_forward_plain(
    sorted_feats: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    chk_offset: torch.Tensor,
    n_chk: int,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    chunk: int,
):
    """The forward in plain PyTorch on the tensors' own device: returns
    ``(stats (8, T·P), chk (n_chk, P))``, tiles ``TILE_BATCH`` at a time."""
    dev = sorted_feats.device
    k = chunk
    p = tile_w * tile_h
    num_tiles = tiles_x * tiles_y
    stats = torch.zeros((STATS_ROWS, num_tiles, p), dtype=torch.float32, device=dev)
    chk = torch.zeros((n_chk, p), dtype=torch.float32, device=dev)
    lane = torch.arange(k, device=dev)
    for b0 in range(0, num_tiles, TILE_BATCH):
        tb = torch.arange(b0, min(b0 + TILE_BATCH, num_tiles), device=dev)
        nb = tb.numel()
        start = tile_start[tb].to(torch.int64)
        end = start + tile_count[tb].to(torch.int64)
        aligned = (start // k) * k
        num_chunks = (end - aligned + k - 1) // k
        off = chk_offset[tb].to(torch.int64)
        px, py = _pixels(tb, tiles_x, tile_w, tile_h)
        trans = torch.ones((nb, p), dtype=torch.float32, device=dev)
        rgb = torch.zeros((nb, p, 3), dtype=torch.float32, device=dev)
        walked = torch.zeros(nb, dtype=torch.int64, device=dev)
        active = num_chunks > 0
        ci = 0
        while bool(active.any()):
            act = torch.nonzero(active).squeeze(1)
            chk[off[act] + ci] = trans[act]
            slot = aligned[:, None] + ci * k + lane[None, :]
            valid = (slot >= start[:, None]) & (slot < end[:, None]) & active[:, None]
            alpha, aux = _chunk_terms(sorted_feats, slot, valid, px, py)
            u, _, gate, weights = _chunk_recompute(alpha, trans)
            rgb = rgb + torch.bmm(weights, aux["colors"])
            carry = trans * torch.amin(torch.where(gate, u, 1.0), dim=2)
            trans = torch.where(active[:, None], carry, trans)
            walked = walked + active.to(torch.int64)
            ci += 1
            active = active & (ci < num_chunks) & (trans.amax(1) >= T_EPS)
        stats[0:3, tb] = rgb.permute(2, 0, 1)
        stats[3, tb] = trans
        stats[4, tb] = walked.to(torch.float32)[:, None].expand(nb, p)
    return stats.reshape(STATS_ROWS, num_tiles * p), chk


def train_backward_plain(
    sorted_feats: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    chk_offset: torch.Tensor,
    gout: torch.Tensor,
    stats: torch.Tensor,
    chk: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    chunk: int,
) -> torch.Tensor:
    """The backward in plain PyTorch, with the gradient written out by
    hand (no autograd): returns d_feats, shaped like ``sorted_feats``,
    zero outside columns 0–8 and outside the tiles' lane ranges."""
    dev = sorted_feats.device
    k = chunk
    p = tile_w * tile_h
    num_tiles = tiles_x * tiles_y
    d_feats = torch.zeros_like(sorted_feats, dtype=torch.float32)
    gout = gout.reshape(STATS_ROWS, num_tiles, p)
    stats = stats.reshape(STATS_ROWS, num_tiles, p)
    lane = torch.arange(k, device=dev)
    for b0 in range(0, num_tiles, TILE_BATCH):
        tb = torch.arange(b0, min(b0 + TILE_BATCH, num_tiles), device=dev)
        start = tile_start[tb].to(torch.int64)
        end = start + tile_count[tb].to(torch.int64)
        aligned = (start // k) * k
        off = chk_offset[tb].to(torch.int64)
        i_end = stats[4, tb, 0].to(torch.int64)
        px, py = _pixels(tb, tiles_x, tile_w, tile_h)
        g_rgb = gout[0:3, tb].permute(1, 2, 0)  # (nb, P, 3)
        acc = gout[3, tb] * stats[3, tb]  # A = dL/dT_final · T_final
        for ci in range(int(i_end.max()) - 1, -1, -1):
            active = ci < i_end
            t_carry = chk[torch.where(active, off + ci, 0)]  # (nb, P)
            slot = aligned[:, None] + ci * k + lane[None, :]
            valid = (slot >= start[:, None]) & (slot < end[:, None]) & active[:, None]
            alpha, aux = _chunk_terms(sorted_feats, slot, valid, px, py)
            _, t_before, gate, weights = _chunk_recompute(alpha, t_carry)
            gc = torch.bmm(g_rgb, aux["colors"].transpose(1, 2))  # (nb, P, K)
            y = gc * weights
            # S_i = Σ_{j>i} y_j: the inclusive suffix sum shifted by one.
            suffix = torch.flip(torch.cumsum(torch.flip(y, [2]), 2), [2])
            s = torch.cat([suffix[:, :, 1:], torch.zeros_like(suffix[:, :, :1])], 2)
            gate_f = gate.to(torch.float32)
            d_alpha = gate_f * gc * t_before - (s + gate_f * acc[:, :, None]) / (
                1.0 - alpha
            )
            d_alpha = torch.where(
                aux["mask"] & (aux["alpha_raw"] < ALPHA_MAX), d_alpha, 0.0
            )
            md2_raw = aux["md2_raw"]
            d_md2 = torch.where(
                (md2_raw > 0.0) & (md2_raw < MD2_CLIP),
                -0.5 * d_alpha * aux["alpha_raw"], 0.0,
            )
            dx, dy = aux["dx"], aux["dy"]
            ca, cb, cc = aux["ca"], aux["cb"], aux["cc"]
            grads = torch.stack([
                (d_md2 * (-(2.0 * ca * dx + cb * dy))).sum(1),
                (d_md2 * (-(2.0 * cc * dy + cb * dx))).sum(1),
                (d_md2 * dx * dx).sum(1),
                (d_md2 * dx * dy).sum(1),
                (d_md2 * dy * dy).sum(1),
                (d_alpha * aux["e"]).sum(1),
            ], dim=2)  # (nb, K, 6)
            d_colors = torch.bmm(weights.transpose(1, 2), g_rgb)  # (nb, K, 3)
            grads = torch.cat([grads, d_colors], dim=2)
            d_feats[slot[valid], :GRAD_COLS] = grads[valid]
            acc = torch.where(active[:, None], acc + y.sum(2), acc)
    return d_feats


# ------------------------------------------------------------- the kernels
def _check(name, checks):
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{name}: {msg}")


def _common_checks(sorted_feats, tile_start, tile_count, chk_offset, num_tiles, p,
                   chunk):
    return [
        (sorted_feats.dtype == torch.float32 and sorted_feats.dim() == 2
         and sorted_feats.shape[1] == FEAT_DIM, "sorted_feats must be (C, 16) float32"),
        (all(t.dtype == torch.int32 and tuple(t.shape) == (num_tiles,)
             for t in (tile_start, tile_count, chk_offset)),
         f"tile_start, tile_count and chk_offset must be ({num_tiles},) int32"),
        (p % 128 == 0 and p <= 4096, "tile_w*tile_h must be a multiple of 128, ≤ 4096"),
        (1 <= chunk <= 512, "chunk must be in [1, 512]"),
    ]


def _check_devices(name, dev, tensors):
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and on one device")


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc})"
        )


def train_forward(
    sorted_feats: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    chk_offset: torch.Tensor,
    n_chk: int,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    chunk: int,
):
    """The training compositor's forward: ``(stats (8, T·P), chk
    (n_chk, P))`` from (C, 16) f32 sorted features, per-tile ranges and
    :func:`chunk_offsets`. CUDA tensors launch the kernel (counted in
    ``launches``); CPU tensors run :func:`train_forward_plain`."""
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
              chunk=chunk)
    dev = sorted_feats.device
    if dev.type == "cpu":
        return train_forward_plain(sorted_feats, tile_start, tile_count, chk_offset,
                                   n_chk, **kw)
    if dev.type != "cuda":
        raise ValueError(f"train_forward: unsupported device {dev}")
    num_tiles = tiles_x * tiles_y
    p = tile_w * tile_h
    _check("train_forward", _common_checks(sorted_feats, tile_start, tile_count,
                                           chk_offset, num_tiles, p, chunk))
    _check_devices("train_forward", dev,
                   (sorted_feats, tile_start, tile_count, chk_offset))
    lib = _build.load("tile_train")
    stats = torch.empty((STATS_ROWS, num_tiles * p), dtype=torch.float32, device=dev)
    chk = torch.empty((max(n_chk, 1), p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gr_train_forward(
            sorted_feats.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), chk_offset.data_ptr(), stats.data_ptr(),
            chk.data_ptr(), tiles_x, tiles_y, tile_w, tile_h, chunk, stream,
        )
    _raise_on(lib, rc, "train_forward")
    train_forward.launches += 1
    return stats, chk[:n_chk]


def train_backward(
    sorted_feats: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    chk_offset: torch.Tensor,
    gout: torch.Tensor,
    stats: torch.Tensor,
    chk: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    chunk: int,
) -> torch.Tensor:
    """The training compositor's backward: d_feats shaped like
    ``sorted_feats`` from the forward's stats and checkpoints and the
    (8, T·P) cotangent rows (0–2 dL/drgb, 3 dL/dT_final). CUDA tensors
    launch the kernel (counted in ``launches``); CPU tensors run
    :func:`train_backward_plain`."""
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
              chunk=chunk)
    dev = sorted_feats.device
    if dev.type == "cpu":
        return train_backward_plain(sorted_feats, tile_start, tile_count, chk_offset,
                                    gout, stats, chk, **kw)
    if dev.type != "cuda":
        raise ValueError(f"train_backward: unsupported device {dev}")
    num_tiles = tiles_x * tiles_y
    p = tile_w * tile_h
    checks = _common_checks(sorted_feats, tile_start, tile_count, chk_offset,
                            num_tiles, p, chunk)
    checks += [
        (all(t.dtype == torch.float32 and tuple(t.shape) == (STATS_ROWS, num_tiles * p)
             for t in (gout, stats)), f"gout and stats must be (8, {num_tiles * p}) float32"),
        (chk.dtype == torch.float32 and chk.dim() == 2 and chk.shape[1] == p,
         f"chk must be (n, {p}) float32"),
    ]
    _check("train_backward", checks)
    _check_devices("train_backward", dev, (sorted_feats, tile_start, tile_count,
                                           chk_offset, gout, stats, chk))
    lib = _build.load("tile_train")
    d_feats = torch.zeros_like(sorted_feats)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gr_train_backward(
            sorted_feats.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), chk_offset.data_ptr(), gout.data_ptr(),
            stats.data_ptr(), chk.data_ptr(), d_feats.data_ptr(), tiles_x, tiles_y,
            tile_w, tile_h, chunk, stream,
        )
    _raise_on(lib, rc, "train_backward")
    train_backward.launches += 1
    return d_feats


#: Kernel launches made through ``train_forward`` / ``train_backward`` in
#: this process.
train_forward.launches = 0
train_backward.launches = 0
