"""The training compositor's two kernels: the f32 forward and its
hand-written backward.

Counterpart of the two TPU kernels in
``gaussianrenderer_tpu/ops/pallas/tile_train.py`` (``_fwd_kernel`` and
``_bwd_kernel``). :func:`train_forward` and :func:`train_backward` launch
the hand-written CUDA passes (``csrc/tile_train.cu``) for tensors on a
CUDA device and run :func:`train_forward_plain` and
:func:`train_backward_plain`, the same functions in plain PyTorch, for
tensors on the CPU. Nothing falls back: a CUDA tensor launches the
kernels or raises.

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

The kernels split both walks at chunk boundaries, one block per (tile,
chunk) row where they can (``csrc/tile_train.cu`` says why that is
exact): forward products → scan → composite → reduce, backward totals →
suffix → gradients. Each pass has a plain twin here
(``fwd_*_plain``, ``bwd_*_plain``); composed
(:func:`train_forward_passes_plain`, :func:`train_backward_passes_plain`)
they give the plain versions' results bit for bit on the CPU.
"""

from __future__ import annotations

import ctypes
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
from gaussianrenderer_tpu_torch.utils import trace

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
    total = trace.host_read("chunk_rows", incl[-1]) if n.numel() else 0
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


def _chunk_grads(alpha, aux, t_before, gate, weights, g_rgb, acc):
    """One chunk's per-lane gradient columns 0–8, (nb, K, 9), summed over
    the pixels, from its recompute, the rgb cotangent (nb, P, 3) and the
    premultiplied cotangent at the chunk's exit ``acc`` (nb, P); also
    returns y = (g·c)·w, (nb, P, K)."""
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
    return torch.cat([grads, d_colors], dim=2), y


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
            grads, y = _chunk_grads(alpha, aux, t_before, gate, weights, g_rgb, acc)
            d_feats[slot[valid], :GRAD_COLS] = grads[valid]
            acc = torch.where(active[:, None], acc + y.sum(2), acc)
    return d_feats


# ------------------------------------------------ the kernels' passes, plain
# Each twin loops over the same tile batches and chunk indices as the plain
# versions above and calls the same helpers on tensors of the same shapes,
# so that composed they round exactly as those do.
def _tile_batches(num_tiles, dev):
    for b0 in range(0, num_tiles, TILE_BATCH):
        yield torch.arange(b0, min(b0 + TILE_BATCH, num_tiles), device=dev)


def _windows(tb, tile_start, tile_count, chk_offset, k):
    """A tile batch's (start, end, aligned, chunk windows, first row)."""
    start = tile_start[tb].to(torch.int64)
    end = start + tile_count[tb].to(torch.int64)
    aligned = (start // k) * k
    return start, end, aligned, (end - aligned + k - 1) // k, chk_offset[tb].to(torch.int64)


def _slots(start, end, aligned, active, ci, k):
    """Chunk ci's lane slots (nb, K) and which of them are in range."""
    slot = aligned[:, None] + ci * k + torch.arange(k, device=start.device)[None, :]
    return slot, (slot >= start[:, None]) & (slot < end[:, None]) & active[:, None]


def fwd_products_plain(sorted_feats, tile_start, tile_count, chk_offset, n_chk, *,
                       tiles_x, tiles_y, tile_w, tile_h, chunk):
    """Forward pass 1: each row's ungated product U of (1 − alpha) over
    all of its in-range lanes, per pixel: (n_chk, P)."""
    dev = sorted_feats.device
    p = tile_w * tile_h
    prod = torch.ones((n_chk, p), dtype=torch.float32, device=dev)
    for tb in _tile_batches(tiles_x * tiles_y, dev):
        start, end, aligned, windows, off = _windows(tb, tile_start, tile_count,
                                                     chk_offset, chunk)
        px, py = _pixels(tb, tiles_x, tile_w, tile_h)
        ones = torch.ones((tb.numel(), p), dtype=torch.float32, device=dev)
        for ci in range(int(windows.max())):
            active = ci < windows
            slot, valid = _slots(start, end, aligned, active, ci, chunk)
            alpha, _ = _chunk_terms(sorted_feats, slot, valid, px, py)
            u = _chunk_recompute(alpha, ones)[0]
            prod[off[active] + ci] = u[active, :, -1]
    return prod


def fwd_scan_plain(prod, tile_start, tile_count, chk_offset, *, num_tiles, chunk):
    """Forward pass 2: per pixel ``T ← fl(T·U)`` row after row while the
    product stays ≥ 1e-3. Overwrites ``prod`` with each pixel's
    checkpoints up to its last row (the row it leaves below 1e-3, or the
    tile's last; the rest keep U, as in the kernel) and returns ``(last
    (T, P), i_end (T,))``, int64; a tile without rows has last −1."""
    dev = prod.device
    p = prod.shape[1]
    last = torch.empty((num_tiles, p), dtype=torch.int64, device=dev)
    for tb in _tile_batches(num_tiles, dev):
        _, _, _, windows, off = _windows(tb, tile_start, tile_count, chk_offset, chunk)
        nb = tb.numel()
        trans = torch.ones((nb, p), dtype=torch.float32, device=dev)
        alive = (windows > 0)[:, None].expand(nb, p).clone()
        last_b = (windows - 1)[:, None].expand(nb, p).clone()
        for ci in range(int(windows.max())):
            has = ci < windows
            rows = off[has] + ci
            u, t, a = prod[rows], trans[has], alive[has]
            prod[rows] = torch.where(a, t, u)
            v = t * u
            died = a & ~(v >= T_EPS)
            trans[has] = torch.where(a & ~died, v, t)
            last_b[has] = torch.where(died, ci, last_b[has])
            alive[has] = a & ~died
        last[tb] = last_b
    return last, last.amax(1) + 1


def fwd_composite_plain(sorted_feats, tile_start, tile_count, chk_offset, chk, last, i_end,
                        *, tiles_x, tiles_y, tile_w, tile_h, chunk):
    """Forward pass 3: each row below its tile's i_end composited from its
    checkpoint with the gated arithmetic. Returns the rgb partials
    (n_chk, 3, P) (rows past i_end zero) and each pixel's exit T at its
    last row, (T, P) (1 for a tile without rows)."""
    dev = sorted_feats.device
    p = tile_w * tile_h
    num_tiles = tiles_x * tiles_y
    part = torch.zeros((chk.shape[0], 3, p), dtype=torch.float32, device=dev)
    t_final = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    for tb in _tile_batches(num_tiles, dev):
        start, end, aligned, _, off = _windows(tb, tile_start, tile_count, chk_offset,
                                               chunk)
        i_end_b, last_b = i_end[tb], last[tb]
        px, py = _pixels(tb, tiles_x, tile_w, tile_h)
        for ci in range(int(i_end_b.max())):
            active = ci < i_end_b
            # Past its last row a pixel's checkpoint still holds U: it
            # enters at 0 there and adds nothing.
            entry = active[:, None] & (ci <= last_b)
            t_carry = torch.where(entry, chk[torch.where(active, off + ci, 0)], 0.0)
            slot, valid = _slots(start, end, aligned, active, ci, chunk)
            alpha, aux = _chunk_terms(sorted_feats, slot, valid, px, py)
            u, _, gate, weights = _chunk_recompute(alpha, t_carry)
            part[off[active] + ci] = torch.bmm(weights, aux["colors"])[active].transpose(1, 2)
            t_exit = t_carry * torch.amin(torch.where(gate, u, 1.0), dim=2)
            t_final[tb] = torch.where(entry & (ci == last_b), t_exit, t_final[tb])
    return part, t_final


def fwd_reduce_plain(part, chk, last, i_end, t_final, chk_offset):
    """Forward pass 4: rgb = each pixel's partials of rows 0..last added in
    chunk order from 0; the exit T into its checkpoints after its last row
    (``chk`` in place). Returns stats (8, T·P)."""
    num_tiles, p = t_final.shape
    dev = t_final.device
    stats = torch.zeros((STATS_ROWS, num_tiles, p), dtype=torch.float32, device=dev)
    for tb in _tile_batches(num_tiles, dev):
        off = chk_offset[tb].to(torch.int64)
        i_end_b, last_b = i_end[tb], last[tb]
        rgb = torch.zeros((tb.numel(), 3, p), dtype=torch.float32, device=dev)
        for ci in range(int(i_end_b.max())):
            active = ci < i_end_b
            rows = torch.where(active, off + ci, 0)
            rgb = rgb + torch.where((ci <= last_b)[:, None, :], part[rows], 0.0)
            fill = active[:, None] & (ci > last_b)
            chk[rows[active]] = torch.where(fill, t_final[tb], chk[rows])[active]
        stats[0:3, tb] = rgb.transpose(0, 1)
    stats[3] = t_final
    stats[4] = i_end.to(torch.float32)[:, None]
    return stats.reshape(STATS_ROWS, num_tiles * p)


def train_forward_passes_plain(sorted_feats, tile_start, tile_count, chk_offset, n_chk, *,
                               tiles_x, tiles_y, tile_w, tile_h, chunk):
    """The forward as the kernels' four passes, in plain PyTorch: ``(stats,
    chk)`` equal to :func:`train_forward_plain`'s (checkpoint rows past a
    tile's i_end excepted: unspecified, as in the kernel)."""
    geom = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                chunk=chunk)
    chk = fwd_products_plain(sorted_feats, tile_start, tile_count, chk_offset, n_chk,
                             **geom)
    last, i_end = fwd_scan_plain(chk, tile_start, tile_count, chk_offset,
                                 num_tiles=tiles_x * tiles_y, chunk=chunk)
    part, t_final = fwd_composite_plain(sorted_feats, tile_start, tile_count, chk_offset,
                                        chk, last, i_end, **geom)
    return fwd_reduce_plain(part, chk, last, i_end, t_final, chk_offset), chk


def _bwd_rows(sorted_feats, tile_start, tile_count, chk_offset, stats, chk, *, tiles_x,
              tiles_y, tile_w, tile_h, chunk):
    """Every walked chunk of every tile batch, recomputed from its
    checkpoint, last chunk first: yields (tile batch, active tiles, rows,
    slots, in-range, alpha, aux, t_before, gate, weights)."""
    p = tile_w * tile_h
    num_tiles = tiles_x * tiles_y
    for tb in _tile_batches(num_tiles, sorted_feats.device):
        start, end, aligned, _, off = _windows(tb, tile_start, tile_count, chk_offset,
                                               chunk)
        i_end = stats.reshape(STATS_ROWS, num_tiles, p)[4, tb, 0].to(torch.int64)
        px, py = _pixels(tb, tiles_x, tile_w, tile_h)
        for ci in range(int(i_end.max()) - 1, -1, -1):
            active = ci < i_end
            rows = torch.where(active, off + ci, 0)
            slot, valid = _slots(start, end, aligned, active, ci, chunk)
            alpha, aux = _chunk_terms(sorted_feats, slot, valid, px, py)
            _, t_before, gate, weights = _chunk_recompute(alpha, chk[rows])
            yield tb, active, rows, slot, valid, alpha, aux, t_before, gate, weights


def bwd_totals_plain(sorted_feats, tile_start, tile_count, chk_offset, gout, stats, chk, *,
                     tiles_x, tiles_y, tile_w, tile_h, chunk):
    """Backward pass 1: each walked row's chunk total ``Y = Σ_j (g·c_j)·w_j``
    per pixel, (n_chk, P) (the kernel sums in double, this in the plain
    version's order)."""
    p = tile_w * tile_h
    gout = gout.reshape(STATS_ROWS, tiles_x * tiles_y, p)
    totals = torch.zeros((chk.shape[0], p), dtype=torch.float32, device=chk.device)
    for tb, active, rows, _, _, _, aux, _, _, weights in _bwd_rows(
            sorted_feats, tile_start, tile_count, chk_offset, stats, chk, tiles_x=tiles_x,
            tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h, chunk=chunk):
        gc = torch.bmm(gout[0:3, tb].permute(1, 2, 0), aux["colors"].transpose(1, 2))
        totals[rows[active]] = (gc * weights).sum(2)[active]
    return totals


def bwd_suffix_plain(gout, stats, totals, chk_offset):
    """Backward pass 2: the premultiplied cotangent at each walked row's
    exit, ``A_exit(c) = gT·T_final + Σ_{c'>c} Y_c'`` added in reverse chunk
    order: (n_chk, P)."""
    num_tiles = chk_offset.shape[0]
    gout = gout.reshape(STATS_ROWS, num_tiles, -1)
    stats = stats.reshape(STATS_ROWS, num_tiles, -1)
    a_exit = torch.zeros_like(totals)
    for tb in _tile_batches(num_tiles, totals.device):
        off = chk_offset[tb].to(torch.int64)
        i_end = stats[4, tb, 0].to(torch.int64)
        acc = gout[3, tb] * stats[3, tb]
        for ci in range(int(i_end.max()) - 1, -1, -1):
            active = ci < i_end
            rows = torch.where(active, off + ci, 0)
            a_exit[rows[active]] = acc[active]
            acc = torch.where(active[:, None], acc + totals[rows], acc)
    return a_exit


def bwd_grads_plain(sorted_feats, tile_start, tile_count, chk_offset, gout, stats, chk, a_exit,
                    *, tiles_x, tiles_y, tile_w, tile_h, chunk):
    """Backward pass 3: each walked row's per-lane gradient from its
    recompute and ``a_exit``, written to the row's in-range lanes:
    d_feats shaped like ``sorted_feats``."""
    p = tile_w * tile_h
    gout = gout.reshape(STATS_ROWS, tiles_x * tiles_y, p)
    d_feats = torch.zeros_like(sorted_feats, dtype=torch.float32)
    for tb, _, rows, slot, valid, alpha, aux, t_before, gate, weights in _bwd_rows(
            sorted_feats, tile_start, tile_count, chk_offset, stats, chk, tiles_x=tiles_x,
            tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h, chunk=chunk):
        grads, _ = _chunk_grads(alpha, aux, t_before, gate, weights,
                                gout[0:3, tb].permute(1, 2, 0), a_exit[rows])
        d_feats[slot[valid], :GRAD_COLS] = grads[valid]
    return d_feats


def train_backward_passes_plain(sorted_feats, tile_start, tile_count, chk_offset, gout,
                                stats, chk, *, tiles_x, tiles_y, tile_w, tile_h, chunk):
    """The backward as the kernels' three passes, in plain PyTorch: d_feats
    equal to :func:`train_backward_plain`'s."""
    geom = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                chunk=chunk)
    args = (sorted_feats, tile_start, tile_count, chk_offset, gout, stats, chk)
    totals = bwd_totals_plain(*args, **geom)
    a_exit = bwd_suffix_plain(gout, stats, totals, chk_offset)
    return bwd_grads_plain(*args, a_exit, **geom)


# ------------------------------------------------------------- the kernels
#: Pass ids of ``gr_train_pass`` (csrc/tile_train.cu ``Pass``).
(ROW_TILES, FWD_PRODUCTS, FWD_SCAN, FWD_COMPOSITE, FWD_REDUCE, BWD_TOTALS, BWD_SUFFIX,
 BWD_GRADS) = range(8)


class PassArgs(ctypes.Structure):
    """``GrTrainArgs`` of csrc/tile_train.cu, field for field: device
    pointers (0 where a pass reads none), then the geometry."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "feats", "tile_start", "tile_count", "chk_offset", "row_tile", "chk", "stats",
        "part", "gout", "ysum", "a_exit", "d_feats")] + [(name, ctypes.c_int) for name in (
            "n_rows", "tiles_x", "num_tiles", "tile_w", "tile_h", "K")]


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
        (p > 0 and p % 128 == 0, "tile_w*tile_h must be a positive multiple of 128"),
        (1 <= chunk <= 512, "chunk must be in [1, 512]"),
    ]


def _check_devices(name, dev, tensors, aligned):
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and on one device")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: float inputs must start on a 16-byte boundary")


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc})"
        )


def _run(fn, dev, passes, args):
    """Launch ``passes`` in order on the current stream, each counted in
    ``fn.kernel_launches``."""
    lib = _build.load("tile_train")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for pass_id in passes:
            rc = lib.gr_train_pass(pass_id, ctypes.addressof(args), stream)
            _raise_on(lib, rc, fn.__name__)
            fn.kernel_launches += 1


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
    :func:`chunk_offsets`. CUDA tensors launch the kernels (calls counted
    in ``launches``, kernels in ``kernel_launches``: five a call, two
    when no tile has a row); CPU tensors run :func:`train_forward_plain`."""
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
    _check_devices("train_forward", dev, (sorted_feats, tile_start, tile_count, chk_offset),
                   (sorted_feats,))
    rows = max(n_chk, 1)
    row_tile = torch.empty(rows, dtype=torch.int32, device=dev)
    stats = torch.empty((STATS_ROWS, num_tiles * p), dtype=torch.float32, device=dev)
    chk = torch.empty((rows, p), dtype=torch.float32, device=dev)
    part = torch.empty((rows, 3, p), dtype=torch.float32, device=dev)
    args = PassArgs(
        feats=sorted_feats.data_ptr(), tile_start=tile_start.data_ptr(),
        tile_count=tile_count.data_ptr(), chk_offset=chk_offset.data_ptr(),
        row_tile=row_tile.data_ptr(), chk=chk.data_ptr(), stats=stats.data_ptr(),
        part=part.data_ptr(), n_rows=n_chk, tiles_x=tiles_x, num_tiles=num_tiles,
        tile_w=tile_w, tile_h=tile_h, K=chunk,
    )
    passes = ((ROW_TILES, FWD_PRODUCTS, FWD_SCAN, FWD_COMPOSITE, FWD_REDUCE) if n_chk
              else (FWD_SCAN, FWD_REDUCE))
    _run(train_forward, dev, passes, args)
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
    launch the kernels (calls counted in ``launches``, kernels in
    ``kernel_launches``: four a call, none without checkpoint rows); CPU
    tensors run :func:`train_backward_plain`."""
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
                                           chk_offset, gout, stats, chk),
                   (sorted_feats, gout, stats, chk))
    d_feats = torch.zeros_like(sorted_feats)
    n_rows = chk.shape[0]
    if n_rows:
        row_tile = torch.empty(n_rows, dtype=torch.int32, device=dev)
        ysum = torch.empty((n_rows, p), dtype=torch.float64, device=dev)
        a_exit = torch.empty((n_rows, p), dtype=torch.float32, device=dev)
        args = PassArgs(
            feats=sorted_feats.data_ptr(), tile_start=tile_start.data_ptr(),
            tile_count=tile_count.data_ptr(), chk_offset=chk_offset.data_ptr(),
            row_tile=row_tile.data_ptr(), chk=chk.data_ptr(), stats=stats.data_ptr(),
            gout=gout.data_ptr(), ysum=ysum.data_ptr(), a_exit=a_exit.data_ptr(),
            d_feats=d_feats.data_ptr(), n_rows=n_rows, tiles_x=tiles_x,
            num_tiles=num_tiles, tile_w=tile_w, tile_h=tile_h, K=chunk,
        )
        _run(train_backward, dev, (ROW_TILES, BWD_TOTALS, BWD_SUFFIX, BWD_GRADS), args)
    train_backward.launches += 1
    return d_feats


#: Calls of ``train_forward`` / ``train_backward`` that reached the kernels
#: in this process (``launches``), and the kernels they launched
#: (``kernel_launches``).
train_forward.launches = train_forward.kernel_launches = 0
train_backward.launches = train_backward.kernel_launches = 0
