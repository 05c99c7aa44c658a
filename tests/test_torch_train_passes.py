"""The train kernels' passes (``csrc/tile_train.cu``: forward products →
scan → composite → reduce, backward totals → suffix → gradients) as
plain PyTorch twins, composed, against the plain versions they replace
(``train_forward_plain`` / ``train_backward_plain``), bit for bit: stats
rows 0–4 (and the zero rows), every walked checkpoint row, i_end and
d_feats. The split at chunk boundaries is exact, so nothing here has a
tolerance.

Cases: the two frames of tests/test_torch_train_compositor.py (800
splats at 128×160; a heavy-overdraw 96×96 frame with over 20 chunks in a
tile), a hand-built frame whose pixels die mid-chunk, fail the gate at a
chunk's last lane, end a chunk below 1e-3 with every gate passed, and
survive (or not) at fl(T·U) one float from 1e-3, with an empty tile,
an empty window and adjacent tiles whose aligned windows overlap; and a
frame of 64×128 tiles (8192 pixels, past the old kernels' 4096). The
kernels themselves are held against the plain versions on the card
(chip_smoke.py; the last test here skips without one).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.compositing import FEAT_DIM
from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_train_compositor import camera, heavy_case, normal_case, pipeline

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The hand-built frame: 4 tiles of 16×8 pixels in a row, chunks of 32.
HAND_K = 32
HAND_TILE = (16, 8)
#: Pixel columns of tile 0 and what their lanes make of them.
MID_CHUNK, LAST_LANE, ALL_GATED, SURVIVES, JUST_BELOW = (0, 3), (4, 5), (6, 7), (8, 9), (10, 11)


class Frame:
    def __init__(self, sf, tile_start, tile_count, tiles_x, tiles_y, tile_w, tile_h, chunk):
        self.sf, self.tile_start, self.tile_count = sf, tile_start, tile_count
        self.geom = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
                         chunk=chunk)
        self.off, self.n_chk = tt.chunk_offsets(tile_start, tile_count, chunk)
        self.num_tiles, self.p = tiles_x * tiles_y, tile_w * tile_h

    def args(self):
        return self.sf, self.tile_start, self.tile_count, self.off

    def walked(self, stats):
        """(tile, checkpoint rows) of every walked chunk."""
        i_end = stats.reshape(tt.STATS_ROWS, self.num_tiles, self.p)[4, :, 0].to(torch.int64)
        return [(t, slice(int(self.off[t]), int(self.off[t]) + int(i_end[t])))
                for t in range(self.num_tiles)]


def from_pipeline(sf, asg, cfg):
    return Frame(sf, asg.tile_start, asg.tile_count, cfg.tiles_x, cfg.tiles_y, cfg.tile_w,
                 cfg.tile_h, cfg.chunk_size)


def chunk_product(ops):
    """U of one chunk's lanes with the given opacities (flat splats:
    alpha = op), rounded as the plain version rounds it."""
    alpha = torch.clamp_max(torch.tensor(ops, dtype=torch.float32) * 1.0, 0.99)
    return torch.cumprod(1.0 - alpha[None, None, :], dim=2)[0, 0, -1]


def survivor_opacity(t0):
    """The largest f32 opacity o such that T·U ≥ 1e-3 for T = t0 and 8
    lanes of o: one float more and the pixel ends the chunk below."""
    lo, hi = np.array([0.2, 0.9], np.float32).view(np.int32)
    eps = np.float32(1e-3)
    ok = lambda bits: float(t0 * chunk_product([np.int32(bits).view(np.float32)] * 8)) >= eps  # noqa: E731
    assert ok(lo) and not ok(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return np.int32(lo).view(np.float32), np.int32(hi).view(np.float32)


def hand_built():
    """Tile 0 (lanes 0–79, chunks 0–31, 32–63, 64–95):
    - MID_CHUNK: lanes 0–11 at 0.5; its gate first fails at lane 10.
    - ALL_GATED: lanes 17–24 at 0.62; every gate passes,
      and the chunk leaves it at 0.38⁸ < 1e-3.
    - LAST_LANE: lanes 25–31 at 0.72; the gate first fails at lane 31,
      the chunk's last.
    - SURVIVES / JUST_BELOW: lanes 12–16 at 0.3, then 8 lanes at the
      largest opacity that keeps fl(T·U) ≥ 1e-3 (lanes 32–39) or the next
      float up (lanes 40–47).
    - columns 12–15: seeded Gaussian splats in lanes 48–79.
    Tile 1 (lanes 80–150: windows from 64, overlapping tile 0's last):
    opaque splats end it in its first chunk. Tile 2: no lanes, start 151
    (one empty window). Tile 3: no lanes, start 160 (no window)."""
    rng = np.random.default_rng(4)
    tw, th = HAND_TILE
    feats = np.zeros((160 + HAND_K, FEAT_DIM), np.float32)

    def flat(lane, op, x0, x1):
        f = feats[lane]
        f[0:2] = (x0 + x1) / 2, th / 2
        f[5] = op
        f[6:9] = rng.uniform(0.1, 1.0, 3)
        f[9:13] = x0, 0, x1, th - 1

    def gaussian(lane, x0, x1):
        f = feats[lane]
        f[0:2] = rng.uniform(x0, x1), rng.uniform(0, th - 1)
        sx, sy = rng.uniform(1.0, 3.0, 2)
        f[2:5] = 1 / sx ** 2, rng.uniform(-0.1, 0.1), 1 / sy ** 2
        f[5] = rng.uniform(0.1, 0.9)
        f[6:9] = rng.uniform(0.0, 1.0, 3)
        f[9:13] = x0, 0, x1, th - 1

    for lane in range(0, 12):
        flat(lane, 0.5, *MID_CHUNK)
    t0 = chunk_product([0.3] * 5)
    op_s, op_below = survivor_opacity(t0)
    for lane in range(12, 17):
        flat(lane, 0.3, SURVIVES[0], JUST_BELOW[1])
    for lane in range(17, 25):
        flat(lane, 0.62, *ALL_GATED)
    for lane in range(25, 32):
        flat(lane, 0.72, *LAST_LANE)
    for lane in range(32, 40):
        flat(lane, op_s, *SURVIVES)
    for lane in range(40, 48):
        flat(lane, op_below, *JUST_BELOW)
    for lane in range(48, 80):
        gaussian(lane, 12, 15)
    for lane in range(80, 151):
        if lane % 3:
            gaussian(lane, tw, 2 * tw - 1)
        else:
            flat(lane, 0.95, tw, 2 * tw - 1)
    tile_start = torch.tensor([0, 80, 151, 160], dtype=torch.int32)
    tile_count = torch.tensor([80, 71, 0, 0], dtype=torch.int32)
    frame = Frame(torch.from_numpy(feats), tile_start, tile_count, 4, 1, tw, th, HAND_K)
    return frame, float(t0)


def p8192_case():
    scene = gt.make_random_scene(700, seed=9, extent=1.2, scale_range=(0.05, 0.3),
                                 device="cpu")
    scene = scene._replace(opacity=torch.clamp(scene.opacity * 2.0, 0.0, 1.0))
    cfg = gt.RenderConfig(height=128, width=128, num_tile_x=2, num_tile_y=1,
                          compositor="diff")
    assert cfg.tile_w * cfg.tile_h == 8192
    sf, asg = pipeline(scene, camera(1.0, pos=(0, 0, 3.0), fov=60.0), cfg)
    return from_pipeline(sf, asg, cfg)


CASES = {
    "normal": lambda: from_pipeline(*normal_case()),
    "heavy_overdraw": lambda: from_pipeline(*heavy_case()),
    "hand_built": lambda: hand_built()[0],
    "tiles_64x128": p8192_case,
}


def cotangent(frame, seed):
    g = np.random.default_rng(seed).normal(size=(tt.STATS_ROWS, frame.num_tiles * frame.p))
    g[4:] = 0.0
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_passes_equal_plain(case):
    frame = CASES[case]()
    stats, chk = tt.train_forward_plain(*frame.args(), frame.n_chk, **frame.geom)
    stats_t, chk_t = tt.train_forward_passes_plain(*frame.args(), frame.n_chk, **frame.geom)
    assert torch.equal(stats_t, stats)  # rows 0–4 and the zero rows 5–7
    for _, rows in frame.walked(stats):
        assert torch.equal(chk_t[rows], chk[rows])


@pytest.mark.parametrize("case", list(CASES))
def test_backward_passes_equal_plain(case):
    frame = CASES[case]()
    stats, chk = tt.train_forward_plain(*frame.args(), frame.n_chk, **frame.geom)
    stats_t, chk_t = tt.train_forward_passes_plain(*frame.args(), frame.n_chk, **frame.geom)
    gout = cotangent(frame, seed=2)
    d = tt.train_backward_plain(*frame.args(), gout, stats, chk, **frame.geom)
    d_t = tt.train_backward_passes_plain(*frame.args(), gout, stats_t, chk_t, **frame.geom)
    assert float(d[:, :tt.GRAD_COLS].abs().max()) > 0
    assert torch.equal(d_t, d)


def test_hand_built_frame_has_its_cases():
    """The hand-built frame does what it was built for, read off the plain
    forward: where each column group stops and at what T."""
    frame, t0 = hand_built()
    stats, chk = tt.train_forward_plain(*frame.args(), frame.n_chk, **frame.geom)
    st = stats.reshape(tt.STATS_ROWS, frame.num_tiles, *HAND_TILE[::-1])
    t_final, i_end = st[3], st[4, :, 0, 0].to(torch.int64)
    windows = [3, 3, 1, 0]
    assert frame.n_chk == sum(windows) and int(frame.off[1]) == 3
    assert i_end.tolist() == [3, 1, 1, 0]  # tile 1 ends early; 2 walks an empty window

    def cols(group):
        return t_final[0, :, group[0]:group[1] + 1]

    rel = dict(rtol=1e-5, atol=0.0)
    # The gate fails at lane 10 of chunk 0 (t_before 0.5¹⁰ < 1e-3 ≤ 0.5⁹).
    assert torch.allclose(cols(MID_CHUNK), torch.full((8, 4), 0.5 ** 10), **rel)
    # The gate fails at lane 31, the chunk's last: T is 0.28⁶, not 0.28⁷.
    assert torch.allclose(cols(LAST_LANE), torch.full((8, 2), 0.28 ** 6), **rel)
    # Every gate passes and the chunk ends at 0.38⁸ < 1e-3.
    assert torch.allclose(cols(ALL_GATED), torch.full((8, 2), 0.38 ** 8), **rel)
    eps = torch.tensor(1e-3, dtype=torch.float32)
    assert bool((cols(SURVIVES) >= eps).all()) and float(cols(SURVIVES).max()) < 1.0002e-3
    assert bool((cols(JUST_BELOW) < eps).all()) and float(cols(JUST_BELOW).min()) > 0.9995e-3
    # Survivors keep chunk 1's checkpoint t0 and chunk 2's fl(t0·U).
    chk0 = chk[0:3].reshape(3, HAND_TILE[1], HAND_TILE[0])
    assert bool((chk0[1, :, SURVIVES[0]] == np.float32(t0)).all())
    assert torch.equal(chk0[2, :, SURVIVES[0]], cols(SURVIVES)[:, 0])
    # The tiles without lanes.
    assert bool((t_final[2:] == 1.0).all()) and float(st[0:3, 2:].abs().max()) == 0.0


def test_kernel_checks_take_any_multiple_of_128_pixels():
    sf = torch.zeros((256, FEAT_DIM))
    ranges = [torch.zeros(2, dtype=torch.int32)] * 3
    for p, ok in ((128, True), (8192, True), (64 * 255, False), (96, False)):
        checks = tt._common_checks(sf, *ranges, 2, p, 128)
        assert all(c for c, _ in checks) == ok, p


def test_wrappers_launch_or_raise_off_the_cpu():
    """CPU tensors run the plain versions; any other device launches the
    kernels or raises (no fallback)."""
    frame = hand_built()[0]
    meta = [t.to("meta") for t in frame.args()]
    with pytest.raises(ValueError, match="device"):
        tt.train_forward(*meta, frame.n_chk, **frame.geom)
    stats = torch.zeros((tt.STATS_ROWS, frame.num_tiles * frame.p), device="meta")
    with pytest.raises(ValueError, match="device"):
        tt.train_backward(*meta, stats, stats, torch.zeros((frame.n_chk, frame.p),
                                                           device="meta"), **frame.geom)


def test_pass_args_mirror_the_kernel_source():
    """``PassArgs`` and the pass ids match ``GrTrainArgs`` and ``Pass`` in
    csrc/tile_train.cu, field for field (ctypes cannot check them)."""
    src = open(tt._build.CSRC_DIR + "/tile_train.cu").read()
    body = src.split("struct GrTrainArgs {")[1].split("};")[0]
    fields = [re.match(r"\s*(?:const )?(\w+\*?)\s+(\w+);", line).groups()
              for line in body.splitlines() if ";" in line]
    assert [name for _, name in fields] == [name for name, _ in tt.PassArgs._fields_]
    for (ctype, _), (_, pytype) in zip(fields, tt.PassArgs._fields_):
        assert pytype is (ctypes.c_int if ctype == "int" else ctypes.c_void_p), ctype
    enum = src.split("enum Pass {")[1].split("};")[0]
    ids = [int(v) for v in re.findall(r"= (\d+),", enum)]
    assert ids == [tt.ROW_TILES, tt.FWD_PRODUCTS, tt.FWD_SCAN, tt.FWD_COMPOSITE,
                   tt.FWD_REDUCE, tt.BWD_TOTALS, tt.BWD_SUFFIX, tt.BWD_GRADS]


def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    dev = torch.device("cuda")
    for make in (lambda: hand_built()[0], p8192_case):
        frame = make()
        args = [t.to(dev) for t in frame.args()]
        stats_k, chk_k = tt.train_forward(*args, frame.n_chk, **frame.geom)
        stats_p, chk_p = tt.train_forward_plain(*args, frame.n_chk, **frame.geom)
        assert float((stats_k - stats_p).abs().max()) <= 1e-4
        for _, rows in frame.walked(stats_p):
            if rows.stop > rows.start:
                assert float((chk_k[rows] - chk_p[rows]).abs().max()) <= 1e-4
        gout = cotangent(frame, seed=2).to(dev)
        d_k = tt.train_backward(*args, gout, stats_k, chk_k, **frame.geom)
        d_p = tt.train_backward_plain(*args, gout, stats_p, chk_p, **frame.geom)
        for col in range(tt.GRAD_COLS):
            scale = float(d_p[:, col].abs().max())
            assert float((d_k[:, col] - d_p[:, col]).abs().max()) <= 1e-4 * scale
