"""Bit-exactness of the port's packed-record encoders and of the exact
dead-tile prune against the JAX package (ops/instances.py).

Every integer encode is bit-exact. XLA's CPU sqrt and log are not always
correctly rounded, so the values they produce (the Cholesky factors, the
prune's gain) may differ from torch's by an ulp: those are held at
ULP_RTOL, and the integer steps after them are fed identical inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops import instances as ji

from gaussianrenderer_tpu_torch.ops import instances as pi

#: Two float32 ulps, relative.
ULP_RTOL = 2.4e-7


def _f32(rng, n):
    """Float32 values over the whole encode window and past both ends."""
    mag = 2.0 ** rng.uniform(-60, 30, n)
    vals = np.concatenate([
        mag, -mag, rng.uniform(0, 1, n),
        [0.0, -0.0, 1.0, 2.0 ** -47, 2.0 ** 17, 1.3e5, np.inf, 1e-45],
    ])
    return vals.astype(np.float32)


def _u32(x):
    """Port int64/int32 bit patterns → uint32 NumPy."""
    return (x.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)


def test_e6m10_and_s1e6m9_round_trip_bit_exact():
    rng = np.random.default_rng(0)
    x = _f32(rng, 5000)
    pos = np.abs(x)
    e_j = np.asarray(ji._enc_e6m10(pos))
    e_p = pi._enc_e6m10(torch.from_numpy(pos))
    np.testing.assert_array_equal(e_j, _u32(e_p))
    np.testing.assert_array_equal(
        np.asarray(ji._dec_e6m10(e_j)), pi._dec_e6m10(e_p).numpy()
    )
    s_j = np.asarray(ji._enc_s1e6m9(x))
    s_p = pi._enc_s1e6m9(torch.from_numpy(x))
    np.testing.assert_array_equal(s_j, _u32(s_p))
    np.testing.assert_array_equal(
        np.asarray(ji._dec_s1e6m9(s_j)), pi._dec_s1e6m9(s_p).numpy()
    )
    # Every 16-bit code decodes identically.
    codes = np.arange(65536, dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(ji._dec_e6m10(codes)),
        pi._dec_e6m10(torch.from_numpy(codes.astype(np.int64))).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(ji._dec_s1e6m9(codes)),
        pi._dec_s1e6m9(torch.from_numpy(codes.astype(np.int64))).numpy(),
    )


def test_color_and_rgb10_bits_exact():
    rng = np.random.default_rng(1)
    c = np.concatenate([
        rng.uniform(-0.1, 1.1, 6000), np.arange(1024) / 1023.0,
        (np.arange(1023) + 0.5) / 1023.0, [np.nan, np.inf, -np.inf],
    ]).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(ji._color_bits(c)), _u32(pi._color_bits(torch.from_numpy(c)))
    )
    rgb = c[: (len(c) // 3) * 3].reshape(-1, 3)
    np.testing.assert_array_equal(
        np.asarray(ji._rgb10_bits(rgb)), _u32(pi._rgb10_bits(torch.from_numpy(rgb)))
    )


def test_conic_chol_matches():
    rng = np.random.default_rng(2)
    n = 4000
    lam1 = 10.0 ** rng.uniform(-4, 2, n)
    lam2 = lam1 * 10.0 ** rng.uniform(-5, 0, n)
    th = rng.uniform(0, np.pi, n)
    ct, st = np.cos(th), np.sin(th)
    a = (lam1 * ct * ct + lam2 * st * st).astype(np.float32)
    c = (lam1 * st * st + lam2 * ct * ct).astype(np.float32)
    b = (2.0 * (lam1 - lam2) * ct * st).astype(np.float32)
    a[:3] = [0.0, -1.0, np.nan]
    want = [np.asarray(v) for v in ji._conic_chol(a, b, c)]
    got = pi._conic_chol(*(torch.from_numpy(v) for v in (a, b, c)))
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=ULP_RTOL, atol=0)
    # w = √(C − v²) cancels for needles, magnifying an ulp of v; the conic
    # C = v² + w² it rebuilds is what must agree.
    np.testing.assert_allclose(
        (got[1] * got[1] + got[2] * got[2]).numpy(),
        want[1] * want[1] + want[2] * want[2], rtol=1e-6, atol=0,
    )
    back_j = [np.asarray(v) for v in ji._chol_conic(*(jnp.asarray(x) for x in want))]
    back_p = pi._chol_conic(*(torch.from_numpy(x.copy()) for x in want))
    for w, g in zip(back_j, back_p):
        np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("tile", [(32, 32), (16, 16), (64, 8)])
def test_center_fields_bit_exact(tile):
    """Fine 13.3 centers, COARSE 1-px centers for far off-screen ones, and
    the clip flag beyond even the coarse window."""
    tw, th = tile
    rng = np.random.default_rng(3)
    n = 6000
    scale = np.where(rng.uniform(size=n) < 0.5, 3000.0, 60000.0)
    cx = rng.uniform(-1, 1, n) * scale
    cy = rng.uniform(-1, 1, n) * scale
    cx[:4] = [0.0, 0.5, -2048.0, 6143.875]
    cx = cx.astype(np.float32)
    cy = cy.astype(np.float32)
    tmin_x = rng.integers(0, 60, n).astype(np.int32)
    tmin_y = rng.integers(0, 34, n).astype(np.int32)
    rw = rng.integers(1, 20, n).astype(np.int32)
    rh = rng.integers(1, 20, n).astype(np.int32)
    want = [np.asarray(v) for v in ji._center_fields(cx, cy, tmin_x, tmin_y, rw, rh, tw, th)]
    got = pi._center_fields(
        torch.from_numpy(cx), torch.from_numpy(cy),
        *(torch.from_numpy(v.astype(np.int64)) for v in (tmin_x, tmin_y, rw, rh)),
        tw, th,
    )
    np.testing.assert_array_equal(want[0], _u32(got[0]))
    np.testing.assert_array_equal(want[1], got[1].numpy())
    np.testing.assert_array_equal(want[2], got[2].numpy())
    assert want[1].any() and want[2].any() and not want[1].all()


def _dead_inputs(seed=0, n=4000):
    """The JAX package's brute-force dead-tile inputs: anisotropic conics
    up to condition 1e4, centers around a 32×32 tile at the origin, random
    pixel AABBs."""
    rng = np.random.default_rng(seed)
    lam1 = 10.0 ** rng.uniform(-4, 1, n)
    lam2 = lam1 * 10.0 ** rng.uniform(-4, 0, n)
    th = rng.uniform(0, np.pi, n)
    ct, st = np.cos(th), np.sin(th)
    a = lam1 * ct * ct + lam2 * st * st
    c = lam1 * st * st + lam2 * ct * ct
    b = 2.0 * (lam1 - lam2) * ct * st
    op = 10.0 ** rng.uniform(-2.9, 0, n)
    cx = rng.uniform(-80, 112, n)
    cy = rng.uniform(-80, 112, n)
    ex = rng.uniform(1, 120, n)
    ey = rng.uniform(1, 120, n)
    return a, b, c, op, cx, cy, cx - ex, cy - ey, cx + ex, cy + ey


def test_prune_params_and_tile_dead_match_jax():
    a, b, c, op, cx, cy, x0, y0, x1, y1 = (
        v.astype(np.float32) for v in _dead_inputs()
    )
    prune_j = [np.asarray(v) for v in ji._prune_params(a, b, c, op)]
    prune_p = pi._prune_params(*(torch.from_numpy(v) for v in (a, b, c, op)))
    for w, g in zip(prune_j[:5], prune_p[:5]):
        np.testing.assert_array_equal(w, g.numpy())
    # gain_m = 1.05·(−2 ln ε + 2 ln op) + 0.05: a log ulp, absolute on the
    # ~13.8 constant term.
    np.testing.assert_allclose(prune_p[5].numpy(), prune_j[5], rtol=0, atol=4e-6)
    # The test itself, on identical constants.
    prune_p = tuple(torch.from_numpy(v.copy()) for v in prune_j)
    z = np.zeros_like(cx)
    for ox, oy in ((0.0, 0.0), (32.0, 0.0), (-32.0, 64.0)):
        dead_j = np.asarray(ji._tile_dead(
            prune_j, cx, cy, z + ox, z + oy, x0, y0, x1, y1, 32, 32
        ))
        dead_p = pi._tile_dead(
            prune_p, *(torch.from_numpy(v) for v in (cx, cy, z + ox, z + oy,
                                                      x0, y0, x1, y1)), 32, 32,
        ).numpy()
        np.testing.assert_array_equal(dead_j, dead_p)
        assert 0 < dead_p.sum() < len(dead_p)


def test_tile_dead_safe_and_exact_vs_bruteforce():
    """The port's prune is SAFE (a killed tile has no integer pixel with
    alpha ≥ ALPHA_EPS in f64 math) and EXACT up to its declared margin
    (a tile whose continuous min md² clears gain_m with room is killed)."""
    a, b, c, op, cx, cy, x0, y0, x1, y1 = _dead_inputs(seed=1, n=1500)
    f = [torch.from_numpy(v.astype(np.float32)) for v in (a, b, c, op)]
    prune = pi._prune_params(*f)
    zero = torch.zeros(len(a))
    dead = pi._tile_dead(
        prune, *(torch.from_numpy(v.astype(np.float32)) for v in (cx, cy)),
        zero, zero, *(torch.from_numpy(v.astype(np.float32)) for v in (x0, y0, x1, y1)),
        32, 32,
    ).numpy()
    px = np.arange(32, dtype=np.float64)
    gx, gy = np.meshgrid(px, px, indexing="xy")
    gain = 2.0 * np.log(np.maximum(op, 1e-12) / pi.ALPHA_EPS)
    ts = np.linspace(0, 1, 129)
    killed_wrong = missed = 0
    for i in range(len(a)):
        in_box = (gx >= x0[i]) & (gx <= x1[i]) & (gy >= y0[i]) & (gy <= y1[i])
        dx, dy = gx - cx[i], gy - cy[i]
        md2 = a[i] * dx * dx + b[i] * dx * dy + c[i] * dy * dy
        if dead[i] and (in_box & (md2 <= gain[i])).any():
            killed_wrong += 1
        lx, hx = max(0.0, x0[i]) - cx[i], min(31.0, x1[i]) - cx[i]
        ly, hy = max(0.0, y0[i]) - cy[i], min(31.0, y1[i]) - cy[i]
        if hx < lx or hy < ly:
            missed += not dead[i]
            continue
        edge = np.concatenate([
            np.stack([np.full_like(ts, lx), ly + (hy - ly) * ts], 1),
            np.stack([np.full_like(ts, hx), ly + (hy - ly) * ts], 1),
            np.stack([lx + (hx - lx) * ts, np.full_like(ts, ly)], 1),
            np.stack([lx + (hx - lx) * ts, np.full_like(ts, hy)], 1),
        ])
        bmin = (a[i] * edge[:, 0] ** 2 + b[i] * edge[:, 0] * edge[:, 1]
                + c[i] * edge[:, 1] ** 2).min()
        if lx <= 0 <= hx and ly <= 0 <= hy:
            bmin = 0.0
        if bmin > (gain[i] * 1.05 + 0.05) * 1.05 + 0.1 and not dead[i]:
            missed += 1
    assert killed_wrong == 0
    assert missed == 0
    assert dead.sum() > 100


def test_needle_records_bit_exact_against_eager_jax():
    """Run op by op (no jit fusion), the JAX emitter and the port give the
    same records in the same order on the needle scene, where the jitted
    comparison (test_torch_instances.py) has to allow one chol-w code."""
    from test_torch_instances import emit_both

    jax_inst, port_inst, _ = emit_both("needles", jax_emitter=ji.build_packed_instances)
    total = int(jax_inst.total_instances)
    np.testing.assert_array_equal(
        np.asarray(jax_inst.packed_feats)[:, :total],
        port_inst.packed_feats.numpy().view(np.uint32),
    )
    np.testing.assert_array_equal(
        np.asarray(jax_inst.tile_count), port_inst.tile_count.numpy()
    )
