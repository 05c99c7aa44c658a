"""The port's sort components (``ops/sort.py``) against the JAX package's.

Every comparison is bit-exact: the keys are u32 values (carried as int64
in the port) and the sorts are exact. ``sort_packed`` and
``radix_sort_u32`` are stable in both packages, so their payloads must
be equal too; the JAX ``sort_two_key`` is an unstable ``lax.sort``, so
its payloads are compared as multisets within each group of equal keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops import sort as jsort

from gaussianrenderer_tpu_torch.ops import sort as tsort


def _keys(n, seed=0, tile_bits=11):
    """Seeded (tiles int32, depths u32): with 11 tile bits half the packed
    keys have the top bit set."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 1 << tile_bits, n, dtype=np.int32)
    depths = rng.integers(0, 1 << (32 - tile_bits), n, dtype=np.uint32)
    return tiles, depths


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_pack_unpack_round_trip_bit_equal():
    tiles, depths = _keys(1000)
    jkey = np.asarray(jsort.pack_key(jnp.asarray(tiles), jnp.asarray(depths), 21))
    key = tsort.pack_key(_t(tiles), _t(depths), 21)
    np.testing.assert_array_equal(key.numpy(), jkey.astype(np.int64))
    assert int(key.max()) >= 2**31  # keys with the top bit set
    t2, d2 = tsort.unpack_key(key, 21)
    jt2, jd2 = jsort.unpack_key(jnp.asarray(jkey), 21)
    assert t2.dtype == torch.int32
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt2))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2).astype(np.int64))
    np.testing.assert_array_equal(t2.numpy(), tiles)
    np.testing.assert_array_equal(d2.numpy(), depths)


@pytest.mark.parametrize("n", [1, 7, 1000, 50_000])
def test_sort_packed_and_radix_bit_equal(n):
    """Keys and payloads of both stable sorts equal the JAX package's; the
    radix composition equals the monolithic sort."""
    tiles, depths = _keys(n, seed=n)
    jkey = jsort.pack_key(jnp.asarray(tiles), jnp.asarray(depths), 21)
    jvid = jnp.arange(n, dtype=jnp.int32)
    key = tsort.pack_key(_t(tiles), _t(depths), 21)
    vid = torch.arange(n, dtype=torch.int32)

    kp, vp = tsort.sort_packed(key, vid)
    jkp, jvp = jsort.sort_packed(jkey, jvid)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp).astype(np.int64))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jvp))
    assert bool(tsort.is_nondecreasing(kp))

    kr, vr = tsort.radix_sort_u32(key, vid)
    jkr, jvr = jsort.radix_sort_u32(jkey, jvid)
    np.testing.assert_array_equal(kr.numpy(), np.asarray(jkr).astype(np.int64))
    np.testing.assert_array_equal(vr.numpy(), np.asarray(jvr))
    np.testing.assert_array_equal(kr.numpy(), kp.numpy())
    np.testing.assert_array_equal(vr.numpy(), vp.numpy())


@pytest.mark.parametrize("digit_bits", [4, 8, 16])
def test_radix_digit_widths_bit_equal(digit_bits):
    """Full-range u32 keys (half ≥ 2³¹) with many ties: every digit width
    gives the JAX 8-bit composition's keys and payloads."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, 5000, dtype=np.uint32)
    keys[::3] = keys[0]  # tie groups: stability shows in the payloads
    vid = np.arange(5000, dtype=np.int32)
    jk, jv = jsort.radix_sort_u32(jnp.asarray(keys), jnp.asarray(vid), digit_bits=8)
    k, v = tsort.radix_sort_u32(_t(keys), torch.from_numpy(vid), digit_bits=digit_bits)
    assert k.dtype == torch.int64
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # An int32 key wraps to u32 as astype(uint32) does.
    (k32,) = tsort.radix_sort_u32(torch.from_numpy(keys.view(np.int32)), digit_bits=digit_bits)
    np.testing.assert_array_equal(k32.numpy(), k.numpy())


def test_sort_two_key_matches_jax():
    tiles, depths = _keys(20_000, seed=9, tile_bits=4)  # 16 tiles: heavy hi ties
    depths[::2] = depths[0]  # and (hi, lo) ties
    vid = np.arange(tiles.size, dtype=np.int32)
    jh, jl, jv = jsort.sort_two_key(jnp.asarray(tiles), jnp.asarray(depths), jnp.asarray(vid))
    h, l, v = tsort.sort_two_key(torch.from_numpy(tiles), _t(depths), torch.from_numpy(vid))
    assert h.dtype == torch.int32 and l.dtype == torch.int64 and v.dtype == torch.int32
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl).astype(np.int64))
    key = h.numpy().astype(np.int64) << 32 | l.numpy()
    bounds = np.flatnonzero(np.diff(key)) + 1
    groups = 0
    for a, b in zip(np.split(v.numpy(), bounds), np.split(np.asarray(jv), bounds)):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
        groups += a.size > 1
    assert groups > 0
    # The packed sort agrees with the oracle on the packed key.
    key_o = tsort.pack_key(h, l, 28)
    (kp,) = tsort.sort_packed(tsort.pack_key(torch.from_numpy(tiles), _t(depths), 28))
    assert torch.equal(kp, key_o)


@pytest.mark.parametrize(
    "keys",
    [[1, 2, 2, 3], [3, 2], [5], [2**32 - 1, 2**32 - 1], [0, 2**31, 2**31 - 1]],
)
def test_is_nondecreasing_matches_jax(keys):
    want = bool(jsort.is_nondecreasing(jnp.asarray(np.array(keys, np.uint32))))
    got = tsort.is_nondecreasing(torch.tensor(keys, dtype=torch.int64))
    assert got.dtype == torch.bool and bool(got) == want
