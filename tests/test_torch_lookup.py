"""The port's table lookup (``ops/cuda/lookup.py``) against the JAX package's
``ops/pallas/lookup.py``.

The JAX ``table_lookup`` runs its Pallas kernel in interpret mode, as the
JAX package's own tests run it on the CPU. Everything here is bit-exact:
``bf16_ceil`` is integer arithmetic on the f32 bits, and the lookup
returns a bf16-rounded table value, so no tolerance applies. The CUDA
kernel runs only on a card (``chip_smoke.py`` holds it against the plain
version there, bit for bit); its test here skips without one.
"""

import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.pallas import lookup as jax_lookup

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.cuda import lookup


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_bf16_ceil_bit_equal():
    rng = np.random.default_rng(0)
    seeded = np.concatenate([
        rng.uniform(0.0, 1e4, 4000), rng.exponential(1e6, 4000),
        rng.uniform(0.0, 1.0, 2000) * 1e-30,
    ]).astype(np.float32)
    edges = np.array([
        0x00000000,  # 0
        0x4E800000,  # SAT_NONE = 2^30
        0x3F800000, 0x47800000, 0x41200000,  # low 16 bits already zero
        0x3F800001, 0x3F80FFFF, 0x3F7FFFFF,  # round up within / across
        0x00000001, 0x0000FFFF, 0x00010000,  # subnormals
        0x7F7EFFFF,  # rounds up to the largest bf16-exact finite f32
        0x7F7F0000,  # the largest finite f32 that does not round past the exponent
        0x7F7F0001, 0x7F7FFFFF,  # round past it, to inf (both packages)
    ], np.uint32).view(np.float32)
    x = np.concatenate([seeded, edges])
    want = _bits(np.asarray(jax_lookup.bf16_ceil(x)).astype(np.float32))
    got = lookup.bf16_ceil(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    # Never rounds down, and lands on a bf16 value.
    fin = np.isfinite(got.numpy())
    assert np.all(got.numpy()[fin] >= x[fin])
    assert np.all(_bits(got.numpy()) & 0xFFFF == 0)
    assert float(lookup.bf16_ceil(torch.tensor([2.0**30]))[0]) == gt.satcull.SAT_NONE


# (M, r, N): M not a multiple of 128; M > 16,384 with r > 128 (the 4K
# cutoff pyramid, as satcull.rect_cutoff sizes it); a one-entry table.
_LOOKUP_CASES = {
    "m3000": (3000, 128, 5000),
    "m43035_r384": (43035, 384, 6000),
    "m1": (1, 128, 300),
}


@pytest.mark.parametrize("case", sorted(_LOOKUP_CASES))
def test_table_lookup_plain_bit_equal(case):
    m, r, n = _LOOKUP_CASES[case]
    rng = np.random.default_rng(m)
    # An unrounded f32 table: both round it to bf16 to nearest even.
    table = rng.uniform(0.1, 1e4, m).astype(np.float32)
    table[: min(m, 8)] = np.float32(2.0**30)
    idx = rng.integers(-50, m + 50, n).astype(np.int32)  # out of range: clamped
    idx[:4] = [np.iinfo(np.int32).min, -1, m, np.iinfo(np.int32).max]
    want = np.asarray(jax_lookup.table_lookup(table, idx, r=r, q=128))
    got = lookup.table_lookup_plain(torch.from_numpy(table), torch.from_numpy(idx), r=r)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # The wrapper takes int64 indices too (the emitter's tile ids), and on
    # CPU tensors runs the plain version without counting a launch.
    before = lookup.table_lookup.launches
    got64 = gt.table_lookup(torch.from_numpy(table), torch.from_numpy(idx.astype(np.int64)),
                            r=r)
    assert lookup.table_lookup.launches == before
    np.testing.assert_array_equal(_bits(got64.numpy()), _bits(want))


def test_table_lookup_of_a_ceiled_table_is_take():
    """``test_lookup_kernel_matches_take``, ported: on a bf16-ceiled table
    the lookup is an exact gather."""
    rng = np.random.default_rng(1)
    tab = lookup.bf16_ceil(torch.from_numpy(rng.uniform(0.1, 1e4, 3000).astype(np.float32)))
    idx = torch.from_numpy(rng.integers(0, 3000, 5000).astype(np.int32))
    torch.testing.assert_close(gt.table_lookup(tab, idx), tab[idx.long()], rtol=0, atol=0)


def test_table_lookup_rejects_what_it_cannot_view():
    with pytest.raises(ValueError, match="exceeds"):
        lookup.table_lookup_plain(torch.zeros(16385), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="empty"):
        gt.table_lookup(torch.zeros(0), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        gt.table_lookup(torch.zeros(4, device="meta"),
                        torch.zeros(3, dtype=torch.int32, device="meta"))


def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    rng = np.random.default_rng(2)
    # The table the kernel's shared memory holds at most (csrc/lookup.cu
    # kMaxEntries), with r sized to view it.
    m_max, r_max = 232448 // 2, 1024
    for m, r in ((3000, 384), (43035, 384), (1, 128), (m_max, r_max)):
        table = torch.from_numpy(rng.uniform(0.1, 1e4, m).astype(np.float32)).cuda()
        for dtype in (torch.int32, torch.int64):
            full = torch.from_numpy(rng.integers(-9, m + 9, 100_008)).to(dtype).cuda()
            # Aligned, with a tail past the last 16-byte vector, and views
            # that start one element (4 or 8 bytes) past a 16-byte boundary.
            for idx in (full[:100_000], full[:100_003], full[1:100_006], full[1:8]):
                before = gt.table_lookup.launches
                got = gt.table_lookup(table, idx, r=r)
                torch.cuda.synchronize()
                assert gt.table_lookup.launches == before + 1
                want = lookup.table_lookup_plain(table, idx, r=r)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32))
