"""The port's blocked GEMM (``ops/cuda/matmul.py``) against the JAX
package's ``ops/pallas/matmul.py``.

The JAX ``matmul_pallas`` runs its Pallas kernel in interpret mode, as
the JAX package's own tests run it on the CPU. Inputs are bf16 values
(f32 NumPy arrays rounded to bf16 once, then handed to both packages).
A product of two bf16 values is exact in f32, so the two packages differ
only in the order of the f32 sums: the tolerance is 1e-6 of the largest
|entry| (f32 epsilon times a few, for K ≤ 512). The CUDA kernel runs only
on a card (``chip_smoke.py`` holds it against the plain version there at
8192³); its test here skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.pallas.matmul import matmul_pallas

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.cuda import matmul

from test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_TOL = 1e-6

# (M, K, N, block): the JAX test harness's shape class with 128 blocks,
# and an edge shape no 128-tile divides, with 8 blocks.
_CASES = {"128_blocks": (256, 512, 384, 128), "edge_8_blocks": (264, 136, 328, 8)}


def _bf16_pair(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(torch.bfloat16)
    return a, b


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_matches_jax(case):
    m, k, n, blk = _CASES[case]
    a, b = _bf16_pair(m, k, n, seed=m)
    ja = jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(matmul_pallas(ja, jb, bm=blk, bn=blk, bk=blk))
    got = matmul.matmul_blocked_plain(a, b, bm=blk, bn=blk, bk=blk)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= REL_TOL * scale
    # The wrapper on CPU tensors runs the plain version, counting nothing.
    before = gt.matmul_blocked.launches
    torch.testing.assert_close(gt.matmul_blocked(a, b, bm=blk, bn=blk, bk=blk), got,
                               rtol=0, atol=0)
    assert gt.matmul_blocked.launches == before


def test_ones_closed_form():
    """``matrix_test --ones``: every entry of ones(n, n) @ ones(n, n) is n."""
    o = torch.ones((512, 512), dtype=torch.bfloat16)
    out = gt.matmul_blocked(o, o, bm=256, bn=256, bk=256)
    assert torch.equal(out, torch.full((512, 512), 512.0))


@pytest.mark.parametrize(
    "shapes,blocks",
    [
        (((256, 512), (512, 384)), (512, 128, 128)),  # M not a multiple of bm
        (((256, 512), (512, 384)), (128, 256, 128)),  # N
        (((256, 520), (520, 384)), (128, 128, 128)),  # K
    ],
)
def test_block_multiple_contract(shapes, blocks):
    a = torch.zeros(shapes[0], dtype=torch.bfloat16)
    b = torch.zeros(shapes[1], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block multiples"):
        gt.matmul_blocked(a, b, *blocks)
    with pytest.raises(ValueError, match="block multiples"):
        matmul.matmul_blocked_plain(a, b, *blocks)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        gt.matmul_blocked(a, b.T)


def _offset_view(rows, cols, elements):
    """A contiguous bf16 (rows, cols) view that starts ``elements`` into
    its storage."""
    flat = torch.zeros(rows * cols + elements, dtype=torch.bfloat16)
    return flat[elements:].view(rows, cols)


# (A, B, route): TMA takes K and N multiples of 8 with 16-byte-aligned
# bases; everything else takes the packed route.
_DISPATCH = {
    "8192_cube": (lambda: torch.empty((8192, 8192), dtype=torch.bfloat16),
                  lambda: torch.empty((8192, 8192), dtype=torch.bfloat16), "sm90"),
    "8192_k_8192_n_1024": (lambda: torch.empty((8192, 8192), dtype=torch.bfloat16),
                           lambda: torch.empty((8192, 1024), dtype=torch.bfloat16), "sm90"),
    "edge_264_136_328": (lambda: torch.empty((264, 136), dtype=torch.bfloat16),
                         lambda: torch.empty((136, 328), dtype=torch.bfloat16), "sm90"),
    "odd_37_13_29": (lambda: torch.empty((37, 13), dtype=torch.bfloat16),
                     lambda: torch.empty((13, 29), dtype=torch.bfloat16), "packed"),
    "k_not_8": (lambda: torch.empty((64, 12), dtype=torch.bfloat16),
                lambda: torch.empty((12, 64), dtype=torch.bfloat16), "packed"),
    "n_not_8": (lambda: torch.empty((64, 64), dtype=torch.bfloat16),
                lambda: torch.empty((64, 60), dtype=torch.bfloat16), "packed"),
    "a_offset_2_bytes": (lambda: _offset_view(264, 136, 1),
                         lambda: torch.empty((136, 328), dtype=torch.bfloat16), "packed"),
    "b_offset_8_bytes": (lambda: torch.empty((264, 136), dtype=torch.bfloat16),
                         lambda: _offset_view(136, 328, 4), "packed"),
    "a_offset_16_bytes": (lambda: _offset_view(264, 136, 8),
                          lambda: torch.empty((136, 328), dtype=torch.bfloat16), "sm90"),
}


@pytest.mark.parametrize("case", sorted(_DISPATCH))
def test_gemm_kernel_dispatch(case):
    """Which route serves a product depends on shape and alignment alone."""
    make_a, make_b, want = _DISPATCH[case]
    a, b = make_a(), make_b()
    assert a.is_contiguous() and b.is_contiguous()
    assert matmul.gemm_kernel(a, b) == want


def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    mm = gt.matmul_blocked
    # (M, K, N, block, A's offset in elements): the last case's A starts
    # 2 bytes off 16-byte alignment, which only the packed route takes.
    cases = [(*c, 0) for c in _CASES.values()] + [(37, 13, 29, 1, 0), (264, 136, 328, 8, 1)]
    for m, k, n, blk, offset in cases:
        a, b = (t.cuda() for t in _bf16_pair(m, k, n, seed=k))
        if offset:
            a = torch.cat([a.flatten()[:offset], a.flatten()])[offset:].view(m, k)
        kernel = matmul.gemm_kernel(a, b)
        assert kernel == ("sm90" if k % 8 == n % 8 == 0 and a.data_ptr() % 16 == 0
                          else "packed")
        before = (mm.launches, mm.launches_sm90, mm.launches_packed)
        got = mm(a, b, bm=blk, bn=blk, bk=blk)
        torch.cuda.synchronize()
        sm90 = int(kernel == "sm90")
        assert (mm.launches, mm.launches_sm90, mm.launches_packed) == (
            before[0] + 1, before[1] + sm90, before[2] + 1 - sm90)
        want = matmul.matmul_blocked_plain(a, b, bm=blk, bn=blk, bk=blk)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("offset", [0, 1])
def test_packed_route_at_1001_on_cuda(offset):
    """matrix_test's odd run, (1001, 1001) x (1001, 1001) with 7-blocks,
    through the packed route: A as it is, and A as a view 2 bytes off
    16-byte alignment. Two launches give the same bits; the product is
    within 1e-5 of the largest entry of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    mm, n = gt.matmul_blocked, 1001
    a, b = (t.cuda() for t in _bf16_pair(n, n, n, seed=n + offset))
    if offset:
        a = torch.cat([a.flatten()[:offset], a.flatten()])[offset:].view(n, n)
        assert a.is_contiguous() and a.data_ptr() % 16 != 0
    assert matmul.gemm_kernel(a, b) == "packed"
    before = (mm.launches, mm.launches_sm90, mm.launches_packed)
    got = mm(a, b, bm=7, bn=7, bk=7)
    again = mm(a, b, bm=7, bn=7, bk=7)
    torch.cuda.synchronize()
    assert (mm.launches, mm.launches_sm90, mm.launches_packed) == (
        before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = matmul.matmul_blocked_plain(a, b, bm=7, bn=7, bk=7)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

