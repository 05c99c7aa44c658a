"""The port's bitonic block sort (``ops/cuda/block_sort.py``) against the
JAX package's ``ops/pallas/block_sort.py``.

The JAX ``block_sort_runs`` runs its Pallas kernel in interpret mode, as
the JAX package's own test runs it on the CPU. The comparison is bit for
bit on all 9 rows: the port reproduces the bitonic network and its tie
rule (swap only when strictly out of order), not merely a sort, so on
tied keys the payload rows must land where the TPU kernel puts them. The
CUDA kernel runs only on a card (``chip_smoke.py`` holds it against the
plain version there at the render path's instance count); its test here
skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.pallas import block_sort as jax_block_sort

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.cuda import block_sort

from test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# case: (run, C, key range); payload rows are random u32.
_CASES = {
    "jax_test_random_u32": (512, 2048, 2**32),
    "tie_heavy_keys": (256, 1024, 16),
}


def _matrix(run, c, key_hi, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (block_sort.ROWS, c), dtype=np.uint32)
    x[0] = rng.integers(0, key_hi, c, dtype=np.uint32)
    return x


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_bit_equal_to_jax(case):
    run, c, key_hi = _CASES[case]
    x = _matrix(run, c, key_hi, seed=run)
    want = np.asarray(jax_block_sort.block_sort_runs(jnp.asarray(x), run=run))
    xt = torch.from_numpy(x.astype(np.int64))
    got = block_sort.block_sort_runs_plain(xt, run=run)
    assert got.dtype == torch.int64 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # The wrapper on a CPU tensor runs the plain version, counting nothing.
    before = gt.block_sort_runs.launches
    np.testing.assert_array_equal(gt.block_sort_runs(xt, run=run).numpy(), got.numpy())
    assert gt.block_sort_runs.launches == before

    stable = np.concatenate([
        b * run + np.argsort(x[0, b * run:(b + 1) * run], kind="stable")
        for b in range(c // run)
    ])
    np.testing.assert_array_equal(want[0], x[0, stable])  # keys: a sort
    if key_hi == 16:
        # Payloads: the network, not a stable sort, in every block.
        for b in range(c // run):
            sl = slice(b * run, (b + 1) * run)
            assert not np.array_equal(want[1:, sl], x[1:, stable[sl]])


def test_permutation_depends_on_keys_alone():
    """The kernel sorts (key, in-run index) pairs and gathers the 9 rows
    by the index. That equals sorting all 9 rows
    because a swap reads only the keys: here the plain network's output
    rows equal the input rows gathered by its own index row."""
    run, c = 256, 1024
    x = _matrix(run, c, 16, seed=5)
    x[1] = np.tile(np.arange(run, dtype=np.uint32), c // run)
    got = block_sort.block_sort_runs_plain(torch.from_numpy(x.astype(np.int64)), run=run)
    src = (np.arange(c) // run) * run + got[1].numpy()
    np.testing.assert_array_equal(got[2:].numpy(), x[2:, src].astype(np.int64))
    np.testing.assert_array_equal(got[0].numpy(), x[0, src].astype(np.int64))


@pytest.mark.parametrize(
    "shape,run,match",
    [
        ((8, 1024), 256, "9, C"),
        ((9, 1000), 256, "multiple"),
        ((9, 1536), 384, "power of two"),
        ((9, 1024), 128, "power of two"),
    ],
)
def test_contract_violations_raise(shape, run, match):
    x = torch.zeros(shape, dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        block_sort.block_sort_runs_plain(x, run=run)
    with pytest.raises(ValueError, match=match):
        gt.block_sort_runs(x, run=run)


def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    for run, c, key_hi in ((256, 1 << 16, 16), (2048, 1 << 16, 2**32), (16384, 1 << 16, 2**32)):
        x = torch.from_numpy(_matrix(run, c, key_hi, seed=run).astype(np.int64)).cuda()
        before = gt.block_sort_runs.launches
        got = gt.block_sort_runs(x, run=run)
        torch.cuda.synchronize()
        assert gt.block_sort_runs.launches == before + 1
        assert torch.equal(got, block_sort.block_sort_runs_plain(x, run=run))
    with pytest.raises(ValueError, match="largest"):
        gt.block_sort_runs(torch.zeros((9, 32768), dtype=torch.int64, device="cuda"),
                           run=32768)
