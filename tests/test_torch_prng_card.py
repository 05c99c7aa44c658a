"""The draw kernel (``csrc/prng.cu``) against its plain version on a CUDA
card; skipped where there is none (chip_smoke.py's densify-draw phase
runs the same checks on the H100). No JAX here, so the file runs on a
machine with a card:

    python -m pytest tests/test_torch_prng_card.py -q -n 0

Gates: bits and uniforms bit-equal to the plain version's on the CPU,
normals within 4 ulp of them, two launches bit-equal, one launch a call,
the bf16 draw within one bf16 ulp (an erf_inv a few f32 ulp off may round
the other way).
"""

import numpy as np
import pytest
import torch

from gaussianrenderer_tpu_torch.ops.cuda import prng

MAX_ULP = 4


def ulp_distance(a, b):
    """|a - b| in float32 units in the last place (int64 array)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", [0, 20, -1])
def test_kernel_matches_plain_on_cuda(seed):
    dev = _cuda()
    shape = (500_000, 3)
    before = prng.launches
    bits = prng.random_bits(seed, shape, dev)
    u = prng.uniform(seed, shape, dev)
    eps = prng.normal(seed, shape, dev)
    again = prng.normal(seed, shape, dev)
    torch.cuda.synchronize()
    assert prng.launches - before == 4
    assert torch.equal(bits.cpu(), prng.random_bits_plain(seed, shape))
    assert torch.equal(u.cpu().view(torch.int32),
                       prng.uniform_plain(seed, shape).view(torch.int32))
    assert torch.equal(eps.view(torch.int32), again.view(torch.int32))
    d = ulp_distance(eps.cpu().numpy(), prng.normal_plain(seed, shape).numpy())
    assert d.max() <= MAX_ULP


def test_bf16_kernel_matches_plain_on_cuda():
    dev = _cuda()
    got = prng.normal(0, (300, 300), dev, torch.bfloat16).cpu().float()
    plain = prng.normal_plain(0, (300, 300), dtype=torch.bfloat16).float()
    assert bool(((got - plain).abs() <= plain.abs() * 2.0**-7).all())
    assert prng.normal(0, (0, 3), dev).shape == (0, 3)
