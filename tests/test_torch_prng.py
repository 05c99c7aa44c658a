"""JAX's random draw in the port (``gaussianrenderer_tpu_torch/ops/cuda/prng.py``)
against ``jax.random`` on the CPU, and the densify episode and a fit that
draw it, with nothing replaced.

Gates:
- ``random_bits_plain`` and ``uniform_plain`` bit-equal to
  ``jax.random.bits`` and ``jax.random.uniform(key, shape, float32,
  nextafter(-1, 0), 1)`` (the uniform under ``jax.random.normal``), for
  seeds 0, 1, 4, 12345, 2^31 - 1 and -1 at (1, 3), (7, 3) and (100003, 3);
- ``normal_plain`` within 4 ulp of ``jax.random.normal`` (log1p is the
  CPU's, not XLA's), on at most 1% of the values (0.96% measured);
- the bf16 draw bit-equal to ``jax.random.normal(PRNGKey(0), (300, 300),
  bfloat16)`` (the GEMM harness's inputs);
- ``densify_step`` with the port's own draw against JAX's on each episode
  of tests/test_torch_densify.py: the counts, the refill mask and every
  moment exactly equal, every parameter within 1e-6 absolute (the
  tolerance of the tests there, which replace the draw by JAX's);
- a small ``fit_scene`` with two episodes against JAX's, again with
  nothing replaced: episode records equal, every loss within 1e-3
  relative (tests/test_torch_fit.py's gate);
The kernel against its plain version on a CUDA card is in
tests/test_torch_prng_card.py (no JAX there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu import train as jtrain

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import train as ptrain
from gaussianrenderer_tpu_torch.convert import to_torch_params
from gaussianrenderer_tpu_torch.ops.cuda import prng

from test_torch_common import np_tree, one_torch_thread  # noqa: F401
from test_torch_densify import EPISODES, both_episodes, check_episode
from test_torch_fit import fit_views, start_params
from test_torch_prng_card import MAX_ULP, ulp_distance

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = (0, 1, 4, 12345, 2**31 - 1, -1)
SHAPES = ((1, 3), (7, 3), (100003, 3))
MAX_SHARE_DIFFERING = 0.01
LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_equal_to_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    got = prng.random_bits_plain(seed, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    want_u = np.asarray(jax.random.uniform(key, shape, jnp.float32, LO, 1.0))
    got_u = prng.uniform_plain(seed, shape)
    assert got_u.dtype == torch.float32
    np.testing.assert_array_equal(got_u.numpy().view(np.int32), want_u.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_4_ulp_of_jax(seed):
    for shape in SHAPES:
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
        got = prng.normal_plain(seed, shape).numpy()
        d = ulp_distance(got, want)
        assert d.max() <= MAX_ULP, (shape, int(d.max()))
        assert (d > 0).mean() <= MAX_SHARE_DIFFERING, (shape, float((d > 0).mean()))


def test_normal_bf16_bit_equal_to_jax():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (300, 300), jnp.bfloat16))
    got = prng.normal_plain(0, (300, 300), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_wrappers_on_the_cpu_are_the_plain_draw():
    """The wrappers take the plain version on the CPU, count no launch,
    and ``_densify_eps`` is JAX's (n, 3) draw; other dtypes, devices and
    negative dimensions raise."""
    before = prng.launches
    torch.testing.assert_close(prng.normal(7, (50, 3), "cpu"), prng.normal_plain(7, (50, 3)),
                               rtol=0, atol=0)
    assert torch.equal(prng.random_bits(7, (4,), "cpu"), prng.random_bits_plain(7, (4,)))
    assert torch.equal(prng.uniform(7, (4,), "cpu"), prng.uniform_plain(7, (4,)))
    eps = ptrain._densify_eps(20, 1000, torch.device("cpu"))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(20), (1000, 3), jnp.float32))
    assert eps.shape == (1000, 3) and ulp_distance(eps.numpy(), want).max() <= MAX_ULP
    assert prng.normal(3, (0, 3), "cpu").shape == (0, 3)
    assert prng.launches == before
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        prng.normal(0, (2,), "cpu", torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        prng.normal(0, (2,), "meta")
    with pytest.raises(ValueError, match="negative"):
        prng.random_bits_plain(0, (-1, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            prng.normal(0, (2,), "cuda")


@pytest.mark.parametrize("case", sorted(EPISODES))
def test_densify_step_own_draw_matches_jax(case):
    """test_torch_densify.py's episodes with the port's own draw."""
    (params, state), kw = EPISODES[case]()
    refill = check_episode(*both_episodes(params, state, **kw))
    assert refill.any() == (case != "noop")


def test_fit_scene_own_draw_matches_jax():
    """test_torch_fit.py's fit against JAX (12 steps, episodes at 4 and
    8) with the port's own draw."""
    (jviews, jcfg), (pviews, pcfg) = fit_views()
    start = start_params()
    kw = dict(steps=12, densify_every=4, opacity_reset_every=7)
    _, jh = jtrain.fit_scene(jviews, jcfg, start, optimizer=jtrain.make_optimizer(1e-2),
                             auto_capacity=False, **kw)
    _, ph = gt.fit_scene(pviews, pcfg, to_torch_params(np_tree(start), "cpu"),
                         optimizer=gt.make_optimizer(1e-2), **kw)
    assert [e["step"] for e in ph["densify"]] == [4, 8]
    assert ph["densify"] == jh["densify"]
    assert all(e["recycled"] > 0 for e in ph["densify"])
    np.testing.assert_allclose(ph["losses"], jh["losses"], rtol=1e-3, atol=0)
