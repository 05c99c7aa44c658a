"""Adaptive density control (``DensifyState``, ``accumulate_densify_stats``,
the densifying train step and ``densify_step``) against the JAX package's
``train`` module on the CPU, and the port's own episode properties.

Gates:
- ``accumulate_densify_stats``: accumulators within 1e-6 relative, the
  visible count exact;
- the densifying step (one step of ``_make_step_fn(densify=True)``, the
  scan compositor on both sides): the view-space gradient norms within
  1e-3 of the largest JAX norm (the training gradients' tolerance,
  tests/test_torch_train.py), on a scene where no splat dominates a
  column; ``visible`` (the denominators) and ``needed`` exactly equal;
  the loss within 1e-5 relative; the parameters bit-equal to the
  non-densifying step's;
- ``densify_step`` with ``_densify_eps`` replaced by JAX's
  ``jax.random.normal(PRNGKey(seed))`` draw itself, so that only the
  episode's own arithmetic is compared: refill mask (the rows whose
  all-ones Adam moments were zeroed), ``recycled``/``dead``/``eligible``
  and the moment resets exactly equal, every parameter within 1e-6
  absolute (the port's own draw is JAX's within 4 ulp; the same episodes
  with nothing replaced are in tests/test_torch_prng.py);
- the split quantile bit-equal to ``jnp.nanquantile``.
The port's own draw is also held to the JAX tests' properties: refills
near their donors, survivors untouched, and one seed giving one episode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussianrenderer_tpu import train as jtrain
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import train as ptrain
from gaussianrenderer_tpu_torch.convert import (
    to_torch_adam_state,
    to_torch_densify_state,
    to_torch_params,
)

from test_torch_common import np_tree, one_torch_thread  # noqa: F401
from test_torch_train import LEAVES, train_setup

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_eps(seed, n, device):
    """The JAX package's densify sample draw, as a torch tensor."""
    eps = jax.random.normal(jax.random.PRNGKey(seed), (n, 3), jnp.float32)
    return torch.from_numpy(np.array(eps)).to(device)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(ptrain, "_densify_eps", jax_eps)


def densify_setup(n=64, n_dead=10, n_hot=6, seed=3, hot_scores=None):
    """tests/test_train.py ``_densify_setup`` (JAX params and state):
    ``n_dead`` near-transparent splats, then ``n_hot`` splats whose mean
    gradient is ``hot_scores`` (default 0.01 each)."""
    params = jtrain.SceneParams.from_scene(
        jax_make_scene(n, seed=seed, scale_range=(0.05, 0.2)))
    raw_op = np.asarray(params.raw_opacity).copy()
    raw_op[:n_dead] = -8.0
    params = params._replace(raw_opacity=jnp.asarray(raw_op))
    grad_accum = np.zeros(n, np.float32)
    scores = np.full(n_hot, 0.01) if hot_scores is None else np.asarray(hot_scores)
    grad_accum[n_dead:n_dead + n_hot] = 100.0 * scores
    state = jtrain.DensifyState(grad_accum=jnp.asarray(grad_accum),
                                denom=jnp.full((n,), 100.0, jnp.float32),
                                steps=jnp.int32(100))
    return params, state


def both_episodes(params, state, **kw):
    """``densify_step`` in both packages from all-ones Adam moments;
    returns ((params, moments, state, info) JAX, the same port)."""
    opt = optax.adam(1e-2)
    jopt = jax.tree_util.tree_map(
        lambda x: jnp.ones_like(x) if getattr(x, "ndim", 0) else x, opt.init(params))
    adam = jopt[0]
    popt = to_torch_adam_state(np.asarray(adam.count), np_tree(adam.mu), np_tree(adam.nu),
                               device="cpu")
    jout = jtrain.densify_step(params, jopt, state, **kw)
    pout = gt.densify_step(to_torch_params(np_tree(params), "cpu"), popt,
                           to_torch_densify_state(np_tree(state), "cpu"), **kw)
    return jout, pout


def check_episode(jout, pout):
    (jp, jopt, jst, jinfo), (pp, popt, pst, pinfo) = jout, pout
    assert {k: int(v) for k, v in pinfo.items()} == {k: int(v) for k, v in jinfo.items()}
    jrefill = np.asarray(jopt[0].mu.positions)[:, 0] == 0
    prefill = popt.mu.positions[:, 0].numpy() == 0
    np.testing.assert_array_equal(prefill, jrefill)
    assert prefill.sum() == int(jinfo["recycled"])
    for f in gt.SceneParams._fields:
        want = getattr(jp, f)
        if want is None:
            assert getattr(pp, f) is None
            continue
        got = getattr(pp, f).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6, err_msg=f)
        for moments, jm in ((popt.mu, jopt[0].mu), (popt.nu, jopt[0].nu)):
            np.testing.assert_array_equal(getattr(moments, f).numpy(),
                                          np.asarray(getattr(jm, f)), err_msg=f)
    assert int(popt.count) == int(jopt[0].count)
    assert float(pst.grad_accum.abs().sum()) == 0.0 and int(pst.steps) == 0
    return prefill


# ------------------------------------------------------------ statistics
@pytest.mark.parametrize("with_visible", [True, False])
def test_accumulate_densify_stats_matches_jax(with_visible):
    rng = np.random.default_rng(7)
    n = 300
    js, ps = jtrain.DensifyState.zero(n), gt.DensifyState.zero(n, device="cpu")
    for _ in range(3):
        g = rng.normal(0, 1e-3, (2, n)).astype(np.float32)
        g[:, rng.uniform(size=n) < 0.3] = 0.0
        vis = rng.uniform(size=n) < 0.7 if with_visible else None
        js = jtrain.accumulate_densify_stats(js, jnp.asarray(g),
                                             None if vis is None else jnp.asarray(vis))
        ps = gt.accumulate_densify_stats(ps, torch.from_numpy(g),
                                         None if vis is None else torch.from_numpy(vis))
    np.testing.assert_allclose(ps.grad_accum.numpy(), np.asarray(js.grad_accum),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ps.denom.numpy(), np.asarray(js.denom))
    assert int(ps.steps) == int(js.steps) == 3
    assert ps.steps.dtype == torch.int32


def test_densifying_step_matches_jax():
    (jp, jcfg, jcam), (pp, pcfg, pcam), target = train_setup()
    n = pp.positions.shape[0]
    jopt, popt = jtrain.make_optimizer(), gt.make_optimizer()
    jstep = jtrain._make_step_fn(jcfg, jopt, jtrain.mse_loss, timed=False, densify=True)
    pstep = ptrain._make_step_fn(pcfg, popt, gt.mse_loss, timed=False, densify=True)
    _, _, jd, jloss, jneeded = jstep(jp, jopt.init(jp), jtrain.DensifyState.zero(n), jcam,
                                     jnp.asarray(target))
    tgt = torch.from_numpy(target)
    pp1, _, pd, ploss, pneeded = pstep(pp, popt.init(pp), gt.DensifyState.zero(n, "cpu"),
                                       pcam, tgt)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * float(jloss)
    want = np.asarray(jd.grad_accum)
    assert want.max() > 0 and (want > 1e-3 * want.max()).mean() > 0.3
    np.testing.assert_allclose(pd.grad_accum.numpy(), want, rtol=0,
                               atol=1e-3 * want.max())
    np.testing.assert_array_equal(pd.denom.numpy(), np.asarray(jd.denom))
    assert float(pd.denom.sum()) > 0
    assert pneeded.dtype == torch.int64 and pneeded.dim() == 0
    assert int(pneeded) == int(jneeded)
    # needed is the training path's emitted instance total.
    _, st = gt.render_frame(pp.to_scene(), pcam, ptrain._training_config(pcfg))
    assert int(st.num_instances) == int(pneeded)
    # The same body without the probe: the same parameters.
    step, _ = gt.make_train_step(pcfg, optimizer=popt)
    plain = step(pp, popt.init(pp), pcam, tgt)[0]
    for f in LEAVES:
        assert torch.equal(getattr(pp1, f), getattr(plain, f)), f
    with pytest.raises(TypeError, match="dstate"):
        pstep(pp, popt.init(pp), pcam, tgt)


# --------------------------------------------------------------- episodes
def _recycle():
    return densify_setup(), {}


def _moment_reset():
    return densify_setup(n_hot=6), {}


def _prune_scale():
    params, state = densify_setup(n_dead=4)
    raw_scales = np.asarray(params.raw_scales).copy()
    raw_scales[10] = np.log(5.0)  # an opaque survivor, ballooned
    return (params._replace(raw_scales=jnp.asarray(raw_scales)), state), {"prune_scale": 1.0}


def _noop():
    params = jtrain.SceneParams.from_scene(jax_make_scene(48, seed=5, scale_range=(0.05, 0.2)))
    return (params, jtrain.DensifyState.zero(48)), {}


def _time_params():
    params, state = densify_setup()
    tp = np.random.default_rng(0).uniform(0, 1, size=(64, 5)).astype(np.float32)
    return (params._replace(time_params=jnp.asarray(tp)), state), {"seed": 9}


def _split_and_clone():
    """20 dead slots, 8 donors of distinct scores: four large (split) and
    four small (clone)."""
    params, state = densify_setup(n_dead=20, n_hot=8,
                                  hot_scores=0.01 + 0.001 * np.arange(8))
    raw_scales = np.asarray(params.raw_scales).copy()
    raw_scales[20:24] = np.log(0.3)
    raw_scales[24:28] = np.log(0.04)
    return (params._replace(raw_scales=jnp.asarray(raw_scales)), state), {"seed": 4}


EPISODES = {"recycle": _recycle, "moment_reset": _moment_reset,
            "prune_scale": _prune_scale, "noop": _noop, "time_params": _time_params,
            "split_and_clone": _split_and_clone}


@pytest.mark.parametrize("case", sorted(EPISODES))
def test_densify_step_matches_jax(case, jax_noise):
    (params, state), kw = EPISODES[case]()
    jout, pout = both_episodes(params, state, **kw)
    refill = check_episode(jout, pout)
    info = {k: int(v) for k, v in pout[3].items()}
    if case == "noop":
        assert info["recycled"] == 0 and not refill.any()
    elif case == "prune_scale":
        assert info["dead"] == 5 and refill[10]
        assert float(torch.exp(pout[0].raw_scales).amax()) <= 1.0 + 1e-5
    else:
        assert info["recycled"] == info["dead"] > 0
    if case == "split_and_clone":
        scales = np.exp(np.asarray(params.raw_scales)).max(1)
        cut = float(jnp.nanquantile(jnp.where(np.arange(64) < 20, jnp.nan, scales), 0.75))
        donors = scales[20:28]
        assert (donors >= cut).sum() == 4 and (donors < cut).sum() == 4
        # Split donors shrink by 1/1.6, clone donors keep their scales.
        shrunk = pout[0].raw_scales[20:28].numpy() - np.asarray(params.raw_scales)[20:28]
        np.testing.assert_allclose(shrunk[:4], np.log(1 / 1.6), rtol=0, atol=1e-6)
        assert (shrunk[4:] == 0).all()
    if case == "time_params":
        np.testing.assert_array_equal(pout[0].time_params[16:].numpy(),
                                      np.asarray(params.time_params)[16:])


@pytest.mark.parametrize("case", ["nan_holes", "no_nan", "one_value", "all_nan", "ties"])
def test_split_quantile_matches_jnp_nanquantile(case):
    rng = np.random.default_rng(11)
    x = rng.uniform(0.001, 0.5, 2049).astype(np.float32)
    if case == "nan_holes":
        x[rng.uniform(size=x.size) < 0.4] = np.nan
    elif case == "one_value":
        x = np.array([0.25], np.float32)
    elif case == "all_nan":
        x = np.full(7, np.nan, np.float32)
    elif case == "ties":
        x = np.round(x * 8) / 8
    for q in (0.75, 0.5, 0.1):
        want = np.asarray(jnp.nanquantile(jnp.asarray(x), q))
        got = ptrain._nanquantile(torch.from_numpy(x), q).numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the port's own draw
def test_densify_refills_donor_neighbourhoods():
    """tests/test_train.py's densify properties with the port's own draw:
    every dead slot refilled within 5σ of a hot donor, survivors
    untouched, stats reset, no low-opacity splat left."""
    n, n_dead, n_hot = 64, 10, 6
    params, state = densify_setup(n, n_dead, n_hot)
    pp = to_torch_params(np_tree(params), "cpu")
    popt = gt.make_optimizer().init(pp)
    new, _, st, info = gt.densify_step(pp, popt, to_torch_densify_state(np_tree(state), "cpu"))
    assert new.positions.shape == (n, 3)
    assert (int(info["dead"]), int(info["eligible"]), int(info["recycled"])) == (
        n_dead, n_hot, n_dead)
    assert float(torch.sigmoid(new.raw_opacity).min()) >= 5e-3
    donors = pp.positions[n_dead:n_dead + n_hot].numpy()
    sigma = float(torch.exp(pp.raw_scales[n_dead:n_dead + n_hot]).max())
    d = np.linalg.norm(new.positions[:n_dead].numpy()[:, None] - donors[None], axis=-1)
    assert (d.min(axis=1) < 5 * sigma + 1e-6).all()
    tail = slice(n_dead + n_hot, n)
    for f in LEAVES:
        assert torch.equal(getattr(new, f)[tail], getattr(pp, f)[tail]), f
    assert float(st.grad_accum.abs().sum()) == 0.0 and int(st.steps) == 0


def test_densify_seed_gives_one_episode():
    params, state = densify_setup()
    pp = to_torch_params(np_tree(params), "cpu")
    ps = to_torch_densify_state(np_tree(state), "cpu")
    popt = gt.make_optimizer().init(pp)
    a = gt.densify_step(pp, popt, ps, seed=5)[0]
    b = gt.densify_step(pp, popt, ps, seed=5)[0]
    c = gt.densify_step(pp, popt, ps, seed=6)[0]
    for f in LEAVES:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.positions[:10], c.positions[:10])
    assert torch.equal(a.positions[10:], c.positions[10:])
