"""One training step (``make_train_step`` with ``make_optimizer`` and with
``make_3dgs_optimizer``), the optimizers' arithmetic and
``reset_opacity``, against the JAX package's ``train`` module and optax on
the CPU; loss descent and the timed (spacetime) step on the port alone.

Gates: from the same parameters and target, the loss within 1e-5
relative, and every updated leaf within 1e-6 of JAX's for the elements
whose JAX gradient is above 1e-3 of the leaf's largest and 1000× Adam's
eps (Adam's first step is ``rate · g / (|g| + eps)``: about ``±rate``
whatever |g| is, so an element whose gradient is float noise may step
either way, and near eps a small gradient difference moves the step;
those elements are held to two step sizes). Unit gradients give each group its 3DGS rate
exactly as optax does (1e-6 relative). ``reset_opacity``: parameters
equal, opacity moments zeroed, the rest untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu import train as jtrain
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_params

from test_torch_common import np_tree, one_torch_thread  # noqa: F401
from test_torch_train import LEAVES, train_setup

pytestmark = pytest.mark.usefixtures("one_torch_thread")


#: First-step size of each leaf (make_optimizer; make_3dgs_optimizer at
#: scene extent 2, before the SH bands' ÷20).
RATES = {
    "adam": dict.fromkeys(LEAVES + ("time_params",), 1e-2),
    "3dgs": dict(positions=3.2e-4, sh=2.5e-3, raw_opacity=5e-2, raw_scales=5e-3,
                 quats=1e-3),
}


def _optimizers(kind):
    if kind == "adam":
        return jtrain.make_optimizer(), gt.make_optimizer()
    return jtrain.make_3dgs_optimizer(scene_extent=2.0), gt.make_3dgs_optimizer(2.0)


def check_step(kind, before, got, want, jgrad, leaves):
    """Updated leaves against JAX's: within 1e-6 where the JAX gradient
    is above 1e-3 of the leaf's largest and 1000× eps, within two steps
    elsewhere, and the step taken."""
    eps = {"adam": 1e-8, "3dgs": 1e-15}[kind]
    for f in leaves:
        rate = RATES[kind][f]
        new, ref = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        g = np.abs(np.asarray(getattr(jgrad, f)))
        firm = (g > 1e-3 * g.max()) & (g > 1e3 * eps)
        assert firm.mean() > 0.2, f  # the comparison covers many elements
        diff = np.abs(new - ref)
        assert diff[firm].max() <= 1e-6, (kind, f, diff[firm].max())
        assert diff.max() <= 2.0 * rate * (1 + 1e-5), (kind, f)
        moved = np.abs(new - getattr(before, f).numpy())
        assert moved.max() > 0.5 * rate / (20 if f == "sh" and kind == "3dgs" else 1)


@pytest.mark.parametrize("kind", ["adam", "3dgs"])
def test_one_step_matches_jax(kind):
    (jp, jcfg, jcam), (pp, pcfg, pcam), target = train_setup()
    jopt, popt = _optimizers(kind)
    jstep, _ = jtrain.make_train_step(jcfg, optimizer=jopt)
    pstep, _ = gt.make_train_step(pcfg, optimizer=popt)
    jgrad = jax.jit(jax.grad(jtrain.mse_loss), static_argnums=(3,))(
        jp, jcam, jnp.asarray(target), jcfg)
    jp1, _, jloss = jstep(jp, jopt.init(jp), jcam, jnp.asarray(target))
    pp1, pstate, ploss = pstep(pp, popt.init(pp), pcam, torch.from_numpy(target))
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * float(jloss)
    assert int(pstate.count) == 1
    check_step(kind, pp, pp1, jp1, jgrad, LEAVES)


def test_optimizer_rates_match_optax():
    """Unit gradients: Adam's first update is ±rate per group; SH bands
    past the DC term train at sh_lr/20; the position rate follows
    ``optax.exponential_decay`` with its end-value floor."""
    js = jax_make_scene(64, seed=5, spacetime=True)
    jp = jtrain.SceneParams.from_scene(js)
    pp = to_torch_params(np_tree(jp), "cpu")
    jopt, popt = jtrain.make_3dgs_optimizer(scene_extent=2.0), gt.make_3dgs_optimizer(2.0)
    jup, _ = jopt.update(jax.tree.map(jnp.ones_like, jp), jopt.init(jp), jp)
    pup, _ = popt.update(gt.SceneParams(*(torch.ones_like(p) for p in pp)),
                         popt.init(pp), pp)
    for f in LEAVES + ("time_params",):
        np.testing.assert_allclose(getattr(pup, f).numpy(), np.asarray(getattr(jup, f)),
                                   rtol=1e-6, atol=0)
    sh = np.abs(pup.sh.numpy())
    np.testing.assert_allclose(sh[:, :3], 2.5e-3, rtol=1e-5)
    np.testing.assert_allclose(sh[:, 3:], 2.5e-3 / 20.0, rtol=1e-5)
    sched = popt.rates["positions"]
    for count in (0, 1, 1000, 30_000, 60_000):
        want = float(_optax_pos_rate(count))
        assert abs(float(sched(torch.tensor(count, dtype=torch.int32))) - want) <= (
            1e-6 * want)


def _optax_pos_rate(count):
    import optax

    return optax.exponential_decay(
        init_value=1.6e-4 * 2.0, transition_steps=30_000, decay_rate=1.6e-6 / 1.6e-4,
        end_value=1.6e-6 * 2.0,
    )(jnp.int32(count))


def test_reset_opacity_matches_jax():
    js = jax_make_scene(64, seed=4)
    jp = jtrain.SceneParams.from_scene(js)
    pp = to_torch_params(np_tree(jp), "cpu")
    jopt, popt = jtrain.make_3dgs_optimizer(), gt.make_3dgs_optimizer()
    _, jstate = jopt.update(jax.tree.map(jnp.ones_like, jp), jopt.init(jp), jp)
    _, pstate = popt.update(gt.SceneParams(*(
        None if p is None else torch.ones_like(p) for p in pp)), popt.init(pp), pp)
    jp2, _ = jtrain.reset_opacity(jp, jstate, ceiling=0.01)
    pp2, pstate2 = gt.reset_opacity(pp, pstate, ceiling=0.01)
    np.testing.assert_array_equal(pp2.raw_opacity.numpy(), np.asarray(jp2.raw_opacity))
    assert float(torch.sigmoid(pp2.raw_opacity).max()) <= 0.0100001
    assert float(pstate2.mu.raw_opacity.abs().max()) == 0.0
    assert float(pstate2.nu.raw_opacity.abs().max()) == 0.0
    assert float(pstate2.mu.positions.abs().max()) > 0.0
    assert isinstance(gt.reset_opacity(pp, ceiling=0.5), gt.SceneParams)


def test_training_reduces_loss():
    """tests/test_train.py::test_training_reduces_loss on the port: from
    perturbed SH and opacity, 15 Adam steps halve the MSE to the true
    scene's render (the training kernels' plain versions)."""
    (_, _, _), (pp, pcfg, pcam), _ = train_setup()
    target = gt.render_for_training(pp, pcam, pcfg).detach()
    noise = np.random.default_rng(0).normal(size=tuple(pp.sh.shape)).astype(np.float32)
    params = pp._replace(sh=pp.sh + 0.3 * torch.from_numpy(noise),
                         raw_opacity=pp.raw_opacity - 0.5)
    step, opt = gt.make_train_step(pcfg)
    state = opt.init(params)
    losses = []
    for _ in range(15):
        params, state, loss = step(params, state, pcam, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.5, losses


def test_timed_step_on_spacetime_scene():
    """``timed=True``: the step takes a time value, velocities get
    gradients through ``slice_spacetime``, and one step matches JAX's."""
    (_, jcfg, jcam), (_, pcfg, pcam), target = train_setup()
    js = jax_make_scene(120, seed=2, scale_range=(0.05, 0.2), spacetime=True)
    jp = jtrain.SceneParams.from_scene(js)
    pp = to_torch_params(np_tree(jp), "cpu")
    t = jnp.float32(0.7)
    jstep, jopt = jtrain.make_train_step(jcfg, timed=True)
    pstep, popt = gt.make_train_step(pcfg, timed=True)
    with pytest.raises(TypeError):
        pstep(pp, popt.init(pp), pcam, torch.from_numpy(target))
    jgrad = jax.jit(jax.grad(jtrain.mse_loss), static_argnums=(3,))(
        jp, jcam, jnp.asarray(target), jcfg, t)
    assert float(jnp.abs(jgrad.time_params[:, 2:]).max()) > 0
    jp1, _, jloss = jstep(jp, jopt.init(jp), jcam, jnp.asarray(target), t)
    pp1, _, ploss = pstep(pp, popt.init(pp), pcam, torch.from_numpy(target), 0.7)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * float(jloss)
    check_step("adam", pp, pp1, jp1, jgrad, LEAVES + ("time_params",))
