"""Multi-device training of the port (``make_multichip_train_step``,
``fit_scene(mesh=...)``) on 4 gloo ranks on the CPU, against the port's
single device and the JAX package.

Gates:
- ``pad_params_for_mesh`` and ``pad_target_for_mesh`` equal the JAX
  functions;
- the mesh step's loss equals the single-device MSE within 1e-6 relative,
  and its gradients, concatenated over the ranks, equal the port's
  single-device autograd within the JAX package's own multi-chip bound
  (tests/test_train.py:316, :554: 3e-7 absolute, or relative to the
  largest) and ``jax.grad`` within the port's bound against JAX
  (tests/test_torch_train.py: 1e-3 of the largest), for equal strips and
  balanced strips with an empty strip, with the scan compositor and with
  the training kernels' path;
- ``fit_scene(mesh)`` on a scene padded to the mesh: losses within 1e-3
  relative of the JAX package's ``fit_scene(mesh=...)`` on a 4-device CPU
  mesh (equal strips) and of the port's single-device fit (balanced
  strips); the same whole params on every rank;
- its checkpoints: rank 0's step-4 checkpoint read by a single-device
  ``load_checkpoint`` is the returned params bit for bit; the step-2
  checkpoint restored onto the rank shards is the padded state's rows;
  a resume from step 2 repeats the losses and params bit for bit.

The ranks start once for the module (``spawn``); the rank side imports
only torch and the port, and takes the scene and targets as arrays.
"""

import os

import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import parallel as par
from gaussianrenderer_tpu_torch import train as ptrain

D = 4
RANK_TIMEOUT = 300.0
BOUNDS = (0, 2, 3, 3, 8)
GRAD_TOL_JAX = 1e-3
FIT_STEPS = 4
FIT_REL = 1e-3
#: Splats of the fit: not a multiple of D, so the mesh pads.
FIT_N = 122


def setup_arrays(n=120):
    """tests/test_train.py's training setup (the port's test_torch_train
    ``train_setup`` scene) as NumPy: params with SH + 0.1, and the target
    the unshifted params render through JAX's render_for_training."""
    import jax.numpy as jnp

    from gaussianrenderer_tpu import train as jtrain

    from test_torch_train import train_setup

    (jp, jcfg, jcam), _, _ = train_setup(n=n)
    target = np.asarray(jtrain.render_for_training(jp, jcam, jcfg))
    jp0 = jp._replace(sh=jp.sh + jnp.float32(0.1))
    return {f: (None if getattr(jp0, f) is None else np.asarray(getattr(jp0, f)))
            for f in jp0._fields}, target


def port_cfg(**kw):
    return gt.RenderConfig(height=64, width=128, compositor="xla", diff_max_chunks=8,
                           num_tile_x=4, num_tile_y=8, **kw)


def port_cam():
    cam = gt.Camera()
    cam.set_position([0.0, 0.0, 5.0])
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(60.0)
    cam.set_aspect_ratio(2.0)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    return cam.params(3.0, device="cpu")


def to_params(arrays):
    return gt.SceneParams(**{k: None if v is None else torch.from_numpy(np.array(v))
                             for k, v in arrays.items()})


class GradGrab:
    """An "optimizer" that keeps the gradients it is given and updates
    nothing."""

    def init(self, params):
        return None

    def update(self, grads, state, params=None):
        self.grads = grads
        return gt.SceneParams(*(None if g is None else torch.zeros_like(g)
                                for g in grads)), state


GRAD_CASES = [(bounds, kernel) for bounds in (None, BOUNDS) for kernel in (False, True)]


def rank_train(mesh, grad_arrays, target, fit_arrays, fit_target, ckpt_dir):
    out = {"grads": {}}
    params = to_params(grad_arrays)
    camp = port_cam()
    tgt = torch.from_numpy(target)
    for bounds, kernel in GRAD_CASES:
        cfg = port_cfg(diff_kernel=kernel)
        grab = GradGrab()
        step, _ = gt.make_multichip_train_step(cfg, mesh, grab, strip_bounds=bounds)
        shard = ptrain._mesh_shard(gt.pad_params_for_mesh(params, D), mesh)
        _, _, loss = step(shard, None, camp, gt.pad_target_for_mesh(tgt, cfg))
        out["grads"][(bounds, kernel)] = (float(loss), {
            k: v.numpy() for k, v in grab.grads._asdict().items() if v is not None})

    cfg = port_cfg(diff_kernel=False)
    start = to_params(fit_arrays)
    views = [(camp, torch.from_numpy(fit_target))]
    opt = gt.make_optimizer(1e-2)
    kw = dict(steps=FIT_STEPS, optimizer=opt, mesh=mesh, log_every=2, opacity_reset_every=3)
    p_eq, h_eq = gt.fit_scene(views, cfg, start, **kw)
    p_bal, h_bal = gt.fit_scene(views, cfg, start, strip_bounds=BOUNDS, **kw)
    p_ck, h_ck = gt.fit_scene(views, cfg, start, checkpoint_dir=ckpt_dir, checkpoint_every=2,
                              **kw)
    step2 = os.path.join(ckpt_dir, "step_000002")
    p_res, h_res = gt.fit_scene(views, cfg, start, resume_from=step2, **kw)
    template = ptrain._mesh_shard(gt.pad_params_for_mesh(start, D), mesh)
    shard, state, _, at = gt.load_checkpoint(step2, template, opt.init(template), mesh=mesh)
    np_tree = lambda t: {k: None if v is None else v.numpy()  # noqa: E731
                         for k, v in t._asdict().items()}
    out["fit"] = dict(
        equal=(np_tree(p_eq), h_eq), balanced=(np_tree(p_bal), h_bal),
        checkpointed=(np_tree(p_ck), h_ck), resumed=(np_tree(p_res), h_res),
        restored=(np_tree(shard), np_tree(state.mu), int(state.count), at),
    )
    return out


@pytest.fixture(scope="module")
def setup():
    return setup_arrays(), setup_arrays(FIT_N)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    (grad_arrays, target), (fit_arrays, fit_target) = setup
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    res = par.spawn(rank_train, D, grad_arrays, target, fit_arrays, fit_target, ckpt,
                    backend="gloo", device="cpu", timeout=RANK_TIMEOUT)
    return res, ckpt


def single_grads(arrays, target, cfg):
    leaves = gt.SceneParams(*(None if x is None else x.requires_grad_(True)
                              for x in to_params(arrays)))
    loss = gt.mse_loss(leaves, port_cam(), torch.from_numpy(np.array(target)), cfg)
    live = [x for x in leaves if x is not None]
    grads = dict(zip([f for f, x in zip(leaves._fields, leaves) if x is not None],
                     torch.autograd.grad(loss, live)))
    return float(loss.detach()), {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("bounds,kernel", GRAD_CASES,
                         ids=[f"{'balanced' if b else 'equal'}-{'kernel' if k else 'scan'}"
                              for b, k in GRAD_CASES])
def test_mesh_gradients_match_single_device(setup, ranks, bounds, kernel):
    (arrays, target), _ = setup
    loss_s, gs = single_grads(arrays, target, port_cfg(diff_kernel=kernel))
    n = arrays["positions"].shape[0]
    for r in ranks[0]:
        assert r["grads"][(bounds, kernel)][0] == ranks[0][0]["grads"][(bounds, kernel)][0]
    loss_m = ranks[0][0]["grads"][(bounds, kernel)][0]
    assert abs(loss_m - loss_s) <= 1e-6 * max(1.0, abs(loss_s))
    for name, g in gs.items():
        gm = np.concatenate([r["grads"][(bounds, kernel)][1][name] for r in ranks[0]])
        assert gm.shape[0] == n
        tol = max(3e-7, 3e-7 * float(np.abs(g).max()))
        np.testing.assert_allclose(gm, g, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("bounds", [None, BOUNDS], ids=["equal", "balanced"])
def test_mesh_gradients_match_jax_grad(setup, ranks, bounds):
    import jax
    import jax.numpy as jnp

    from gaussianrenderer_tpu import train as jtrain

    from test_torch_train import train_setup

    (arrays, target), _ = setup
    (_, jcfg, jcam), _, _ = train_setup()
    jp0 = jtrain.SceneParams(**{k: None if v is None else jnp.asarray(v)
                                for k, v in arrays.items()})
    jg = jax.grad(jtrain.mse_loss)(jp0, jcam, jnp.asarray(target), jcfg)
    for name in ("positions", "sh", "raw_opacity", "raw_scales", "quats"):
        want = np.asarray(getattr(jg, name))
        got = np.concatenate([r["grads"][(bounds, False)][1][name] for r in ranks[0]])
        assert np.abs(want).max() > 0, name
        assert np.abs(got - want).max() <= GRAD_TOL_JAX * np.abs(want).max(), name


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def test_fit_scene_mesh_matches_jax(setup, ranks):
    import jax

    from gaussianrenderer_tpu import train as jtrain
    from gaussianrenderer_tpu.parallel import make_mesh as jax_make_mesh

    from test_torch_train import train_setup

    _, (arrays, target) = setup
    (_, jcfg, jcam), _, _ = train_setup(n=FIT_N)
    start = jtrain.SceneParams(**arrays)
    jparams, jh = jtrain.fit_scene(
        [(jcam, target)], jcfg, start, steps=FIT_STEPS, optimizer=jtrain.make_optimizer(1e-2),
        mesh=jax_make_mesh(jax.devices()[:D]), log_every=2, opacity_reset_every=3)
    (p_eq, h_eq) = ranks[0][0]["fit"]["equal"]
    assert len(h_eq["losses"]) == FIT_STEPS and h_eq["densify"] == [] and h_eq["overflow"] == []
    assert _rel(h_eq["losses"], jh["losses"]) <= FIT_REL
    assert p_eq["positions"].shape == (FIT_N, 3)
    assert np.abs(p_eq["positions"] - np.asarray(jparams.positions)).max() <= 1e-3
    for r in ranks[0][1:]:
        for k, v in r["fit"]["equal"][0].items():
            if v is not None:
                np.testing.assert_array_equal(v, p_eq[k], err_msg=k)


def test_fit_scene_mesh_balanced_matches_single_device(setup, ranks):
    _, (arrays, target) = setup
    _, h1 = gt.fit_scene([(port_cam(), torch.from_numpy(np.array(target)))],
                         port_cfg(diff_kernel=False),
                         to_params(arrays), steps=FIT_STEPS, optimizer=gt.make_optimizer(1e-2),
                         log_every=2, opacity_reset_every=3)
    _, h_bal = ranks[0][0]["fit"]["balanced"]
    assert _rel(h_bal["losses"], h1["losses"]) <= FIT_REL
    assert all(np.isfinite(h_bal["losses"]))


def test_mesh_checkpoint_reads_on_one_device(setup, ranks):
    _, (arrays, _) = setup
    res, ckpt = ranks
    p_ck, h_ck = res[0]["fit"]["checkpointed"]
    template = to_params(arrays)
    opt = gt.make_optimizer(1e-2)
    params, state, _, step = gt.load_checkpoint(os.path.join(ckpt, "step_000004"), template,
                                                opt.init(template))
    assert step == FIT_STEPS and int(state.count) == FIT_STEPS
    for k, v in params._asdict().items():
        if v is not None:
            np.testing.assert_array_equal(v.numpy(), p_ck[k], err_msg=k)
    assert h_ck["losses"] == res[0]["fit"]["equal"][1]["losses"]


def test_mesh_checkpoint_restores_onto_rank_shards(setup, ranks):
    _, (arrays, _) = setup
    res, ckpt = ranks
    saved, state, _, _ = gt.load_checkpoint(os.path.join(ckpt, "step_000002"),
                                            to_params(arrays),
                                            gt.make_optimizer(1e-2).init(to_params(arrays)))
    padded = gt.pad_params_for_mesh(saved, D)
    ns = padded.positions.shape[0] // D
    for rank, r in enumerate(res):
        shard, mu, count, at = r["fit"]["restored"]
        assert at == 2 and count == 2
        for k, v in padded._asdict().items():
            if v is not None:
                np.testing.assert_array_equal(shard[k], v[rank * ns:(rank + 1) * ns].numpy(),
                                              err_msg=k)
        want_mu = state.mu.positions.numpy()[rank * ns:(rank + 1) * ns]
        np.testing.assert_array_equal(mu["positions"][:want_mu.shape[0]], want_mu)
        assert not mu["positions"][want_mu.shape[0]:].any()
    # Resume from step 2: the same losses and params as the uninterrupted run.
    p_ck, h_ck = res[0]["fit"]["checkpointed"]
    p_res, h_res = res[0]["fit"]["resumed"]
    assert h_res["losses"] == h_ck["losses"][2:]
    for k, v in p_ck.items():
        if v is not None:
            np.testing.assert_array_equal(p_res[k], v, err_msg=k)


def test_pad_params_and_target_match_jax():
    import jax.numpy as jnp

    from gaussianrenderer_tpu import train as jtrain
    from gaussianrenderer_tpu.config import RenderConfig as JaxConfig
    from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene

    jp = jtrain.SceneParams.from_scene(jax_make_scene(10, seed=1, spacetime=True))
    pp = to_params({f: np.asarray(getattr(jp, f)) for f in jp._fields})
    assert gt.pad_params_for_mesh(pp, 5) is pp
    for multiple in (4, 8):
        want = jtrain.pad_params_for_mesh(jp, multiple)
        got = gt.pad_params_for_mesh(pp, multiple)
        for f in jp._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)
    target = np.random.default_rng(0).uniform(size=(3, 100, 70)).astype(np.float32)
    for cfg_kw in (dict(height=100, width=70), dict(height=100, width=70, num_tile_y=3)):
        want = jtrain.pad_target_for_mesh(jnp.asarray(target), JaxConfig(**cfg_kw))
        got = gt.pad_target_for_mesh(torch.from_numpy(target), gt.RenderConfig(**cfg_kw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
