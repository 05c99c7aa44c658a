"""``fit_scene`` (``gaussianrenderer_tpu_torch.train``) against the JAX
package's on the CPU, and the loop's cadences on the port alone.

Gates:
- against JAX's ``fit_scene`` from the same start (2 views, Adam 1e-2,
  12 steps, an episode every 4 steps, an opacity reset at 7, the scan
  compositor on both sides, ``_densify_eps`` replaced by JAX's draw
  itself; the port's own draw, JAX's within 4 ulp, runs the same fit in
  tests/test_torch_prng.py):
  episode records equal and every step's loss within 1e-3 relative. The
  test asserts that no splat's score at an episode lies within 1% of the
  2e-4 threshold, so that float differences cannot flip a donor (the
  episodes recycle 28 and 4 slots);
- resume from ``step_000005`` reproduces the uninterrupted run bit for
  bit (losses and parameters);
- the cadences as ``tests/test_train.py`` pins them for the JAX package:
  episodes at 8 and 16 of 24, the SH warm-up's bands and its two
  warnings, timed views, the snapshot hook, the visible count.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu import train as jtrain
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import train as ptrain
from gaussianrenderer_tpu_torch.convert import to_torch_params

from test_torch_common import both_cameras, np_tree, one_torch_thread  # noqa: F401
from test_torch_densify import jax_eps
from test_torch_train import train_setup

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def fit_views(spread=2.0, poses=2):
    """Views of train_setup's scene from (±spread, 0, 5), in both packages
    (JAX targets carried to the port), and the two configs."""
    (jp, jcfg, _), (_, pcfg, _), _ = train_setup()
    jviews, pviews = [], []
    for i in range(poses):
        x = spread * (2 * i - 1) if poses == 2 else 0.0
        jc, pc, _ = both_cameras(128, 64, pos=(x, 0.0, 5.0), fov=60.0)
        target = jtrain.render_for_training(jp, jc, jcfg)
        jviews.append((jc, target))
        pviews.append((pc, torch.from_numpy(np.array(target))))
    return (jviews, jcfg), (pviews, pcfg)


def start_params(seed=46, kill=20):
    """A seeded random start of 120 splats, the first ``kill`` of them
    transparent (dead at the first episode)."""
    start = jtrain.SceneParams.from_scene(
        jax_make_scene(120, seed=seed, scale_range=(0.05, 0.2)))
    raw = np.asarray(start.raw_opacity).copy()
    raw[:kill] = -8.0
    return start._replace(raw_opacity=jnp.asarray(raw))


def test_fit_scene_matches_jax(monkeypatch):
    (jviews, jcfg), (pviews, pcfg) = fit_views()
    start = start_params()
    monkeypatch.setattr(ptrain, "_densify_eps", jax_eps)
    margins = []
    real = ptrain.densify_step

    def spy(params, opt_state, state, **kw):
        score = state.grad_accum / state.denom.clamp_min(1.0)
        margins.append(float((score / 2e-4 - 1.0).abs().min()))
        return real(params, opt_state, state, **kw)

    monkeypatch.setattr(ptrain, "densify_step", spy)
    kw = dict(steps=12, densify_every=4, opacity_reset_every=7)
    _, jh = jtrain.fit_scene(jviews, jcfg, start, optimizer=jtrain.make_optimizer(1e-2),
                             auto_capacity=False, **kw)
    _, ph = gt.fit_scene(pviews, pcfg, to_torch_params(np_tree(start), "cpu"),
                         optimizer=gt.make_optimizer(1e-2), **kw)
    assert len(margins) == 2 and min(margins) > 0.01, margins
    assert jh["overflow"] == [] and ph["overflow"] == []
    assert [e["step"] for e in ph["densify"]] == [4, 8]
    assert ph["densify"] == jh["densify"]
    assert all(e["recycled"] > 0 for e in ph["densify"])
    assert len(ph["losses"]) == 12
    np.testing.assert_allclose(ph["losses"], jh["losses"], rtol=1e-3, atol=0)


def test_fit_scene_cadences_and_final_checkpoint(tmp_path):
    """tests/test_train.py::test_fit_scene_end_to_end on the port:
    episodes at 8 and 16 but not 24 (0.7·24 = 16.8), the loss falls, and
    the final checkpoint restores the fitted parameters."""
    _, (pviews, pcfg) = fit_views(spread=0.5)
    start = to_torch_params(np_tree(start_params(seed=77, kill=0)), "cpu")
    logged = []
    fitted, hist = gt.fit_scene(
        pviews, pcfg, start, steps=24, densify_every=8, densify_stop=0.7,
        opacity_reset_every=23, checkpoint_dir=str(tmp_path), checkpoint_every=24,
        log_every=10, log_fn=lambda s, l: logged.append((s, l)))
    assert len(hist["losses"]) == 24 and hist["overflow"] == []
    assert [e["step"] for e in hist["densify"]] == [8, 16]
    assert np.mean(hist["losses"][-4:]) < np.mean(hist["losses"][:4])
    assert [s for s, _ in logged] == [10, 20]
    assert logged[0][1] == hist["losses"][9]
    rp, ro, rd, step = gt.load_checkpoint(str(tmp_path / "step_000024"), start)
    assert step == 24 and ro is None and rd is None
    assert torch.equal(rp.positions, fitted.positions)


def test_fit_scene_resume_reproduces_uninterrupted_run(tmp_path):
    _, (pviews, pcfg) = fit_views()
    start = to_torch_params(np_tree(start_params()), "cpu")
    kw = dict(steps=10, densify_every=4, opacity_reset_every=7)
    full, hist_full = gt.fit_scene(pviews, pcfg, start, **kw)
    ck = tmp_path / "ck"
    gt.fit_scene(pviews, pcfg, start, checkpoint_dir=str(ck), checkpoint_every=5, **kw)
    assert sorted(os.listdir(ck)) == ["step_000005", "step_000010"]
    resumed, hist_res = gt.fit_scene(pviews, pcfg, start,
                                     resume_from=str(ck / "step_000005"), **kw)
    assert len(hist_res["losses"]) == 5
    assert hist_res["losses"] == hist_full["losses"][5:]
    assert hist_res["densify"] == [e for e in hist_full["densify"] if e["step"] > 5]
    assert hist_full["densify"][0]["recycled"] > 0
    for name, a, b in zip(gt.SceneParams._fields, full, resumed):
        if a is None:
            assert b is None
            continue
        assert torch.equal(a, b), name


def test_fit_scene_resume_without_densify_state(tmp_path):
    """A checkpoint of params and moments alone resumes with fresh
    accumulators."""
    _, (pviews, pcfg) = fit_views(poses=1)
    start = to_torch_params(np_tree(start_params(kill=0)), "cpu")
    opt = gt.make_3dgs_optimizer(position_lr_max_steps=4)
    gt.save_checkpoint(str(tmp_path / "ck"), start, opt.init(start), step=2)
    _, hist = gt.fit_scene(pviews, pcfg, start, steps=4, optimizer=opt,
                           resume_from=str(tmp_path / "ck"))
    assert len(hist["losses"]) == 2


def test_fit_scene_sh_warmup_unlocks_bands_on_schedule():
    """Bands above the active degree are zeroed at warm-up start and stay
    zero until their unlock step (before step 2 at cadence 2)."""
    _, (pviews, pcfg) = fit_views(poses=1)
    start = to_torch_params(np_tree(start_params(seed=78, kill=0)), "cpu")
    sh0 = start.sh.clone()
    kw = dict(sh_warmup_every=2, densify_every=0, opacity_reset_every=0)
    with pytest.warns(RuntimeWarning, match="zeroing non-zero SH"):
        fitted, _ = gt.fit_scene(pviews, pcfg, start, steps=1, **kw)
    assert float(fitted.sh[:, 3:].abs().max()) == 0.0
    assert not torch.equal(fitted.sh[:, :3], sh0[:, :3])
    with pytest.warns(RuntimeWarning, match="never unlock"):
        fitted3, _ = gt.fit_scene(pviews, pcfg, start, steps=3, **kw)
    assert float(fitted3.sh[:, 3:12].abs().max()) > 0.0
    assert float(fitted3.sh[:, 12:].abs().max()) == 0.0
    # zero_sh_rest=False keeps a pretrained scene's bands.
    kept, _ = gt.fit_scene(pviews, pcfg, start, steps=1, zero_sh_rest=False, **kw)
    assert torch.equal(kept.sh[:, 3:], sh0[:, 3:])
    assert torch.equal(start.sh, sh0)


def test_fit_scene_timed_views():
    """(cam, target, time) triples train the time leaf; mixed arities
    raise."""
    (_, jcfg, _), (_, pcfg, _), _ = train_setup()
    truth = to_torch_params(np_tree(jtrain.SceneParams.from_scene(
        jax_make_scene(120, seed=21, spacetime=True, scale_range=(0.05, 0.2)))), "cpu")
    _, pc, _ = both_cameras(128, 64, pos=(0.0, 0.0, 5.0), fov=60.0)
    with torch.no_grad():
        views = [(pc, gt.render_for_training(truth, pc, pcfg, t), t) for t in (0.2, 0.8)]
    noise = torch.from_numpy(np.random.default_rng(0).normal(
        size=tuple(truth.positions.shape)).astype(np.float32))
    start = truth._replace(positions=truth.positions + 0.05 * noise)
    fitted, hist = gt.fit_scene(views, pcfg, start, steps=10)
    assert len(hist["losses"]) == 10
    assert hist["losses"][-1] < hist["losses"][0]
    assert not torch.equal(fitted.time_params, start.time_params)
    with pytest.raises(ValueError, match="views must"):
        gt.fit_scene([views[0], views[1][:2]], pcfg, start, steps=2)
    with pytest.raises(ValueError, match="at least one"):
        gt.fit_scene([], pcfg, start, steps=2)


def test_fit_scene_snapshot_hook():
    _, (pviews, pcfg) = fit_views(poses=1)
    start = to_torch_params(np_tree(start_params(seed=9, kill=0)), "cpu")
    calls = []
    fit_out, hist = gt.fit_scene(pviews, pcfg, start, steps=5, snapshot_every=2,
                                 snapshot_fn=lambda s, p, l: calls.append((s, p, l)))
    assert [s for s, _, _ in calls] == [2, 4]
    for s, p, l in calls:
        assert p.positions.shape == start.positions.shape
        assert isinstance(l, float) and l == hist["losses"][s - 1]
    assert not torch.equal(calls[0][1].positions, calls[1][1].positions)
    assert not torch.equal(calls[1][1].positions, fit_out.positions)


def test_accumulate_densify_stats_counts_projected_visibility():
    """tests/test_train.py:1013 in both packages: a projected splat with a
    zero gradient counts, a culled splat's gradient does not; without the
    mask, a nonzero gradient counts."""
    grads = np.array([[0.0, 1.0, 0.5], [0.0, 0.0, 0.0]], np.float32)
    visible = np.array([True, True, False])
    for vis, denom in ((visible, [1.0, 1.0, 0.0]), (None, [0.0, 1.0, 1.0])):
        p = gt.accumulate_densify_stats(gt.DensifyState.zero(3, device="cpu"),
                                        torch.from_numpy(grads),
                                        None if vis is None else torch.from_numpy(vis))
        j = jtrain.accumulate_densify_stats(jtrain.DensifyState.zero(3), jnp.asarray(grads),
                                            None if vis is None else jnp.asarray(vis))
        np.testing.assert_array_equal(p.denom.numpy(), denom)
        np.testing.assert_array_equal(p.denom.numpy(), np.asarray(j.denom))
        np.testing.assert_array_equal(p.grad_accum.numpy(), [0.0, 1.0, 0.5])


@pytest.mark.parametrize("case,match", [
    ("timed", "timed views are single-chip only"),
    ("densify_every", "densify_every requires mesh=None"),
    ("sh_warmup_every", "sh_warmup_every requires mesh=None"),
    ("loss_fn", "strip-masked loss built into make_multichip_train_step"),
])
def test_fit_scene_mesh_rejects_single_device_options(case, match):
    """fit_scene(mesh=...) refuses what stays single-device, with the JAX
    package's messages, before it touches the mesh (the multi-device
    fit itself: tests/test_torch_multichip_train.py)."""
    _, (pviews, pcfg) = fit_views(poses=1)
    start = to_torch_params(np_tree(start_params(kill=0)), "cpu")
    kw = {"densify_every": dict(densify_every=4), "sh_warmup_every": dict(sh_warmup_every=2),
          "loss_fn": dict(loss_fn=gt.l1_dssim_loss)}.get(case, {})
    if case == "timed":
        pviews = [v + (0.5,) for v in pviews]
    with pytest.raises(ValueError, match=match):
        gt.fit_scene(pviews, pcfg, start, steps=1, mesh=object(), **kw)


def test_fit_scene_launches_the_train_kernels_on_the_card():
    """A few fit_scene steps on the card launch gr_train_pass's forward and
    backward once a step each (chip_smoke's fit-500k checks the same at
    full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py's fit-500k phase runs this on the H100")
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    cfg = gt.RenderConfig(height=64, width=128, compositor="diff")
    scene = gt.make_random_scene(2000, seed=0, scale_range=(0.05, 0.2), device="cuda")
    cam = gt.Camera()
    cam.set_position([0.0, 0.0, 5.0])
    cam.set_aspect_ratio(2.0)
    cam.update_camera_matrices()
    camp = cam.params(cfg.k_sigma, device="cuda")
    params = gt.SceneParams.from_scene(scene)
    with torch.no_grad():
        views = [(camp, gt.render_for_training(params, camp, cfg))]
    tt.train_forward.launches = tt.train_backward.launches = 0
    _, hist = gt.fit_scene(views, cfg, params._replace(raw_opacity=params.raw_opacity - 1),
                           steps=3, densify_every=2)
    assert tt.train_forward.launches == 3 and tt.train_backward.launches == 3
    assert np.isfinite(hist["losses"]).all() and len(hist["densify"]) == 1
