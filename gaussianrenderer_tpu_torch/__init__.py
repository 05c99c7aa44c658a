"""PyTorch/CUDA port of gaussianrenderer_tpu: 3D Gaussian Splatting on an
NVIDIA H100.

The JAX package ``gaussianrenderer_tpu`` is the reference this port is
held against; this package imports nothing from it and never imports JAX.
Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``,
where every kernel's plain PyTorch version runs instead.

    import gaussianrenderer_tpu_torch as gt
    scene = gt.make_random_scene(100_000, seed=0)            # on cuda
    cam = gt.Camera(); cam.set_position([0, 0, 6]); cam.update_camera_matrices()
    cfg = gt.RenderConfig(height=600, width=800)
    fb, stats = gt.render_frame(scene, cam.params(cfg.k_sigma), cfg)

    # A session with the saturation cull (frame 1 culls nothing):
    render = gt.make_renderer(scene, gt.RenderConfig(height=600, width=800,
                                                     sat_cull=True))
    fb, stats = render(cam.params(3.0))   # stats.sat_culled, stats.sat_risk

    # Training: Adam steps against a target frame (the diff compositor's
    # forward and backward kernels on the card).
    params = gt.SceneParams.from_scene(scene)
    step, opt = gt.make_train_step(cfg, optimizer=gt.make_3dgs_optimizer(),
                                   loss_fn=gt.l1_dssim_loss)
    state = opt.init(params)
    params, state, loss = step(params, state, cam.params(3.0), target)

    # A fit with densification, from a COLMAP workspace, a Blender
    # transforms*.json capture or a poses.json dataset (apps/fit), here
    # seeded from a COLMAP workspace's SfM points.
    from gaussianrenderer_tpu_torch.scene import colmap
    views = gt.load_views("dataset/", cfg)
    params = colmap.init_from_points(*colmap.load_colmap_points("dataset/"), n=100_000)
    params, history = gt.fit_scene(views, cfg, params, steps=3000,
                                   loss_fn=gt.l1_dssim_loss, densify_every=300)
    print(gt.evaluate(params, views, cfg)["psnr"])
    gt.save_ply(params.to_scene(), "fitted.ply")
    # Scenes load and save as .ply, .gsz or .splat, and edit on the host.
    scene = gt.load_scene("data/trained_2m.gsz")                     # on cuda
    gt.save_compact(gt.prune_scene(scene, min_opacity=0.005), "out.gsz")

    # The viewer: a headless Canvas session and its browser front end
    # (viewer.py, web_viewer.py; apps/cull_sort_test is gr-render).
    from gaussianrenderer_tpu_torch.viewer import Canvas
    canvas = Canvas(height=1080, width=1920)
    canvas.init()
    canvas.load_gaussians("data/trained_2m.gsz")
    fb, stats = canvas.render(); img = canvas.draw()   # (H, W, 3) uint8
    canvas.serve(port=8800)                            # blocks; a browser drives it

    # Several devices (parallel/multichip.py): one rank per process, each
    # with its block of the splats; every rank gets the whole frame. Run
    # under `torchrun --nproc-per-node D` (make_mesh() on the default
    # group) or started by parallel.spawn(fn, D).
    from gaussianrenderer_tpu_torch import parallel
    mesh = parallel.make_mesh()
    fb, stats = parallel.render_frame_multichip(parallel.shard_scene(scene, mesh),
                                                cam.params(3.0), cfg, mesh, exchange="a2a_q")
    params, history = gt.fit_scene(views, cfg, params, steps=3000, mesh=mesh)

    # The harnesses' kernels: the blocked bf16 GEMM and the bitonic block
    # sort (apps/matrix_test, apps/radix_test, apps/onesweep).
    c = gt.matmul_blocked(a_bf16, b_bf16, bm=128, bn=128, bk=128)  # f32
    y = gt.block_sort_runs(x_u32_as_int64, run=2048)                # (9, C)
"""

from gaussianrenderer_tpu_torch.config import RenderConfig, UiSettings, parse_color
from gaussianrenderer_tpu_torch.convert import (
    to_torch_adam_state,
    to_torch_camera,
    to_torch_densify_state,
    to_torch_params,
    to_torch_scene,
)
from gaussianrenderer_tpu_torch.ops import satcull
from gaussianrenderer_tpu_torch.ops.compositing import (
    build_features,
    composite_tiles_diff,
    composite_tiles_xla,
)
from gaussianrenderer_tpu_torch.ops.cuda.block_sort import (
    block_sort_runs,
    block_sort_runs_plain,
)
from gaussianrenderer_tpu_torch.ops.cuda.lookup import table_lookup
from gaussianrenderer_tpu_torch.ops.cuda.matmul import matmul_blocked, matmul_blocked_plain
from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import (
    composite_tiles_packed,
    composite_tiles_packed_plain,
)
from gaussianrenderer_tpu_torch.ops.instances import (
    PackedInstances,
    build_packed_instances,
)
from gaussianrenderer_tpu_torch.ops.projection import (
    ProjectedGaussians,
    preprocess_gaussians,
    slice_spacetime,
)
from gaussianrenderer_tpu_torch.ops.sh import eval_sh, eval_sh_columns
from gaussianrenderer_tpu_torch.ops.sort import (
    is_nondecreasing,
    pack_key,
    radix_sort_u32,
    sort_packed,
    sort_two_key,
    unpack_key,
)
from gaussianrenderer_tpu_torch.ops.tile_train import composite_tiles_train
from gaussianrenderer_tpu_torch.ops.tiling import TileAssignment, build_sorted_instances
from gaussianrenderer_tpu_torch.render import (
    RenderStats,
    framebuffer_to_image,
    make_renderer,
    render_frame,
    save_png,
)
from gaussianrenderer_tpu_torch.scene.camera import Camera, CameraParams
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene, morton_codes
from gaussianrenderer_tpu_torch.scene.compact import (
    load_compact,
    load_splat,
    save_compact,
    save_splat,
)
from gaussianrenderer_tpu_torch.scene.edit import (
    crop_scene,
    merge_scenes,
    prune_scene,
    transform_scene,
)
from gaussianrenderer_tpu_torch.scene.io import (
    load_ply,
    load_scene,
    make_clustered_scene,
    make_random_scene,
    make_surface_scene,
    save_ply,
)
from gaussianrenderer_tpu_torch.train import (
    DensifyState,
    SceneParams,
    accumulate_densify_stats,
    dataset_image_shape,
    densify_step,
    evaluate,
    fit_scene,
    l1_dssim_loss,
    load_checkpoint,
    load_views,
    make_3dgs_optimizer,
    make_multichip_train_step,
    make_optimizer,
    make_train_step,
    mse_loss,
    pad_params_for_mesh,
    pad_target_for_mesh,
    psnr,
    render_for_training,
    reset_opacity,
    save_checkpoint,
    ssim,
)

__all__ = [
    "Camera",
    "CameraParams",
    "DensifyState",
    "GaussianScene",
    "PackedInstances",
    "ProjectedGaussians",
    "RenderConfig",
    "RenderStats",
    "SceneParams",
    "TileAssignment",
    "UiSettings",
    "accumulate_densify_stats",
    "block_sort_runs",
    "block_sort_runs_plain",
    "build_features",
    "build_packed_instances",
    "build_sorted_instances",
    "composite_tiles_diff",
    "composite_tiles_packed",
    "composite_tiles_packed_plain",
    "composite_tiles_train",
    "composite_tiles_xla",
    "crop_scene",
    "dataset_image_shape",
    "densify_step",
    "eval_sh",
    "eval_sh_columns",
    "evaluate",
    "fit_scene",
    "framebuffer_to_image",
    "is_nondecreasing",
    "l1_dssim_loss",
    "load_checkpoint",
    "load_compact",
    "load_ply",
    "load_scene",
    "load_splat",
    "load_views",
    "make_3dgs_optimizer",
    "make_clustered_scene",
    "make_optimizer",
    "make_multichip_train_step",
    "make_random_scene",
    "make_renderer",
    "make_surface_scene",
    "make_train_step",
    "matmul_blocked",
    "matmul_blocked_plain",
    "merge_scenes",
    "morton_codes",
    "mse_loss",
    "pack_key",
    "parse_color",
    "preprocess_gaussians",
    "prune_scene",
    "pad_params_for_mesh",
    "pad_target_for_mesh",
    "psnr",
    "radix_sort_u32",
    "render_for_training",
    "render_frame",
    "reset_opacity",
    "satcull",
    "save_checkpoint",
    "save_compact",
    "save_ply",
    "save_png",
    "save_splat",
    "slice_spacetime",
    "sort_packed",
    "sort_two_key",
    "ssim",
    "table_lookup",
    "to_torch_adam_state",
    "to_torch_camera",
    "to_torch_densify_state",
    "to_torch_params",
    "to_torch_scene",
    "transform_scene",
    "unpack_key",
]
