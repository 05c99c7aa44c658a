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
"""

from gaussianrenderer_tpu_torch.config import RenderConfig, parse_color
from gaussianrenderer_tpu_torch.convert import (
    to_torch_camera,
    to_torch_params,
    to_torch_scene,
)
from gaussianrenderer_tpu_torch.ops import satcull
from gaussianrenderer_tpu_torch.ops.compositing import (
    build_features,
    composite_tiles_diff,
    composite_tiles_xla,
)
from gaussianrenderer_tpu_torch.ops.cuda.lookup import table_lookup
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
from gaussianrenderer_tpu_torch.ops.sh import eval_sh_columns
from gaussianrenderer_tpu_torch.ops.sort import pack_key, sort_packed
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
from gaussianrenderer_tpu_torch.scene.io import load_ply, make_random_scene
from gaussianrenderer_tpu_torch.train import (
    SceneParams,
    l1_dssim_loss,
    make_3dgs_optimizer,
    make_optimizer,
    make_train_step,
    mse_loss,
    render_for_training,
    reset_opacity,
    ssim,
)

__all__ = [
    "Camera",
    "CameraParams",
    "GaussianScene",
    "PackedInstances",
    "ProjectedGaussians",
    "RenderConfig",
    "RenderStats",
    "SceneParams",
    "TileAssignment",
    "build_features",
    "build_packed_instances",
    "build_sorted_instances",
    "composite_tiles_diff",
    "composite_tiles_packed",
    "composite_tiles_packed_plain",
    "composite_tiles_train",
    "composite_tiles_xla",
    "eval_sh_columns",
    "framebuffer_to_image",
    "l1_dssim_loss",
    "load_ply",
    "make_3dgs_optimizer",
    "make_optimizer",
    "make_random_scene",
    "make_renderer",
    "make_train_step",
    "morton_codes",
    "mse_loss",
    "pack_key",
    "parse_color",
    "preprocess_gaussians",
    "render_for_training",
    "render_frame",
    "reset_opacity",
    "satcull",
    "save_png",
    "slice_spacetime",
    "sort_packed",
    "ssim",
    "table_lookup",
    "to_torch_camera",
    "to_torch_params",
    "to_torch_scene",
]
