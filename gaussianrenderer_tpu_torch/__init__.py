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
"""

from gaussianrenderer_tpu_torch.config import RenderConfig, parse_color
from gaussianrenderer_tpu_torch.convert import to_torch_camera, to_torch_scene
from gaussianrenderer_tpu_torch.ops import satcull
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

__all__ = [
    "Camera",
    "CameraParams",
    "GaussianScene",
    "PackedInstances",
    "ProjectedGaussians",
    "RenderConfig",
    "RenderStats",
    "build_packed_instances",
    "composite_tiles_packed",
    "composite_tiles_packed_plain",
    "eval_sh_columns",
    "framebuffer_to_image",
    "load_ply",
    "make_random_scene",
    "make_renderer",
    "morton_codes",
    "pack_key",
    "parse_color",
    "preprocess_gaussians",
    "render_frame",
    "satcull",
    "save_png",
    "slice_spacetime",
    "sort_packed",
    "table_lookup",
    "to_torch_camera",
    "to_torch_scene",
]
