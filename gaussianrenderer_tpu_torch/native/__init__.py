"""Native (host C++) readers of the port, loaded through ctypes.

``ply_native`` reads 3DGS PLY files (``scene/io.load_ply``'s default) and
``colmap_native`` reads COLMAP ``points3D.bin`` clouds
(``scene/colmap.read_points3d_bin``'s default). The ``.cpp`` sources are
the JAX package's, unchanged, and build with the same g++ flags, so the
same compiler gives the same bits. ``_build.NATIVE`` compiles each on
first use into ``build/torch_native/``; a failed build raises.
"""

from gaussianrenderer_tpu_torch.native import colmap_native, ply_native  # noqa: F401

__all__ = ["colmap_native", "ply_native"]
