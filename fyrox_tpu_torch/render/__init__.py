"""Render layer: the deferred + CSM path of ``fyrox_tpu.render`` — mesh
builders, the tiled 2DH rasterizer (K5, ``csrc/tile_raster.cu``), CSM
shadows, deferred PBR lighting and the frame pipeline."""
from fyrox_tpu_torch.render import (lighting, mesh, pipeline, raster,
                                    shadows, tile_raster)
from fyrox_tpu_torch.render.mesh import (MeshData, make_cone, make_cube,
                                         make_plane, make_sphere)
from fyrox_tpu_torch.render.pipeline import (RenderConfig, RenderTemplate,
                                             build_render_template,
                                             render_frame,
                                             render_frame_demand)
from fyrox_tpu_torch.render.shadows import CsmConfig

__all__ = ["lighting", "mesh", "pipeline", "raster", "shadows",
           "tile_raster", "MeshData", "make_cube", "make_sphere",
           "make_plane", "make_cone", "CsmConfig", "RenderConfig",
           "RenderTemplate", "build_render_template", "render_frame",
           "render_frame_demand"]
