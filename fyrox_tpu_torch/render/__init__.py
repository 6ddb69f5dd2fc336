"""Render layer: the port of ``fyrox_tpu.render`` — mesh builders, the
tiled rasterizer (K5, ``csrc/tile_raster.cu``: 2DH and near-clipped
affine variants) and the streaming one, CSM and spot / point shadow maps,
HZB occlusion, textures and materials, deferred PBR lighting, light
shafts, the skybox, the transparent forward pass, reflection probes,
post-processing, SSAO, the `.shader` resource contract, and the frame
pipeline with its captured form (``CapturedFrame``: one CUDA graph a
frame)."""
from fyrox_tpu_torch.render import (lighting, mesh, occlusion, pipeline,
                                    post, probe, raster, shader, shadows,
                                    skybox, ssao, texture, tile_raster,
                                    transparent, volumetric)
from fyrox_tpu_torch.render.mesh import (MeshData, make_cone, make_cube,
                                         make_plane, make_sphere)
from fyrox_tpu_torch.render.pipeline import (CapturedFrame, RenderConfig,
                                             RenderTemplate,
                                             build_render_template,
                                             render_frame,
                                             render_frame_demand,
                                             render_frames_chunked)
from fyrox_tpu_torch.render.shadows import CsmConfig
from fyrox_tpu_torch.render.skybox import SkyBox, gradient_faces
from fyrox_tpu_torch.render.texture import Material, Texture, load_texture

__all__ = ["lighting", "mesh", "occlusion", "pipeline", "post", "probe",
           "raster", "shader", "shadows", "skybox", "ssao", "texture",
           "tile_raster", "transparent", "volumetric",
           "MeshData", "make_cube", "make_sphere", "make_plane", "make_cone",
           "CsmConfig", "RenderConfig", "RenderTemplate",
           "build_render_template", "render_frame", "render_frame_demand",
           "render_frames_chunked", "CapturedFrame", "SkyBox",
           "gradient_faces", "Material", "Texture", "load_texture"]
