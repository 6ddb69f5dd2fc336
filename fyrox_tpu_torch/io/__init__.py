"""IO: asset import (the FBX reader and writer), the Visitor format (.rgs,
host only), .rgs scene loading and state checkpoints (the port's
``fyrox_tpu.io``; glTF import and prefab deltas are the ``gltf`` and
``inheritance`` submodules, as there)."""
from fyrox_tpu_torch.io import checkpoint, fbx, rgs_scene, visitor
from fyrox_tpu_torch.io.checkpoint import (load_state, save_state,
                                           state_to_visitor)
from fyrox_tpu_torch.io.fbx import (fbx_to_engine, fbx_to_scene, parse_fbx,
                                    write_fbx)
from fyrox_tpu_torch.io.rgs_scene import load_scene
from fyrox_tpu_torch.io.visitor import VisitorNode, read_rgs, write_rgs

__all__ = ["checkpoint", "fbx", "visitor", "rgs_scene", "load_scene",
           "fbx_to_engine", "fbx_to_scene",
           "parse_fbx", "write_fbx", "VisitorNode", "read_rgs", "write_rgs",
           "save_state", "load_state", "state_to_visitor"]
