"""IO: asset import (the FBX reader and writer), the Visitor format (.rgs,
host only) and state checkpoints (the port's part of ``fyrox_tpu.io``)."""
from fyrox_tpu_torch.io import checkpoint, fbx, visitor
from fyrox_tpu_torch.io.checkpoint import (load_state, save_state,
                                           state_to_visitor)
from fyrox_tpu_torch.io.fbx import (fbx_to_engine, fbx_to_scene, parse_fbx,
                                    write_fbx)
from fyrox_tpu_torch.io.visitor import VisitorNode, read_rgs, write_rgs

__all__ = ["checkpoint", "fbx", "visitor", "fbx_to_engine", "fbx_to_scene",
           "parse_fbx", "write_fbx", "VisitorNode", "read_rgs", "write_rgs",
           "save_state", "load_state", "state_to_visitor"]
