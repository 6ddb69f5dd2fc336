"""Asset import (the port's copy of ``fyrox_tpu.io``'s FBX reader and
writer; host numpy only)."""
from fyrox_tpu_torch.io import fbx
from fyrox_tpu_torch.io.fbx import (fbx_to_engine, fbx_to_scene, parse_fbx,
                                    write_fbx)

__all__ = ["fbx", "fbx_to_engine", "fbx_to_scene", "parse_fbx", "write_fbx"]
