"""Model scenes (the flagship bench configuration) and generated assets."""
from fyrox_tpu_torch.models.assets import make_character_fbx
from fyrox_tpu_torch.models.character import (assemble_imported,
                                              build_character_scene,
                                              build_flagship,
                                              build_pile_scene)

__all__ = ["build_flagship", "build_character_scene", "build_pile_scene",
           "assemble_imported", "make_character_fbx"]
