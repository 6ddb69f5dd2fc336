"""Model scenes (the flagship bench configuration) and generated assets."""
from fyrox_tpu_torch.models.assets import make_character_fbx
from fyrox_tpu_torch.models.character import (build_character_scene,
                                              build_flagship,
                                              build_pile_scene)

__all__ = ["build_flagship", "build_character_scene", "build_pile_scene",
           "make_character_fbx"]
