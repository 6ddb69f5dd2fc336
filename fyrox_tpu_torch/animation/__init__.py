"""Animation layer: tracks/clips, poses, ABSMs (blend spaces, layers),
root motion, skinning and blend shapes, sprite sheets."""
from fyrox_tpu_torch.animation import (blendspace, machine, player, pose,
                                       rootmotion, skinning, spritesheet,
                                       track)
from fyrox_tpu_torch.animation.blendspace import (BlendSpaceTemplate,
                                                  build_blend_space)
from fyrox_tpu_torch.animation.machine import (MachineBuilder, MachineState,
                                               MachineTemplate,
                                               init_machine_state)
from fyrox_tpu_torch.animation.rootmotion import (RootMotionSettings,
                                                  build_root_motion,
                                                  extract_root_motion,
                                                  init_root_motion_state)
from fyrox_tpu_torch.animation.skinning import SkinTemplate
from fyrox_tpu_torch.animation.track import (AnimationSet,
                                             AnimationSetBuilder,
                                             AnimationState,
                                             init_animation_state)

__all__ = ["blendspace", "machine", "player", "pose", "rootmotion",
           "skinning", "spritesheet", "track",
           "AnimationSet", "AnimationSetBuilder", "AnimationState",
           "init_animation_state", "MachineBuilder", "MachineState",
           "MachineTemplate", "init_machine_state", "SkinTemplate",
           "BlendSpaceTemplate", "build_blend_space", "RootMotionSettings",
           "build_root_motion", "extract_root_motion",
           "init_root_motion_state"]
