"""Animation layer: tracks/clips, poses, the ABSM, skinning."""
from fyrox_tpu_torch.animation import machine, player, pose, skinning, track
from fyrox_tpu_torch.animation.machine import (MachineBuilder, MachineState,
                                               MachineTemplate,
                                               init_machine_state)
from fyrox_tpu_torch.animation.skinning import SkinTemplate
from fyrox_tpu_torch.animation.track import (AnimationSet,
                                             AnimationSetBuilder,
                                             AnimationState,
                                             init_animation_state)

__all__ = ["machine", "player", "pose", "skinning", "track",
           "AnimationSet", "AnimationSetBuilder", "AnimationState",
           "init_animation_state", "MachineBuilder", "MachineState",
           "MachineTemplate", "init_machine_state", "SkinTemplate"]
