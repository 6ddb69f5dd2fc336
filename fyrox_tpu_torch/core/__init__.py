"""Core math: quaternions, transforms, keyframe curves."""
from fyrox_tpu_torch.core import curve, quat, transform

__all__ = ["curve", "quat", "transform"]
