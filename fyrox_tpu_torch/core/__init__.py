"""Core math: quaternions, transforms, keyframe curves, bounding boxes
and frustums."""
from fyrox_tpu_torch.core import aabb, curve, frustum, quat, transform

__all__ = ["aabb", "curve", "frustum", "quat", "transform"]
