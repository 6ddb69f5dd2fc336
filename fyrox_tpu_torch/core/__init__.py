"""Core math: quaternions, transforms, keyframe curves, bounding boxes,
frustums and ray tests."""
from fyrox_tpu_torch.core import aabb, curve, frustum, quat, ray, transform

__all__ = ["aabb", "curve", "frustum", "quat", "ray", "transform"]
