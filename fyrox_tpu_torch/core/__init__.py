"""Core math: quaternions, transforms, keyframe curves, bounding boxes,
frustums, ray tests and colours."""
from fyrox_tpu_torch.core import (aabb, color, curve, frustum, quat, ray,
                                  transform)

__all__ = ["aabb", "color", "curve", "frustum", "quat", "ray", "transform"]
