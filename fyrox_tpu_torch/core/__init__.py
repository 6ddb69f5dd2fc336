"""Core math: quaternions, transforms, keyframe curves, bounding boxes,
frustums, ray tests, colours and the fyrox-math helpers (``mathutil``)."""
from fyrox_tpu_torch.core import (aabb, color, curve, frustum, mathutil,
                                  quat, ray, transform)

__all__ = ["aabb", "color", "curve", "frustum", "mathutil", "quat", "ray",
           "transform"]
