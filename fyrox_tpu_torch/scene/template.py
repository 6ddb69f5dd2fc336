"""Scene templates: the static, host-side half of a scene.

Same layout as ``fyrox_tpu.scene.template`` (topology, node types, payload
routing, initial local transforms, local bounding boxes, the render,
sound and navmesh payloads), kept as numpy.
The port carries its own copy because the JAX package cannot be imported
on a machine without JAX; a CPU test holds the two equal.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

__all__ = ["NodeType", "SceneTemplate"]


class NodeType(enum.IntEnum):
    PIVOT = 0
    CAMERA = 1
    MESH = 2
    SPRITE = 3
    POINT_LIGHT = 4
    SPOT_LIGHT = 5
    DIRECTIONAL_LIGHT = 6
    RIGID_BODY = 7
    COLLIDER = 8
    JOINT = 9
    ANIMATION_PLAYER = 10
    ABSM = 11
    PARTICLE_SYSTEM = 12
    SOUND = 13
    LISTENER = 14
    DECAL = 15
    TERRAIN = 16
    NAVMESH = 17
    RECTANGLE = 18
    RIGID_BODY_2D = 19
    COLLIDER_2D = 20
    JOINT_2D = 21
    TILE_MAP = 22
    RAGDOLL = 23
    REFLECTION_PROBE = 24
    SKYBOX = 25


@dataclass
class SceneTemplate:
    """Static scene description shared by every world of a batch."""
    parent: np.ndarray                 # [N] int32, -1 for roots
    node_type: np.ndarray              # [N] int32 (NodeType)
    names: List[str]
    levels: List[np.ndarray]           # node indices per hierarchy depth
    depth: np.ndarray                  # [N] int32
    payload: np.ndarray                # [N] int32 index into a payload table
    init_position: np.ndarray          # [N,3] f32
    init_rotation: np.ndarray          # [N,4] f32 quat xyzw
    init_scale: np.ndarray             # [N,3] f32
    init_visibility: np.ndarray        # [N] bool
    init_enabled: np.ndarray           # [N] bool
    init_lifetime: np.ndarray          # [N] f32 (+inf = unlimited)
    init_pre_rotation: Optional[np.ndarray] = None
    init_post_rotation: Optional[np.ndarray] = None
    init_rotation_offset: Optional[np.ndarray] = None
    init_rotation_pivot: Optional[np.ndarray] = None
    init_scaling_offset: Optional[np.ndarray] = None
    init_scaling_pivot: Optional[np.ndarray] = None
    local_bbox_min: Optional[np.ndarray] = None
    local_bbox_max: Optional[np.ndarray] = None
    cameras: dict = field(default_factory=dict)
    lights: dict = field(default_factory=dict)     # SoA dict of light params
    meshes: list = field(default_factory=list)     # list of render.MeshData
    sprites: dict = field(default_factory=dict)    # SoA node, size, color
    decals: dict = field(default_factory=dict)     # SoA node, color, strength
    # sound sources and listeners (scene/sound/mod.rs, listener.rs): the
    # sources' static parameters; positions come from the node globals
    # every rendered block (sound/scene.py)
    sounds: dict = field(default_factory=dict)     # SoA of source params
    listeners: dict = field(default_factory=dict)  # SoA (node)
    sound_buffers: list = field(default_factory=list)  # mono f32 arrays
    # Rectangle 2D nodes (dim2/rectangle.rs): a coloured / textured unit
    # quad in the node's local XY plane
    rectangles: dict = field(default_factory=dict)  # SoA (node, color,
    rect_textures: list = field(default_factory=list)  # uv_rect, texture)
    # NavigationalMesh nodes (scene/navmesh.rs:81): node-local navmesh
    # geometry; utils.navagent.template_navmesh bakes the node's transform
    navmeshes: dict = field(default_factory=dict)  # SoA (node, data index)
    navmesh_data: list = field(default_factory=list)  # (verts, tris) pairs
    # builder-attached extras; "lod_groups": [[(begin, end, [nodes])...]]
    extras: dict = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(self.parent.shape[0])

    @property
    def max_depth(self) -> int:
        return len(self.levels)

    def doubling_pointers(self):
        """Pointer-doubling ancestor tables: a list of int64 arrays [N+1];
        table r maps node i to its ancestor at distance 2^r, with the
        virtual identity slot N absorbing exhausted chains."""
        if getattr(self, "_doubling", None) is None:
            n = self.num_nodes
            p = np.where(self.parent >= 0, self.parent, n)
            p = np.append(p, n).astype(np.int64)
            rounds = max(int(np.ceil(np.log2(max(self.max_depth, 1) + 1))), 1)
            tables = []
            for _ in range(rounds):
                tables.append(p.copy())
                p = p[p]
            self._doubling = tables
        return self._doubling

    @staticmethod
    def compute_levels(parent: np.ndarray):
        """Group node indices by hierarchy depth (roots at depth 0)."""
        n = parent.shape[0]
        depth = np.zeros(n, np.int32)
        for i in range(n):
            d, p = 0, parent[i]
            while p >= 0:
                d += 1
                p = parent[p]
                if d > n:
                    raise ValueError("cycle in scene hierarchy")
            depth[i] = d
        levels = [np.nonzero(depth == d)[0].astype(np.int32)
                  for d in range(int(depth.max()) + 1 if n else 0)]
        return levels, depth
