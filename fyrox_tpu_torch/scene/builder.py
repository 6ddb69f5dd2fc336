"""Host-side scene construction (the port's copy of
``fyrox_tpu.scene.builder`` for the node kinds the port uses).

Pivots, rigid-body nodes, cameras, lights and meshes are supported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from fyrox_tpu_torch.scene.template import NodeType, SceneTemplate

__all__ = ["SceneBuilder"]

_IDENT_Q = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


@dataclass
class _NodeRec:
    name: str
    parent: int
    node_type: int
    position: np.ndarray
    rotation: np.ndarray
    scale: np.ndarray
    visibility: bool = True
    enabled: bool = True
    lifetime: float = np.inf
    bbox_min: Optional[np.ndarray] = None
    bbox_max: Optional[np.ndarray] = None
    payload: int = -1


class SceneBuilder:
    """Accumulates nodes, then ``build()`` packs a SceneTemplate."""

    def __init__(self):
        self._nodes: List[_NodeRec] = []
        self._cameras: dict = dict(node=[], fov=[], z_near=[], z_far=[],
                                   ortho=[], vertical_size=[], enabled=[])
        self._lights: dict = dict(node=[], kind=[], color=[], radius=[],
                                  hotspot=[], falloff_delta=[], intensity=[],
                                  cast_shadows=[])
        self._meshes: list = []

    def add_node(self, name="node", parent=-1, node_type=NodeType.PIVOT,
                 position=(0, 0, 0), rotation=None, scale=(1, 1, 1),
                 visibility=True, enabled=True, lifetime=np.inf,
                 bbox=None) -> int:
        rec = _NodeRec(
            name=name, parent=int(parent), node_type=int(node_type),
            position=np.asarray(position, np.float32),
            rotation=(np.asarray(rotation, np.float32) if rotation is not None
                      else _IDENT_Q.copy()),
            scale=np.asarray(scale, np.float32),
            visibility=bool(visibility), enabled=bool(enabled),
            lifetime=float(lifetime))
        if bbox is not None:
            rec.bbox_min = np.asarray(bbox[0], np.float32)
            rec.bbox_max = np.asarray(bbox[1], np.float32)
        self._nodes.append(rec)
        return len(self._nodes) - 1

    def add_pivot(self, name="pivot", parent=-1, **kw) -> int:
        return self.add_node(name, parent, NodeType.PIVOT, **kw)

    def add_camera(self, name="camera", parent=-1, fov=np.deg2rad(75.0),
                   z_near=0.025, z_far=2048.0, ortho=False,
                   vertical_size=5.0, camera_enabled=True, **kw) -> int:
        idx = self.add_node(name, parent, NodeType.CAMERA, **kw)
        self._nodes[idx].payload = len(self._cameras["node"])
        c = self._cameras
        c["node"].append(idx)
        c["fov"].append(float(fov))
        c["z_near"].append(float(z_near))
        c["z_far"].append(float(z_far))
        c["ortho"].append(bool(ortho))
        c["vertical_size"].append(float(vertical_size))
        c["enabled"].append(bool(camera_enabled))
        return idx

    # -- lights (light/{point,spot,directional}.rs) ------------------------
    def add_light(self, kind, name="light", parent=-1, color=(1.0, 1.0, 1.0),
                  radius=10.0, hotspot=np.deg2rad(90.0),
                  falloff_delta=np.deg2rad(5.0), intensity=1.0,
                  cast_shadows=True, **kw) -> int:
        node_type = {"point": NodeType.POINT_LIGHT,
                     "spot": NodeType.SPOT_LIGHT,
                     "directional": NodeType.DIRECTIONAL_LIGHT}[kind]
        idx = self.add_node(name, parent, node_type, **kw)
        self._nodes[idx].payload = len(self._lights["node"])
        li = self._lights
        li["node"].append(idx)
        li["kind"].append({"point": 0, "spot": 1, "directional": 2}[kind])
        li["color"].append(np.asarray(color, np.float32))
        li["radius"].append(float(radius))
        li["hotspot"].append(float(hotspot))
        li["falloff_delta"].append(float(falloff_delta))
        li["intensity"].append(float(intensity))
        li["cast_shadows"].append(bool(cast_shadows))
        return idx

    # -- mesh ----------------------------------------------------------------
    def add_mesh(self, mesh_data, name="mesh", parent=-1, **kw) -> int:
        """mesh_data: fyrox_tpu_torch.render.mesh.MeshData; its bbox becomes
        the node's local bounding box unless `bbox` is given."""
        if kw.get("bbox") is None and hasattr(mesh_data, "bbox"):
            kw["bbox"] = mesh_data.bbox
        idx = self.add_node(name, parent, NodeType.MESH, **kw)
        self._nodes[idx].payload = len(self._meshes)
        self._meshes.append(mesh_data)
        return idx

    def build(self) -> SceneTemplate:
        n = len(self._nodes)
        parent = np.array([r.parent for r in self._nodes], np.int32)
        levels, depth = SceneTemplate.compute_levels(parent)

        def stack(get, shape, dtype=np.float32):
            return (np.stack([np.asarray(get(r), dtype) for r in self._nodes])
                    if n else np.zeros((0,) + shape, dtype))

        has_bbox = any(r.bbox_min is not None for r in self._nodes)
        zero3 = np.zeros(3, np.float32)
        return SceneTemplate(
            parent=parent,
            node_type=np.array([r.node_type for r in self._nodes], np.int32),
            names=[r.name for r in self._nodes],
            levels=levels,
            depth=depth,
            payload=np.array([r.payload for r in self._nodes], np.int32),
            init_position=stack(lambda r: r.position, (3,)),
            init_rotation=stack(lambda r: r.rotation, (4,)),
            init_scale=stack(lambda r: r.scale, (3,)),
            init_visibility=stack(lambda r: r.visibility, (), bool),
            init_enabled=stack(lambda r: r.enabled, (), bool),
            init_lifetime=stack(lambda r: r.lifetime, ()),
            local_bbox_min=(np.stack([zero3 if r.bbox_min is None
                                      else r.bbox_min for r in self._nodes])
                            if has_bbox else None),
            local_bbox_max=(np.stack([zero3 if r.bbox_max is None
                                      else r.bbox_max for r in self._nodes])
                            if has_bbox else None),
            cameras={k: np.asarray(v) for k, v in self._cameras.items()},
            lights={k: np.asarray(v) for k, v in self._lights.items()},
            meshes=list(self._meshes),
        )
