"""Host-side scene construction (the port's copy of
``fyrox_tpu.scene.builder`` for the node kinds the port uses).

Pivots, rigid-body nodes, cameras, lights, meshes, sprites, decals,
rectangles, sound sources, listeners, navmeshes and LOD groups are
supported, and
``instantiate`` copies one builder's nodes into another.
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
        self._sprites: dict = dict(node=[], size=[], color=[])
        self._decals: dict = dict(node=[], color=[], strength=[])
        self._sounds: dict = dict(node=[], buffer=[], gain=[], pitch=[],
                                  looping=[], playing=[], radius=[],
                                  max_distance=[], rolloff=[])
        self._sound_buffers: list = []
        self._listeners: dict = dict(node=[])
        self._rects: dict = dict(node=[], color=[], uv_rect=[], texture=[])
        self._rect_textures: list = []
        self._navmeshes: dict = dict(node=[], data=[])
        self._navmesh_data: list = []
        self.extras: dict = {}

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

    # -- sprite (billboard; sprite.rs) -------------------------------------
    def add_sprite(self, name="sprite", parent=-1, size=0.5,
                   color=(1.0, 1.0, 1.0), **kw) -> int:
        if kw.get("bbox") is None:
            kw["bbox"] = (np.full(3, -size, np.float32),
                          np.full(3, size, np.float32))
        idx = self.add_node(name, parent, NodeType.SPRITE, **kw)
        self._nodes[idx].payload = len(self._sprites["node"])
        self._sprites["node"].append(idx)
        self._sprites["size"].append(float(size))
        self._sprites["color"].append(np.asarray(color, np.float32))
        return idx

    def add_decal(self, name="decal", parent=-1, color=(1.0, 0.2, 0.2),
                  strength=1.0, **kw) -> int:
        """Decal node (scene/decal.rs:115): projects its colour onto the
        geometry inside the node's unit-cube volume (scale the node to size
        the box), applied to the G-buffer before lighting."""
        idx = self.add_node(name, parent, NodeType.DECAL, **kw)
        self._nodes[idx].payload = len(self._decals["node"])
        d = self._decals
        d["node"].append(idx)
        d["color"].append(np.asarray(color, np.float32))
        d["strength"].append(float(strength))
        return idx

    # -- sound source + listener (scene/sound/mod.rs, listener.rs) ----------
    def add_sound(self, buffer, name="sound", parent=-1, gain=1.0,
                  pitch=1.0, looping=True, playing=True, radius=1.0,
                  max_distance=25.0, rolloff=1.0, **kw) -> int:
        """Spatial sound source node (scene/sound/mod.rs): its world
        position drives the mixer's source every rendered block
        (Engine.render_audio). `buffer`: mono float32 samples, or the int
        index of a buffer added before."""
        idx = self.add_node(name, parent, NodeType.SOUND, **kw)
        if not isinstance(buffer, (int, np.integer)):
            self._sound_buffers.append(np.asarray(buffer, np.float32))
            buffer = len(self._sound_buffers) - 1
        self._nodes[idx].payload = len(self._sounds["node"])
        s = self._sounds
        s["node"].append(idx)
        s["buffer"].append(int(buffer))
        s["gain"].append(float(gain))
        s["pitch"].append(float(pitch))
        s["looping"].append(bool(looping))
        s["playing"].append(bool(playing))
        s["radius"].append(float(radius))
        s["max_distance"].append(float(max_distance))
        s["rolloff"].append(float(rolloff))
        return idx

    def add_listener(self, name="listener", parent=-1, **kw) -> int:
        """Listener node (scene/sound/listener.rs): its global pose is the
        mixer's ear position and orientation; the first listener wins, the
        reference's single active listener."""
        idx = self.add_node(name, parent, NodeType.LISTENER, **kw)
        self._nodes[idx].payload = len(self._listeners["node"])
        self._listeners["node"].append(idx)
        return idx

    # -- Rectangle 2D (dim2/rectangle.rs) -----------------------------------
    def add_rectangle(self, name="rectangle", parent=-1,
                      color=(1.0, 1.0, 1.0), uv_rect=(0.0, 0.0, 1.0, 1.0),
                      texture=None, **kw) -> int:
        """Rectangle node (dim2/rectangle.rs): a coloured / textured unit
        quad in the node's local XY plane that transforms with the node,
        drawn double-sided and emissive; `uv_rect=(u0, v0, u1, v1)`
        selects the texture's sub-region."""
        if kw.get("bbox") is None:
            kw["bbox"] = (np.asarray([-0.5, -0.5, -0.01], np.float32),
                          np.asarray([0.5, 0.5, 0.01], np.float32))
        idx = self.add_node(name, parent, NodeType.RECTANGLE, **kw)
        self._nodes[idx].payload = len(self._rects["node"])
        tex = -1
        if texture is not None:
            if isinstance(texture, (int, np.integer)):
                tex = int(texture)
            else:
                self._rect_textures.append(texture)
                tex = len(self._rect_textures) - 1
        r = self._rects
        r["node"].append(idx)
        r["color"].append(np.asarray(color, np.float32))
        r["uv_rect"].append(np.asarray(uv_rect, np.float32))
        r["texture"].append(tex)
        return idx

    # -- NavigationalMesh (scene/navmesh.rs:81) -----------------------------
    def add_navmesh(self, vertices, triangles, name="navmesh", parent=-1,
                    **kw) -> int:
        """NavigationalMesh node: navmesh geometry in the scene graph, its
        vertices node-local. ``utils.navagent.template_navmesh`` bakes the
        node's template transform in and returns a ``utils.navmesh.Navmesh``
        for pathfinding; ``BatchedNavAgents`` steers along it."""
        idx = self.add_node(name, parent, NodeType.NAVMESH, **kw)
        self._nodes[idx].payload = len(self._navmeshes["node"])
        self._navmesh_data.append((np.asarray(vertices, np.float32),
                                   np.asarray(triangles, np.int32)))
        self._navmeshes["node"].append(idx)
        self._navmeshes["data"].append(len(self._navmesh_data) - 1)
        return idx

    def add_lod_group(self, levels):
        """Attach a LOD group (LodGroup, scene/base.rs:129): levels is a
        list of (begin, end, [node indices]), begin / end the normalised
        camera-distance range ((dist - z_near) / (z_far - z_near)) in which
        the listed nodes and their subtrees are rendered."""
        self.extras.setdefault("lod_groups", []).append(
            [(float(b), float(e), [int(o) for o in objs])
             for b, e, objs in levels])

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

    # -- prefab instantiation ---------------------------------------------
    def instantiate(self, prefab: "SceneBuilder", parent=-1, position=None,
                    rotation=None, scale=None, name_prefix="") -> int:
        """Copy another builder's nodes into this scene with their handles
        remapped (Model::instantiate, resource/model/mod.rs:354) under an
        inserted pivot that takes the optional transform; returns the
        pivot. Camera, light, mesh, sprite, sound, listener, rectangle and
        navmesh payloads are remapped (sound buffers, rectangle textures
        and navmesh geometry too), as the JAX package's ``instantiate``
        does."""
        import copy
        kw = {k: v for k, v in (("position", position),
                                ("rotation", rotation), ("scale", scale))
              if v is not None}
        root = self.add_pivot(name_prefix + "instance", parent=parent, **kw)
        offset = len(self._nodes)
        payload_off = {
            NodeType.CAMERA: len(self._cameras["node"]),
            NodeType.POINT_LIGHT: len(self._lights["node"]),
            NodeType.SPOT_LIGHT: len(self._lights["node"]),
            NodeType.DIRECTIONAL_LIGHT: len(self._lights["node"]),
            NodeType.MESH: len(self._meshes),
            NodeType.SOUND: len(self._sounds["node"]),
            NodeType.LISTENER: len(self._listeners["node"]),
            NodeType.RECTANGLE: len(self._rects["node"]),
            NodeType.NAVMESH: len(self._navmeshes["node"])}
        buf_off = len(self._sound_buffers)
        navd_off = len(self._navmesh_data)
        rtex_off = len(self._rect_textures)
        for rec in prefab._nodes:
            rec2 = copy.deepcopy(rec)
            rec2.name = name_prefix + rec2.name
            rec2.parent = rec2.parent + offset if rec2.parent >= 0 else root
            if rec2.payload >= 0:
                rec2.payload += payload_off.get(rec2.node_type, 0)
            self._nodes.append(rec2)

        def extend(dst, src, remap=None):
            for k in dst:
                vals = list(src[k])
                if k == "node":
                    vals = [v + offset for v in vals]
                elif remap is not None and k in remap:
                    vals = [remap[k](v) for v in vals]
                dst[k].extend(vals)

        extend(self._cameras, prefab._cameras)
        extend(self._lights, prefab._lights)
        self._meshes.extend(prefab._meshes)
        extend(self._sprites, prefab._sprites)
        extend(self._sounds, prefab._sounds,
               {"buffer": lambda v: v + buf_off})
        self._sound_buffers.extend(prefab._sound_buffers)
        extend(self._listeners, prefab._listeners)
        extend(self._rects, prefab._rects,
               {"texture": lambda v: v + rtex_off if v >= 0 else v})
        self._rect_textures.extend(prefab._rect_textures)
        extend(self._navmeshes, prefab._navmeshes,
               {"data": lambda v: v + navd_off})
        self._navmesh_data.extend(prefab._navmesh_data)
        return root

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
            sprites={k: np.asarray(v) for k, v in self._sprites.items()},
            decals={k: np.asarray(v) for k, v in self._decals.items()},
            sounds={k: np.asarray(v) for k, v in self._sounds.items()},
            listeners={k: np.asarray(v)
                       for k, v in self._listeners.items()},
            sound_buffers=list(self._sound_buffers),
            rectangles={k: np.asarray(v) for k, v in self._rects.items()},
            rect_textures=list(self._rect_textures),
            navmeshes={k: np.asarray(v) for k, v in self._navmeshes.items()},
            navmesh_data=list(self._navmesh_data),
            extras=dict(self.extras),
        )
