"""Load reference .rgs scenes into SceneTemplates (the port's copy of
``fyrox_tpu.io.rgs_scene``; host only: the result is the port's numpy
SceneTemplate, which ``init_state`` / ``Engine`` put on a device).

Walks the Visitor tree of a Fyrox scene (Scene → Graph → Pool → Records →
ItemN → Payload → Data → NodeData, as serialized by Scene::save
fyrox-impl/src/scene/mod.rs:628) and reconstructs hierarchy + full local
transforms into a SceneBuilder.

Node typing: the Data node's TypeUuid identifies the concrete NodeTrait
impl; the table below carries the uuids we map so far (harvested from
reference scenes), everything else loads as a PIVOT with its name/transform
preserved — enough for the step/cull loops, with payload-specific fields
(cameras, lights, meshes) deepening over time.
"""
from __future__ import annotations

import uuid as uuid_mod
from typing import Union

import numpy as np

from fyrox_tpu_torch.io.visitor import VisitorNode, read_rgs
from fyrox_tpu_torch.scene.builder import SceneBuilder
from fyrox_tpu_torch.scene.template import NodeType, SceneTemplate

__all__ = ["load_scene", "parse_graph"]

# Known node-type uuids (Data.TypeUuid → NodeType).
_TYPE_UUIDS = {
    # fyrox-impl node type uuids (reflect type_uuid attributes)
    "57c125ff-e54d-44c0-a9b1-17b8451a1e8d": NodeType.PIVOT,
    "198d3aca-433c-4ce1-bb25-3190699b757f": NodeType.CAMERA,
    "caaf9d7b-bd74-48ce-b7cc-57e9dc65c2e6": NodeType.MESH,
    "60fd7e34-46c1-4ae9-8803-1f5f4c48695a": NodeType.SPRITE,
    "12639b99-e1cf-46a8-a34a-c3cc5db8b22e": NodeType.POINT_LIGHT,
    "23658785-7ceb-4d25-8baa-5200cc2db7b0": NodeType.SPOT_LIGHT,
    "8b210ffc-f1fa-4b8b-b4a5-afc10a9a9d9e": NodeType.DIRECTIONAL_LIGHT,
    # scene/sound/mod.rs:78 Sound, listener.rs:62 Listener (node kind is
    # preserved through load; source buffers re-bind via SceneBuilder)
    "28621735-8cd1-4fad-8faf-ecd24bf8aa99": NodeType.SOUND,
    "2c7dabc1-5666-4256-b020-01532701e4c6": NodeType.LISTENER,
}


def _vec(node: VisitorNode, name, default):
    v = node.field_value(name)
    return np.asarray(default if v is None else v, np.float32)


def _inheritable(parent: VisitorNode, name, default):
    """Read an InheritableVariable field: inline `Value` field, a child
    region with a Value field, or a legacy string region (Length + Data
    blob — how old scenes store strings)."""
    v = parent.field_value(name)
    if v is not None:
        return v
    ch = parent.child(name)
    if ch is not None:
        v = ch.field_value("Value")
        if v is not None:
            return v
        blob = ch.field_value("Data")
        if blob is not None and ch.field_value("Length") is not None:
            try:
                return bytes(blob).decode("utf-8", errors="replace")
            except Exception:
                return default
    return default


def parse_graph(root: VisitorNode) -> SceneBuilder:
    """VisitorNode tree → SceneBuilder with hierarchy + transforms."""
    scene = root.child("Scene") or root
    graph = scene.child("Graph")
    if graph is None:
        raise ValueError("no Scene/Graph region in .rgs file")
    pool = graph.child("Pool")
    records = pool.child("Records")

    items = []
    for rec in records.children:
        # current layout: Item → Payload; legacy: Item → ItemData → Payload
        holder = rec if rec.child("Payload") is not None else rec.child("ItemData")
        payload = holder.child("Payload") if holder is not None else None
        if payload is None or not payload.field_value("IsSome", 0):
            items.append(None)
            continue
        data = payload.child("Data")
        node_data = data.child("NodeData") if data is not None else None
        # typed nodes nest the common Base data one level deeper:
        # Data → NodeData → Base (base.rs fields); pivots put them inline
        if node_data is not None and node_data.child("Base") is not None:
            node_data = node_data.child("Base")
        if node_data is None and data is not None and data.child("Transform"):
            node_data = data   # very old layout: fields inline on Data
        items.append((data, node_data))

    builder = SceneBuilder()
    slot_to_builder = {}
    parents = {}

    for slot, item in enumerate(items):
        if item is None:
            continue
        data, nd = item
        name = (nd.field_value("Name") or _inheritable(nd, "Name", None)
                or f"node{slot}") if nd else f"node{slot}"
        tf = nd.child("Transform") if nd else None

        kw = {}
        if tf is not None:
            kw["position"] = np.asarray(_inheritable(tf, "LocalPosition",
                                                     np.zeros(3)), np.float32)
            kw["rotation"] = np.asarray(_inheritable(tf, "LocalRotation",
                                                     [0, 0, 0, 1]), np.float32)
            kw["scale"] = np.asarray(_inheritable(tf, "LocalScale",
                                                  np.ones(3)), np.float32)
            for fx_name, our_name in [("PreRotation", "pre_rotation"),
                                      ("PostRotation", "post_rotation"),
                                      ("RotationOffset", "rotation_offset"),
                                      ("RotationPivot", "rotation_pivot"),
                                      ("ScalingOffset", "scaling_offset"),
                                      ("ScalingPivot", "scaling_pivot")]:
                v = _inheritable(tf, fx_name, None)
                if v is not None:
                    arr = np.asarray(v, np.float32)
                    ident = (np.array([0, 0, 0, 1], np.float32) if arr.shape[-1] == 4
                             else np.zeros(3, np.float32))
                    if not np.allclose(arr, ident):
                        kw[our_name] = arr
        vis = nd.field_value("Visibility") if nd else None
        if vis is None and nd is not None:
            vis = _inheritable(nd, "Visibility", True)
        kw["visibility"] = bool(vis) if vis is not None else True

        type_uuid = None
        if data is not None:
            raw = data.field_value("TypeUuid")
            if raw is not None:
                type_uuid = str(uuid_mod.UUID(bytes=bytes(raw)))
        node_type = _TYPE_UUIDS.get(type_uuid, NodeType.PIVOT)

        idx = builder.add_node(name=name, parent=-1, node_type=node_type, **kw)
        slot_to_builder[slot] = idx

        par = nd.child("Parent") if nd else None
        if par is not None and par.field_value("Generation", 0) != 0:
            parents[slot] = int(par.field_value("Index", 0))

    # resolve parents (slot indices → builder indices)
    for slot, pslot in parents.items():
        if pslot in slot_to_builder:
            builder._nodes[slot_to_builder[slot]].parent = slot_to_builder[pslot]
    return builder


def load_scene(source: Union[str, bytes]) -> SceneTemplate:
    """Read a .rgs file (binary FBAF, legacy RG3D, or ASCII FTAX) into a
    packed SceneTemplate."""
    if isinstance(source, str):
        with open(source, "rb") as f:
            source = f.read()
    data = source
    root, _version = read_rgs(data)
    return parse_graph(root).build()
