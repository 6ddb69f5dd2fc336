"""glTF 2.0 asset loading (the port's copy of ``fyrox_tpu.io.gltf``).

Equivalent of the reference's glTF import pipeline (fyrox-impl/src/
resource/gltf/, ~2,500 LoC incl. animation import gltf/animation.rs):
loads node hierarchies with TRS transforms, meshes (positions/normals/uvs/
indices), skins (4-joint weights + inverse bind matrices), and keyframe
animations (translation/rotation/scale channels) into this engine's
builders. Supports .gltf (external or base64 data: URIs) and .glb
containers.

Host code: the loader returns builders and numpy arrays, as the JAX
package's does. Its two float32 conversions (a ``matrix`` node's
decomposition, a rotation channel's quaternion → matrix) run on CPU
tensors through the port's ``core.transform`` and ``core.quat`` whatever
device the caller later puts the scene on, since their output is host
numpy.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

import torch

from fyrox_tpu_torch.animation import AnimationSetBuilder, SkinTemplate
from fyrox_tpu_torch.core import quat as quat_mod
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.render.mesh import MeshData
from fyrox_tpu_torch.scene.builder import SceneBuilder

__all__ = ["load_gltf", "GltfScene"]

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclass
class GltfScene:
    """Loaded asset: a SceneBuilder plus per-node payloads."""
    builder: SceneBuilder
    node_map: Dict[int, int]                    # gltf node → builder index
    meshes: List[MeshData] = field(default_factory=list)
    mesh_nodes: List[int] = field(default_factory=list)   # builder indices
    skins: List[SkinTemplate] = field(default_factory=list)
    animations: Optional[AnimationSetBuilder] = None

    def build(self):
        return self.builder.build()


def _read_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB container")
    off = 12
    doc = None
    bin_chunk = b""
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8:off + 8 + clen]
        if ctype == 0x4E4F534A:      # JSON
            doc = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:    # BIN
            bin_chunk = chunk
        off += 8 + clen
    return doc, bin_chunk


def _load_buffers(doc, base_dir, glb_bin):
    bufs = []
    for b in doc.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(glb_bin)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _accessor(doc, bufs, idx) -> np.ndarray:
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    buf = bufs[view.get("buffer", 0)]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride")
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = np.frombuffer(buf, np.uint8,
                            count=stride * (count - 1) + itemsize,
                            offset=offset)
        out = np.zeros((count, ncomp), dtype)
        for i in range(count):
            out[i] = np.frombuffer(raw, dtype, ncomp, i * stride)
        arr = out
    else:
        arr = np.frombuffer(buf, dtype, count * ncomp, offset).reshape(
            count, ncomp)
    return arr.copy()


def load_gltf(path: str) -> GltfScene:
    """Load a .gltf/.glb file into builders."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"glTF":
        doc, glb_bin = _read_glb(data)
    else:
        doc = json.loads(data.decode("utf-8"))
        glb_bin = b""
    base_dir = os.path.dirname(os.path.abspath(path))
    bufs = _load_buffers(doc, base_dir, glb_bin)

    sb = SceneBuilder()
    gltf_nodes = doc.get("nodes", [])

    # parent table
    parent = {i: -1 for i in range(len(gltf_nodes))}
    for i, n in enumerate(gltf_nodes):
        for c in n.get("children", []):
            parent[c] = i

    # topological insertion (parents first)
    node_map: Dict[int, int] = {}
    order = []
    def visit(i):
        if i in node_map:
            return
        if parent[i] >= 0 and parent[i] not in node_map:
            visit(parent[i])
        node_map[i] = -2  # placeholder to break cycles
        order.append(i)
    for i in range(len(gltf_nodes)):
        visit(i)

    scene = GltfScene(builder=sb, node_map={})
    for i in order:
        n = gltf_nodes[i]
        kw = {}
        if "matrix" in n:
            m = np.asarray(n["matrix"], np.float32).reshape(4, 4).T
            p_, r_, s_ = tfm.decompose_mat4(torch.from_numpy(m))
            kw = dict(position=p_.numpy(), rotation=r_.numpy(),
                      scale=s_.numpy())
        else:
            if "translation" in n:
                kw["position"] = np.asarray(n["translation"], np.float32)
            if "rotation" in n:
                kw["rotation"] = np.asarray(n["rotation"], np.float32)
            if "scale" in n:
                kw["scale"] = np.asarray(n["scale"], np.float32)
        p = scene.node_map.get(parent[i], -1)
        bidx = sb.add_node(name=n.get("name", f"node{i}"), parent=p, **kw)
        scene.node_map[i] = bidx

    # meshes
    for i in order:
        n = gltf_nodes[i]
        if "mesh" not in n:
            continue
        mesh = doc["meshes"][n["mesh"]]
        for prim in mesh.get("primitives", []):
            attrs = prim["attributes"]
            pos = _accessor(doc, bufs, attrs["POSITION"]).astype(np.float32)
            nrm = (_accessor(doc, bufs, attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else
                   np.tile(np.asarray([[0, 1, 0]], np.float32), (len(pos), 1)))
            uv = (_accessor(doc, bufs, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else np.zeros((len(pos), 2), np.float32))
            if "indices" in prim:
                tris = _accessor(doc, bufs, prim["indices"]).reshape(-1, 3)
            else:
                tris = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
            md = MeshData(pos, nrm, uv, tris.astype(np.int32))
            scene.meshes.append(md)
            scene.mesh_nodes.append(scene.node_map[i])

            # skin
            if "skin" in n and "JOINTS_0" in attrs:
                skin = doc["skins"][n["skin"]]
                joints = [scene.node_map[j] for j in skin["joints"]]
                ibm = (_accessor(doc, bufs, skin["inverseBindMatrices"])
                       .reshape(-1, 4, 4).transpose(0, 2, 1).astype(np.float32)
                       if "inverseBindMatrices" in skin else
                       np.tile(np.eye(4, dtype=np.float32),
                               (len(joints), 1, 1)))
                j4 = _accessor(doc, bufs, attrs["JOINTS_0"]).astype(np.int32)
                w4_raw = _accessor(doc, bufs, attrs["WEIGHTS_0"])
                if w4_raw.dtype != np.float32:
                    # normalized u8/u16 weights per glTF spec
                    w4 = w4_raw.astype(np.float32) / np.iinfo(w4_raw.dtype).max
                else:
                    w4 = w4_raw
                w4 = w4 / np.maximum(w4.sum(-1, keepdims=True), 1e-8)
                scene.skins.append(SkinTemplate(
                    bones=np.asarray(joints, np.int32), inv_bind=ibm,
                    vertices=pos, bone_indices=j4, bone_weights=w4))

    # animations → AnimationSetBuilder (LINEAR samplers; rotations become
    # quat keyframes stored as separate euler channels are NOT used — the
    # engine's rotation tracks are euler, so quat channels are converted)
    if doc.get("animations"):
        ab = AnimationSetBuilder()
        for anim in doc["animations"]:
            # clip length = max input time
            length = 0.0
            chans = []
            for ch in anim.get("channels", []):
                smp = anim["samplers"][ch["sampler"]]
                times = _accessor(doc, bufs, smp["input"]).reshape(-1)
                vals = _accessor(doc, bufs, smp["output"])
                length = max(length, float(times.max()) if len(times) else 0.0)
                chans.append((ch, times, vals))
            clip = ab.add_clip(anim.get("name", "anim"), length=max(length, 1e-3))
            for ch, times, vals in chans:
                tgt = ch["target"]
                node = scene.node_map[tgt["node"]]
                path = tgt["path"]
                keysets = lambda comp: [dict(time=float(t), value=float(v))
                                        for t, v in zip(times, comp)]
                if path == "translation":
                    ab.add_position_track(clip, node,
                                          [keysets(vals[:, k]) for k in range(3)])
                elif path == "scale":
                    ab.add_scale_track(clip, node,
                                       [keysets(vals[:, k]) for k in range(3)])
                elif path == "rotation":
                    # quat keys → euler XYZ keys (engine rotation tracks are
                    # euler, matching the reference's UnitQuaternionEuler).
                    # Two continuity passes so interpolation between adjacent
                    # keys takes the short way: (1) pick q vs -q per key to
                    # keep dot(q_i, q_{i-1}) >= 0, (2) np.unwrap each euler
                    # component so keys straddling ±π don't lerp through 0.
                    q = vals.astype(np.float64)
                    if len(q) > 1:
                        flips = np.cumprod(np.where(
                            np.sum(q[1:] * q[:-1], -1) < 0.0, -1.0, 1.0))
                        q[1:] *= flips[:, None]
                    m = quat_mod.to_mat3(torch.from_numpy(
                        q.astype(np.float32))).numpy().astype(np.float64)
                    sy = -m[:, 2, 0]
                    sy = np.clip(sy, -1, 1)
                    ey = np.arcsin(sy)
                    ex = np.unwrap(np.arctan2(m[:, 2, 1], m[:, 2, 2]))
                    ez = np.unwrap(np.arctan2(m[:, 1, 0], m[:, 0, 0]))
                    ab.add_rotation_track(clip, node,
                                          [keysets(ex), keysets(ey), keysets(ez)])
        scene.animations = ab

    return scene
