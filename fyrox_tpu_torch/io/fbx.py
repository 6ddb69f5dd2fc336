"""FBX import: binary + ASCII document parser and scene extraction (the
port's copy of ``fyrox_tpu.io.fbx``; host numpy, building the port's
SceneBuilder, MeshData, SkinTemplate and AnimationSetBuilder).

Equivalent of the reference's FBX pipeline (fyrox-impl/src/resource/fbx/):
the document layer (resource/fbx/document/mod.rs:138-149 auto-detects
ASCII vs binary by the "Kaydara FBX Binary  " magic) parses the node tree
with typed properties; the scene layer walks Objects/Connections to build
Model hierarchy + Geometry meshes (polygon fan triangulation, per-layer
normals/UVs with direct or index-to-direct mapping, matching
resource/fbx/scene/geom.rs semantics).

Binary format notes (public Kaydara layout): each node record is
  u32 end_offset | u32 num_props | u32 prop_list_len | u8 name_len | name
followed by typed properties — scalars Y/C/I/F/D/L, zlib-compressible
arrays f/d/l/i/b, and S/R blobs — then child records and a 13-byte NULL
sentinel when children exist. Version >= 7500 widens the record fields to
u64 (sentinel 25 bytes).
"""
from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from fyrox_tpu_torch.animation.skinning import SkinTemplate
from fyrox_tpu_torch.animation.track import AnimationSetBuilder
from fyrox_tpu_torch.core import quat as quat_mod
from fyrox_tpu_torch.render.mesh import MeshData
from fyrox_tpu_torch.scene.builder import SceneBuilder

__all__ = ["FbxNode", "parse_fbx", "fbx_to_scene", "load_fbx_scene",
           "write_fbx", "extract_skin", "extract_animations",
           "fbx_to_engine"]

_BINARY_MAGIC = b"Kaydara FBX Binary  \x00"


@dataclass
class FbxNode:
    name: str
    properties: list = field(default_factory=list)
    children: List["FbxNode"] = field(default_factory=list)

    def child(self, name) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def all(self, name) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]

    def prop(self, i, default=None):
        return self.properties[i] if i < len(self.properties) else default


# --------------------------------------------------------------------------
# binary reader
# --------------------------------------------------------------------------

_SCALAR = {b"Y": ("<h", 2), b"C": ("<B", 1), b"I": ("<i", 4),
           b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8)}
_ARRAY = {b"f": np.float32, b"d": np.float64, b"l": np.int64,
          b"i": np.int32, b"b": np.uint8}


def _read_props(data, pos, count):
    props = []
    for _ in range(count):
        code = data[pos:pos + 1]
        pos += 1
        if code in _SCALAR:
            fmt, size = _SCALAR[code]
            props.append(struct.unpack_from(fmt, data, pos)[0])
            pos += size
        elif code in _ARRAY:
            n, enc, clen = struct.unpack_from("<III", data, pos)
            pos += 12
            raw = data[pos:pos + clen]
            pos += clen
            if enc == 1:
                raw = zlib.decompress(raw)
            props.append(np.frombuffer(raw, _ARRAY[code], count=n).copy())
        elif code == b"S":
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            props.append(data[pos:pos + n].decode("utf-8", "replace"))
            pos += n
        elif code == b"R":
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            props.append(data[pos:pos + n])
            pos += n
        else:
            raise ValueError(f"unknown FBX property type {code!r}")
    return props, pos


def _read_node(data, pos, wide):
    if wide:
        end, nprops, _plen = struct.unpack_from("<QQQ", data, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", data, pos)
        pos += 12
    nlen = data[pos]
    pos += 1
    if end == 0 and nprops == 0 and nlen == 0:
        return None, pos          # NULL sentinel
    name = data[pos:pos + nlen].decode("ascii", "replace")
    pos += nlen
    props, pos = _read_props(data, pos, nprops)
    node = FbxNode(name, props)
    while pos < end:
        child, pos = _read_node(data, pos, wide)
        if child is None:
            break
        node.children.append(child)
    return node, end


def _parse_binary(data) -> FbxNode:
    version = struct.unpack_from("<I", data, len(_BINARY_MAGIC) + 2)[0]
    wide = version >= 7500
    pos = len(_BINARY_MAGIC) + 2 + 4
    root = FbxNode("")
    while pos < len(data):
        node, pos = _read_node(data, pos, wide)
        if node is None:
            break
        root.children.append(node)
    return root


# --------------------------------------------------------------------------
# ASCII reader (document/ascii.rs equivalent)
# --------------------------------------------------------------------------

def _tokenize_ascii(text):
    for line in text.splitlines():
        line = line.split(";", 1)[0].strip()
        if line:
            yield line


def _parse_ascii(text) -> FbxNode:
    root = FbxNode("")
    stack = [root]
    pending = None
    for line in _tokenize_ascii(text):
        if line == "}":
            stack.pop()
            continue
        opens = line.endswith("{")
        body = line[:-1].strip() if opens else line
        if ":" in body:
            name, rest = body.split(":", 1)
            props = []
            for tok in _split_ascii_props(rest.strip()):
                props.append(_ascii_value(tok))
            node = FbxNode(name.strip(), props)
            stack[-1].children.append(node)
            if opens:
                stack.append(node)
            pending = node
        elif body and pending is not None:
            # continuation rows of a long array (a: 1,2,3, \n 4,5)
            pending.properties.extend(
                _ascii_value(t) for t in _split_ascii_props(body))
    # fold `a:` array child nodes into numpy arrays like the binary path
    def fold(n):
        a = n.child("a")
        if a is not None and len(n.children) == 1:
            n.properties = [np.asarray(a.properties)]
            n.children = []
        for c in n.children:
            fold(c)
    fold(root)
    return root


def _split_ascii_props(s):
    out, cur, depth, instr = [], "", 0, False
    for ch in s:
        if ch == '"':
            instr = not instr
            cur += ch
        elif ch == "," and not instr and depth == 0:
            if cur.strip():
                out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _ascii_value(tok):
    if tok.startswith('"'):
        return tok.strip('"')
    if tok.startswith("*"):          # array length marker `*8`
        return int(tok[1:])
    try:
        if "." in tok or "e" in tok or "E" in tok:
            return float(tok)
        return int(tok)
    except ValueError:
        return tok


def parse_fbx(data) -> FbxNode:
    """Parse FBX bytes (auto-detect binary vs ASCII, document/mod.rs:138)."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    if data.startswith(_BINARY_MAGIC[:18]):
        return _parse_binary(data)
    return _parse_ascii(data.decode("utf-8", "replace"))


# --------------------------------------------------------------------------
# scene extraction (resource/fbx/scene/)
# --------------------------------------------------------------------------

def _triangulate_polys(index):
    """PolygonVertexIndex → [T,3] fan triangles. The last index of every
    polygon is stored negated as -i-1 (geom.rs polygon decoding)."""
    tris = []
    poly = []
    for raw in np.asarray(index, np.int64):
        if raw < 0:
            poly.append(int(~raw))
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
            poly = []
        else:
            poly.append(int(raw))
    return np.asarray(tris, np.int32).reshape(-1, 3)


def _layer_to_per_vertex(geom, layer_name, value_name, n_verts, dim):
    """Resolve a LayerElement (normals/UV) to per-control-point values.
    Handles ByVertice/ByPolygonVertex x Direct/IndexToDirect."""
    layer = geom.child(layer_name)
    if layer is None:
        return None
    vals_node = layer.child(value_name)
    if vals_node is None:
        return None
    vals = np.asarray(vals_node.properties[0], np.float64).reshape(-1, dim)
    mapping = (layer.child("MappingInformationType") or FbxNode("", ["ByVertice"])).prop(0)
    refmode = (layer.child("ReferenceInformationType") or FbxNode("", ["Direct"])).prop(0)
    idx_node = layer.child(value_name + "Index") or layer.child("UVIndex")
    if refmode == "IndexToDirect" and idx_node is not None:
        vals = vals[np.asarray(idx_node.properties[0], np.int64)]
    if mapping in ("ByVertice", "ByVertex"):
        return vals.astype(np.float32)
    if mapping == "ByPolygonVertex":
        # average polygon-vertex values down onto control points
        index = geom.child("PolygonVertexIndex").properties[0]
        cp = np.asarray([i if i >= 0 else ~i for i in np.asarray(index, np.int64)])
        out = np.zeros((n_verts, dim), np.float64)
        cnt = np.zeros(n_verts, np.float64)
        np.add.at(out, cp, vals[:len(cp)])
        np.add.at(cnt, cp, 1.0)
        return (out / np.maximum(cnt[:, None], 1.0)).astype(np.float32)
    return None


def _props70(model):
    out = {}
    p70 = model.child("Properties70")
    if p70 is None:
        return out
    for p in p70.all("P"):
        name = p.prop(0)
        out[name] = [v for v in p.properties[4:]]
    return out


# --------------------------------------------------------------------------
# binary writer (the reverse of the reader above: Kaydara header + node
# records with typed properties; used for asset generation and export)
# --------------------------------------------------------------------------

def _write_prop(p):
    if isinstance(p, bool):
        return b"C" + struct.pack("<B", int(p))
    if isinstance(p, int):
        return b"I" + struct.pack("<i", p)
    if isinstance(p, float):
        return b"D" + struct.pack("<d", p)
    if isinstance(p, str):
        raw = p.encode()
        return b"S" + struct.pack("<I", len(raw)) + raw
    arr = np.asarray(p)
    code = {np.dtype(np.float64): b"d", np.dtype(np.int32): b"i",
            np.dtype(np.int64): b"l", np.dtype(np.float32): b"f"}[arr.dtype]
    raw = arr.tobytes()
    comp = zlib.compress(raw)
    return code + struct.pack("<III", arr.size, 1, len(comp)) + comp


def _write_node(name, props=(), children=(), base=0):
    pb = b"".join(_write_prop(p) for p in props)
    nb = name.encode()
    header_len = 12 + 1 + len(nb)
    kids = b""
    off = base + header_len + len(pb)
    for cname, cprops, ckids in children:
        kb = _write_node(cname, cprops, ckids, base=off + len(kids))
        kids += kb
    if children:
        kids += b"\x00" * 13
    end = base + header_len + len(pb) + len(kids)
    hdr = struct.pack("<III", end, len(props), len(pb)) + bytes([len(nb)]) + nb
    return hdr + pb + kids


def write_fbx(top_nodes) -> bytes:
    """Serialize `(name, [props], [children])` trees to binary FBX
    (version 7400). Round-trips through `parse_fbx`."""
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    for name, props, kids in top_nodes:
        out += _write_node(name, props, kids, base=len(out))
    out += b"\x00" * 13
    return out


def fbx_to_scene(doc: FbxNode, scene_builder=None, return_ids=False):
    """Build a SceneTemplate from an FBX document: Model nodes (Lcl
    Translation/Rotation/Scaling) + Geometry meshes connected via OO links
    (resource/fbx/mod.rs conversion). Returns (SceneBuilder, name→node),
    plus the model-id→node map when `return_ids` (ids are unique where
    names may collide — skins/curves must bind by id)."""
    sb = scene_builder or SceneBuilder()
    objects = doc.child("Objects")
    conns = doc.child("Connections")
    if objects is None:
        return sb, {}

    geoms, models = {}, {}
    for g in objects.all("Geometry"):
        gid = int(g.prop(0, 0))
        verts = np.asarray(g.child("Vertices").properties[0],
                           np.float64).reshape(-1, 3).astype(np.float32)
        tris = _triangulate_polys(g.child("PolygonVertexIndex").properties[0])
        n = _layer_to_per_vertex(g, "LayerElementNormal", "Normals",
                                 len(verts), 3)
        if n is None:
            n = np.tile(np.asarray([[0, 1, 0]], np.float32), (len(verts), 1))
        uv = _layer_to_per_vertex(g, "LayerElementUV", "UV", len(verts), 2)
        if uv is None:
            uv = np.zeros((len(verts), 2), np.float32)
        geoms[gid] = MeshData(verts, n, uv, tris)

    for m in objects.all("Model"):
        mid = int(m.prop(0, 0))
        name = str(m.prop(1, "model"))
        if "::" in name:
            name = name.split("::", 1)[1]
        p = _props70(m)
        tr = p.get("Lcl Translation", [0.0, 0.0, 0.0])[:3]
        rot = p.get("Lcl Rotation", [0.0, 0.0, 0.0])[:3]
        scl = p.get("Lcl Scaling", [1.0, 1.0, 1.0])[:3]
        models[mid] = dict(name=name, translation=tr, rotation=rot,
                           scale=scl, parent=0, geometry=None)

    # Connections: C: "OO", child, parent
    if conns is not None:
        for c in conns.all("C"):
            kind, child_id, parent_id = c.prop(0), int(c.prop(1)), int(c.prop(2))
            if kind != "OO":
                continue
            if child_id in geoms and parent_id in models:
                models[parent_id]["geometry"] = child_id
            elif child_id in models and parent_id in models:
                models[child_id]["parent"] = parent_id

    name_to_node = {}
    made = {}

    def build(mid):
        if mid in made:
            return made[mid]
        m = models[mid]
        parent = build(m["parent"]) if m["parent"] in models else -1
        # degrees → radians in float64, then the quaternion in float32 (the
        # JAX package's from_euler on float32 arrays)
        ex, ey, ez = (torch.tensor(math.radians(float(v)), dtype=torch.float32)
                      for v in m["rotation"])
        q = quat_mod.from_euler(ex, ey, ez).numpy()
        kw = dict(parent=parent,
                  position=[float(v) for v in m["translation"]],
                  rotation=q, scale=[float(v) for v in m["scale"]])
        if m["geometry"] is not None:
            idx = sb.add_mesh(geoms[m["geometry"]], name=m["name"], **kw)
        else:
            idx = sb.add_pivot(name=m["name"], **kw)
        made[mid] = idx
        name_to_node[m["name"]] = idx
        return idx

    for mid in models:
        build(mid)
    if return_ids:
        return sb, name_to_node, made
    return sb, name_to_node


def load_fbx_scene(path_or_bytes, scene_builder=None):
    """One call from bytes or a path to (SceneBuilder, name → node
    index)."""
    return fbx_to_scene(parse_fbx(path_or_bytes), scene_builder)


# --------------------------------------------------------------------------
# skins + animations (resource/fbx/scene/animation.rs, model.rs deformers)
# --------------------------------------------------------------------------

FBX_TICKS_PER_SECOND = 46186158000.0


def extract_skin(doc: FbxNode, geometry_id=None):
    """Skin deformer extraction: Cluster indexes/weights + bind matrices.

    Returns None or dict(bone_model_ids [B], indices [V,4] int32,
    weights [V,4] f32, inv_bind [B,4,4]) for the (first) skinned
    geometry. Mirrors the reference's Deformer/SubDeformer walk."""
    objects = doc.child("Objects")
    conns = doc.child("Connections")
    if objects is None or conns is None:
        return None
    links = [(int(c.prop(1)), int(c.prop(2))) for c in conns.all("C")
             if c.prop(0) == "OO"]
    parent_of = {}
    children_of = {}
    for child, parent in links:
        parent_of.setdefault(child, []).append(parent)
        children_of.setdefault(parent, []).append(child)

    deformers = {int(d.prop(0, 0)): d for d in objects.all("Deformer")}
    geoms = {int(g.prop(0, 0)): g for g in objects.all("Geometry")}
    skins = {i: d for i, d in deformers.items()
             if "Skin" in str(d.prop(2, ""))
             and "Cluster" not in str(d.prop(2, ""))}
    for sid, skin in skins.items():
        gids = [p for p in parent_of.get(sid, []) if p in geoms]
        if not gids or (geometry_id is not None and geometry_id not in gids):
            continue
        gid = gids[0]
        n_verts = len(np.asarray(geoms[gid].child("Vertices").properties[0])) // 3
        clusters = [deformers[c] for c in children_of.get(sid, [])
                    if c in deformers and "Cluster" in str(deformers[c].prop(2, ""))]
        bone_ids, inv_bind = [], []
        acc = [[] for _ in range(n_verts)]     # (weight, bone_slot)
        for slot, cl in enumerate(clusters):
            cid = int(cl.prop(0, 0))
            bones = [p for p in children_of.get(cid, [])]
            # bone Model links INTO the cluster (Model -OO-> Cluster)
            bone = bones[0] if bones else -1
            bone_ids.append(bone)
            # FBX matrices are COLUMN-major flats; engine matrices are
            # column-vector convention (translation in [:3,3]) — the
            # row-major reshape must be transposed (a no-op only for the
            # identity, which is why synthetic fixtures never caught it)
            tl = cl.child("TransformLink")
            t = cl.child("Transform")
            if t is not None:
                inv_bind.append(np.asarray(t.properties[0],
                                           np.float64).reshape(4, 4).T)
            elif tl is not None:
                inv_bind.append(np.linalg.inv(
                    np.asarray(tl.properties[0], np.float64).reshape(4, 4).T))
            else:
                inv_bind.append(np.eye(4))
            idxs = cl.child("Indexes")
            wts = cl.child("Weights")
            if idxs is None or wts is None:
                continue
            for vi, wv in zip(np.asarray(idxs.properties[0], np.int64),
                              np.asarray(wts.properties[0], np.float64)):
                if 0 <= vi < n_verts:
                    acc[int(vi)].append((float(wv), slot))
        indices = np.zeros((n_verts, 4), np.int32)
        weights = np.zeros((n_verts, 4), np.float32)
        for vi, lst in enumerate(acc):
            lst.sort(reverse=True)
            for k, (wv, slot) in enumerate(lst[:4]):
                indices[vi, k] = slot
                weights[vi, k] = wv
            tot = weights[vi].sum()
            if tot > 0:
                weights[vi] /= tot
        return dict(geometry_id=gid,
                    bone_model_ids=np.asarray(bone_ids, np.int64),
                    indices=indices, weights=weights,
                    inv_bind=np.stack(inv_bind).astype(np.float32))
    return None


def extract_animations(doc: FbxNode):
    """AnimationCurveNode/AnimationCurve extraction.

    Returns {model_id: {channel: [(t_sec, value), ...]}} with channel in
    'Lcl Translation'/'Lcl Rotation' + component letters ('T.X', 'R.Z'…) —
    the raw curves the reference converts into engine tracks
    (resource/gltf parity lives in io/gltf.py; FBX stores per-component
    curves in FBX ticks)."""
    objects = doc.child("Objects")
    conns = doc.child("Connections")
    if objects is None or conns is None:
        return {}
    curve_nodes = {int(n.prop(0, 0)): n
                   for n in objects.all("AnimationCurveNode")}
    curves = {int(n.prop(0, 0)): n for n in objects.all("AnimationCurve")}
    out = {}
    # OP links carry the property names on both hops:
    #   AnimationCurve -OP("d|X")-> AnimationCurveNode
    #   AnimationCurveNode -OP("Lcl Translation")-> Model
    node_target = {}
    for c in conns.all("C"):
        if c.prop(0) != "OP":
            continue
        child, parent, pname = int(c.prop(1)), int(c.prop(2)), str(c.prop(3, ""))
        if child in curve_nodes and parent not in curve_nodes:
            node_target[child] = (parent, pname)
    for c in conns.all("C"):
        if c.prop(0) != "OP":
            continue
        child, parent, comp = int(c.prop(1)), int(c.prop(2)), str(c.prop(3, ""))
        if child in curves and parent in node_target:
            model, prop = node_target[parent]
            cv = curves[child]
            kt = np.asarray(cv.child("KeyTime").properties[0], np.float64)
            kv = np.asarray(cv.child("KeyValueFloat").properties[0], np.float64)
            times = kt / FBX_TICKS_PER_SECOND
            tag = ("T" if "Translation" in prop else
                   "R" if "Rotation" in prop else
                   "S" if "Scaling" in prop else prop)
            axis = comp.split("|")[-1].strip().upper()[-1:] or "X"
            out.setdefault(model, {})[f"{tag}.{axis}"] = list(
                zip(times.tolist(), kv.tolist()))
    return out


def fbx_to_engine(data, scene_builder=None):
    """Full import: FBX bytes/path → (SceneBuilder, name→node,
    SkinTemplate|None, AnimationSet|None).

    Ties the document-layer extractors into the engine templates: the
    skinned geometry's clusters become a SkinTemplate over the imported
    bone nodes, and per-component animation curves become one clip with
    position/rotation tracks (resource/fbx/ → engine conversion,
    mirroring what io/gltf.py does for glTF)."""
    doc = parse_fbx(data)
    # id→node comes straight from the build walk: FBX files commonly
    # contain duplicate model NAMES, so a name-keyed rebuild would bind
    # skin bones / animation curves to the wrong node
    sb, names, id_to_node = fbx_to_scene(doc, scene_builder, return_ids=True)
    objects = doc.child("Objects")

    skin_t = None
    skin = extract_skin(doc)
    if skin is not None:
        geom = None
        for g in objects.all("Geometry"):
            if int(g.prop(0, 0)) == skin["geometry_id"]:
                geom = g
        verts = np.asarray(geom.child("Vertices").properties[0],
                           np.float64).reshape(-1, 3).astype(np.float32)
        bone_nodes = np.asarray(
            [id_to_node.get(int(b), -1) for b in skin["bone_model_ids"]],
            np.int32)
        skin_t = SkinTemplate(bones=bone_nodes,
                              inv_bind=skin["inv_bind"],
                              vertices=verts,
                              bone_indices=skin["indices"],
                              bone_weights=skin["weights"])

    anim_set = None
    curves = extract_animations(doc)
    if curves:
        ab = AnimationSetBuilder()
        length = max((k[-1][0] for chans in curves.values()
                      for k in chans.values() if k), default=1.0)
        clip = ab.add_clip("fbx", length=max(length, 1e-3), looping=True)
        for model_id, chans in curves.items():
            node = id_to_node.get(model_id, -1)
            if node < 0:
                continue
            if any(c.startswith("T.") for c in chans):
                keys = []
                for ax in "XYZ":
                    ks = chans.get(f"T.{ax}", [(0.0, 0.0)])
                    keys.append([dict(time=t_, value=v) for t_, v in ks])
                ab.add_position_track(clip, node=node, keys_xyz=keys)
            if any(c.startswith("R.") for c in chans):
                keys = []
                for ax in "XYZ":
                    ks = chans.get(f"R.{ax}", [(0.0, 0.0)])
                    keys.append([dict(time=t_, value=math.radians(v))
                                 for t_, v in ks])
                ab.add_rotation_track(clip, node=node, keys_euler_xyz=keys)
        anim_set = ab.build()
    return sb, names, skin_t, anim_set
