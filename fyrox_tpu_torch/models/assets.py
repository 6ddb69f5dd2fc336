"""Generated benchmark assets: a complete skinned-character FBX (the
port's copy of ``fyrox_tpu.models.assets``: the same arguments write the
same bytes).

The "real asset" of the flagship is authored here as an actual binary FBX
document (written by io/fbx.write_fbx, read back by the full import path):
a bone chain with real bind poses, a tube mesh skinned by per-bone
clusters with distance-falloff weights, and per-bone rotation curves.
Everything the flagship consumes then flows through document parsing →
model/connection walk → skin-cluster extraction → curve conversion
(io/fbx.fbx_to_engine), so import-path faults cannot hide behind
synthetic in-memory skins.
"""
from __future__ import annotations

import numpy as np

from fyrox_tpu_torch.io.fbx import write_fbx

__all__ = ["make_character_fbx"]

_TICKS = 46186158000.0      # FBX ticks per second


def make_character_fbx(n_bones=16, n_verts=2000, seed=0,
                       seg_len=0.15, radius=0.12) -> bytes:
    """Binary FBX of a skinned tube character along +X.

    Bone chain b0→b{n-1} (each +seg_len local X), tube mesh of rings
    around the chain, one cluster per bone (gaussian weights by distance,
    TransformLink bind matrices), and a 1-second looping Z-rotation wave
    on every other bone.
    """
    rng = np.random.default_rng(seed)
    objs = []
    conns = []

    # ---- geometry: tube rings (quads between consecutive rings) ----
    ring = 8
    n_rings = max(n_verts // ring, 2)
    xs = np.linspace(0.0, seg_len * n_bones, n_rings)
    ang = np.linspace(0.0, 2 * np.pi, ring, endpoint=False)
    verts = np.zeros((n_rings, ring, 3))
    verts[..., 0] = xs[:, None]
    verts[..., 1] = radius * np.cos(ang)[None, :]
    verts[..., 2] = radius * np.sin(ang)[None, :]
    verts = verts.reshape(-1, 3)
    polys = []
    for r in range(n_rings - 1):
        for k in range(ring):
            a = r * ring + k
            b = r * ring + (k + 1) % ring
            c = (r + 1) * ring + (k + 1) % ring
            d = (r + 1) * ring + k
            polys.extend([a, b, c, -(d + 1)])     # quad, last index negated
    normals = verts - np.stack([verts[:, 0], np.zeros(len(verts)),
                                np.zeros(len(verts))], 1)
    nl = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = np.where(nl > 1e-6, normals / np.maximum(nl, 1e-6),
                       [[0.0, 1.0, 0.0]])
    geometry = ("Geometry", [1000, "Geometry::body", "Mesh"], [
        ("Vertices", [verts.reshape(-1).astype(np.float64)], []),
        ("PolygonVertexIndex", [np.asarray(polys, np.int32)], []),
        ("LayerElementNormal", [0], [
            ("MappingInformationType", ["ByVertice"], []),
            ("ReferenceInformationType", ["Direct"], []),
            ("Normals", [normals.reshape(-1).astype(np.float64)], []),
        ]),
    ])
    objs.append(geometry)

    mesh_model = ("Model", [1, "Model::body", "Mesh"], [])
    objs.append(mesh_model)
    conns.append(("C", ["OO", 1000, 1], []))

    # ---- bone chain ----
    bone_ids = []
    for b in range(n_bones):
        mid = 100 + b
        bone_ids.append(mid)
        tr = [0.0, 0.0, 0.0] if b == 0 else [seg_len, 0.0, 0.0]
        objs.append(("Model", [mid, f"Model::bone{b}", "LimbNode"], [
            ("Properties70", [], [
                ("P", ["Lcl Translation", "", "", ""] + tr, []),
            ]),
        ]))
        if b > 0:
            conns.append(("C", ["OO", mid, mid - 1], []))

    # ---- skin deformer + per-bone clusters ----
    objs.append(("Deformer", [2000, "Deformer::skin", "Skin"], []))
    conns.append(("C", ["OO", 2000, 1000], []))
    bone_x = np.arange(n_bones) * seg_len        # bind-pose world x
    for b in range(n_bones):
        cid = 3000 + b
        dist = np.abs(verts[:, 0] - bone_x[b])
        w = np.exp(-(dist / (seg_len * 1.2)) ** 2)
        sel = np.flatnonzero(w > 0.05)
        bind = np.eye(4)
        bind[3, 0] = bone_x[b]                   # row-major translation row
        objs.append(("Deformer", [cid, f"SubDeformer::c{b}", "Cluster"], [
            ("Indexes", [sel.astype(np.int32)], []),
            ("Weights", [w[sel].astype(np.float64)], []),
            ("TransformLink", [bind.reshape(-1).astype(np.float64)], []),
        ]))
        conns.append(("C", ["OO", cid, 2000], []))
        conns.append(("C", ["OO", 100 + b, cid], []))

    # ---- animation: Z-rotation wave on every other bone ----
    times = (np.asarray([0.0, 0.25, 0.5, 0.75, 1.0]) * _TICKS
             ).astype(np.int64)
    for b in range(0, n_bones, 2):
        phase = b / n_bones * 2 * np.pi
        vals = 20.0 * np.sin(phase + 2 * np.pi * times / _TICKS)  # degrees
        cn = 4000 + b
        cv = 5000 + b
        objs.append(("AnimationCurveNode", [cn, "AnimCurveNode::R", ""], []))
        objs.append(("AnimationCurve", [cv, "AnimCurve::", ""], [
            ("KeyTime", [times], []),
            ("KeyValueFloat", [vals.astype(np.float64)], []),
        ]))
        conns.append(("C", ["OP", cn, 100 + b, "Lcl Rotation"], []))
        conns.append(("C", ["OP", cv, cn, "d|Z"], []))

    return write_fbx([("Objects", [], objs),
                      ("Connections", [], conns)])
