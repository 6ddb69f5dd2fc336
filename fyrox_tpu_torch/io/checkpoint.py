"""State checkpoint and resume (the port's ``fyrox_tpu.io.checkpoint``).

The reference's save path (the Visitor serializing whole scenes;
Scene::save, scene/mod.rs:628). A state is a nest of NamedTuples and
tuples of tensors, so a checkpoint is its leaves copied to the host into
one ``.npz`` (``leaf_{i}``, in the order of ``jax.tree.flatten`` over the
same structure: depth first, field order, None fields skipped), the format
of the JAX package's ``save_state``: a checkpoint that either package
writes loads in the other. ``state_to_visitor`` exports one world's node
poses as a Visitor (.rgs) blob that reference tooling reads.
"""
from __future__ import annotations

import io as _io
from typing import Any

import numpy as np
import torch

from fyrox_tpu_torch.engine import _leaves, _map
from fyrox_tpu_torch.io.visitor import VisitorNode, write_rgs

__all__ = ["save_state", "load_state", "state_to_visitor"]


def save_state(state: Any, path: str):
    """Write every tensor of `state` (a nest of tuples of tensors) to an
    .npz file, leaf i as ``leaf_{i}``."""
    arrs = {f"leaf_{i}": x.detach().cpu().numpy()
            for i, x in enumerate(_leaves(state))}
    buf = _io.BytesIO()
    np.savez_compressed(buf, **arrs)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_state(template_state: Any, path: str):
    """The arrays that save_state wrote, in the structure of
    `template_state` and on its tensors' devices. Refuses (ValueError, the
    JAX package's shape message) a file whose leaves differ from the
    template's in number, shape or dtype, rather than load one leaf into
    another's place."""
    old = _leaves(template_state)
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        if n != len(old):
            raise ValueError(f"checkpoint shape mismatch: {n} leaves vs "
                             f"{len(old)}")
        new = [z[f"leaf_{i}"] for i in range(n)]
    for o, a in zip(old, new):
        if tuple(o.shape) != tuple(a.shape):
            raise ValueError(f"checkpoint shape mismatch: {a.shape} vs "
                             f"{tuple(o.shape)}")
        if torch.from_numpy(np.zeros(0, a.dtype)).dtype != o.dtype:
            raise ValueError(f"checkpoint dtype mismatch: {a.dtype} vs "
                             f"{o.dtype}")
    it = iter(new)
    return _map(lambda o: torch.as_tensor(next(it), device=o.device),
                template_state)


def state_to_visitor(engine_state, scene_template, world: int = 0) -> bytes:
    """Export one world's node poses as a Visitor (.rgs-style) blob that
    reference-side tooling can parse: Scene/Graph/Pool/Records with
    NodeData name + transform per node."""
    scene = engine_state.scene
    pos = scene.position[world].cpu().numpy()
    rot = scene.rotation[world].cpu().numpy()
    scl = scene.scale[world].cpu().numpy()

    root = VisitorNode("__ROOT__")
    scene_n = VisitorNode("Scene")
    graph_n = VisitorNode("Graph")
    pool_n = VisitorNode("Pool")
    records = VisitorNode("Records")
    records.add("Length", "u32", scene_template.num_nodes)
    for i in range(scene_template.num_nodes):
        item = VisitorNode(f"Item{i}")
        item.add("Generation", "u32", 1)
        payload = VisitorNode("Payload")
        payload.add("IsSome", "u8", 1)
        data = VisitorNode("Data")
        nd = VisitorNode("NodeData")
        nd.add("Name", "string", scene_template.names[i])
        tf = VisitorNode("Transform")
        for fname, kind, val in [("LocalPosition", "vec3f32", pos[i]),
                                 ("LocalRotation", "quat", rot[i]),
                                 ("LocalScale", "vec3f32", scl[i])]:
            v = VisitorNode(fname)
            v.add("Value", kind, val)
            tf.children.append(v)
        nd.children.append(tf)
        parent = VisitorNode("Parent")
        pidx = int(scene_template.parent[i])
        parent.add("Index", "u32", max(pidx, 0))
        parent.add("Generation", "u32", 1 if pidx >= 0 else 0)
        nd.children.append(parent)
        data.children.append(nd)
        payload.children.append(data)
        item.children.append(payload)
        records.children.append(item)
    pool_n.children.append(records)
    graph_n.children.append(pool_n)
    scene_n.children.append(graph_n)
    root.children.append(scene_n)
    return write_rgs(root)
