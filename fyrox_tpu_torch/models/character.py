"""Flagship scene: animated skinned character + rigid-body pile + camera.

Host-side builders, the port's copies of ``fyrox_tpu.models.character``;
the same numpy seeds give the same templates (a CPU test holds them
equal). By default the pile has 64 bodies and takes the dense broadphase,
as the JAX package's default does; ``n_bodies=1000`` is the bench
configuration (100 bones / 50k vertices / 1000 bodies) on the slab
broadphase, which every pile of 192 bodies or more takes. With
``real_asset`` the character is an imported FBX (``models.assets``
writes one) on the plain AnimationPlayer; ``with_audio`` adds a sound
source on the character and a listener on the camera.
"""
from __future__ import annotations

import numpy as np

from fyrox_tpu_torch.animation import (AnimationSetBuilder, MachineBuilder,
                                       SkinTemplate)
from fyrox_tpu_torch.engine import Engine
from fyrox_tpu_torch.io.fbx import fbx_to_engine
from fyrox_tpu_torch.physics import (BALL, CUBOID, HALFSPACE, BodyType,
                                     PhysicsBuilder)
from fyrox_tpu_torch.scene import NodeType, SceneBuilder
from fyrox_tpu_torch.scene import graph as graph_mod
from fyrox_tpu_torch.scene import init_state
from fyrox_tpu_torch.sound.engine import SAMPLE_RATE

__all__ = ["build_flagship", "build_character_scene", "build_pile_scene",
           "assemble_flagship", "assemble_imported"]

# slab windows sized from the measured demand of the settled 1k pile
SLAB_WINDOW = (12, 8, 10)
SLAB_ACTIVE = 16
SLAB_WALK = 48
# under temporal broadphase reuse the fattened AABBs raise the demand
# (class 0 on the settled pile 11 → 14), so the windows and the walk grow
REUSE_WINDOW = (16, 8, 12)
REUSE_WALK = 64


def _linear_keys(times, values):
    return [dict(time=float(t), value=float(v)) for t, v in zip(times, values)]


def build_character_scene(n_bones=100, n_verts=50_000, seed=0,
                          with_machine=True):
    """Bone-chain character with walk/run clips on an ABSM and a
    dense-weight skin. Returns (builder, aset, machine, bones, skin)."""
    rng = np.random.default_rng(seed)
    sb = SceneBuilder()
    root = sb.add_pivot("character")
    bones = []
    prev = root
    for i in range(n_bones):
        # branch every 10 bones, like limbs off a spine
        parent = prev if i % 10 else (bones[max(0, i - 10)] if bones
                                      else root)
        idx = sb.add_pivot(f"bone{i}", parent=parent,
                           position=(0.15, 0.0, 0.0))
        bones.append(idx)
        prev = idx

    ab = AnimationSetBuilder()
    walk = ab.add_clip("walk", length=1.0, looping=True)
    run = ab.add_clip("run", length=0.6, looping=True)
    for k, bidx in enumerate(bones):
        if k % 2:
            continue
        phase = (k / len(bones)) * 2 * np.pi
        amp_w, amp_r = 0.35, 0.6
        times = [0.0, 0.25, 0.5, 0.75, 1.0]
        vals_w = [amp_w * np.sin(phase + 2 * np.pi * t) for t in times]
        ab.add_rotation_track(walk, bidx, [
            _linear_keys(times, [0] * 5), _linear_keys(times, [0] * 5),
            _linear_keys(times, vals_w)])
        times_r = [0.0, 0.15, 0.3, 0.45, 0.6]
        vals_r = [amp_r * np.sin(phase + 2 * np.pi * t / 0.6)
                  for t in times_r]
        ab.add_rotation_track(run, bidx, [
            _linear_keys(times_r, [0] * 5), _linear_keys(times_r, [0] * 5),
            _linear_keys(times_r, vals_r)])
    aset = ab.build()

    mt = None
    if with_machine:
        mb = MachineBuilder()
        p_run = mb.add_parameter("run")
        s_walk = mb.add_state("walk", clip=walk)
        s_run = mb.add_state("run", clip=run)
        mb.set_entry_state(s_walk)
        mb.add_transition(s_walk, s_run, p_run, duration=0.3)
        mb.add_transition(s_run, s_walk, p_run, duration=0.3, invert=True)
        mt = mb.build()

    verts = rng.uniform(-0.2, 0.2, (n_verts, 3)).astype(np.float32)
    verts[:, 0] += rng.uniform(0, 0.15 * n_bones, n_verts).astype(np.float32)
    nearest = np.clip((verts[:, 0] / 0.15).astype(np.int32), 0, n_bones - 1)
    idx4 = np.stack([np.clip(nearest + d, 0, n_bones - 1) for d in range(4)],
                    1)
    w4 = rng.uniform(0.1, 1.0, (n_verts, 4)).astype(np.float32)
    w4 /= w4.sum(-1, keepdims=True)
    return sb, aset, mt, bones, (verts, idx4.astype(np.int32), w4)


def build_pile_scene(sb: SceneBuilder, n_bodies=64, seed=1):
    """Rigid-body pile (balls and boxes) above a ground plane."""
    rng = np.random.default_rng(seed)
    pb = PhysicsBuilder()
    ground_node = sb.add_pivot("ground")
    gb = pb.add_body(node=ground_node, body_type=BodyType.STATIC)
    pb.add_collider(gb, HALFSPACE, [], friction=0.6)
    body_nodes = []
    grid = max(int(np.ceil(n_bodies ** (1.0 / 3.0))), 1)
    for i in range(n_bodies):
        gx, gy, gz = i % grid, (i // grid) % grid, i // (grid * grid)
        pos = ((gx - grid / 2) * 0.7 + rng.uniform(-0.05, 0.05),
               0.6 + gy * 0.7,
               (gz - grid / 2) * 0.7 + rng.uniform(-0.05, 0.05))
        node = sb.add_node(f"body{i}", node_type=NodeType.RIGID_BODY,
                           position=pos,
                           bbox=(np.full(3, -0.3), np.full(3, 0.3)))
        bi = pb.add_body(node=node, position=pos)
        if i % 2:
            pb.add_collider(bi, BALL, [0.25], friction=0.5, restitution=0.1)
        else:
            pb.add_collider(bi, CUBOID, [0.22, 0.22, 0.22], friction=0.5)
        body_nodes.append(node)
    return pb, body_nodes


def build_flagship(n_bones=100, n_verts=50_000, n_bodies=64,
                   max_active_pairs=None, seed=0, broadphase_period=1,
                   real_asset=None, with_audio=False):
    """Character + pile + camera. Returns (Engine, SkinTemplate).

    A pile of 192 bodies or more takes the slab broadphase;
    broadphase_period > 1 turns on its temporal reuse (the JAX package's
    FYROX_SLAB_BP_PERIOD), with its wider windows. A smaller pile takes
    the dense broadphase, all P pairs in the compact contact layout, or
    compacted into max_active_pairs slots a step where that is given.

    real_asset: binary FBX bytes or a path. The character then comes
    through the full import path (io/fbx.fbx_to_engine: document → models
    → skin clusters → animation curves) and plays on the plain
    AnimationPlayer (no machine); n_bones, n_verts, max_active_pairs and
    broadphase_period are then unused, as in the JAX package.
    ``models.assets.make_character_fbx()`` writes one.

    with_audio: a 160 Hz hum (a fifth of a second, looping) on the first
    bone and a listener on the camera (scene/sound/mod.rs per-frame sync;
    ``Engine.render_audio`` mixes it beside the ticks); unused with
    real_asset, as in the JAX package."""
    if real_asset is not None:
        return _build_flagship_real(real_asset, n_bodies=n_bodies, seed=seed)
    sb, aset, mt, bones, skin_data = build_character_scene(
        n_bones=n_bones, n_verts=n_verts, seed=seed)
    pb, _ = build_pile_scene(sb, n_bodies=n_bodies, seed=seed + 1)
    if n_bodies >= 192:
        reuse = broadphase_period > 1
        pt = pb.build(broadphase="slab",
                      slab_window=REUSE_WINDOW if reuse else SLAB_WINDOW,
                      slab_active=SLAB_ACTIVE,
                      slab_walk=REUSE_WALK if reuse else SLAB_WALK,
                      broadphase_period=broadphase_period)
    else:
        pt = pb.build(max_active_pairs=max_active_pairs or 0,
                      broadphase="dense")
    return assemble_flagship(sb, pt, aset, mt, bones, skin_data,
                             with_audio=with_audio)


def assemble_flagship(sb, pt, aset, mt, bones, skin_data, with_audio=False):
    """The flagship's tail: a camera (with_audio: the listener on it and
    the hum on the first bone), the scene template, the skin's inverse
    bind poses from the initial hierarchy and the Engine. Returns
    (Engine, SkinTemplate)."""
    verts, idx4, w4 = skin_data
    cam = sb.add_camera("main_camera", position=(0, 3.0, -10.0))
    if with_audio:
        t = np.arange(SAMPLE_RATE // 5) / SAMPLE_RATE
        hum = (0.3 * np.sin(2 * np.pi * 160 * t)).astype(np.float32)
        sb.add_listener("ears", parent=cam)
        sb.add_sound(hum, name="character_hum", parent=bones[0],
                     radius=1.0, max_distance=40.0)
    template = sb.build()
    st = graph_mod.update_hierarchical_data(
        init_state(template, 1, device="cpu"), template)
    bind = st.globals_[0].numpy()
    inv_bind = np.linalg.inv(bind[np.asarray(bones)]).astype(np.float32)
    skin = SkinTemplate(bones=np.asarray(bones, np.int32), inv_bind=inv_bind,
                        vertices=verts, bone_indices=idx4, bone_weights=w4)
    engine = Engine(template=template, physics=pt, animations=aset,
                    machine=mt)
    return engine, skin



def _build_flagship_real(asset, n_bodies=64, seed=0):
    """The flagship with an imported skinned character (build_flagship's
    real_asset): the FBX's scene, skin and clip, the pile, a camera."""
    sb = SceneBuilder()
    _, _, skin, aset = fbx_to_engine(asset, scene_builder=sb)
    if skin is None:
        raise ValueError("real_asset has no skin deformer")
    return assemble_imported(sb, skin, aset, n_bodies=n_bodies, seed=seed)


def assemble_imported(sb, skin, aset, n_bodies=64, seed=0, hum=None):
    """The flagship around an imported character already in `sb` (an FBX's
    or a glTF's scene, its SkinTemplate and AnimationSet, on the plain
    player): build_pile_scene's pile (slab broadphase from 192 bodies,
    dense below), optionally `hum` (mono samples) as a Sound on the skin's
    first bone, a camera (with the hum, a listener on it). Returns
    (Engine, SkinTemplate)."""
    pb, _ = build_pile_scene(sb, n_bodies=n_bodies, seed=seed + 1)
    if hum is not None:
        sb.add_sound(hum, name="character_hum", parent=int(skin.bones[0]),
                     radius=1.0, max_distance=40.0)
    cam = sb.add_camera("main_camera", position=(0, 3.0, -10.0))
    if hum is not None:
        sb.add_listener("ears", parent=cam)
    template = sb.build()
    if n_bodies >= 192:
        pt = pb.build(broadphase="slab", slab_window=SLAB_WINDOW)
    else:
        pt = pb.build(max_active_pairs=0, broadphase="dense")
    return Engine(template=template, physics=pt, animations=aset), skin
