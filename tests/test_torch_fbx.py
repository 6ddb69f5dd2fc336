"""Port parity: FBX import and the real-asset flagship of fyrox_tpu_torch
against fyrox_tpu (fyrox_tpu/io/fbx.py, fyrox_tpu/models/assets.py,
fyrox_tpu/models/character.py:190-205): the same bytes give the same
templates, skin and clip, and the flagship built from them steps the same
on the plain AnimationPlayer path, on the dense broadphase (24 bodies) and
on the slab broadphase's staged route (192 bodies), against the JAX engine
jitted."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.animation import skinning as jskinning
from fyrox_tpu.io import fbx as jfbx
from fyrox_tpu.models import build_flagship as jax_build_flagship
from fyrox_tpu.models.assets import make_character_fbx as jax_make_fbx
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.animation import skinning as tskinning
from fyrox_tpu_torch.engine import _leaves
from fyrox_tpu_torch.io import fbx as tfbx
from fyrox_tpu_torch.models import build_flagship as torch_build_flagship
from fyrox_tpu_torch.models import make_character_fbx as torch_make_fbx

torch.set_num_threads(2)

W, DENSE_TICKS, SLAB_TICKS = 2, 15, 5
ASSET = dict(n_bones=8, n_verts=320)      # tests/test_real_asset.py:13


@pytest.fixture(scope="module")
def asset():
    return jax_make_fbx(**ASSET)


@pytest.mark.parametrize("kw", [ASSET, dict(n_bones=16, n_verts=2000),
                                dict(n_bones=5, n_verts=100, seed=3,
                                     seg_len=0.2, radius=0.05)])
def test_make_character_fbx_writes_the_same_bytes(kw):
    assert torch_make_fbx(**kw) == jax_make_fbx(**kw)


@pytest.fixture(scope="module")
def imported(asset):
    return jfbx.fbx_to_engine(asset), tfbx.fbx_to_engine(asset)


SCENE_FIELDS = ["parent", "node_type", "payload", "init_position",
                "init_rotation", "init_scale", "local_bbox_min",
                "local_bbox_max"]


@pytest.mark.parametrize("field", SCENE_FIELDS)
def test_imported_scene_template_equal(imported, field):
    (jsb, jnames, _, _), (tsb, tnames, _, _) = imported
    assert jnames == tnames
    jt, tt = jsb.build(), tsb.build()
    assert jt.names == tt.names
    np.testing.assert_array_equal(getattr(jt, field), getattr(tt, field))


def test_imported_mesh_data_equal(imported):
    (jsb, *_), (tsb, *_) = imported
    jm, tm = jsb.build().meshes, tsb.build().meshes
    assert len(jm) == len(tm) == 1
    for f in ("positions", "normals", "uvs", "triangles"):
        np.testing.assert_array_equal(getattr(jm[0], f), getattr(tm[0], f))


@pytest.mark.parametrize("field", ["bones", "inv_bind", "vertices",
                                   "bone_indices", "bone_weights"])
def test_imported_skin_equal(imported, field):
    (_, _, jskin, _), (_, _, tskin, _) = imported
    np.testing.assert_array_equal(np.asarray(getattr(jskin, field)),
                                  getattr(tskin, field))


def test_imported_animation_set_equal(imported):
    (*_, jaset), (*_, taset) = imported
    want = convert.animation_set(jaset)
    assert taset.names == want.names
    for f in ("length", "speed", "looping", "rot_node", "rot_anim",
              "pos_node", "pos_anim"):
        np.testing.assert_array_equal(getattr(taset, f), getattr(want, f))
    assert taset.pos_curves is None and want.pos_curves is None
    for a, b in zip(taset.rot_curves, want.rot_curves):
        np.testing.assert_array_equal(a, b)


def test_parsed_document_equal(asset):
    """The document trees are the same, node by node and property by
    property."""
    def flat(n, depth=0):
        out = [(depth, n.name, len(n.properties))]
        for p in n.properties:
            out.append(np.asarray(p).tolist() if isinstance(p, np.ndarray)
                       else p)
        for c in n.children:
            out.extend(flat(c, depth + 1))
        return out

    assert flat(jfbx.parse_fbx(asset)) == flat(tfbx.parse_fbx(asset))


def test_writer_round_trips_through_the_reader():
    tree = [("Objects", [], [("Model", [7, "Model::a", "Null"], [
        ("Vals", [np.arange(5, dtype=np.float64), 3, 2.5, "s", True], [])])])]
    data = tfbx.write_fbx(tree)
    assert data == jfbx.write_fbx(tree)
    doc = tfbx.parse_fbx(data)
    vals = doc.child("Objects").child("Model").child("Vals").properties
    np.testing.assert_array_equal(vals[0], np.arange(5.0))
    assert vals[1:] == [3, 2.5, "s", 1]


ASCII_DOC = """
; ASCII FBX: a triangle mesh under a turned pivot
Objects:  {
    Geometry: 300, "Geometry::tri", "Mesh" {
        Vertices: *12 {
            a: 0,0,0, 1,0,0, 0,1,0, 1,1,0.5
        }
        PolygonVertexIndex: *4 {
            a: 0,1,3,-3
        }
    }
    Model: 400, "Model::tri", "Mesh" {
        Properties70:  {
            P: "Lcl Translation", "", "", "", 7.0, 0.0, 0.0
            P: "Lcl Rotation", "", "", "", 30.0, -45.0, 60.0
        }
    }
    Model: 500, "Model::pivot", "Null" {
        Properties70:  {
            P: "Lcl Rotation", "", "", "", 0.0, 90.0, 12.5
            P: "Lcl Scaling", "", "", "", 2.0, 2.0, 2.0
        }
    }
}
Connections:  {
    C: "OO", 300, 400
    C: "OO", 400, 500
}
"""


def test_ascii_document_with_rotations_imports_alike():
    """An ASCII document (the reader's other format) with turned models:
    degrees → radians → the float32 quaternion, as the JAX package's
    from_euler computes it."""
    (jsb, jnames), (tsb, tnames) = (
        m.fbx_to_scene(m.parse_fbx(ASCII_DOC.encode())) for m in (jfbx, tfbx))
    assert jnames == tnames
    jt, tt = jsb.build(), tsb.build()
    for f in ("parent", "init_position", "init_scale"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f))
    np.testing.assert_allclose(jt.init_rotation, tt.init_rotation, rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(jt.meshes[0].triangles,
                                  tt.meshes[0].triangles)


def _diff(js, ts):
    """Per state tensor, the largest |JAX - port| (NaN-free: an inf
    lifetime against an inf is 0)."""
    a = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    b = [x.numpy() for x in _leaves(ts)]
    assert len(a) == len(b)
    out = []
    for x, y in zip(a, b):
        assert x.shape == y.shape
        same = (x == y) | (np.isnan(x) & np.isnan(y)) if x.size else x == y
        with np.errstate(invalid="ignore"):
            d = np.where(same, 0.0, np.abs(x.astype(np.float64)
                                           - y.astype(np.float64)))
        out.append(float(d.max()) if d.size else 0.0)
    return out


@pytest.fixture(scope="module")
def dense_run(asset):
    """15 ticks (0.25 s of the clip) of the 24-body real-asset flagship,
    both packages, from the same initial state, with skinning before and
    after."""
    je, jskin = jax_build_flagship(n_bodies=24, real_asset=asset)
    te, tskin = torch_build_flagship(n_bodies=24, real_asset=asset)
    js = je.init_state(num_worlds=W)
    ts = te.init_state(W, device="cpu")
    init = _diff(js, ts)
    v0 = tskinning.skin_positions_dense(
        tskinning.bone_matrices(ts.scene.globals_, tskin), tskin)
    step = jax.jit(je.step)
    ticks = []
    for _ in range(DENSE_TICKS):
        js, ts = step(js), te.step(ts)
        ticks.append(_diff(js, ts))
    jverts = jskinning.skin_positions_dense(
        jskinning.bone_matrices(js.scene.globals_, jskin), jskin)
    tverts = tskinning.skin_positions_dense(
        tskinning.bone_matrices(ts.scene.globals_, tskin), tskin)
    return dict(init=init, ticks=ticks, js=js, ts=ts, te=te, tskin=tskin,
                jverts=np.asarray(jverts), tverts=tverts.numpy(),
                v0=v0.numpy())


def test_real_asset_flagship_takes_the_plain_player(dense_run):
    te = dense_run["te"]
    assert te.machine is None and te.animations.num_animations == 1
    assert dense_run["ts"].animation.machine is None
    assert te.physics.grid is None                   # dense broadphase


def test_real_asset_initial_state_equal(dense_run):
    assert max(dense_run["init"]) <= 1e-6


@pytest.mark.parametrize("field,tol", [
    ("position", 1e-5), ("rotation", 1e-5), ("scale", 1e-5),
    ("globals_", 1e-5)])
def test_real_asset_local_poses_and_globals_match(dense_run, field, tol):
    js, ts = dense_run["js"], dense_run["ts"]
    np.testing.assert_allclose(np.asarray(getattr(js.scene, field)),
                               getattr(ts.scene, field).numpy(), rtol=0,
                               atol=tol)


def test_real_asset_every_tick_matches(dense_run):
    """Every state tensor (poses, globals, clip times, bodies, contacts)
    within 1e-5 of the JAX engine's at each of the 15 ticks."""
    worst = max(max(t) for t in dense_run["ticks"])
    assert worst <= 1e-5, worst


def test_real_asset_skinned_vertices_match(dense_run):
    np.testing.assert_allclose(dense_run["jverts"], dense_run["tverts"],
                               rtol=0, atol=1e-4)


def test_real_asset_bind_pose_and_motion(dense_run):
    """tests/test_real_asset.py's checks in the port: at t = 0 the skin
    reproduces the bind-pose mesh (global @ inv_bind = identity at bind),
    and 15 ticks of the imported curves move the mesh."""
    skin = dense_run["tskin"]
    assert np.abs(dense_run["v0"][0] - skin.vertices).max() < 1e-3
    moved = np.linalg.norm(dense_run["tverts"] - dense_run["v0"],
                           axis=-1).max()
    assert np.isfinite(dense_run["tverts"]).all() and moved > 0.01, moved
    ib = skin.inv_bind
    assert not np.allclose(ib[3], np.eye(4))
    assert abs(ib[3][0, 3] + 3 * 0.15) < 1e-5


@pytest.fixture(scope="module")
def slab_run(asset):
    """SLAB_TICKS ticks of the 192-body real-asset flagship on the slab
    broadphase: JAX jitted (its staged XLA path off the TPU) against the
    port's staged route, every body falling at 3 m/s (world 1 at 4.5) so
    that the pile meets the ground within the run."""
    je, _ = jax_build_flagship(n_bodies=192, real_asset=asset)
    te, _ = torch_build_flagship(n_bodies=192, real_asset=asset)
    js = je.init_state(num_worlds=W)
    dyn = (np.asarray(je.physics.body_type) == 0)[None, :, None]
    v = np.where(dyn, np.float32([0.0, -3.0, 0.0]), np.float32(0.0))
    v = v * (1.5 ** np.arange(W, dtype=np.float32))[:, None, None]
    js = js._replace(physics=js.physics._replace(linvel=jnp.asarray(
        np.broadcast_to(v, js.physics.linvel.shape).astype(np.float32))))
    ts = convert.engine_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    step = jax.jit(je.step)
    ticks = []
    for _ in range(SLAB_TICKS):
        js, ts = step(js), te.step(ts, fused=False)
        ticks.append(_diff(js, ts))
    return te, js, ts, ticks


def test_real_asset_slab_staged_ticks_match(slab_run):
    te, js, ts, ticks = slab_run
    assert te.physics.grid is not None
    assert int((ts.physics.warm_pair >= 0).sum()) > 0   # contacts live
    np.testing.assert_array_equal(np.asarray(js.physics.warm_pair),
                                  ts.physics.warm_pair.numpy())
    worst = max(max(t) for t in ticks)
    assert worst <= 1e-5, worst
