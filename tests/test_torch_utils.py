"""Port parity: fyrox_tpu_torch.utils and core.mathutil against
fyrox_tpu's on the CPU.

Mirrors tests/test_aux.py (A*, distance fields, navmeshes, behavior trees,
the lightmap bake) and tests/test_navmesh_rectangle_nodes.py (navmesh
nodes, template_navmesh, batched agents): the same inputs, from numpy
seeds, through both packages. Host code (A*, the grid graph, the navmesh
and its funnel) must give equal results; device code is held within the
tolerance stated at each test. The NavigationalMesh payload survives
convert.scene_template.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.core import mathutil as jmu
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.utils import astar as jastar
from fyrox_tpu.utils import behavior as jbehavior
from fyrox_tpu.utils import lightmap as jlightmap
from fyrox_tpu.utils import navagent as jnavagent
from fyrox_tpu.utils import navmesh as jnavmesh
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.core import mathutil as tmu
from fyrox_tpu_torch.scene import SceneBuilder
from fyrox_tpu_torch.scene.template import NodeType
from fyrox_tpu_torch.utils import (BatchedNavAgents, BehaviorTreeBuilder,
                                   Navmesh, NavmeshAgent, Status,
                                   astar_search, build_grid_graph,
                                   distance_field, pack_adjacency,
                                   template_navmesh)
from fyrox_tpu_torch.utils import lightmap

torch.set_num_threads(2)


# ---- A* and distance fields ----------------------------------------------

def _walled(n=12):
    """A grid with a wall at x = n/2, open only at the top row, and a
    second wall at x = n/4 open only at the bottom: a serpentine."""
    blocked = [y * n + n // 2 for y in range(n - 1)]
    blocked += [y * n + n // 4 for y in range(1, n)]
    return build_grid_graph(n, n, blocked), jastar.build_grid_graph(
        n, n, blocked)


def test_grid_graphs_and_astar_paths_equal_jax():
    ((v, nb), (jv, jnb)) = _walled()
    np.testing.assert_array_equal(v, jv)
    assert nb == jnb
    for s, g in ((0, 11), (0, 143), (13, 130), (5, 5), (0, 6)):
        assert astar_search(v, nb, s, g) == jastar.astar(jv, jnb, s, g)
    blocked = [y * 10 + 5 for y in range(10)]
    v2, nb2 = build_grid_graph(10, 10, blocked)
    assert astar_search(v2, nb2, 0, 9) == [] == jastar.astar(
        *jastar.build_grid_graph(10, 10, blocked), 0, 9)


def test_distance_field_on_a_walled_grid_equals_jax_and_astar():
    ((v, nb), (jv, jnb)) = _walled()
    idx, w = pack_adjacency(v, nb, device="cpu")
    jidx, jw = jastar.pack_adjacency(jv, jnb)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    src = np.asarray([0, 143, 77], np.int32)
    iters = 160                  # past the serpentine's longest path
    got = distance_field(idx, w, torch.as_tensor(src), num_iters=iters)
    want = np.asarray(jastar.distance_field(jidx, jw, jnp.asarray(src),
                                            num_iters=iters))
    np.testing.assert_array_equal(got.numpy(), want)
    for k, s in enumerate(src):
        for g in (11, 130, 64, 66):          # 66 lies in a wall
            path = astar_search(v, nb, int(s), g)
            assert got[k, g] == (pytest.approx(len(path) - 1) if path
                                 else float("inf"))
    # mask sources and the default round count
    mask = np.zeros((2, len(v)), bool)
    mask[0, [0, 5]] = True
    mask[1, 100] = True
    np.testing.assert_array_equal(
        distance_field(idx, w, torch.as_tensor(mask)).numpy(),
        np.asarray(jastar.distance_field(jidx, jw, jnp.asarray(mask))))


# ---- navmeshes ------------------------------------------------------------

def _two_rooms():
    """tests/test_aux.py's two rooms joined by a corridor (xz plane)."""
    quads = [(0, 0, 4, 4), (4, 1.5, 6, 2.5), (6, 0, 10, 4)]
    verts, tris = [], []
    for (x0, z0, x1, z1) in quads:
        base = len(verts)
        verts += [(x0, 0, z0), (x1, 0, z0), (x1, 0, z1), (x0, 0, z1)]
        tris += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def _lshape():
    """tests/test_navmesh_rectangle_nodes.py's L of two corridors."""
    v = np.asarray([[0, 0, 0], [3, 0, 0], [4, 0, 0], [0, 0, 1], [3, 0, 1],
                    [4, 0, 1], [3, 0, 4], [4, 0, 4]], np.float32)
    t = np.asarray([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4], [4, 5, 7],
                    [4, 7, 6]], np.int32)
    return v, t


def test_navmesh_paths_and_agent_equal_jax():
    v, t = _two_rooms()
    nm, jnm = Navmesh(v, t), jnavmesh.Navmesh(v, t)
    rng = np.random.default_rng(4)
    for _ in range(8):
        s = np.asarray([rng.uniform(0, 4), 0, rng.uniform(0, 4)], np.float32)
        g = np.asarray([rng.uniform(6, 10), 0, rng.uniform(0, 4)],
                       np.float32)
        np.testing.assert_array_equal(nm.build_path(s, g),
                                      jnm.build_path(s, g))
    a = NavmeshAgent(position=np.asarray([1.0, 0, 2.0], np.float32),
                     speed=2.0)
    ja = jnavmesh.NavmeshAgent(position=np.asarray([1.0, 0, 2.0],
                                                   np.float32), speed=2.0)
    assert a.calculate_path(nm, (3.5, 0, 2.0))
    assert ja.calculate_path(jnm, (3.5, 0, 2.0))
    for _ in range(400):
        a.update(1 / 60)
        ja.update(1 / 60)
    np.testing.assert_array_equal(a.position, ja.position)
    np.testing.assert_allclose(a.position, [3.5, 0, 2.0], atol=1e-3)


def test_navmesh_node_converts_with_its_geometry():
    v, t = _lshape()
    jsb, sb = JSceneBuilder(), SceneBuilder()
    for b in (jsb, sb):
        b.add_pivot("root")
        b.add_navmesh(v, t, name="floor", position=(10.0, 0.5, -1.0),
                      rotation=(0.0, np.sin(0.3), 0.0, np.cos(0.3)),
                      scale=(2, 1, 1))
    jt, tt = jsb.build(), sb.build()
    ct = convert.scene_template(jt)
    for got in (ct, tt):
        assert got.node_type[1] == NodeType.NAVMESH and got.payload[1] == 0
        np.testing.assert_array_equal(got.navmeshes["node"],
                                      jt.navmeshes["node"])
        np.testing.assert_array_equal(got.navmeshes["data"],
                                      jt.navmeshes["data"])
        assert len(got.navmesh_data) == 1
        np.testing.assert_array_equal(got.navmesh_data[0][0], v)
        np.testing.assert_array_equal(got.navmesh_data[0][1], t)
    nm, jnm = template_navmesh(ct), jnavagent.template_navmesh(jt)
    np.testing.assert_allclose(nm.vertices, jnm.vertices, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(nm.triangles, jnm.triangles)
    assert abs(float(nm.vertices[:, 1].min()) - 0.5) < 1e-6
    with pytest.raises(IndexError):
        template_navmesh(ct, 1)
    # instantiate carries the payload over, its data index shifted
    host = SceneBuilder()
    host.add_navmesh(v, t, name="first")
    host.instantiate(sb, name_prefix="b_")
    ht = host.build()
    assert list(ht.navmeshes["data"]) == [0, 1]
    assert ht.names[ht.navmeshes["node"][1]] == "b_floor"


def test_batched_agents_steer_as_jax_and_reach_their_goals():
    v, t = _lshape()
    sb, jsb = SceneBuilder(), JSceneBuilder()
    sb.add_navmesh(v, t)
    jsb.add_navmesh(v, t)
    nm = template_navmesh(sb.build())
    jnm = jnavagent.template_navmesh(jsb.build())
    starts = np.asarray([[0.3, 0.0, 0.5], [0.5, 0.0, 0.5]], np.float32)
    goals = np.asarray([[3.5, 0.0, 3.6], [3.6, 0.0, 3.0]], np.float32)
    agents, jagents = BatchedNavAgents(0.05), jnavagent.BatchedNavAgents(0.05)
    st = agents.plan(nm, starts, goals, device="cpu")
    jst = jagents.plan(jnm, starts, goals)
    np.testing.assert_array_equal(st.waypoints.numpy(),
                                  np.asarray(jst.waypoints))
    np.testing.assert_array_equal(st.length.numpy(), np.asarray(jst.length))
    pos, jpos = torch.as_tensor(starts), jnp.asarray(starts)
    speed = np.asarray([2.0, 1.5], np.float32)
    for i in range(400):
        vel, st = agents.steer(st, pos, torch.as_tensor(speed), 1 / 30)
        jvel, jst = jagents.steer(jst, jpos, jnp.asarray(speed), 1 / 30)
        # each tick from JAX's own positions: the cursors stay equal
        np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), atol=1e-6)
        np.testing.assert_array_equal(st.wp.numpy(), np.asarray(jst.wp))
        jpos = jpos + jvel * (1 / 30)
        pos = torch.as_tensor(np.asarray(jpos))
    err = np.linalg.norm(pos.numpy() - goals, axis=-1)
    assert (err < 0.15).all(), err


# ---- behavior trees -------------------------------------------------------

def _tree(b):
    """selector(sequence(leaf, inverter(leaf)), selector(leaf, leaf),
    leaf): every composite kind, 5 leaves."""
    root = b.selector()
    seq = b.sequence(parent=root)
    b.leaf(seq)
    inv = b.inverter(parent=seq)
    b.leaf(inv)
    sel = b.selector(parent=root)
    b.leaf(sel)
    b.leaf(sel)
    b.leaf(root)
    return b.build(root)


def test_behavior_tick_over_every_leaf_status_equals_jax():
    tree, jtree = _tree(BehaviorTreeBuilder()), _tree(
        jbehavior.BehaviorTreeBuilder())
    assert tree.num_leaves == jtree.num_leaves == 5
    statuses = np.stack(np.meshgrid(*[np.arange(3)] * 5, indexing="ij"),
                        -1).reshape(-1, 5).astype(np.int32)   # all 3^5
    got = tree.tick(torch.as_tensor(statuses))
    want = np.asarray(jtree.tick(jnp.asarray(statuses)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(got.tolist()) == {Status.SUCCESS, Status.FAILURE,
                                 Status.RUNNING}


# ---- lightmap -------------------------------------------------------------

def _room(seed=0, n_pts=24):
    """A roof quad, a wall and a tilted panel over seeded sample points."""
    rng = np.random.default_rng(seed)
    tris = np.asarray([
        [[-2, 1.0, -2], [2, 1.0, -2], [2, 1.0, 2]],
        [[-2, 1.0, -2], [2, 1.0, 2], [-2, 1.0, 2]],
        [[1.2, -1, -2], [1.3, 2, -2], [1.25, -1, 2]],
        [[-1.5, 0.3, 0.2], [-0.4, 0.6, 0.9], [-1.1, 0.4, -0.7]]], np.float32)
    pts = np.concatenate([rng.uniform(-2.5, 2.5, (n_pts, 3)) * [1, 0.1, 1],
                          [[10, 0, 0]]]).astype(np.float32)
    nrm = rng.normal(size=(n_pts + 1, 3)) * 0.3 + [0, 1, 0]
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    return tris, pts, nrm


def test_lightmap_bake_equals_jax_run_op_by_op():
    """Held to JAX run op by op (jax.disable_jit()): compiled, XLA may
    contract Möller-Trumbore's products into FMAs and flip a grazing ray.
    Every ray agrees here, so AO is equal and direct light within 1e-6."""
    tris, pts, nrm = _room()
    with jax.disable_jit():
        jao = jlightmap.bake_vertex_ao(pts, nrm, tris, n_rays=16,
                                       max_dist=5.0, chunk=32)
        jsun = jlightmap.bake_direct_light(pts, nrm, tris,
                                           light_dir=(0.3, -1, 0.2),
                                           chunk=32)
        jpt = jlightmap.bake_direct_light(pts, nrm, tris,
                                          light_pos=(0.2, 0.5, 0.1),
                                          intensity=2.0, chunk=32)
    ao = lightmap.bake_vertex_ao(pts, nrm, tris, n_rays=16, max_dist=5.0,
                                 device="cpu")
    np.testing.assert_array_equal(ao.numpy(), jao)
    assert ao[-1] == 1.0 and ao.min() < 0.6
    sun = lightmap.bake_direct_light(pts, nrm, tris, light_dir=(0.3, -1, 0.2),
                                     device="cpu")
    pt = lightmap.bake_direct_light(pts, nrm, tris, light_pos=(0.2, 0.5, 0.1),
                                    intensity=2.0, device="cpu")
    np.testing.assert_allclose(sun.numpy(), jsun, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), jpt, rtol=1e-6, atol=1e-6)
    assert (sun.numpy() == 0).any() and (sun.numpy() > 0.5).any()


def test_lightmap_batches_rays_within_the_budget(monkeypatch):
    """A budget of a few rows a batch gives the same bake."""
    tris, pts, nrm = _room(1, 8)
    whole = lightmap.bake_vertex_ao(pts, nrm, tris, n_rays=8, device="cpu")
    monkeypatch.setattr(lightmap, "RAY_TRI_BUDGET", 3 * len(tris))
    assert torch.equal(whole, lightmap.bake_vertex_ao(pts, nrm, tris,
                                                      n_rays=8, device="cpu"))


# ---- mathutil ---------------------------------------------------------------

def test_mathutil_matches_jax():
    rng = np.random.default_rng(7)
    p, a, b, c = (rng.normal(size=(6, 3)).astype(np.float32)
                  for _ in range(4))
    for got, want in zip(tmu.get_barycentric_coords(torch.as_tensor(p), a,
                                                    b, c),
                         jmu.get_barycentric_coords(p, a, b, c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    for got, want in zip(tmu.get_barycentric_coords_2d(p[:, :2], a[:, :2],
                                                       b[:, :2], c[:, :2]),
                         jmu.get_barycentric_coords_2d(p[:, :2], a[:, :2],
                                                       b[:, :2], c[:, :2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tmu.triangle_area(a, b, c).numpy(),
                               np.asarray(jmu.triangle_area(a, b, c)),
                               rtol=1e-6)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tmu.get_farthest_point(pts, p).numpy(),
        np.asarray(jmu.get_farthest_point(pts, p)))
    poly = np.asarray([[0, 0, 0], [1, 0.1, 0], [1, 0.2, 1], [0, 0.1, 1]],
                      np.float32)
    np.testing.assert_allclose(tmu.get_polygon_normal(poly).numpy(),
                               jmu.get_polygon_normal(poly), atol=1e-6)
    for n in p:
        cls = tmu.classify_plane(torch.as_tensor(n))
        assert cls == jmu.classify_plane(n)
        for g, w in zip(tmu.vec3_to_vec2_by_plane(cls, torch.as_tensor(n),
                                                  torch.as_tensor(pts)),
                        jmu.vec3_to_vec2_by_plane(cls, n, pts)):
            np.testing.assert_array_equal(g.numpy(), w)
    for x in (-7.5, 0.3, 13.0):
        assert tmu.wrap_angle(x) == jmu.wrap_angle(x)
        assert tmu.ieee_remainder(x, 2.5) == jmu.ieee_remainder(x, 2.5)
        assert tmu.round_to_step(x, 0.7) == jmu.round_to_step(x, 0.7)
        assert tmu.cubicf(1.0, 2.0, x / 20, 0.5, -0.5) == jmu.cubicf(
            1.0, 2.0, x / 20, 0.5, -0.5)
        assert tmu.spherical_to_cartesian(x, 0.4, 2.0) == \
            jmu.spherical_to_cartesian(x, 0.4, 2.0)
    r, jr = tmu.Rect(1, 2, 3, 4), jmu.Rect(1, 2, 3, 4)
    assert tmu.ray_rect_intersection(r, (0, 0), (1, 1.2)) == \
        jmu.ray_rect_intersection(jr, (0, 0), (1, 1.2))
    assert r.clip_by(tmu.Rect(2, 3, 9, 9)).size == \
        jr.clip_by(jmu.Rect(2, 3, 9, 9)).size


# ---- stats ------------------------------------------------------------------

def test_performance_statistics_scope_and_trace(tmp_path):
    from fyrox_tpu.utils.stats import PerformanceStatistics as JStats
    from fyrox_tpu_torch.utils.stats import (PerformanceStatistics, scope,
                                             trace_to)
    stats, jstats = PerformanceStatistics(), JStats()
    x = torch.ones(64)
    for s in (stats, jstats):
        for _ in range(3):
            with s.measure("tick", block_on=(x, (x,))):
                x = x * 1.5
        with s.measure("frame"):
            pass
        assert s.counts == {"tick": 3, "frame": 1}
        assert s.mean_ms("tick") > 0 and s.mean_ms("none") == 0.0
        assert [ln.split(":")[0] for ln in s.report().splitlines()] == [
            "frame", "tick"]
        s.reset()
        assert not s.totals
    with trace_to(str(tmp_path)) as prof:
        with scope("physics"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "physics" in names
    assert (tmp_path / "trace.json").stat().st_size > 0
