"""Port parity: ray tests (fyrox_tpu_torch.core.ray) and the physics
queries (physics/queries.py: cast_ray, sphere_cast, shape_cast,
compute_contacts) against fyrox_tpu on the CPU.

The same numpy-seeded rays go through both packages over a small world
with every primitive kind, a hull and a heightfield (which casts do not
hit, in either package), at W = 2 posed worlds. Hits, colliders and
bodies equal; times of impact within 1e-5. The rays are 4-8 m long, so
a toi's last bits move a point by a few 1e-6 m, and a ball's or
capsule's normal (the point's offset from the centre, normalized)
divides that by the radius: points and normals are held to 5e-5. A cast
shape's contact point is its support point along the hit normal, which
a cuboid or capsule face makes a tie that the normal's last bits settle:
those are compared by their support height along the normal.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from fyrox_tpu.core import ray as jray
from fyrox_tpu.physics import queries as jq
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.physics.world import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.core import ray as tray
from fyrox_tpu_torch.physics import queries as tq
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics.world import PhysicsBuilder

torch.set_num_threads(2)

TOL = 1e-5
W, R = 2, 48


def _t(x):
    return torch.as_tensor(np.array(x))


def _world(pb, hulls=True):
    """A halfspace, two colliders of each primitive kind at seeded poses,
    and (with `hulls`) cylinders and cones (which carry hulls), a hull
    cloud and a heightfield."""
    rng = np.random.default_rng(5)
    g = pb.add_body(body_type=1)
    pb.add_collider(g, sh.HALFSPACE, [])
    shapes = [(sh.BALL, [0.4]), (sh.CUBOID, [0.3, 0.5, 0.2]),
              (sh.CAPSULE, [0.4, 0.25])]
    if hulls:
        shapes += [(sh.CYLINDER, [0.3, 0.3]), (sh.CONE, [0.35, 0.3])]
    for i, (k, p) in enumerate(shapes * 2):
        q = rng.normal(size=4)
        b = pb.add_body(position=(rng.uniform(-3, 3), rng.uniform(0.5, 2.5),
                                  rng.uniform(-3, 3)),
                        rotation=q / np.linalg.norm(q))
        pb.add_collider(b, k, p)
    if hulls:
        b = pb.add_body(position=(0.0, 1.5, 0.0))
        pb.add_collider(b, sh.CONVEX, points=rng.normal(size=(10, 3)) * 0.3)
        h = pb.add_body(body_type=1, position=(0.0, -0.2, 0.0))
        pb.add_collider(h, sh.HEIGHTFIELD, heights=chip_smoke.hills(9, 8.0),
                        size=(8.0, 8.0))
    return pb


@pytest.fixture(scope="module")
def worlds():
    jpb, tpb = _world(JPhysicsBuilder()), _world(PhysicsBuilder())
    jt, tt = jpb.build(broadphase="dense"), tpb.build(broadphase="dense")
    js = jworld.init_physics_state(jpb, jt, W)
    js = js._replace(position=js.position.at[1].add(0.05))
    ts = convert.physics_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    rng = np.random.default_rng(9)
    origin = np.stack([rng.uniform(-4, 4, (W, R)), rng.uniform(3, 5, (W, R)),
                       rng.uniform(-4, 4, (W, R))], -1).astype(np.float32)
    target = np.stack([rng.uniform(-3, 3, (W, R)), rng.uniform(-0.5, 2, (W, R)),
                       rng.uniform(-3, 3, (W, R))], -1).astype(np.float32)
    return jt, tt, js, ts, origin, (target - origin).astype(np.float32)


def _same_hits(jo, to, fields=("toi", "point", "normal")):
    hit = np.asarray(jo["hit"])
    np.testing.assert_array_equal(to["hit"].numpy(), hit)
    for k in ("collider", "body"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), k)
    for k in fields:
        np.testing.assert_allclose(to[k].numpy()[hit], np.asarray(jo[k])[hit],
                                   rtol=0, atol=TOL if k == "toi" else 5e-5,
                                   err_msg=k)
    assert hit.sum() > 10
    return hit


def test_ray_primitives_match():
    rng = np.random.default_rng(3)
    o = rng.normal(size=(64, 3)).astype(np.float32) * 2
    d = rng.normal(size=(64, 3)).astype(np.float32)
    c = rng.normal(size=(64, 3)).astype(np.float32)
    r = rng.uniform(0.2, 1.5, 64).astype(np.float32)
    v = rng.normal(size=(3, 64, 3)).astype(np.float32)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    cases = [("sphere", (o, d, c, r)), ("aabb", (o, d, c - 1.0, c + 1.0)),
             ("plane", (o, d, n, r)), ("triangle", (o, d, *v))]
    for name, args in cases:
        jo = getattr(jray, name)(*map(jnp.asarray, args))
        to = getattr(tray, name)(*map(_t, args))
        for a, b in zip(jo, to):
            a = np.asarray(a)
            if a.dtype == bool:
                np.testing.assert_array_equal(b.numpy(), a, name)
            else:
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                           atol=TOL, err_msg=name)


def test_cast_ray_matches(worlds):
    jt, tt, js, ts, origin, direction = worlds
    jo = jax.jit(lambda s, o, d: jq.cast_ray(s, jt, o, d, max_toi=1.5))(
        js, origin, direction)
    hit = _same_hits(jo, tq.cast_ray(ts, tt, _t(origin), _t(direction),
                                     max_toi=1.5))
    assert (~hit).sum() > 0


def test_sphere_cast_matches(worlds):
    """The JAX sphere_cast reads its radius on the host (a static
    inflation of the template), so it runs eagerly."""
    jt, tt, js, ts, origin, direction = worlds
    jo = jq.sphere_cast(js, jt, origin, direction, 0.2, max_toi=1.5)
    hit = _same_hits(jo, tq.sphere_cast(ts, tt, _t(origin), _t(direction),
                                        0.2, max_toi=1.5))
    assert (~hit).sum() > 0


@pytest.mark.parametrize("kind,params", [
    (sh.BALL, [0.2]), (sh.CUBOID, [0.2, 0.1, 0.3]), (sh.CAPSULE, [0.2, 0.1]),
    (sh.CYLINDER, [0.2, 0.15]), (sh.CONE, [0.25, 0.2])],
    ids=["ball", "cuboid", "capsule", "cylinder", "cone"])
def test_shape_cast_matches(worlds, kind, params):
    jt, tt, js, ts, origin, direction = worlds
    q = np.random.default_rng(kind).normal(size=(W, R, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    jo = jax.jit(lambda s, o, r_, d: jq.shape_cast(s, jt, kind, params, o,
                                                   r_, d, max_toi=0.6))(
        js, origin, q, direction)
    to = tq.shape_cast(ts, tt, kind, params, _t(origin), _t(q),
                       _t(direction), max_toi=0.6)
    _same_hits(jo, to, ("toi", "normal"))

    def support(o):
        off = (np.asarray(o["point"]) - origin
               - direction * np.asarray(o["toi"])[..., None])
        return np.sum(off * np.asarray(o["normal"]), -1)

    hit = np.asarray(jo["hit"])
    np.testing.assert_allclose(support(convert.to_numpy(to))[hit],
                               support(jo)[hit], rtol=0, atol=TOL)


def test_compute_contacts_matches():
    """The JAX package's compute_contacts carries no hull or scenery
    tables, so the comparison world holds the primitives only."""
    jpb = _world(JPhysicsBuilder(), hulls=False)
    tpb = _world(PhysicsBuilder(), hulls=False)
    jt, tt = jpb.build(broadphase="dense"), tpb.build(broadphase="dense")
    js = jworld.init_physics_state(jpb, jt, W)
    js = js._replace(position=js.position.at[:, 1:, 1].set(0.3))
    ts = convert.physics_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    jo = jax.jit(lambda s: jq.compute_contacts(s, jt, pred=0.01))(js)
    to = tq.compute_contacts(ts, tt, pred=0.01)
    np.testing.assert_array_equal(to["active"].numpy(),
                                  np.asarray(jo["active"]))
    act = np.asarray(jo["active"])
    assert act.sum() > 0
    for k in ("normal", "point", "depth"):
        np.testing.assert_allclose(to[k].numpy()[act], np.asarray(jo[k])[act],
                                   rtol=0, atol=TOL, err_msg=k)
    for k in ("body_a", "body_b"):
        np.testing.assert_array_equal(to[k], jo[k])
