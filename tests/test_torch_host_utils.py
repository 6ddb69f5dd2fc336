"""Port parity: the host utilities (``core.spatial``, ``utils.uvgen``,
``core.triangulator``, ``core.sstorage``, ``core.net``) against the JAX
package's on the CPU.

These are numpy and socket code that both packages hold alike, so the
results are held equal bit for bit on seeded inputs: tree queries,
packed rectangles, generated UVs and charts, triangle indices, and the
storage's handles and contents. The two packages' NetStreams talk to
each other over loopback in both directions, in JSON and in raw mode:
the wire format is one.
"""
import time

import numpy as np
import pytest

from fyrox_tpu.core import sstorage as jsst
from fyrox_tpu.core import triangulator as jtri
from fyrox_tpu.core.net import NetListener as JListener
from fyrox_tpu.core.net import NetStream as JStream
from fyrox_tpu.core.spatial import Octree as JOctree
from fyrox_tpu.core.spatial import QuadTree as JQuadTree
from fyrox_tpu.core.spatial import RectPacker as JRectPacker
from fyrox_tpu.utils.uvgen import generate_uvs as jgenerate_uvs
from fyrox_tpu_torch.core import sstorage, triangulator
from fyrox_tpu_torch.core.net import NetListener, NetStream
from fyrox_tpu_torch.core.spatial import Octree, QuadTree, RectPacker
from fyrox_tpu_torch.utils.uvgen import generate_uvs


def _boxes(rng, n, dim):
    lo = rng.uniform(-10, 10, (n, dim))
    return lo, lo + rng.uniform(0.05, 2.0, (n, dim))


def _tree_queries(tree, rng, dim):
    out = []
    for _ in range(24):
        q = rng.uniform(-10, 10, dim)
        h = rng.uniform(0.1, 4.0, dim)
        out.append(tree.aabb_query(q - h, q + h))
        out.append(tree.sphere_query(q, float(rng.uniform(0.1, 3.0))))
        d = rng.standard_normal(dim)
        if rng.random() < 0.2:
            d[0] = 0.0                             # an axis-parallel ray
        out.append(tree.ray_query(q, d, max_t=float(rng.uniform(1, 30))))
    out.append(tree.ray_query(np.full(dim, -20.0), np.ones(dim)))
    return out


@pytest.mark.parametrize("dim", [2, 3])
def test_trees_answer_as_jax(dim):
    mins, maxs = _boxes(np.random.default_rng(dim), 300, dim)
    cls, jcls = (QuadTree, JQuadTree) if dim == 2 else (Octree, JOctree)
    t, jt = cls(mins, maxs, max_items=6), jcls(mins, maxs, max_items=6)
    got = _tree_queries(t, np.random.default_rng(10 + dim), dim)
    want = _tree_queries(jt, np.random.default_rng(10 + dim), dim)
    assert got == want
    assert sum(len(r) for r in got) > 100 and t.root["children"]


def test_rect_packer_places_as_jax():
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 64, (200, 2))
    p, jp = RectPacker(256, 256), JRectPacker(256, 256)
    got = [p.pack(int(w), int(h)) for w, h in sizes]
    assert got == [jp.pack(int(w), int(h)) for w, h in sizes]
    assert None in got and got.count(None) < len(got)
    assert p._free == jp._free


def test_generate_uvs_equals_jax():
    rng = np.random.default_rng(6)
    pos = rng.uniform(-1, 1, (60, 3))
    tris = rng.integers(0, 60, (80, 3))
    uvs, charts = generate_uvs(pos, tris, atlas_size=512)
    juvs, jcharts = jgenerate_uvs(pos, tris, atlas_size=512)
    np.testing.assert_array_equal(uvs, juvs)
    np.testing.assert_array_equal(charts, jcharts)
    assert uvs.dtype == juvs.dtype and len(np.unique(charts)) == 6
    with pytest.raises(Exception) as err:
        generate_uvs(pos, tris, atlas_size=8, margin_texels=4)
    with pytest.raises(type(err.value)):
        jgenerate_uvs(pos, tris, atlas_size=8, margin_texels=4)


def _polygons(rng):
    """Convex and star-shaped (concave) polygons in tilted planes, 3 to 14
    corners, and a concave quad."""
    out = []
    for n in range(3, 15):
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(0.4, 1.0, n) if n % 2 else np.ones(n)
        flat = np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros(n)], 1)
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        out.append(flat @ q.T + rng.uniform(-3, 3, 3))
    out.append(np.array([[0, 0, 0], [2, 0, 0], [0.5, 0.5, 0], [0, 2, 0]],
                        float))
    return out


def test_triangulate_equals_jax():
    for poly in _polygons(np.random.default_rng(8)):
        got, want = triangulator.triangulate(poly), jtri.triangulate(poly)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and len(got) == len(poly) - 2
        np.testing.assert_array_equal(triangulator.polygon_normal(poly),
                                      jtri.polygon_normal(poly))
    assert triangulator.triangulate(np.zeros((2, 3))).shape == (0, 3)


def _storage_session(mod, rng):
    """A seeded run of spawns, frees and lookups; everything observable."""
    buf = mod.SparseBuffer()
    handles, seen = [], []
    for step in range(200):
        if handles and rng.random() < 0.4:
            h = handles.pop(int(rng.integers(len(handles))))
            seen.append(("free", buf.free(h), h.get(), h.assigned))
        else:
            h = buf.spawn(f"item{step}")
            handles.append(h)
            seen.append(("spawn", h.get()))
        seen.append((len(buf), buf.filled))
    seen.append(sorted(buf))
    seen.append([buf.get(h) for h in handles])
    seen.append([buf.is_index_valid(h) for h in handles])
    seen.append((buf.free_raw(-1), buf.free_raw(10_000), buf.get(10_000)))
    buf.clear()
    seen.append((len(buf), buf.filled, list(buf)))
    s = mod.ImmutableString("name")
    seen.append((s == "name", s is mod.ImmutableString("name"),
                 s.cached_hash() == hash("name"), s.to_mutable(),
                 mod.AtomicIndex.unassigned().assigned))
    return seen


def test_sstorage_behaves_as_jax():
    got = _storage_session(sstorage, np.random.default_rng(2))
    assert got == _storage_session(jsst, np.random.default_rng(2))
    assert sstorage.ImmutableString is not jsst.ImmutableString


def _accept(listener, deadline=5.0):
    t0 = time.time()
    while time.time() - t0 < deadline:
        conns = listener.accept_connections()
        if conns:
            return conns[0]
        time.sleep(0.005)
    raise TimeoutError("no connection accepted")


def _receive(stream, n, raw, deadline=5.0):
    got = []
    t0 = time.time()
    while len(got) < n and time.time() - t0 < deadline:
        stream.process_input(got.append, raw=raw)
        time.sleep(0.005)
    return got


def _messages(rng):
    return [{"tick": int(rng.integers(1000)), "pos": rng.standard_normal(3)
             .round(6).tolist(), "name": "wérld"}, "plain",
            list(range(int(rng.integers(1, 40)))), 3.5, True, 0]


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_net_streams_talk_across_packages(server_side):
    """A listener of one package, a client of the other: JSON messages and
    raw payloads both ways, byte for byte."""
    rng = np.random.default_rng(11)
    lst_cls, cli_cls = ((JListener, NetStream) if server_side == "jax"
                        else (NetListener, JStream))
    lst = lst_cls.bind(("127.0.0.1", 0))
    try:
        client = cli_cls.connect(lst.local_address())
        server = _accept(lst)
        try:
            for a, b in ((client, server), (server, client)):
                msgs = _messages(rng)
                for m in msgs:
                    a.send_message(m)
                assert _receive(b, len(msgs), raw=False) == msgs
                blobs = [rng.bytes(int(n)) for n in
                         rng.integers(0, 20_000, 4)]
                for blob in blobs:
                    a.send_message(blob)
                assert _receive(b, len(blobs), raw=True) == blobs
            assert (server.string_peer_address()
                    == "%s:%d" % client._sock.getsockname())
        finally:
            client.close()
            server.close()
    finally:
        lst.close()
