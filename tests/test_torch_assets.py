"""Port parity: asset loading and the scene tools of fyrox_tpu_torch
against fyrox_tpu's on the CPU.

.rgs scenes (binary and ASCII, written here in Fyrox's graph layout by
``chip_smoke.fyrox_scene``), the resource manager, prefab deltas, glTF
(tests/test_gltf.py's asset and a skinned .glb with a ``matrix`` node,
uint8 weights and a rotation channel whose quaternions flip sign and
cross ±pi), Ogg pages and packets, the Vorbis decoder (part by part on
seeded inputs, and one stream written here by the Vorbis I spec),
tilemaps with autotiling and seeded WFC, plugin hot reload and the scene
CLI (inspect, diff, and generated 3D / 2D projects that run 60 ticks).

Bars: exact everywhere the two packages run the same numpy code or only
move values (templates, meshes, decoded PCM, tile grids, deltas, text);
within 1e-6 where a float32 conversion goes through XLA on one side and
PyTorch on the other (a ``matrix`` node's decomposition, a rotation
channel's quaternion → matrix → Euler keys, inverse binds, sampled tracks).
No JAX engine tick runs here.
"""
import base64
import io
import os
import struct
import sys
import textwrap
import uuid

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from fyrox_tpu.animation import init_animation_state as j_init_anim
from fyrox_tpu.animation import track as jtrack
from fyrox_tpu.io import inheritance as jinh
from fyrox_tpu.io.gltf import load_gltf as j_load_gltf
from fyrox_tpu.io.rgs_scene import load_scene as j_load_scene
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.scene import tilemap as jtilemap
from fyrox_tpu.sound import ogg as jogg
from fyrox_tpu.sound import vorbis as jvorbis
from fyrox_tpu.utils import autotile as jautotile
from fyrox_tpu_torch import convert, tools
from fyrox_tpu_torch.animation import init_animation_state, track
from fyrox_tpu_torch.io import inheritance, load_scene, write_rgs
from fyrox_tpu_torch.io.gltf import load_gltf
from fyrox_tpu_torch.physics import PhysicsBuilder
from fyrox_tpu_torch.plugin import Plugin, PluginHost
from fyrox_tpu_torch.resource import ResourceManager, ResourceState
from fyrox_tpu_torch.scene import SceneBuilder, tilemap
from fyrox_tpu_torch.sound import ogg, vorbis
from fyrox_tpu_torch.utils import autotile
from tests.test_gltf import make_gltf

torch.set_num_threads(2)
TOL = 1e-6

TEMPLATE_FIELDS = ("parent", "node_type", "payload", "init_position",
                   "init_rotation", "init_scale", "init_visibility",
                   "init_enabled", "init_lifetime", "init_pre_rotation",
                   "init_post_rotation", "init_rotation_offset",
                   "init_rotation_pivot", "init_scaling_offset",
                   "init_scaling_pivot", "levels", "depth")


def same_template(got, want, tol=0.0):
    """The port's template against a converted JAX one: names exact, every
    array of TEMPLATE_FIELDS exact (floats within tol where given)."""
    assert got.names == want.names
    for f in TEMPLATE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if f == "levels":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            continue
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if tol and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


# ----------------------------------------------------------------- .rgs
def ftax(root):
    """The FTAX ASCII Visitor text (writer/ascii.rs) of a node tree."""
    def value(f):
        k, v = f.kind, f.value
        if k == "bool":
            return "bool", "true" if v else "false"
        if k in ("u8", "u16", "u32", "i32", "u64"):
            return k, str(int(v))
        if k in ("vec3f32", "quat"):
            return k, ";".join(repr(float(x)) for x in np.asarray(v))
        if k == "uuid":
            return k, str(uuid.UUID(bytes=bytes(v)))
        if k == "blob":
            return "data", base64.b64encode(bytes(v)).decode()
        raise ValueError(k)

    def node(n):
        out = [n.name, "["]
        for f in n.fields:
            if f.kind == "string":
                text = f.value.replace('"', '\\"').replace("\n", "\\n")
                out.append(f'{f.name}<str:"{text}">')
            else:
                k, v = value(f)
                out.append(f"{f.name}<{k}:{v}>")
        out.append("]")
        if n.children:
            out.append("{" + "".join(node(c) for c in n.children) + "}")
        return "".join(out)

    return ("FTAX:1;" + node(root)).encode()


@pytest.mark.parametrize("encoding", ["binary", "ascii"])
def test_rgs_scene_loads_equal(encoding):
    tree = chip_smoke.fyrox_scene()
    data = write_rgs(tree) if encoding == "binary" else ftax(tree)
    got = load_scene(data)
    same_template(got, convert.scene_template(j_load_scene(data)))
    assert got.num_nodes == chip_smoke.RGS_NODES
    assert len(set(got.node_type.tolist())) == 9
    assert got.init_pre_rotation is not None
    assert got.init_scaling_offset is None       # identity terms drop
    assert not got.init_visibility.all() and (got.parent < 0).sum() > 1


def test_rgs_sound_and_listener_nodes_build_and_step():
    """SOUND and LISTENER nodes load with no buffer; the template builds,
    and an Engine over it initialises and ticks."""
    from fyrox_tpu_torch.engine import Engine
    from fyrox_tpu_torch.scene import NodeType
    t = load_scene(write_rgs(chip_smoke.fyrox_scene(n_nodes=18)))
    assert {NodeType.SOUND, NodeType.LISTENER} <= set(t.node_type.tolist())
    assert t.sounds["node"].size == 0 and t.listeners["node"].size == 0
    e = Engine(template=t)
    s = e.step(e.init_state(2, device="cpu"))
    assert bool(torch.isfinite(s.scene.globals_).all())


# --------------------------------------------------------- resources
def test_resource_request_dedup_and_async_load(tmp_path):
    path = tmp_path / "scene.rgs"
    path.write_bytes(write_rgs(chip_smoke.fyrox_scene()))
    rm = ResourceManager()
    r1 = rm.request(str(path))
    r2 = rm.request(str(path))
    assert r1 is r2
    r1.wait(10)
    assert r1.state == ResourceState.OK
    same_template(r1.data, convert.scene_template(j_load_scene(str(path))))
    rm.shutdown()


def test_resource_missing_loader_and_custom_loader(tmp_path):
    rm = ResourceManager()
    events = []
    rm.add_listener(lambda r: events.append(r.state))
    p = tmp_path / "thing.xyz"
    p.write_text("x")
    r = rm.request(str(p)).wait(5)
    assert r.state == ResourceState.LOAD_ERROR and "no loader" in r.error
    assert ResourceState.LOAD_ERROR in events
    rm.register_loader(".txt", lambda q: open(q).read())
    p = tmp_path / "a.txt"
    p.write_text("hello")
    r = rm.request(str(p)).wait(5)
    assert r.is_ok() and r.data == "hello"
    assert {".rgs", ".wav", ".ogg", ".gltf", ".glb", ".png",
            ".ppm"} <= set(rm._loaders)
    rm.shutdown()


# --------------------------------------------------------- inheritance
def _prefab(lib_sb):
    sb = lib_sb()
    root = sb.add_pivot("root", position=(0.0, 1.0, 0.0))
    sb.add_node("arm", parent=root, position=(1.0, 0.0, 0.0))
    sb.add_node("hand", parent=1, position=(0.5, 0.0, 0.0), visibility=False)
    return sb


def test_inheritance_deltas_equal():
    out = []
    for sb_cls, inh in ((JSceneBuilder, jinh), (SceneBuilder, inheritance)):
        prefab = _prefab(sb_cls).build()
        scene = sb_cls()
        scene.add_pivot("level")
        scene.instantiate(_prefab(sb_cls), parent=0)
        scene._nodes[3].position = np.asarray([2.0, 0.5, 0.0], np.float32)
        scene._nodes[4].visibility = True
        inst = scene.build()
        deltas = inh.compute_deltas(prefab, inst, node_offset=2)
        edited = _prefab(sb_cls)
        edited._nodes[0].scale = np.asarray([2.0, 2.0, 2.0], np.float32)
        merged = inh.apply_deltas(edited.build(), deltas)
        out.append((deltas, merged))
    (jd, jm), (d, m) = out
    assert d == jd and set(d) == {1, 2}
    same_template(m, convert.scene_template(jm))
    np.testing.assert_array_equal(m.init_scale[0], [2.0, 2.0, 2.0])


# ----------------------------------------------------------------- glTF
def same_gltf(got, want, tol=0.0):
    same_template(got.build(), convert.scene_template(want.build()), tol)
    assert got.node_map == want.node_map
    assert got.mesh_nodes == want.mesh_nodes
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(got.meshes, want.meshes):
        for f in ("positions", "normals", "uvs", "triangles"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(got.skins) == len(want.skins)
    for a, b in zip(got.skins, want.skins):
        for f in ("bones", "vertices", "bone_indices", "bone_weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_allclose(a.inv_bind, b.inv_bind, rtol=0, atol=tol)


def same_clips(got, want, times):
    a, b = got.animations.build(), want.animations.build()
    for kind in ("pos", "rot", "scl"):
        ca, cb = getattr(a, f"{kind}_curves"), getattr(b, f"{kind}_curves")
        assert (ca is None) == (cb is None)
        np.testing.assert_array_equal(getattr(a, f"{kind}_node"),
                                      getattr(b, f"{kind}_node"))
        if ca is not None:
            np.testing.assert_array_equal(ca.times, cb.times)
            np.testing.assert_allclose(ca.values, cb.values, rtol=0,
                                       atol=TOL)
    for t in times:
        s = init_animation_state(a, 1, device="cpu")
        s = s._replace(time=torch.full((1, a.num_animations), t))
        js = j_init_anim(b, 1)
        js = js._replace(time=jnp.full((1, b.num_animations), t))
        got_s, want_s = track.sample_tracks(a, s), jtrack.sample_tracks(b, js)
        assert set(got_s) == set(want_s)
        for k in got_s:
            np.testing.assert_array_equal(got_s[k][0], want_s[k][0])
            np.testing.assert_allclose(got_s[k][2].numpy(),
                                       np.asarray(want_s[k][2]), rtol=0,
                                       atol=TOL)


def test_gltf_embedded_asset_equal(tmp_path):
    path = make_gltf(str(tmp_path))
    got, want = load_gltf(path), j_load_gltf(path)
    same_gltf(got, want)
    same_clips(got, want, (0.0, 0.5, 0.75))


def _skinned_glb(tmp_path):
    """6 bones (one written as a matrix), 64 vertices with uint8 weights,
    a rotation channel turning about z from 2.6 to 3.9 rad whose stored
    quaternions alternate in sign, and a translation channel."""
    rng = np.random.default_rng(5)
    nodes = [dict(name="root", parent=-1, translation=(0.0, 1.0, 0.0))]
    for i in range(6):
        nodes.append(dict(name=f"bone{i}", parent=i,
                          translation=(0.2, 0.0, 0.0),
                          rotation=(0.0, 0.0, 0.0, 1.0)))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = 0.7
    q = np.r_[axis * np.sin(ang / 2), np.cos(ang / 2)]
    x, y, z, w = q
    rot = np.asarray([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
    m = np.eye(4)
    m[:3, :3] = rot * np.asarray([1.5, 0.8, 1.2])
    m[:3, 3] = (0.3, -0.1, 0.2)
    nodes[3] = dict(name="bone2", parent=2, matrix=m)
    nodes.append(dict(name="skin_mesh", parent=-1))
    bones = list(range(1, 7))
    verts = rng.uniform(-0.2, 1.4, (64, 3)).astype(np.float32)
    j4 = rng.integers(0, 6, (64, 4))
    w4 = rng.uniform(0.05, 1.0, (64, 4))
    w4 /= w4.sum(-1, keepdims=True)
    inv = np.linalg.inv(np.stack([np.eye(4) + 0.01 * i for i in range(6)]))
    times = np.linspace(0.0, 1.0, 7)
    angles = np.linspace(2.6, 3.9, 7)
    quats = chip_smoke.euler_to_quat(0.0 * angles, 0.0 * angles, angles)
    quats[1::2] *= -1.0
    tr = np.stack([times, 0.0 * times, -times], -1)
    data = chip_smoke.write_glb(
        nodes, skin=dict(node=len(nodes) - 1, joints=bones, inv_bind=inv,
                         positions=verts,
                         triangles=np.arange(63).reshape(-1, 3),
                         joints4=j4, weights4=w4),
        channels=[(4, "rotation", times, quats),
                  (0, "translation", times, tr)],
        weights_dtype=np.uint8)
    path = tmp_path / "skinned.glb"
    path.write_bytes(data)
    return str(path)


def test_gltf_skinned_glb_equal(tmp_path):
    path = _skinned_glb(tmp_path)
    got, want = load_gltf(path), j_load_gltf(path)
    same_gltf(got, want, tol=TOL)
    rz = got.animations.build().rot_curves.values[2]
    assert rz.max() > np.pi and np.all(np.diff(rz) > 0)   # unwrapped
    same_clips(got, want, (0.0, 0.3, 0.55, 0.9))
    w = got.skins[0].bone_weights
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-6)


# ---------------------------------------------------------- Ogg, Vorbis
def ogg_page(htype, granule, serial, seq, segments):
    """An Ogg page (CRC left zero: the reader does not verify it)."""
    lacing, body = b"", b""
    for seg in segments:
        n = len(seg)
        while n >= 255:
            lacing += bytes([255])
            n -= 255
        lacing += bytes([n])
        body += seg
    return (b"OggS" + struct.pack("<BBqIIIB", 0, htype, granule, serial,
                                  seq, 0, len(lacing)) + lacing + body)


def ident_packet(channels=2, rate=44100, blocks=(6, 8)):
    return (b"\x01vorbis" + struct.pack("<IBIiii", 0, channels, rate, 0,
                                        128000, 0)
            + bytes([blocks[0] | blocks[1] << 4, 1]))


def comment_packet(vendor=b"test-vendor", comments=(b"TITLE=Song",
                                                    b"ARTIST=Band")):
    c = b"\x03vorbis" + struct.pack("<I", len(vendor)) + vendor
    c += struct.pack("<I", len(comments))
    for entry in comments:
        c += struct.pack("<I", len(entry)) + entry
    return c + b"\x01"


@pytest.mark.parametrize("case", ["pages", "long_packet", "info",
                                  "headers_only", "not_vorbis"])
def test_ogg_cases_equal(case):
    stream = (ogg_page(2, 0, 7, 0, [ident_packet()])
              + ogg_page(0, 0, 7, 1, [comment_packet()]))
    outs = []
    for mod in (ogg, jogg):
        if case == "pages":
            pages = mod.read_pages(stream)
            outs.append(([(p.version, p.header_type, p.granule, p.serial,
                           p.seq, p.segments, p.is_bos) for p in pages],
                         mod.read_packets(pages)))
        elif case == "long_packet":
            page = ogg_page(0, 0, 1, 0, [bytes(range(256)) * 2 + bytes(88)])
            outs.append([len(p) for p in mod.read_packets(
                mod.read_pages(page))])
        elif case == "info":
            i = mod.vorbis_info(stream)
            outs.append((i.channels, i.sample_rate, i.bitrate_nominal,
                         i.vendor, i.comments))
        elif case == "headers_only":
            with pytest.raises(ValueError, match="truncated"):
                mod.decode(stream)
            outs.append(None)
        else:
            with pytest.raises(ValueError):
                mod.vorbis_info(b"OggS" + bytes(60))
            outs.append(None)
    assert outs[0] == outs[1]
    if case == "long_packet":
        assert outs[0] == [600]


class Bits:
    """LSB-first bit packer (Vorbis I §2)."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, value, bits):
        self.acc |= (int(value) & ((1 << bits) - 1)) << self.n
        self.n += bits
        return self

    def bytes(self):
        return self.acc.to_bytes((self.n + 7) // 8, "little")


def float32_pack(x):
    """Vorbis float32_pack (§9.2.2): 21-bit mantissa, exponent bias 788."""
    sign = 0x80000000 if x < 0 else 0
    x = abs(x)
    exp = 788 + 20
    mant = x
    while mant >= (1 << 21):
        mant /= 2
        exp += 1
    while mant < (1 << 20) and mant:
        mant *= 2
        exp -= 1
    return sign | (exp << 21) | int(round(mant))


def put_book(b, dim, lengths, ordered=False, lookup=0, vq=None):
    b.put(0x564342, 24).put(dim, 16).put(len(lengths), 24)
    if ordered:
        b.put(1, 1).put(lengths[0] - 1, 5)
        cur = 0
        while cur < len(lengths):
            num = sum(1 for x in lengths[cur:] if x == lengths[cur])
            b.put(num, vorbis._ilog(len(lengths) - cur))
            cur += num
    else:
        sparse = any(x == 0 for x in lengths)
        b.put(0, 1).put(int(sparse), 1)
        for x in lengths:
            if sparse:
                b.put(int(x > 0), 1)
            if x > 0:
                b.put(x - 1, 5)
    b.put(lookup, 4)
    if lookup:
        minv, delta, bits, seq, mult = vq
        b.put(float32_pack(minv), 32).put(float32_pack(delta), 32)
        b.put(bits - 1, 4).put(seq, 1)
        for m in mult:
            b.put(m, bits)


def setup_packet():
    """A Vorbis I setup header: five codebooks (flat, sparse and ordered
    Huffman lengths; VQ lookup types 1 and 2, one cumulative), one floor 1
    with two partition classes (one with a masterbook and an unused
    subclass), one residue of type 2 with four classes over two passes,
    one mapping with square-polar coupling of two channels, and a short
    and a long mode."""
    b = Bits()
    b.put(4, 8)                                          # 5 codebooks
    put_book(b, 1, [3] * 8)                              # 0 floor values
    put_book(b, 1, [2] * 4)                              # 1 residue classes
    put_book(b, 2, [4] * 16, lookup=1,
             vq=(-0.75, 0.5, 3, 0, [0, 1, 2, 3]))        # 2 VQ, lookup 1
    put_book(b, 2, [2, 2, 3, 3, 3, 3], ordered=True, lookup=2,
             vq=(-1.0, 0.25, 4, 1, list(range(12))))    # 3 VQ, lookup 2
    put_book(b, 1, [2, 0, 2, 2, 2])                      # 4 sparse master
    b.put(0, 6).put(0, 16)                               # time transforms
    b.put(0, 6).put(1, 16)                               # one floor 1
    b.put(2, 5).put(0, 4).put(1, 4)                      # partitions 0, 1
    b.put(1, 3).put(0, 2).put(1, 8)                      # class 0: dim 2
    b.put(2, 3).put(1, 2).put(4, 8).put(0, 8).put(1, 8)  # class 1: dim 3
    b.put(1, 2).put(7, 4)                                # mult 2, x < 128
    for x in (40, 90, 20, 64, 110):
        b.put(x, 7)
    b.put(0, 6).put(2, 16)                               # residue type 2
    b.put(0, 24).put(256, 24).put(7, 24).put(3, 6).put(1, 8)
    for cascade in (0b000, 0b001, 0b011, 0b100):
        b.put(cascade & 7, 3).put(0, 1)
    for books in ((), (2,), (2, 3), (3,)):
        for bk in books:
            b.put(bk, 8)
    b.put(0, 6).put(0, 16)                               # one mapping
    b.put(0, 1).put(1, 1).put(0, 8).put(0, 1).put(1, 1)  # couple 0 ↔ 1
    b.put(0, 2).put(0, 8).put(0, 8).put(0, 8)
    b.put(1, 6)                                          # two modes
    b.put(0, 1).put(0, 16).put(0, 16).put(0, 8)
    b.put(1, 1).put(0, 16).put(0, 16).put(0, 8)
    b.put(1, 1)                                          # framing
    return b"\x05vorbis" + b.bytes()


def vorbis_stream(n_packets=24, seed=3):
    """Headers, then seeded random audio packets (first bit clear): every
    bit pattern decodes through complete Huffman trees, so the packets
    drive every stage; the last page's granule trims the output."""
    rng = np.random.default_rng(seed)
    audio = []
    for _ in range(n_packets):
        p = bytearray(rng.integers(0, 256, int(rng.integers(8, 80)),
                                   dtype=np.uint8).tobytes())
        p[0] &= 0xFE
        audio.append(bytes(p))
    pages = [ogg_page(2, 0, 9, 0, [ident_packet(rate=8000)]),
             ogg_page(0, 0, 9, 1, [comment_packet(), setup_packet()])]
    half = n_packets // 2
    pages.append(ogg_page(0, 1000, 9, 2, audio[:half]))
    pages.append(ogg_page(4, 2400, 9, 3, audio[half:]))
    return b"".join(pages)


def test_vorbis_codebooks_and_lookup_equal():
    b = Bits()
    put_book(b, 2, [2, 2, 3, 3, 3, 3], ordered=True, lookup=2,
             vq=(-1.0, 0.25, 4, 1, list(range(12))))
    put_book(b, 3, [3] * 8, lookup=1, vq=(0.5, -0.125, 2, 0, [0, 3]))
    put_book(b, 1, [2, 0, 2, 2, 2])
    put_book(b, 1, [1] + [11] * 1024)                    # long codewords
    data = b.bytes()
    ba, bb = vorbis.BitReader(data), jvorbis.BitReader(data)
    for _ in range(4):
        x, y = vorbis.Codebook(ba), jvorbis.Codebook(bb)
        assert x.lengths == y.lengths and x.long_entries == y.long_entries
        np.testing.assert_array_equal(x.fast, y.fast)
        np.testing.assert_array_equal(x.fast_len, y.fast_len)
        assert (x.vq is None) == (y.vq is None)
        if x.vq is not None:
            np.testing.assert_array_equal(x.vq, y.vq)
        bits = np.random.default_rng(x.entries).integers(
            0, 256, 64, dtype=np.uint8).tobytes()
        ra, rb = vorbis.BitReader(bits), jvorbis.BitReader(bits)
        got = [x.decode(ra) for _ in range(40)]
        assert got == [y.decode(rb) for _ in range(40)]
    assert vorbis._lookup1_values(1000, 3) == jvorbis._lookup1_values(1000, 3)


def test_vorbis_floor1_imdct_and_window_equal():
    stream = vorbis_stream()
    pk = ogg.read_packets(ogg.read_pages(stream))
    da = vorbis.VorbisDecoder(pk[0], pk[2])
    db = jvorbis.VorbisDecoder(pk[0], pk[2])
    fa, fb = da.floors[0][1], db.floors[0][1]
    assert fa.x_list == fb.x_list and fa._lo_nb == fb._lo_nb
    rng = np.random.default_rng(11)
    for n2 in (32, 128):
        for k in range(6):
            bits = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            bits = bytes([bits[0] | 1]) + bits[1:]
            ya = fa.decode(vorbis.BitReader(bits), da.codebooks)
            yb = fb.decode(jvorbis.BitReader(bits), db.codebooks)
            assert ya == yb
            np.testing.assert_array_equal(fa.curve(ya, n2), fb.curve(yb, n2))
    spec = rng.normal(size=(2, 128)).astype(np.float32)
    np.testing.assert_array_equal(da._imdct(spec, 256), db._imdct(spec, 256))
    for geom in ((256, 0, 128, 128, 128), (256, 48, 32, 176, 32),
                 (64, 0, 32, 32, 32)):
        np.testing.assert_array_equal(da._window(*geom), db._window(*geom))


def test_vorbis_stream_decodes_equal(tmp_path):
    stream = vorbis_stream()
    pcm, rate = ogg.decode(stream)
    want, want_rate = jogg.decode(stream)
    assert rate == want_rate == 8000 and pcm.dtype == np.float32
    assert pcm.shape == want.shape and pcm.shape[0] == 2
    np.testing.assert_array_equal(pcm, want)
    assert pcm.shape[1] > 0 and np.abs(pcm).max() > 0
    path = tmp_path / "s.ogg"
    path.write_bytes(stream)
    np.testing.assert_array_equal(ogg.load_ogg(str(path)),
                                  jogg.load_ogg(str(path)))


# ------------------------------------------------------------- tilemaps
def test_tilemap_mesh_boxes_layers_equal():
    lv = chip_smoke.level_tilemap(tilemap, rows=12, cols=36)
    jlv = chip_smoke.level_tilemap(jtilemap, rows=12, cols=36)
    np.testing.assert_array_equal(lv.grid, jlv.grid)
    a, b = tilemap.tilemap_mesh(lv), jtilemap.tilemap_mesh(jlv)
    for f in ("positions", "normals", "uvs", "triangles"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (tilemap.tilemap_collider_boxes(lv)
            == jtilemap.tilemap_collider_boxes(jlv))
    np.testing.assert_array_equal(
        tilemap.tilemap_property_layer(lv, "cost", default=-1.0),
        jtilemap.tilemap_property_layer(jlv, "cost", default=-1.0))
    filled = np.random.default_rng(2).random((9, 11)) > 0.4
    for diagonal in (True, False):
        np.testing.assert_array_equal(
            autotile.autotile_bitmask(filled, diagonal),
            jautotile.autotile_bitmask(filled, diagonal))


def test_tilemap_wfc_and_physics_equal():
    sample = np.asarray([[0, 0, 0, 0], [0, 2, 2, 0], [1, 1, 1, 1],
                         [1, 1, 1, 1]])
    grids = []
    for tm_mod, at in ((tilemap, autotile), (jtilemap, jautotile)):
        ts = tm_mod.TileSet()
        air, rock, moss = (ts.add(solid=s) for s in (False, True, True))
        model = at.WfcModel.from_sample(sample)
        tm = tm_mod.tilemap_from_wfc(model, ts, 8, 10,
                                     wfc_to_tile={0: air, 1: rock, 2: moss},
                                     seed=4, cell_size=0.5)
        grids.append(tm)
    np.testing.assert_array_equal(grids[0].grid, grids[1].grid)
    assert (grids[0].grid != grids[0].grid[0, 0]).any()
    from fyrox_tpu.physics import PhysicsBuilder as JPhysicsBuilder
    pb, jpb = PhysicsBuilder(), JPhysicsBuilder()
    got = tilemap.tilemap_to_physics(grids[0], pb, z_half=0.25)
    want = jtilemap.tilemap_to_physics(grids[1], jpb, z_half=0.25)
    assert got == want and got[1] >= 1
    t, jt = pb.build(broadphase="dense"), convert.physics_template(
        jpb.build(broadphase="dense"))
    for f in ("body_type", "col_body", "col_shape", "col_params",
              "col_pos", "col_rot", "col_friction", "col_restitution",
              "pair_a", "pair_b"):
        np.testing.assert_array_equal(getattr(t, f), getattr(jt, f),
                                      err_msg=f)


# -------------------------------------------------------------- plugins
def test_plugin_hot_reload(tmp_path):
    src = tmp_path / "my_plugin.py"
    body = textwrap.dedent("""
        from fyrox_tpu_torch.plugin import Plugin

        class P(Plugin):
            STEP = {step}

            def __init__(self):
                self.total = 0

            def update(self, context, dt):
                self.total += self.STEP

            def save_state(self):
                return {{"total": self.total}}

            def restore_state(self, state):
                self.total = state["total"]

        def make_plugin():
            return P()
    """)
    src.write_text(body.format(step=1))
    host = PluginHost(context={}, watch_interval=0.0)
    p = host.load_file(str(src))
    host.update(1 / 60, now=1.0)
    host.update(1 / 60, now=2.0)
    assert p.total == 2
    src.write_text(body.format(step=10))
    os.utime(src, (os.stat(src).st_atime, os.stat(src).st_mtime + 5))
    host.update(1 / 60, now=3.0)
    fresh = host.plugins[0]
    assert fresh is not p and fresh.total == 12
    static = host.add(Plugin())
    host.update(1 / 60, now=4.0)
    assert fresh.total == 22 and static in host.plugins


# ---------------------------------------------------------------- tools
def test_tools_inspect_and_diff_print_equal():
    from fyrox_tpu import tools as jtools
    data = write_rgs(chip_smoke.fyrox_scene())
    moved = write_rgs(chip_smoke.fyrox_scene(moved=7))
    texts = []
    for load, mod in ((load_scene, tools), (j_load_scene, jtools)):
        a, b = load(data), load(moved)
        buf = io.StringIO()
        mod.inspect_scene(a, out=buf)
        n_same = mod.diff_scenes(a, a, out=buf)
        n_moved = mod.diff_scenes(a, b, out=buf)
        texts.append((buf.getvalue(), n_same, n_moved))
    assert texts[0] == texts[1]
    assert texts[0][1:] == (0, 1) and "init_position" in texts[0][0]


def test_tools_main_inspect_and_diff(tmp_path, capsys):
    a, b = tmp_path / "a.rgs", tmp_path / "b.rgs"
    a.write_bytes(write_rgs(chip_smoke.fyrox_scene()))
    b.write_bytes(write_rgs(chip_smoke.fyrox_scene(moved=3)))
    assert tools.main(["inspect", str(a)]) == 0
    assert capsys.readouterr().out.startswith("scene: 64 nodes")
    assert tools.main(["diff", str(a), str(a)]) == 0
    assert tools.main(["diff", str(a), str(b)]) == 1
    assert tools.main(["bogus"]) == 2


@pytest.mark.parametrize("style", ["3d", "2d"])
def test_tools_new_project_runs_sixty_ticks(tmp_path, style):
    from fyrox_tpu_torch.engine import _leaves
    from fyrox_tpu_torch.script import Executor
    name = f"proj{style}"
    assert tools.main(["new", name, f"--{style}", "--dir",
                       str(tmp_path)]) == 0
    root = str(tmp_path / name)
    for rel in (f"{name}/__init__.py", f"{name}/game.py", f"{name}/main.py",
                "tests/test_smoke.py", "README.md"):
        assert os.path.exists(os.path.join(root, rel)), rel
    for rel in (f"{name}/game.py", f"{name}/main.py", "tests/test_smoke.py"):
        text = open(os.path.join(root, rel)).read()
        assert "fyrox_tpu_torch" in text and "jax" not in text
        assert "fyrox_tpu." not in text and "platform_guard" not in text
    sys.path.insert(0, root)
    try:
        import importlib
        import importlib.util
        game = importlib.import_module(f"{name}.game")
        engine, state = game.build_game(device="cpu")
        assert state.scene.position.device.type == "cpu"
        state = Executor(engine, state).run(1.0)      # 60 ticks at 60 Hz
        assert not any(torch.isnan(x).any() for x in _leaves(state)
                       if x.is_floating_point())
        y = float(state.physics.position[0, 1, 1])
        assert (0.3 < y < 1.2) if style == "3d" else (0.2 < y < 1.0)
        spec = importlib.util.spec_from_file_location(
            f"{name}_smoke", os.path.join(root, "tests", "test_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        smoke.test_sixty_ticks()             # the generated test, on the CPU
    finally:
        sys.path.remove(root)
        for mod in [m for m in sys.modules if m.startswith(name)]:
            del sys.modules[mod]


def test_tools_new_project_validates(tmp_path):
    for bad in ("1game", "my-game", "a b"):
        with pytest.raises(ValueError):
            tools.new_project(bad, directory=str(tmp_path))
    with pytest.raises(ValueError):
        tools.new_project("ok", style="4d", directory=str(tmp_path))
    tools.new_project("twice", directory=str(tmp_path))
    with pytest.raises(FileExistsError):
        tools.new_project("twice", directory=str(tmp_path))
