"""Port parity: the audio modules of fyrox_tpu_torch against fyrox_tpu's
on the CPU.

The same inputs, made from numpy seeds, go through both packages: the
mixer's render_block for each distance model (looping and one-shot, pitch
1 and 1.5), the bus graph's biquads and reverb, the binaural path, the
colour helpers, the Sound / Listener template and prefab remapping, and
the small audio flagship's ticks with a block rendered after each. Both
run float32; XLA fuses multiply-adds into FMAs in the IIR recurrences
(PyTorch rounds each operation), so the bus is held to 1e-5.
"""
import wave

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.core import color as jcolor
from fyrox_tpu.engine import Engine as JEngine
from fyrox_tpu.models import build_flagship as jax_build_flagship
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.sound import binaural as jbin
from fyrox_tpu.sound import bus as jbus
from fyrox_tpu.sound import engine as jsnd
from fyrox_tpu.sound import scene as jscene
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.core import color as tcolor
from fyrox_tpu_torch.engine import Engine, world_health
from fyrox_tpu_torch.models import build_flagship
from fyrox_tpu_torch.scene import SceneBuilder
from fyrox_tpu_torch.scene.template import NodeType
from fyrox_tpu_torch.sound import binaural as tbin
from fyrox_tpu_torch.sound import bus as tbus
from fyrox_tpu_torch.sound import engine as tsnd
from fyrox_tpu_torch.sound import scene as tscene

torch.set_num_threads(2)


def _tone(freq, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / jsnd.SAMPLE_RATE
    return (0.5 * np.sin(2 * np.pi * freq * t)
            + 0.05 * rng.normal(size=n)).astype(np.float32)


# ---------------------------------------------------------------- mixer

MODELS = [jsnd.DistanceModel.NONE, jsnd.DistanceModel.INVERSE,
          jsnd.DistanceModel.LINEAR, jsnd.DistanceModel.EXPONENT]


@pytest.mark.parametrize("pitch", [1.0, 1.5])
@pytest.mark.parametrize("model", MODELS)
def test_render_block_matches_jax(model, pitch):
    """Four blocks of 5 sources (two buffers of other lengths; looping
    and one-shot; near, far and past max_distance) from the same state:
    blocks within 1e-6, playheads within 1e-6 relative, `playing` equal;
    the one-shot sources run off their buffers' ends inside the roll."""
    rng = np.random.default_rng(7)
    bufs = [_tone(220.0, 700, 1), _tone(330.0, 1100, 2)]
    jb, tb = jsnd.SoundBuffers.pack(bufs), tsnd.SoundBuffers.pack(bufs)
    pos = rng.uniform(-30, 30, (5, 3)).astype(np.float32)
    pos[0] = (0.5, 0.0, 0.0)
    kw = dict(buffer_idx=[0, 1, 0, 1, 0], positions=pos, pitch=pitch,
              radius=1.5, max_distance=25.0, rolloff=0.8)
    for looping in (True, False):
        js = jsnd.init_sources(looping=looping, **kw)
        ts = tsnd.init_sources(looping=looping, device="cpu", **kw)
        js = js._replace(gain=jnp.asarray([1.0, 0.5, 2.0, 1.0, 0.7]))
        ts = ts._replace(gain=torch.tensor([1.0, 0.5, 2.0, 1.0, 0.7]))
        lp = np.asarray([1.0, -2.0, 0.5], np.float32)
        lr = np.asarray([0.6, 0.0, 0.8], np.float32)
        loudest = 0.0
        for _ in range(4):
            jblock, js = jsnd.render_block(jb, js, lp, lr, block_len=300,
                                           distance_model=model)
            tblock, ts = tsnd.render_block(tb, ts, torch.tensor(lp),
                                           torch.tensor(lr), block_len=300,
                                           distance_model=model)
            np.testing.assert_allclose(tblock.numpy(), np.asarray(jblock),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(ts.playhead.numpy(),
                                       np.asarray(js.playhead), rtol=1e-6)
            np.testing.assert_array_equal(ts.playing.numpy(),
                                          np.asarray(js.playing))
            loudest = max(loudest, float(np.abs(np.asarray(jblock)).max()))
        assert loudest > 0.001
        assert looping or not bool(ts.playing.any())


def test_load_wav_matches_jax(tmp_path):
    """The host WAV decoder (16-bit stereo) reads what the JAX package's
    reads."""
    path = str(tmp_path / "tone.wav")
    pcm = (np.stack([_tone(200.0, 500), _tone(300.0, 500, 1)], 1)
           * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(jsnd.SAMPLE_RATE)
        w.writeframes(pcm.tobytes())
    np.testing.assert_array_equal(tsnd.load_wav(path), jsnd.load_wav(path))


# ---------------------------------------------------------------- bus

def _bus_graph(lib, effects):
    return lib.BusGraph.build([
        dict(parent=-1, gain=0.9),
        dict(parent=0, gain=0.5, effects=effects),
        dict(parent=1, gain=0.8),
    ])


@pytest.mark.parametrize("effect", ["lowpass", "highpass", "bandpass",
                                    "allpass", "reverb", "chain"])
def test_bus_process_matches_jax(effect):
    """Three buses (primary ← child with the effect ← grandchild), two
    blocks of 600 samples so that the carried filter and delay-line state
    matters: the primary's blocks and every state leaf within 1e-5."""
    if effect == "reverb":
        effects = [("reverb", 0.6)]
    elif effect == "chain":
        effects = [("biquad", jbus.biquad_coeffs("lowpass", 900.0)),
                   ("reverb", 0.4)]
    else:
        effects = [("biquad", jbus.biquad_coeffs(effect, 1200.0, q=1.1))]
    np.testing.assert_array_equal(
        tbus.biquad_coeffs("lowpass", 900.0),
        jbus.biquad_coeffs("lowpass", 900.0))
    jg, tg = _bus_graph(jbus, effects), _bus_graph(tbus, effects)
    assert tg.depth_order() == jg.depth_order()
    js, ts = jbus.init_state(jg), tbus.init_state(tg, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(2):
        blocks = rng.normal(0, 0.3, (3, 600, 2)).astype(np.float32)
        jout, js = jbus.process(jg, jnp.asarray(blocks), js)
        tout, ts = tbus.process(tg, torch.tensor(blocks), ts)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-5)
    for f in jbus.BusState._fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-5, err_msg=f)


# ---------------------------------------------------------------- binaural

def test_binaural_matches_jax():
    """spherical_head_hrir at azimuths all round the head, sample_hrir on a
    measured ring (wrap-around below the first azimuth included), and
    render_block_binaural with the model and with the ring: within 1e-5."""
    az = np.asarray([0.0, 0.4, -1.2, np.pi / 2, 2.9, -3.1], np.float32)
    np.testing.assert_allclose(
        tbin.spherical_head_hrir(torch.tensor(az)).numpy(),
        np.asarray(jax.jit(jbin.spherical_head_hrir)(jnp.asarray(az))),
        rtol=0, atol=1e-5)
    rng = np.random.default_rng(5)
    ring_az = np.asarray([0.3, 1.5, 2.8, 4.4, 5.6])
    hr = rng.normal(size=(5, 2, 16)).astype(np.float32)
    jsph, tsph = jbin.HrirSphere(ring_az, hr), tbin.HrirSphere(ring_az, hr)
    q = np.asarray([0.1, 0.3, 1.0, 3.0, 6.0, -0.5], np.float32)
    np.testing.assert_allclose(
        tbin.sample_hrir(tsph, torch.tensor(q)).numpy(),
        np.asarray(jbin.sample_hrir(jsph, jnp.asarray(q))), rtol=0,
        atol=1e-5)
    mono = rng.normal(0, 0.5, (3, 513)).astype(np.float32)
    az3 = np.asarray([0.2, -1.0, 2.5], np.float32)
    gains = np.asarray([1.0, 0.5, 0.8], np.float32)
    for sph in (None, (jsph, tsph)):
        j = jax.jit(lambda m, a, g, sph=sph: jbin.render_block_binaural(
            m, a, g, hrir_sphere=None if sph is None else sph[0]))(
            jnp.asarray(mono), jnp.asarray(az3), jnp.asarray(gains))
        t = tbin.render_block_binaural(
            torch.tensor(mono), torch.tensor(az3), torch.tensor(gains),
            hrir_sphere=None if sph is None else sph[1])
        assert tuple(t.shape) == (513, 2)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------- colour

def test_color_matches_jax():
    """Every colour helper on random inputs (hue past 360 and below 0,
    grey rgb whose hue is 0, gradient samples outside its ends): floats
    within 1e-6, bytes equal."""
    rng = np.random.default_rng(11)
    c = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    c[:4] = [0.0, 0.04045, 0.0031308, 1.0]
    tc = torch.tensor(c)
    np.testing.assert_array_equal(
        tcolor.from_rgba8(10, 200, 30, device="cpu").numpy(),
        np.asarray(jcolor.from_rgba8(10, 200, 30)))
    np.testing.assert_array_equal(tcolor.to_rgba8(tc).numpy(),
                                  np.asarray(jcolor.to_rgba8(c)))
    for fn in ("srgb_to_linear", "linear_to_srgb"):
        np.testing.assert_allclose(
            getattr(tcolor, fn)(tc).numpy(),
            np.asarray(getattr(jcolor, fn)(jnp.asarray(c))), rtol=0,
            atol=1e-6, err_msg=fn)
    h = rng.uniform(-400, 800, 64).astype(np.float32)
    s, v = c[:, 1], c[:, 2]
    np.testing.assert_allclose(
        tcolor.hsv_to_rgb(torch.tensor(h), torch.tensor(s),
                          torch.tensor(v)).numpy(),
        np.asarray(jcolor.hsv_to_rgb(jnp.asarray(h), jnp.asarray(s),
                                     jnp.asarray(v))), rtol=0, atol=1e-6)
    rgb = c[:, :3].copy()
    rgb[5] = 0.25                                    # grey: hue 0
    rgb[6] = [0.9, 0.9, 0.2]                         # a tie at the max
    np.testing.assert_allclose(
        tcolor.rgb_to_hsv(torch.tensor(rgb)).numpy(),
        np.asarray(jcolor.rgb_to_hsv(jnp.asarray(rgb))), rtol=0, atol=1e-6)
    pts = [(0.7, (1, 0, 0, 1)), (0.1, (0, 1, 0, 0.5)), (0.4, (0, 0, 1, 1))]
    tg, jg = tcolor.ColorGradient.pack(pts), jcolor.ColorGradient.pack(pts)
    np.testing.assert_array_equal(tg.locations, np.asarray(jg.locations))
    t = rng.uniform(-0.2, 1.2, (4, 16)).astype(np.float32)
    t[0, :3] = [0.1, 0.4, 0.7]
    np.testing.assert_allclose(
        tcolor.sample_gradient(tg, torch.tensor(t)).numpy(),
        np.asarray(jcolor.sample_gradient(jg, jnp.asarray(t))), rtol=0,
        atol=1e-6)


# ---------------------------------------------------------------- scene

def _sound_scene(lib_sb, listener=True, camera=False):
    sb = lib_sb()
    if camera:
        sb.add_camera("cam", position=(0.0, 1.0, -4.0))
    if listener:
        sb.add_listener("ears", position=(0.5, 0.0, 0.0))
    mover = sb.add_pivot("mover", position=(-3.0, 0.0, 1.0))
    sb.add_sound(_tone(300.0, 800), name="a", parent=mover, gain=0.7,
                 pitch=1.5, radius=2.0, max_distance=30.0, rolloff=0.5)
    sb.add_sound(0, name="b", looping=False, playing=True)
    sb.add_sound(_tone(500.0, 400), name="c", playing=False)
    prefab = lib_sb()
    prefab.add_sound(_tone(700.0, 300), name="p")
    prefab.add_listener("pl")
    sb.instantiate(prefab, name_prefix="i_", position=(1.0, 2.0, 3.0))
    return sb.build()


def _same_audio_template(at_t, at_j):
    np.testing.assert_array_equal(at_t.buffers.samples,
                                  np.asarray(at_j.buffers.samples))
    np.testing.assert_array_equal(at_t.buffers.lengths,
                                  np.asarray(at_j.buffers.lengths))
    np.testing.assert_array_equal(at_t.src_node, at_j.src_node)
    assert at_t.listener_node == at_j.listener_node
    for f in tsnd.SourceState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(at_t.base, f)),
                                      np.asarray(getattr(at_j.base, f)),
                                      err_msg=f)


def test_audio_template_and_instantiate_match_jax():
    """A scene with three sources (a shared buffer index, a one-shot, a
    stopped one) and a prefab instantiated into it: the templates' sound,
    listener and buffer fields and the packed AudioTemplate equal the JAX
    package's, field for field; the prefab's payloads and buffer are
    remapped."""
    tt, jt = _sound_scene(SceneBuilder), _sound_scene(JSceneBuilder)
    assert tt.names == jt.names
    np.testing.assert_array_equal(tt.payload, jt.payload)
    np.testing.assert_array_equal(tt.parent, jt.parent)
    for k in jt.sounds:
        np.testing.assert_array_equal(tt.sounds[k], jt.sounds[k], err_msg=k)
    np.testing.assert_array_equal(tt.listeners["node"], jt.listeners["node"])
    assert len(tt.sound_buffers) == len(jt.sound_buffers) == 3
    for a, b in zip(tt.sound_buffers, jt.sound_buffers):
        np.testing.assert_array_equal(a, b)
    assert list(tt.sounds["buffer"]) == [0, 0, 1, 2]
    assert tt.node_type[tt.sounds["node"][-1]] == NodeType.SOUND
    assert tt.names[tt.sounds["node"][-1]] == "i_p"
    _same_audio_template(tscene.build_audio_template(tt),
                         jscene.build_audio_template(jt))
    assert tscene.build_audio_template(SceneBuilder().build()) is None


@pytest.mark.parametrize("camera", [True, False])
def test_listener_fallback_warns(camera, recwarn):
    """Sound nodes without a Listener: the ears fall back to the first
    camera, else to node 0, with a warning (the JAX package logs it)."""
    tt = _sound_scene(SceneBuilder, listener=False, camera=camera)
    # the instantiated prefab brings a listener: drop it for this case
    tt.listeners = {"node": np.zeros(0, np.int32)}
    with pytest.warns(UserWarning, match="no Listener"):
        at = tscene.build_audio_template(tt)
    assert at.listener_node == (int(tt.cameras["node"][0]) if camera else 0)


def test_scene_audio_matches_jax():
    """render_scene_audio on W=3 worlds whose node globals differ (the
    source's mover and the listener moved and turned): blocks within 1e-6
    and the world axis kept first."""
    tt, jt = _sound_scene(SceneBuilder), _sound_scene(JSceneBuilder)
    te, je = Engine(template=tt), JEngine(template=jt)
    ts, js = te.init_state(3, device="cpu"), je.init_state(3)
    rng = np.random.default_rng(2)
    pos = np.asarray(js.scene.position).copy()
    pos += rng.uniform(-2, 2, pos.shape).astype(np.float32)
    rot = rng.normal(size=(3, tt.num_nodes, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    from fyrox_tpu.scene import graph as jgraph
    from fyrox_tpu_torch.scene import graph as tgraph
    js = js._replace(scene=jgraph.update_hierarchical_data(
        js.scene._replace(position=jnp.asarray(pos),
                          rotation=jnp.asarray(rot)), jt))
    ts = ts._replace(scene=tgraph.update_hierarchical_data(
        ts.scene._replace(position=torch.tensor(pos),
                          rotation=torch.tensor(rot)), tt))
    jrender = jax.jit(lambda st: je.render_audio(st, block_len=200))
    for _ in range(2):
        jb, js = jrender(js)
        tb, ts = te.render_audio(ts, block_len=200)
        assert tuple(tb.shape) == (3, 200, 2)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(ts.audio.position.numpy(),
                                   np.asarray(js.audio.position), atol=1e-6)
    assert not np.allclose(tb[0].numpy(), tb[1].numpy())


# ---------------------------------------------------------------- flagship

TICKS = 15
BLOCK = 128


@pytest.fixture(scope="module")
def flagships():
    je, _ = jax_build_flagship(n_bones=8, n_verts=128, n_bodies=4,
                               with_audio=True)
    te, _ = build_flagship(n_bones=8, n_verts=128, n_bodies=4,
                           with_audio=True)
    return je, te


def test_flagship_audio_matches_jax(flagships):
    """The small audio flagship (W=2): TICKS engine ticks, a block after
    each, against one jitted JAX scan of the same: blocks and the final
    state within 1e-5, playheads and `playing` equal."""
    je, te = flagships

    def body(s, _):
        s = je.step(s)
        block, s = je.render_audio(s, block_len=BLOCK)
        return s, block

    js, jblocks = jax.jit(lambda s: jax.lax.scan(body, s, None,
                                                 length=TICKS))(
        je.init_state(2))
    ts = te.init_state(2, device="cpu")
    assert ts.audio is not None and ts.audio.buffer.shape == (2, 1)
    tblocks = []
    for _ in range(TICKS):
        ts = te.step(ts)
        block, ts = te.render_audio(ts, block_len=BLOCK)
        tblocks.append(block)
    tblocks = torch.stack(tblocks, 0)
    np.testing.assert_allclose(tblocks.numpy(), np.asarray(jblocks), rtol=0,
                               atol=1e-5)
    assert np.abs(np.asarray(jblocks)).max() > 1e-3
    np.testing.assert_array_equal(ts.audio.playhead.numpy(),
                                  np.asarray(js.audio.playhead))
    np.testing.assert_array_equal(ts.audio.playing.numpy(),
                                  np.asarray(js.audio.playing))
    for f in ("position", "rotation"):
        np.testing.assert_allclose(
            getattr(ts.scene, f).numpy(), np.asarray(getattr(js.scene, f)),
            rtol=0, atol=1e-5, err_msg=f)
    assert bool(world_health(ts).all())


def test_engine_state_with_audio_converts(flagships):
    """convert.engine_state carries the JAX package's audio state (and
    convert.engine the template's sound fields): the converted engine
    renders the same block from it."""
    je, te = flagships
    js = je.init_state(2)
    js = js._replace(audio=js.audio._replace(
        playhead=jnp.asarray([[100.5], [2000.0]], jnp.float32)))
    ts = convert.engine_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    assert isinstance(ts.audio, tsnd.SourceState)
    np.testing.assert_array_equal(ts.audio.playhead.numpy(),
                                  [[100.5], [2000.0]])
    ce = convert.engine(je)
    _same_audio_template(ce.audio_template(), je.audio_template())
    jb, _ = je.render_audio(js, block_len=64)
    tb, _ = ce.render_audio(ts, block_len=64)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)


def test_rollout_with_audio_equals_steps(flagships):
    """Engine.rollout carries the audio leaves through its ticks unchanged
    and equals the step loop; a block rendered after it advances the
    playheads by the block."""
    _, te = flagships
    st = te.init_state(2, device="cpu")
    rolled = te.rollout(st, 3)
    stepped = te.step(te.step(te.step(st)))
    for a, b in zip(rolled.audio, stepped.audio):
        assert torch.equal(a, b)
    assert torch.equal(rolled.scene.globals_, stepped.scene.globals_)
    assert torch.equal(rolled.audio.playhead, st.audio.playhead)
    _, after = te.render_audio(rolled, block_len=BLOCK)
    assert torch.equal(after.audio.playhead,
                       torch.full((2, 1), float(BLOCK)))


def test_world_health_covers_audio_leaves(flagships):
    """A NaN in one world's playhead marks that world unhealthy, and
    restore_unhealthy takes the fallback's audio state there (the audio
    leaves are state leaves like the others)."""
    from fyrox_tpu_torch.engine import restore_unhealthy
    _, te = flagships
    st = te.init_state(3, device="cpu")
    bad = st._replace(audio=st.audio._replace(
        playhead=torch.tensor([[5.0], [float("nan")], [7.0]])))
    assert world_health(bad).tolist() == [True, False, True]
    fixed = restore_unhealthy(bad, st)
    assert fixed.audio.playhead[:, 0].tolist() == [5.0, 0.0, 7.0]
    assert bool(world_health(fixed).all())
