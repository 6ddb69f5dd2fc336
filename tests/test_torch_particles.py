"""Port parity: particle systems (fyrox_tpu/scene/particles.py) and the
engine's particle and root-motion stages of fyrox_tpu_torch against
fyrox_tpu, and Engine.rollout over them on the CPU.

The port draws the JAX package's own threefry2x32 streams
(fyrox_tpu_torch/core/threefry.py): keys and random bits equal JAX's
exactly; uniform floats equal them up to XLA's fused multiply-add (an
ulp); normal draws take XLA's inverse error function, within an ulp.
Alive masks, spawn debt and the step counter are held exactly over 60
ticks; lifetimes, sizes and velocities within 1e-6. Positions are held
within 1e-6 one tick at a time (each tick of the port from the JAX
package's state before it), and within 1e-5 over the whole 60 ticks: XLA
contracts ``position + dt * velocity`` into a fused multiply-add, so the
two float32 integrations part by an ulp a tick and drift apart by several
at up to ~6 m (2.0e-6 measured)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.animation import AnimationSetBuilder as JSetBuilder
from fyrox_tpu.animation import rootmotion as jrm
from fyrox_tpu.engine import Engine as JEngine
from fyrox_tpu.physics import shapes as jshapes
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.scene import particles as jparticles
from fyrox_tpu_torch import convert
from fyrox_tpu_torch import engine as tengine
from fyrox_tpu_torch.core import threefry
from fyrox_tpu_torch.scene import particles as tparticles

torch.set_num_threads(2)

DT = 1.0 / 60.0
KINDS = {"sphere": 0, "cuboid": 1, "cylinder": 2}


def _template(kind, **kw):
    kw = dict(dict(max_particles=48, emit_rate=75.0, emitter_kind=kind,
                   emitter_size=(0.5, 0.3, 0.4), seed=5), **kw)
    return jparticles.ParticleTemplate(**kw)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_threefry_keys_and_bits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed, "cpu")
    assert [int(x) for x in tkey] == np.asarray(key).tolist()
    for step in (0, 1, 99):
        jk = jax.random.fold_in(key, step)
        tk = threefry.fold_in(tkey, torch.tensor(step, dtype=torch.int32))
        assert [int(x) for x in tk] == np.asarray(jk).tolist()
        jw = np.asarray(jax.random.split(jk, 5))
        tw = threefry.split(tk, 5)
        np.testing.assert_array_equal(jw, np.stack([x.numpy() for x in tw],
                                                   -1))
        jb = jax.random.bits(jax.random.fold_in(jk, 12), (4, 3))
        tb = threefry.random_bits(threefry.fold_in(tk, 12), 12)
        np.testing.assert_array_equal(np.asarray(jb).reshape(-1),
                                      tb.numpy())


def test_uniform_and_normal_draws_match_jax():
    key, tkey = jax.random.PRNGKey(3), threefry.prng_key(3, "cpu")
    worst_u, worst_n = 0.0, 0.0
    for s in range(40):
        jk, tk = jax.random.fold_in(key, s), threefry.fold_in(tkey, s)
        ju = jax.random.uniform(jk, (64, 3), minval=-1.0, maxval=1.0)
        np.testing.assert_array_equal(np.asarray(ju), threefry.uniform(
            tk, (64, 3), -1.0, 1.0).numpy())
        ju = jax.random.uniform(jk, (64,), minval=0.05, maxval=0.15)
        worst_u = max(worst_u, float(np.abs(np.asarray(ju) - threefry.uniform(
            tk, (64,), 0.05, 0.15).numpy()).max()))
        jn = jax.random.normal(jk, (64, 3))
        worst_n = max(worst_n, float(np.abs(np.asarray(jn) - threefry.normal(
            tk, (64, 3)).numpy()).max()))
    assert worst_u <= 1e-8 and worst_n <= 1e-6, (worst_u, worst_n)


@pytest.fixture(scope="module", params=list(KINDS))
def particle_run(request):
    """60 ticks of step_particles, 3 worlds, both packages (JAX jitted)."""
    jt = _template(KINDS[request.param])
    tt = convert.particle_template(jt)
    js = jparticles.init_particles(jt, 3)
    ts = tparticles.init_particles(tt, 3, device="cpu")
    init = (jax.tree_util.tree_map(np.asarray, js), convert.to_numpy(ts))
    step = jax.jit(lambda s: jparticles.step_particles(s, jt, DT))
    ticks, one = [], []
    for _ in range(60):
        from_jax = tparticles.step_particles(
            tparticles.ParticleState(*(torch.as_tensor(np.array(x))
                                       for x in js)), tt, DT)
        js, ts = step(js), tparticles.step_particles(ts, tt, DT)
        ticks.append((jax.tree_util.tree_map(np.asarray, js),
                      convert.to_numpy(ts)))
        one.append(convert.to_numpy(from_jax))
    return init, ticks, one


def test_init_particles_equal(particle_run):
    (ji, ti), _, _ = particle_run
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_alive_debt_and_counter_equal(particle_run):
    _, ticks, _ = particle_run
    for js, ts in ticks:
        np.testing.assert_array_equal(js.alive, ts.alive)
        np.testing.assert_array_equal(js.spawn_debt, ts.spawn_debt)
        assert int(js.step) == int(ts.step)
    # the pool fills, then recycles the slots that die
    assert ticks[-1][1].alive.sum() > 0


@pytest.mark.parametrize("field", ["lifetime", "size", "velocity"])
def test_draws_match(particle_run, field):
    for js, ts in particle_run[1]:
        np.testing.assert_allclose(getattr(js, field), getattr(ts, field),
                                   rtol=0, atol=1e-6)


def test_positions_match_tick_by_tick(particle_run):
    _, ticks, one = particle_run
    for (js, _), ts in zip(ticks, one):
        np.testing.assert_array_equal(js.alive, ts.alive)
        np.testing.assert_allclose(js.position, ts.position, rtol=0,
                                   atol=1e-6)


def test_positions_match_over_60_ticks(particle_run):
    for js, ts in particle_run[1]:
        np.testing.assert_allclose(js.position, ts.position, rtol=0,
                                   atol=1e-5)


def test_draws_differ_by_tick_and_world(particle_run):
    """Counter-based: a newborn slot's draws depend on the tick and the
    world."""
    first = particle_run[1][0][1]
    born = first.alive
    assert born.sum() > 0
    v = first.velocity[born[:, :1].repeat(first.alive.shape[1], 1) & born]
    assert len(np.unique(v.round(6), axis=0)) == len(v)
    assert not np.array_equal(first.velocity[0], first.velocity[1])


# ------------------------------------------------------------------ engine

def _engine(lib):
    """A root-motion walker on a halfspace (dense) with a particle
    emitter: every new engine stage in one scene. lib: (SceneBuilder,
    AnimationSetBuilder, rootmotion, PhysicsBuilder, BodyType, shapes,
    Engine, particle template)."""
    sbc, abc, rm, pbc, bt, sh, eng, pt_ = lib
    sb = sbc()
    root = sb.add_pivot("char_root", position=(0, 0.9, 0))
    ab = abc()
    walk = ab.add_clip("walk", length=1.0, looping=True)
    lk = [dict(time=0.0, value=0.0), dict(time=1.0, value=1.2)]
    z = [dict(time=0.0, value=0.0), dict(time=1.0, value=0.0)]
    ab.add_position_track(walk, node=root, keys_xyz=[lk, z, z])
    aset = ab.build()
    rmd = rm.build_root_motion(aset, rm.RootMotionSettings(node=root))
    pb = pbc()
    g = pb.add_body(body_type=bt.STATIC)
    pb.add_collider(g, sh.HALFSPACE, [0, 0, 0])
    body = pb.add_body(node=root, position=(0, 0.9, 0),
                       lock_rotation=(0, 0, 0))
    pb.add_collider(body, sh.CAPSULE, [0.4, 0.3])
    return eng(template=sb.build(), physics=pb.build(broadphase="dense"),
               animations=aset, particles=pt_, root_motion=rmd,
               root_motion_body=body)


@pytest.fixture(scope="module")
def engines():
    jt = _template(KINDS["cylinder"], max_particles=32)
    je = _engine((JSceneBuilder, JSetBuilder, jrm, jworld.PhysicsBuilder,
                  jworld.BodyType, jshapes, JEngine, jt))
    te = convert.engine(je)
    js = je.init_state(2)
    ts = convert.engine_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    return je, te, js, ts


def test_converted_engine_and_state(engines):
    je, te, js, ts = engines
    assert te.particles.max_particles == 32
    assert te.root_motion_body == je.root_motion_body
    np.testing.assert_array_equal(te.root_motion.pos_track,
                                  je.root_motion.pos_track)
    own = te.init_state(2, device="cpu")
    for a, b in zip(tengine._leaves(own), tengine._leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ts.particles.step.dim() == 0
    assert ts.animation.rootmotion is not None


def test_engine_ticks_match(engines):
    """30 Engine.step ticks: body positions within 1e-5, particle state
    as step_particles' tests hold it."""
    je, te, js, ts = engines
    step = jax.jit(je.step)
    for _ in range(30):
        js, ts = step(js), te.step(ts)
        np.testing.assert_allclose(np.asarray(js.physics.position),
                                   ts.physics.position.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(np.asarray(js.particles.alive),
                                      ts.particles.alive.numpy())
        np.testing.assert_allclose(np.asarray(js.particles.position),
                                   ts.particles.position.numpy(), rtol=0,
                                   atol=1e-5)
    assert float(ts.physics.linvel[0, 1, 0]) > 1.0       # driven by the clip


def _same(a, b):
    la, lb = tengine._leaves(a), tengine._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and torch.equal(x, y)


def test_rollout_equals_steps(engines):
    _, te, _, ts = engines
    want = ts
    for _ in range(8):
        want = te.step(want)
    _same(te.rollout(ts, 8), want)


def test_captured_tick_advances_the_counter(engines):
    """The captured graph's work, run eagerly: the particle counter and
    the root-motion state are copied back, so each advance draws anew and
    three advances equal three steps bit for bit."""
    _, te, _, ts = engines
    tick = tengine.CapturedTick(te, ts, None, True, "sort")
    want = ts
    for k in range(3):
        tick.advance()
        want = te.step(want)
        assert int(tick.static.particles.step) == k + 1
    _same(tick.static, want)


def test_world_health_skips_the_counter(engines):
    _, te, _, ts = engines
    st = te.step(ts)
    assert tengine.world_health(st).all()
    pos = st.particles.position.clone()
    pos[1, 3, 0] = float("nan")
    sick = st._replace(particles=st.particles._replace(position=pos))
    assert tengine.world_health(sick).tolist() == [True, False]
    fixed = tengine.restore_unhealthy(sick, ts)
    assert tengine.world_health(fixed).all()
    assert int(fixed.particles.step) == int(st.particles.step)
    np.testing.assert_array_equal(fixed.particles.position[1].numpy(),
                                  ts.particles.position[1].numpy())


def test_ticks_after_the_first_copy_nothing_from_the_host(engines):
    """Every device constant of a tick (the particle template's, root
    motion's tables) is cached on the first tick: later ticks add no
    entry to the constant cache, as a captured tick must not copy from
    the host."""
    from fyrox_tpu_torch import _util
    _, te, _, ts = engines
    st = te.step(te.step(ts))
    n = len(_util._CONST_CACHE)
    te.step(st)
    assert len(_util._CONST_CACHE) == n


def test_audio_still_raises(engines):
    """Audio is ported (it raised before the port had the mixer): a JAX
    state that carries a mixer state converts into the port's SourceState,
    and the port's step carries it through unchanged while the rest of
    the tick equals the tick without it."""
    from fyrox_tpu.sound import engine as jsnd
    from fyrox_tpu_torch.sound import engine as tsnd
    je, te, js, ts = engines
    src = jsnd.init_sources([0, 0], [[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]],
                            pitch=1.5)
    audio = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x)[None],
                                  (2,) + np.shape(x)).copy(), src)
    jn = jax.tree_util.tree_map(np.asarray, js)._replace(audio=audio)
    conv = convert.engine_state(jn, device="cpu")
    assert isinstance(conv.audio, tsnd.SourceState)
    for f in tsnd.SourceState._fields:
        np.testing.assert_array_equal(getattr(conv.audio, f).numpy(),
                                      getattr(audio, f), err_msg=f)
    stepped = te.step(conv)
    plain = te.step(ts)
    for a, b in zip(stepped.audio, conv.audio):
        assert torch.equal(a, b)
    for a, b in zip(tengine._leaves(stepped._replace(audio=None)),
                    tengine._leaves(plain)):
        assert torch.equal(a, b)