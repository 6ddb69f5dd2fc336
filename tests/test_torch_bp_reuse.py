"""Port parity: the counting-rank slab broadphase with K4b plane_scatter,
and temporal broadphase reuse (broadphase_period > 1), against the JAX
package on the CPU, where the port runs the kernels' plain versions.

K4b's plain version is held to the TPU kernel's own body
(``pallas_ops._scatter_kernel`` through ``pl.pallas_call(interpret=True)``,
set up as ``plane_scatter`` sets it up: KP = 1,024, b_pad = 128) and to its
CPU path; the count-rank broadphase to JAX's under ``FYROX_BP_RANK=count``
on the same AABBs; the reuse rollouts to JAX's jitted ``step_physics``
(period 4, 2 worlds, 20 steps). Inputs are made with numpy seeds."""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from fyrox_tpu.models.character import build_pile_scene as jax_pile_scene
from fyrox_tpu.physics import pallas_ops as jops
from fyrox_tpu.physics import broadphase as jbp
from fyrox_tpu.physics import planes as jplanes
from fyrox_tpu.physics import shapes as jsh
from fyrox_tpu.physics import slab2 as jslab2
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.scene.builder import SceneBuilder as JSceneBuilder
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.physics import broadphase as tbp
from fyrox_tpu_torch.physics import fused_step, plane_ops
from fyrox_tpu_torch.physics import planes as tplanes
from fyrox_tpu_torch.physics import slab2 as tslab2
from fyrox_tpu_torch.physics import world as tworld

torch.set_num_threads(2)

DT = 1.0 / 60.0
PERIOD = 4


@pytest.fixture(autouse=True)
def fresh_perm_cache():
    """pallas_ops._perm_idx caches by id() of a template's matrices, so an
    entry of a template freed earlier in the process could serve a new
    one whose matrix took its id: start each test without entries."""
    jops._PERM_CACHE.clear()


# ---- K4b: plane_scatter against the TPU kernel body -----------------------

def _tpu_scatter(vals, idx, b_pad):
    """pallas_ops.plane_scatter's TPU branch, in interpret mode: vals
    [W,A,KP], idx [W,1,KP] int32 → [W,A,b_pad]."""
    w, a, kp = vals.shape
    blk = jops.BLK
    return np.asarray(pl.pallas_call(
        functools.partial(jops._scatter_kernel, bp=b_pad),
        grid=(w, kp // blk),
        in_specs=[pl.BlockSpec((1, a, blk), lambda i, j: (i, 0, j)),
                  pl.BlockSpec((1, 1, blk), lambda i, j: (i, 0, j))],
        out_specs=pl.BlockSpec((1, a, b_pad), lambda i, j: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((w, a, b_pad), jnp.float32),
        interpret=True)(jnp.asarray(vals), jnp.asarray(idx)))


@pytest.mark.parametrize("case", ["permutation", "repeats"])
def test_plane_scatter_plain_matches_tpu_kernel_body(case):
    rng = np.random.default_rng(0 if case == "permutation" else 1)
    w, a, kp, b_pad = 2, 16, jops.BLK, 128
    vals = rng.standard_normal((w, a, kp)).astype(np.float32)
    if case == "permutation":
        # 120 rows permuted into 128 outputs; the padding points at b_pad
        idx = np.full((w, kp), b_pad, np.int32)
        for wi in range(w):
            idx[wi, :120] = rng.permutation(b_pad)[:120]
    else:
        # repeats, negatives and indices at or past b_pad (they drop)
        idx = rng.integers(-8, b_pad + 40, (w, kp)).astype(np.int32)
    ref = _tpu_scatter(vals, idx[:, None], b_pad)
    # JAX's CPU path (.at[].add(mode="drop")) wraps negative indices
    # around where the TPU kernel drops them: it sees them moved past b_pad
    cpu_idx = np.where(idx < 0, b_pad + 1, idx)
    cpu = np.asarray(jops.plane_scatter(jnp.asarray(vals),
                                        jnp.asarray(cpu_idx[:, None]), b_pad))
    got = plane_ops.plane_scatter_plain(torch.as_tensor(vals),
                                        torch.as_tensor(idx), b_pad).numpy()
    assert got.shape == (w, a, b_pad)
    if case == "permutation":
        assert (got != 0).mean() > 0.9
        np.testing.assert_array_equal(ref, got)     # one value per output
        np.testing.assert_array_equal(cpu, got)
    else:
        assert ((idx >= 0) & (idx < b_pad)).sum(1).max() > b_pad
        # sums of ~8 float32 values in another order
        np.testing.assert_allclose(ref, got, rtol=0, atol=1e-6)
        np.testing.assert_allclose(cpu, got, rtol=0, atol=1e-6)
        # what drops: the same sums with the out-of-range entries removed
        keep = (idx >= 0) & (idx < b_pad)
        clean = plane_ops.plane_scatter_plain(
            torch.as_tensor(vals * keep[:, None]),
            torch.as_tensor(np.where(keep, idx, 0).astype(np.int32)), b_pad)
        np.testing.assert_allclose(clean.numpy(), got, rtol=0, atol=1e-6)


def test_rank_count_and_scatter_rows_match_jax():
    rng = np.random.default_rng(2)
    w, n = 3, 64
    key = rng.integers(0, 12, (w, n)).astype(np.int32)       # many ties
    key[0, :5] = (1 << 31) - 1                               # packed-key range
    tk = torch.as_tensor(key)
    rank = plane_ops.rank_rows(tk)
    np.testing.assert_array_equal(np.asarray(jops.rank_rows(jnp.asarray(key))),
                                  rank.numpy())
    # the inverse of a stable argsort
    order = torch.argsort(tk, dim=1, stable=True)
    np.testing.assert_array_equal(
        torch.empty_like(order).scatter_(1, order, torch.arange(n).expand(
            w, n)).numpy(), rank.numpy())
    q = rng.integers(-2, 14, (w, 40)).astype(np.int32)
    for strict in (True, False):
        want = np.asarray(jops.count_lt(jnp.asarray(key), jnp.asarray(q),
                                        strict=strict))
        got = plane_ops.count_lt(tk, torch.as_tensor(q), strict=strict)
        np.testing.assert_array_equal(want, got.numpy())
        # the broadphase's searchsorted over the sorted keys counts the same
        skey = torch.sort(tk, dim=1).values.contiguous()
        ss = torch.searchsorted(skey, torch.as_tensor(q), right=not strict)
        np.testing.assert_array_equal(want, ss.numpy())
    x = rng.standard_normal((w, n, 10)).astype(np.float32)
    got = plane_ops.scatter_rows(torch.as_tensor(x), rank, n)
    np.testing.assert_array_equal(
        np.asarray(jops.scatter_rows(jnp.asarray(x), jnp.asarray(rank.numpy()),
                                     n)), got.numpy())
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(
        x, order.numpy()[..., None], 1))                     # sorted rows
    idx = rng.integers(-3, n + 3, (w, n)).astype(np.int32)
    np.testing.assert_allclose(
        np.asarray(jops.scatter_rows(jnp.asarray(x), jnp.asarray(idx), n)),
        plane_ops.scatter_rows(torch.as_tensor(x), torch.as_tensor(idx),
                               n).numpy(), rtol=0, atol=1e-6)


# ---- the count-rank slab broadphase ---------------------------------------

def _jax_pile(n=200, seed=1):
    """A 200-body pile at the flagship's period-1 windows."""
    pb, _ = jax_pile_scene(JSceneBuilder(), n_bodies=n, seed=seed)
    return pb, pb.build(broadphase="slab", slab_window=(12, 8, 10),
                        slab_walk=48)


@pytest.fixture(scope="module")
def pile_aabbs():
    """A 200-body pile's AABBs, jittered per world (2 worlds): fat ones,
    and tight ones nested inside them."""
    jops._PERM_CACHE.clear()
    pb, jt = _jax_pile()
    pos, _ = pb.initial_pose()
    rng = np.random.default_rng(4)
    w = 2
    cb = np.asarray(jt.col_body)
    ctr = pos[cb][None] + rng.uniform(-0.1, 0.1, (w, cb.size, 3))
    half = rng.uniform(0.3, 0.42, (w, cb.size, 3))
    amin, amax = ctr - half, ctr + half
    hs = np.asarray(jt.col_shape) == jsh.HALFSPACE
    amin[:, hs] = (-1e9, -2e9, -1e9)
    amax[:, hs] = (1e9, 0.052, 1e9)
    shrink = rng.uniform(0.0, 0.06, (2, w, cb.size, 3))
    tmin, tmax = amin + shrink[0], amax - shrink[1]
    tmin[:, hs], tmax[:, hs] = amin[:, hs], amax[:, hs]
    f32 = lambda x: x.astype(np.float32)                    # noqa: E731
    return jt, convert.physics_template(jt), tuple(
        map(f32, (amin, amax, tmin, tmax)))


@pytest.mark.parametrize("tier", ["delta", "two_tier"])
def test_count_rank_slab_candidates_match_jax(pile_aabbs, tier,
                                              monkeypatch):
    jt, tt, (amin, amax, tmin, tmax) = pile_aabbs
    jcx, tcx = jslab2._ctx(jt), tslab2._ctx(tt)
    if tier == "delta":
        kw = dict(tight_delta=jworld.SPECULATIVE_MARGIN
                  - jworld.PREDICTION_DISTANCE)
        tkw = dict(kw)
    else:
        kw = dict(amin_tight=jnp.asarray(tmin), amax_tight=jnp.asarray(tmax))
        tkw = dict(amin_tight=torch.as_tensor(tmin),
                   amax_tight=torch.as_tensor(tmax))
    monkeypatch.setenv("FYROX_BP_RANK", "count")
    jc, jd = jbp.slab_candidates(jt.grid, jcx.col_body, jcx.dyn_col,
                                 jnp.asarray(amin), jnp.asarray(amax),
                                 return_demand=True, **kw)
    for rank in ("count", "sort"):
        tc, td = tbp.slab_candidates(tt.grid, tcx.col_body, tcx.dyn_col,
                                     torch.as_tensor(amin),
                                     torch.as_tensor(amax), rank=rank,
                                     return_demand=True, **tkw)
        for c in range(3):
            for f in tbp.SlabCandidates._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(jc[c], f)),
                    getattr(tc[c], f).numpy(), err_msg=f"{rank} {c} {f}")
        np.testing.assert_array_equal(np.asarray(jd["walk_total"]),
                                      td["walk_total"].numpy())
        for k in ("class_valid", "class_tight"):
            for c in range(3):
                np.testing.assert_array_equal(
                    np.asarray(jd[k][c]).astype(np.int64),
                    td[k][c].numpy(), err_msg=f"{rank} {k} {c}")
    # the windows hold real work: pairs in both tiers, and overflow
    assert sum(int(np.asarray(c.valid).sum()) for c in jc) > 1000
    tight = np.asarray(jd["class_tight"][0])
    assert 0 < tight.sum() < np.asarray(jd["class_valid"][0]).sum()
    assert np.asarray(jd["class_valid"][0]).max() > tt.grid.s_class[0]


def test_bad_rank_raises(pile_aabbs):
    jt, tt, (amin, amax, _, _) = pile_aabbs
    cx = tslab2._ctx(tt)
    with pytest.raises(ValueError, match="rank"):
        tbp.slab_candidates(tt.grid, cx.col_body, cx.dyn_col,
                            torch.as_tensor(amin), torch.as_tensor(amax),
                            rank="argsort")


def test_two_sided_aabbs_match_jax():
    """_aabb_planes(two_sided=True): rotation-invariant extents and a
    two-sided sweep clipped at half the sweep cap, on a capsule / ball /
    cuboid pile at random poses and velocities."""
    from fyrox_tpu.physics import (BALL, CAPSULE, CUBOID, HALFSPACE,
                                   PhysicsBuilder)
    rng = np.random.default_rng(6)
    pb = PhysicsBuilder()
    g = pb.add_body(body_type=1)
    pb.add_collider(g, HALFSPACE, [])
    for i in range(24):
        b = pb.add_body(position=(0.0, 1.0, 0.0))
        shape, p = [(CAPSULE, [0.15, 0.12]), (BALL, [0.2]),
                    (CUBOID, [0.18, 0.1, 0.25])][i % 3]
        pb.add_collider(b, shape, p, offset=(0.05, 0.0, 0.0) if i % 4 else
                        (0, 0, 0))
    jt = pb.build(broadphase="slab")
    tt = convert.physics_template(jt)
    c = jt.num_colliders
    cpos = rng.uniform(-3, 3, (2, c, 3)).astype(np.float32)
    q = rng.standard_normal((2, c, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    vs = rng.uniform(-0.4, 0.4, (2, c, 3)).astype(np.float32)
    margin = jt.allowed_linear_error + jworld.SPECULATIVE_MARGIN
    extra = np.float32(0.03)
    sp = lambda x, n: tuple(x[..., i] for i in range(n))    # noqa: E731
    with jax.disable_jit():
        jq = sp(jnp.asarray(q), 4)
        want = jslab2._aabb_planes(
            jslab2._ctx(jt), jt, sp(jnp.asarray(cpos), 3),
            jplanes.q_to_rot9(jq), sp(jnp.asarray(vs), 3), margin,
            two_sided=True, extra=jnp.asarray(extra))
    tq = sp(torch.as_tensor(q), 4)
    got = tslab2._aabb_planes(tslab2._ctx(tt), tt, sp(torch.as_tensor(cpos), 3),
                              tplanes.q_to_rot9(tq), sp(torch.as_tensor(vs), 3),
                              margin, two_sided=True, extra=float(extra))
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        a, b = np.asarray(a), b.numpy()
        grid = np.abs(a) < 1e8                          # not the halfspace
        np.testing.assert_allclose(a[grid], b[grid], rtol=0, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-6)
    # both sides of the clip occur: sweeps under and over half the cap
    over = np.abs(vs) + extra > 0.5 * np.asarray(jt.grid.sweep_cap)[None, :,
                                                                     None]
    assert 0 < over[:, 1:].mean() < 1


# ---- reuse rollouts against JAX's jitted step -----------------------------

def _stack_scene(pb_cls, halfspace, cuboid, static):
    """tests/test_bp_reuse.py:46-55: two boxes stacked on the ground."""
    pb = pb_cls()
    g = pb.add_body(body_type=static)
    pb.add_collider(g, halfspace, [0, 0, 0])
    b1 = pb.add_body(position=(0, 0.5, 0))
    pb.add_collider(b1, cuboid, [0.5, 0.5, 0.5])
    b2 = pb.add_body(position=(0.1, 1.5, 0))
    pb.add_collider(b2, cuboid, [0.5, 0.5, 0.5])
    return pb, pb.build(broadphase="slab", broadphase_period=PERIOD)


def _fall_scene(pb_cls, halfspace, cuboid, ball, static, n=14):
    """tests/test_bp_reuse.py:127-155, cut to 14 bodies and started 2 m
    lower so that they land within 20 steps; one static 0.6 m ball sizes
    the hash cell, so the falling bodies keep sweep headroom and reuse
    steps happen between rebuilds."""
    pb = pb_cls()
    g = pb.add_body(body_type=static)
    pb.add_collider(g, halfspace, [0, 0, 0], friction=0.5)
    post = pb.add_body(body_type=static, position=(-6.0, 0.6, -6.0))
    pb.add_collider(post, ball, [0.6])
    for i in range(n):
        b = pb.add_body(position=(6.0 * (i % 14), 1.0 + 0.02 * i,
                                  6.0 * (i // 14)))
        if i % 2:
            pb.add_collider(b, cuboid, [0.3, 0.2, 0.25])
        else:
            pb.add_collider(b, ball, [0.25])
    return pb, pb.build(broadphase="slab", broadphase_period=PERIOD)


def _jax_scene(name):
    if name == "box_stack":
        return _stack_scene(jworld.PhysicsBuilder, jsh.HALFSPACE, jsh.CUBOID,
                            jworld.BodyType.STATIC)
    return _fall_scene(jworld.PhysicsBuilder, jsh.HALFSPACE, jsh.CUBOID,
                       jsh.BALL, jworld.BodyType.STATIC)


@pytest.fixture(scope="module", params=["box_stack", "fast_fall"])
def jax_rollout(request):
    """JAX's jitted step_physics (count rank) over 20 steps from seeded
    velocities, 2 worlds: the start state, bp_age after every step and
    the end state, as numpy."""
    jops._PERM_CACHE.clear()
    pb, jt = _jax_scene(request.param)
    js = jworld.init_physics_state(pb, jt, 2)
    rng = np.random.default_rng(7)
    scale = 0.2 if request.param == "box_stack" else 1.0
    lv = scale * rng.uniform(-3, 3, js.linvel.shape).astype(np.float32)
    av = scale * rng.uniform(-5, 5, js.angvel.shape).astype(np.float32)
    static = np.asarray(jt.body_type) != 0
    lv[:, static], av[:, static] = 0.0, 0.0
    js = js._replace(linvel=jnp.asarray(lv), angvel=jnp.asarray(av))
    start = jax.tree_util.tree_map(np.asarray, js)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FYROX_BP_RANK", "count")
        for k in ("FYROX_PALLAS_INTERPRET", "FYROX_NO_FUSED_STEP"):
            mp.delenv(k, raising=False)
        step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
        ages = []
        for _ in range(20):
            js = step(js)
            ages.append(np.asarray(js.bp_age))
    return (request.param, jt, start, np.stack(ages),
            jax.tree_util.tree_map(np.asarray, js))


@pytest.mark.parametrize("route", ["fused", "staged"])
def test_reuse_rollout_matches_jax(jax_rollout, route, monkeypatch):
    name, jt, start, ages, ref = jax_rollout
    tt = convert.physics_template(jt)
    assert tt.broadphase_period == PERIOD
    assert not fused_step.supports_fused_bp(tt)
    routes = []
    real = fused_step.fused_step

    def spy(*a, **k):
        routes.append(k.get("cands") is not None)
        return real(*a, **k)

    monkeypatch.setattr(fused_step, "fused_step", spy)
    ts = convert.physics_state(start, device="cpu")
    plane_ops.reset_launches()
    got_ages = []
    for _ in range(20):
        ts = tworld.step_physics(ts, tt, DT, fused=route == "fused",
                                 bp_rank="count")
        got_ages.append(ts.bp_age.numpy())
    # the same rebuild steps (a rebuild leaves age 1) and cadence
    np.testing.assert_array_equal(ages, np.stack(got_ages))
    rebuilds = int((ages[:, 0] == 1).sum())
    assert routes == ([True] * 20 if route == "fused" else [])
    if name == "fast_fall":
        assert 2 < rebuilds < 20                  # reuse steps happen
        # an adaptive rebuild restarted the cadence before its period ran
        assert any(ages[i, 0] == 1 and ages[i - 1, 0] not in (0, PERIOD - 1)
                   for i in range(1, 20))
    else:
        assert rebuilds == 20     # the boxes fill the cell: no headroom
    # the cache: candidates equal as integers, positions and budgets
    for c in range(3):
        for f, x in zip(tbp.SlabCandidates._fields, ref.bp_cache[0][c]):
            np.testing.assert_array_equal(
                np.asarray(x), getattr(ts.bp_cache[0][c], f).numpy(),
                err_msg=f"class {c} {f}")
    assert sum(int(np.asarray(c[2]).sum()) for c in ref.bp_cache[0]) > 0
    np.testing.assert_allclose(ref.bp_cache[1], ts.bp_cache[1].numpy(),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(ref.bp_cache[2], ts.bp_cache[2].numpy(),
                               rtol=0, atol=1e-4)
    # the bounds of test_torch_fused.py between two implementations of a
    # 30-step trajectory (test_pallas_step.py:72-73)
    got = convert.to_numpy(ts)
    assert np.abs(ref.position - got.position).max() < 5e-4
    assert np.abs(ref.linvel - got.linvel).max() < 5e-3
    assert (got.warm_pair >= 0).sum() > 0
    assert plane_ops.launches("plane_scatter") == 0     # CPU: plain versions
    # convert carries a JAX reuse state across, cache and age included
    back = convert.to_numpy(convert.physics_state(ref, device="cpu"))
    for x, y in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(tuple(back))):
        np.testing.assert_array_equal(x, y)


# ---- diagnostics ----------------------------------------------------------

def test_demand_and_overflow_stats_match_jax(pile_aabbs):
    """bp_demand_stats (period 1 and 4) and overflow_stats of one state:
    the 200-body pile of the broadphase test (its shapes, so that JAX's
    eager ops reuse their compiles) after 24 steps of the port."""
    jt, tt = pile_aabbs[:2]
    js = jworld.init_physics_state((jt.init_body_pos, jt.init_body_rot), jt,
                                   2)
    ts = convert.physics_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    dyn = torch.as_tensor(tt.body_type == 0)[None, :, None]
    ts = ts._replace(position=ts.position + torch.as_tensor(
        np.random.default_rng(8).uniform(-0.05, 0.05, ts.position.shape)
        .astype(np.float32)) * dyn)
    for _ in range(24):
        ts = tworld.step_physics(ts, tt, DT)
    js = js._replace(**{f: jnp.asarray(getattr(ts, f).numpy())
                        for f in ("position", "rotation", "linvel")})
    for period in (1, PERIOD):
        want = jslab2.bp_demand_stats(jt, js, period=period)
        assert tslab2.bp_demand_stats(tt, ts, period=period) == want
    assert want["class0"]["dropped"] > 0            # the caps drop pairs
    want = jslab2.overflow_stats(jt, js)
    got = tslab2.overflow_stats(tt, ts)
    assert want["max_active_points"] > 0
    assert got == pytest.approx(want, rel=1e-6)
    for k in ("max_active_points", "max_tight_points", "s_active",
              "dropped_points", "tight_dropped_points"):
        assert got[k] == want[k] and isinstance(got[k], int), k


# ---- state and builder ----------------------------------------------------

def test_reuse_state_matches_jax():
    """init_physics_state at period 4: the empty cache (per-class zero
    slots, pid -1, zero positions and coverage) and age 0, as JAX's."""
    pb, jt = _jax_scene("fast_fall")
    tt = convert.physics_template(jt)
    ref = jax.tree_util.tree_map(np.asarray,
                                 jworld.init_physics_state(pb, jt, 3))
    got = tworld.init_physics_state(pb.initial_pose(), tt, 3, device="cpu")
    assert all(isinstance(c, tbp.SlabCandidates) for c in got.bp_cache[0])
    want_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = jax.tree_util.tree_leaves(tuple(convert.to_numpy(got)))
    assert len(want_leaves) == len(got_leaves) == 6 + 4 + 15 + 2 + 1
    for x, y in zip(want_leaves, got_leaves):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
