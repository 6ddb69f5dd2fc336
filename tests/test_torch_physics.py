"""Port parity: the staged slab physics step of fyrox_tpu_torch
(``fused=False``) against fyrox_tpu's XLA staged path (its CPU path) on the
24-body slab scene of tests/test_pallas_solver.py, stage by stage and over
a 30-step rollout. The fused route has its own file, test_torch_fused.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.physics import BALL as JBALL, CUBOID as JCUBOID
from fyrox_tpu.physics import HALFSPACE as JHALFSPACE
from fyrox_tpu.physics import BodyType as JBodyType
from fyrox_tpu.physics import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu.physics import broadphase as jbp
from fyrox_tpu.physics import np_planes as jnp_planes
from fyrox_tpu.physics import pallas_ops as jops
from fyrox_tpu.physics import slab2 as jslab2
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.physics.planes import q_to_rot9 as jq_to_rot9
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.physics import BALL, CUBOID, HALFSPACE, BodyType
from fyrox_tpu_torch.physics import PhysicsBuilder
from fyrox_tpu_torch.physics import broadphase as tbp
from fyrox_tpu_torch.physics import np_planes as tnp_planes
from fyrox_tpu_torch.physics import plane_ops, slab2 as tslab2, tgs_kernel
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.physics.planes import q_to_rot9 as tq_to_rot9

torch.set_num_threads(2)

DT = 1.0 / 60.0
STEPS = 30


def _scene(pb_cls, ball, cuboid, halfspace, static):
    rng = np.random.default_rng(7)
    pb = pb_cls()
    g = pb.add_body(body_type=static)
    pb.add_collider(g, halfspace, [], friction=0.7)
    for i in range(24):
        p = (rng.uniform(-1.5, 1.5), 0.4 + 0.45 * (i // 6),
             rng.uniform(-1.5, 1.5))
        b = pb.add_body(position=p)
        if i % 2:
            pb.add_collider(b, ball, [0.22], friction=0.5, restitution=0.2)
        else:
            pb.add_collider(b, cuboid, [0.18, 0.18, 0.18], friction=0.5)
    return pb, pb.build(broadphase="slab")


@pytest.fixture(scope="module")
def scenes():
    jpb, jt = _scene(JPhysicsBuilder, JBALL, JCUBOID, JHALFSPACE,
                     JBodyType.STATIC)
    tpb, tt = _scene(PhysicsBuilder, BALL, CUBOID, HALFSPACE,
                     BodyType.STATIC)
    return jpb, jt, tpb, tt


@pytest.fixture(scope="module")
def rollout(scenes):
    """Both packages from the same initial state: per-step numpy states."""
    jpb, jt, tpb, tt = scenes
    js = jworld.init_physics_state(jpb, jt, 2)
    ts = convert.physics_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    out = [(jax.tree_util.tree_map(np.asarray, js), convert.to_numpy(ts))]
    for _ in range(STEPS):
        js = step(js)
        ts = tworld.step_physics(ts, tt, DT, fused=False)
        out.append((jax.tree_util.tree_map(np.asarray, js),
                    convert.to_numpy(ts)))
    return out


# ---- K4a: plane gather ----------------------------------------------------

@pytest.mark.parametrize("w,a,n,k", [(2, 19, 25, 288), (3, 10, 24, 1152),
                                     (1, 4, 130, 700)])
def test_plane_gather_plain_matches_jax(w, a, n, k):
    rng = np.random.default_rng(n + k)
    planes = rng.standard_normal((w, a, n)).astype(np.float32)
    idx = rng.integers(0, n + n // 4, (w, k)).astype(np.int32)
    ref = jops.plane_gather(jnp.asarray(planes), jnp.asarray(idx)[:, None])
    got = plane_ops.plane_gather(torch.as_tensor(planes),
                                 torch.as_tensor(idx))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())   # exact


def test_gather_rows_matches_jax_with_negative_indices():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 10)).astype(np.float32)
    idx = rng.integers(-8, 48, (2, 300)).astype(np.int32)
    ref = jops.gather_rows(jnp.asarray(x), jnp.asarray(idx))
    got = plane_ops.gather_rows(torch.as_tensor(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("tables,d,dtype,planar", [
    (3, 10, np.int32, False), (1, 10, np.int32, False),
    (1, 256, np.int64, False), (3, 1, np.int64, False),
    (3, 10, np.int64, True), (1, 23, np.int32, True)])
def test_gather_rows_plain_matches_jax(tables, d, dtype, planar):
    """gather_rows_plain bit for bit against the JAX package's gather_rows
    on per-world tables and on one table every world reads ([1, B, D];
    JAX takes it broadcast over the worlds), indices out of range on both
    sides; the output is a contiguous [W, K, D], or with `planar` a view
    of contiguous [W, D, K] memory."""
    rng = np.random.default_rng(d + tables)
    w, b, k = 3, 40, 300
    x = rng.standard_normal((tables, b, d)).astype(np.float32)
    idx = rng.integers(-8, b + 8, (w, k)).astype(dtype)
    ref = jops.gather_rows(jnp.broadcast_to(jnp.asarray(x), (w, b, d)),
                           jnp.asarray(idx))
    got = plane_ops.gather_rows_plain(torch.as_tensor(x), torch.as_tensor(idx),
                                      planar)
    assert got.shape == (w, k, d)
    assert (got.transpose(1, 2) if planar else got).is_contiguous()
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


# ---- narrowphase ----------------------------------------------------------

COMBOS = [(cls, ka, kb) for cls, combos in tnp_planes.CLASS_COMBOS_P.items()
          for ka, kb in combos]


@pytest.mark.parametrize("cls,ka,kb", COMBOS)
def test_contact_kernels_match(cls, ka, kb):
    rng = np.random.default_rng(100 * cls + 10 * ka + kb)
    k = 256
    q = rng.standard_normal((2, k, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = rng.uniform(-0.3, 0.3, (2, k, 3)).astype(np.float32)
    p6 = np.zeros((2, k, 6), np.float32)
    p6[..., :3] = rng.uniform(0.1, 0.3, (2, k, 3))
    pred = np.full((k,), 0.05, np.float32)
    ea, eb = np.full((k,), ka, np.int32), np.full((k,), kb, np.int32)

    def run(lib, rot9, arr):
        return lib.generate_class_planes(
            cls, arr(ea), arr(eb), tuple(arr(pos[0, :, i]) for i in range(3)),
            rot9(tuple(arr(q[0, :, i]) for i in range(4))),
            tuple(arr(p6[0, :, i]) for i in range(6)),
            tuple(arr(pos[1, :, i]) for i in range(3)),
            rot9(tuple(arr(q[1, :, i]) for i in range(4))),
            tuple(arr(p6[1, :, i]) for i in range(6)), arr(pred))

    ref = run(jnp_planes, jq_to_rot9, jnp.asarray)
    got = run(tnp_planes, tq_to_rot9, torch.as_tensor)
    flat_r = jax.tree_util.tree_leaves(tuple(ref))
    flat_g = jax.tree_util.tree_leaves(
        tuple(tuple(x) if isinstance(x, list) else x for x in got))
    assert len(flat_r) == len(flat_g)
    for r, g in zip(flat_r, flat_g):
        # float32 geometry (SAT axes, clipping, normalisation) in two op
        # orders; depths/points of order 0.1-1
        np.testing.assert_allclose(np.asarray(r), np.asarray(g), rtol=0,
                                   atol=2e-5)


# ---- one step, stage by stage ---------------------------------------------

@pytest.fixture(scope="module")
def stages(scenes, rollout):
    """Both packages' pre-solve stages on the state of step 20 (contacts
    live)."""
    jpb, jt, tpb, tt = scenes
    jst_np, _ = rollout[20]
    jst = jax.tree_util.tree_map(jnp.asarray, jst_np)
    tst = convert.physics_state(jst_np, device="cpu")
    jcx, tcx = jslab2._ctx(jt), tslab2._ctx(tt)
    margin = jt.allowed_linear_error + jworld.SPECULATIVE_MARGIN
    tight = jworld.SPECULATIVE_MARGIN - jworld.PREDICTION_DISTANCE

    def jax_pre(st):
        cpos, cq, lv_c = jslab2._collider_pose_planes(
            jcx, jslab2._unstack3(st.position), jslab2._unstack4(st.rotation),
            jslab2._unstack3(st.linvel))
        crot9 = jq_to_rot9(cq)
        v_sweep = tuple(x * DT for x in lv_c)
        amin, amax = jslab2._aabb_planes(jcx, jt, cpos, crot9, v_sweep,
                                         margin)
        cands = jbp.slab_candidates(jt.grid, jcx.col_body, jcx.dyn_col,
                                    jslab2._stack(amin), jslab2._stack(amax),
                                    tight_delta=tight)
        af, ai = jslab2._narrowphase_windows(jcx, jt, cands, cpos, cq, crot9,
                                             v_sweep, margin, jnp.float32)
        return amin, amax, cands, af, ai, jslab2._compact(jcx, af, ai,
                                                          jnp.float32)

    j = jax.tree_util.tree_map(np.asarray, jax.jit(jax_pre)(jst))
    cpos, cq, lv_c = tslab2._collider_pose_planes(
        tcx, tst.position.unbind(-1), tst.rotation.unbind(-1),
        tst.linvel.unbind(-1))
    v_sweep = tuple(x * DT for x in lv_c)
    amin, amax = tslab2._aabb_planes(tcx, tt, cpos, tq_to_rot9(cq), v_sweep,
                                     margin)
    cands = tbp.slab_candidates(tt.grid, tcx.col_body, tcx.dyn_col,
                                torch.stack(amin, -1), torch.stack(amax, -1),
                                tight_delta=tight)
    af, ai = tslab2._narrowphase_windows(tcx, tt, cands, cpos, cq, v_sweep,
                                         margin)
    t = (amin, amax, cands, af, ai, tslab2._compact(tcx, af, ai))
    return j, convert.to_numpy(t), (jst, tst, jcx, tcx)


def test_aabbs_match(stages):
    j, t, _ = stages
    for a, b in zip(j[0] + j[1], t[0] + t[1]):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("field", ["j_real", "body_j", "valid", "swap",
                                   "pid"])
def test_slab_candidate_windows_equal(stages, field):
    j, t, _ = stages
    assert sum(int(c.valid.sum()) for c in j[2]) > 0
    for cls in range(3):
        np.testing.assert_array_equal(getattr(j[2][cls], field),
                                      getattr(t[2][cls], field))


def test_narrowphase_windows_and_compaction_match(stages):
    j, t, _ = stages
    for name in ("body_j", "pid"):
        np.testing.assert_array_equal(j[4][name], t[4][name])
    for name in j[3]:
        np.testing.assert_allclose(j[3][name], t[3][name], rtol=0,
                                   atol=1e-6, err_msg=name)
    jc, tc = j[5], t[5]
    np.testing.assert_array_equal(jc.pid, tc.pid)
    np.testing.assert_array_equal(jc.body_j, tc.body_j)
    np.testing.assert_array_equal(jc.act, tc.act)
    assert jc.act.sum() > 0
    for a, b in zip(jax.tree_util.tree_leaves((jc.n, jc.pt, jc.depth,
                                               jc.sigma, jc.own)),
                    jax.tree_util.tree_leaves((tc.n, tc.pt, tc.depth,
                                               tc.sigma, tc.own))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("warm", [False, True])
def test_plain_solve_matches_xla_plane_solver(scenes, stages, warm):
    """solve_tgs_plain (the plain version of the K1 kernel) on the JAX
    package's own compacted contacts vs its XLA plane solver."""
    jpb, jt, tpb, tt = scenes
    j, _, (jst, tst, jcx, tcx) = stages
    jcon = jax.tree_util.tree_map(jnp.asarray, j[5])
    if warm:
        warm_j = (jst.warm_n, jst.warm_t1, jst.warm_t2, jst.warm_pair)
        same = (jst.warm_pair == jcon.pid).astype(jnp.float32) * jcon.act
        lam0 = tuple(np.asarray(x * same) for x in warm_j[:3])
    else:
        warm_j = None
        lam0 = tuple(np.zeros(jcon.act.shape, np.float32) for _ in range(3))
    accel = jnp.broadcast_to(jnp.asarray([0.0, -9.81, 0.0]) * (
        jnp.asarray(jt.body_type) == 0)[:, None], jst.position.shape)
    ref = jax.jit(lambda st, con: jslab2._solve_tgs_planes(
        jcx, jt, con, jslab2._unstack3(st.position),
        jslab2._unstack4(st.rotation), jslab2._unstack3(st.linvel),
        jslab2._unstack3(st.angvel), jslab2._unstack3(accel),
        jnp.asarray(jt.inv_mass)[None], DT, warm=warm_j))(jst, jcon)
    ref = jax.tree_util.tree_map(np.asarray, ref)

    tcon = tslab2._Contacts(*(
        tuple(torch.tensor(np.asarray(x)) for x in f)
        if isinstance(f, tuple) else torch.tensor(np.asarray(f))
        for f in j[5]))
    packed = tslab2.pack_solver_inputs(
        tcx, tcon, tuple(torch.as_tensor(x) for x in lam0),
        tst.position.unbind(-1), tst.rotation.unbind(-1),
        tst.linvel.unbind(-1), tst.angvel.unbind(-1),
        torch.as_tensor(np.asarray(accel)).unbind(-1))
    body, lam = tgs_kernel.solve_tgs(*packed,
                                     tgs_kernel.solver_params(tt, DT))
    got_pos = body[:, 6:9].transpose(1, 2).numpy()
    got_lv = body[:, 0:3].transpose(1, 2).numpy()
    # one step of the same solve, reduction orders differing: the
    # reference's own kernel-vs-XLA bounds for one step (pos 1e-6,
    # vel 1e-5, test_pallas_step.py:102-105)
    np.testing.assert_allclose(np.stack(ref[0], -1), got_pos, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.stack(ref[2], -1), got_lv, rtol=0,
                               atol=1e-5)
    w, cg, s = lam.shape[0], tcx.cg, tcx.s_active
    got_lam = lam.transpose(2, 3).reshape(w, 3, cg * s).numpy()
    np.testing.assert_allclose(np.stack(ref[4], 1), got_lam, rtol=1e-4,
                               atol=1e-5)


# ---- the step and the rollout ---------------------------------------------

def test_one_step_candidates_pids_and_positions(rollout):
    jst, tst = rollout[1]
    np.testing.assert_array_equal(jst.warm_pair, tst.warm_pair)
    # one step of identical float32 math in two op orders
    np.testing.assert_allclose(jst.position, tst.position, rtol=0,
                               atol=1e-6)


def test_rollout_stays_within_trajectory_bounds(rollout):
    jst, tst = rollout[-1]
    assert (jst.warm_pair >= 0).sum() > 0          # contacts are live
    dp = np.abs(jst.position - tst.position).max()
    dv = np.abs(jst.linvel - tst.linvel).max()
    # the reference's own bounds between two implementations of this
    # scene's 30-step trajectory (test_pallas_solver.py:64-65)
    assert dp < 5e-4, dp
    assert dv < 5e-3, dv
    assert np.isfinite(tst.position).all()
